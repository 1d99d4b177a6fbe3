"""The roofs ``chip_smoke.py`` reports beside each attention kernel's time,
against numbers worked by hand: the tensor-core and byte roofs of
``attention_bound_ms`` and ``bwd_bound_ms`` (the whole unmasked backward as
5 products with 3 outputs, the key-bias kernels as 3 and 4) and the choice
of the larger, and the exponential roof of ``exp_bound_ms``.  Importing
``chip_smoke`` runs no phase: it imports ``torch`` only inside its
functions."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# [8, 1568, 12, 64]: B h N^2 = 8 * 12 * 1568^2 = 236,027,904 scores
SCORES = 236_027_904


@pytest.mark.parametrize("shape,bias,want_ms,want_by", [
    # 4 B h N^2 d = 60,423,143,424 operations at 989e12/s, against
    # 77,672,448 bytes (q, k, v, o bf16 and LSE f32) at 3.35e12/s: 0.023186 ms
    ((8, 1568, 12, 64), False, 0.0610952, "operations"),
    # 4 * 8 * 12 * 169^2 * 64 = 701,915,136 operations: 7.0972e-4 ms, against
    # 8,306,688 + 64,896 + 5,408 (the key bias) = 8,376,992 bytes: 0.0025006 ms
    ((8, 169, 12, 64), True, 0.0025006, "bytes"),
])
def test_attention_bound_takes_the_larger_roof(shape, bias, want_ms, want_by):
    ms, by = chip_smoke.attention_bound_ms(*shape, bias=bias)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-4)


@pytest.mark.parametrize("clock_mhz,sms,want_ms", [
    # 236,027,904 / (16 * 132 * 1.98e9) s
    (1980, 132, 0.0564420),
    # the same at 1755 MHz on 114 SMs (an H100 PCIe): / (16 * 114 * 1.755e9)
    (1755, 114, 0.0737329),
])
def test_exponential_roof(clock_mhz, sms, want_ms):
    assert chip_smoke.exp_bound_ms(SCORES, clock_mhz, sms) == pytest.approx(want_ms, rel=1e-5)


def test_exponential_roof_beside_the_tensor_cores():
    # at head width 64 the exponentials take nearly as long as the products
    ops_ms, _ = chip_smoke.attention_bound_ms(8, 1568, 12, 64)
    exp_ms = chip_smoke.exp_bound_ms(SCORES, 1980, 132)
    assert 0.9 < exp_ms / ops_ms < 0.95


@pytest.mark.parametrize("shape,products,outputs,want_ms,want_by", [
    # the whole unmasked backward, 5 products: 10 B h N^2 d =
    # 75,528,929,280 operations -> 0.0763690 ms, against (4 + 3) x
    # 4,816,896 bf16 entries + 2 x 8 x 6 x 1568 f32 (L, D) = 68,038,656 bytes
    # -> 0.0203100 ms
    ((8, 1568, 6, 64), 5, 3, 0.0763690, "operations"),
    # the encoder's shape: 1,572,864,000 operations -> 0.0015904 ms, against
    # 7 x 983,040 x 2 + 2 x 8 x 12 x 160 x 4 = 13,885,440 bytes -> 0.0041449 ms
    ((8, 160, 12, 64), 5, 3, 0.0041449, "bytes"),
])
def test_backward_bound_of_the_fused_kernel(shape, products, outputs, want_ms, want_by):
    ms, by = chip_smoke.bwd_bound_ms(*shape, products, outputs)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-5)


@pytest.mark.parametrize("products,outputs,bias,want_ms", [
    # the key-bias kernels keep their own bounds at [8, 169, 12, 64]: dQ
    # reads qs, k, v, dO, L, D and the bias and writes dQ: 5 x 1,038,336 x 2
    # + 2 x 8 x 12 x 169 x 4 + 8 x 169 x 4 = 10,518,560 bytes -> 0.0031399 ms;
    # dK/dV writes two: 12,595,232 bytes -> 0.0037598 ms (both over their
    # 3- and 4-product roofs, 0.0010646 and 0.0014194 ms)
    (3, 1, True, 0.0031399),
    (4, 2, True, 0.0037598),
])
def test_backward_bound_of_the_key_bias_kernels(products, outputs, bias, want_ms):
    ms, by = chip_smoke.bwd_bound_ms(8, 169, 12, 64, products, outputs, bias=bias)
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, rel=1e-4)
