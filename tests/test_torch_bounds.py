"""The roofs ``chip_smoke.py`` reports beside each attention kernel's time,
against numbers worked by hand: the tensor-core and byte roofs of
``attention_bound_ms`` and ``bwd_bound_ms`` (the whole backward as 5
products with 3 outputs; under a key bias that masks some keys, K and V
read and multiplied for the attendable keys only) and the choice of the
larger, and the exponential roof of ``exp_bound_ms``.  Importing
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


@pytest.mark.parametrize("shape,bias,keys,want_ms,want_by", [
    # 4 B h N^2 d = 60,423,143,424 operations at 989e12/s, against
    # 77,672,448 bytes (q, k, v, o bf16 and LSE f32) at 3.35e12/s: 0.023186 ms
    ((8, 1568, 12, 64), False, None, 0.0610952, "operations"),
    # 4 * 8 * 12 * 169^2 * 64 = 701,915,136 operations: 7.0972e-4 ms, against
    # 8,306,688 + 64,896 + 5,408 (the key bias) = 8,376,992 bytes: 0.0025006 ms
    ((8, 169, 12, 64), True, None, 0.0025006, "bytes"),
    # 76 of each element's 169 keys attendable (608 in all): 4 * 12 * 169 *
    # 608 * 64 = 315,654,144 operations (3.1916e-4 ms), against q and o for
    # every token and k and v for the 608 keys, 2 * (1352 + 608) * 12 * 64 * 2
    # = 6,021,120, + 64,896 + 5,408 = 6,091,424 bytes: 0.0018183 ms
    ((8, 169, 12, 64), True, 608, 0.0018183, "bytes"),
])
def test_attention_bound_takes_the_larger_roof(shape, bias, keys, want_ms, want_by):
    ms, by = chip_smoke.attention_bound_ms(*shape, bias=bias, keys=keys)
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


@pytest.mark.parametrize("products,outputs,keys,want_ms", [
    # the fused key-bias backward at [8, 169, 12, 64], 5 products and 3
    # outputs: it reads qs, k, v, dO, L, D and the bias and writes dQ, dK, dV:
    # 7 x 1,038,336 x 2 + 2 x 8 x 12 x 169 x 4 + 8 x 169 x 4 = 14,671,904
    # bytes -> 0.0043797 ms, over its 1,754,787,840-operation roof (0.0017743)
    (5, 3, None, 0.0043797),
    # 608 of the 1352 keys attendable: k and v for those only, (5 x 1352 + 2
    # x 608) x 12 x 64 x 2 + 129,792 + 5,408 = 12,386,336 bytes -> 0.0036974
    # ms, over 10 x 12 x 169 x 608 x 64 = 789,135,360 operations (7.979e-4)
    (5, 3, 608, 0.0036974),
])
def test_backward_bound_of_the_key_bias_kernels(products, outputs, keys, want_ms):
    ms, by = chip_smoke.bwd_bound_ms(8, 169, 12, 64, products, outputs, bias=True, keys=keys)
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, rel=1e-4)
