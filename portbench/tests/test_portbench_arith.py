"""The benchmark's frozen arithmetic against the originals it was copied
from, and against PyTorch's own count of the products it bounds."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith
from portbench.reference import masks

REPO = Path(__file__).resolve().parents[2]


def config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_videomae_counts_equal_the_originals(chip_smoke):
    from bvc_tpu_torch.utils.config import ModelConfig

    m = config("videomae_b")["model"]
    visible = arith.num_visible(m, 0.9)
    assert visible == 160 and arith.seq_len(m) == 1568
    assert arith.train_flops_per_clip(m, visible) == chip_smoke.train_flops_per_clip(
        ModelConfig(), 160)
    assert round(arith.train_flops_per_clip(m, visible) / 1e9, 1) == 202.7
    assert arith.embed_flops_per_clip(m) == chip_smoke.embed_flops_per_clip(ModelConfig())
    assert round(arith.embed_flops_per_clip(m) / 1e9, 1) == 360.7


def test_jepa_count_at_the_caps_equals_the_original(chip_smoke):
    m = config("vjepa_vit_b")["model"]
    cfg, _, _ = chip_smoke.jepa_config()
    assert dataclasses.asdict(cfg)["pred_emb_dim"] == m["pred_emb_dim"]
    assert arith.jepa_train_flops_per_clip(m, 169, 30, 4) == \
        chip_smoke.jepa_train_flops_per_clip(cfg, 169, 30, 4)
    assert round(arith.jepa_train_flops_per_clip(m, 169, 30, 4) / 1e9, 1) == 219.0


def test_jepa_count_keeps_fewer_tokens_on_a_padded_batch():
    c = config("vjepa_vit_b")
    enc, pred = masks.multiblock(7, 0, 64, (2, 14, 14), c["mask"])
    assert enc.shape == (64, 169) and pred.shape == (64, 4, 30)
    ke, kp = int((enc[0] >= 0).sum()), int((pred[0, 0] >= 0).sum())
    assert (enc >= 0).sum(1).tolist() == [ke] * 64  # every row keeps as many
    assert ke < 169 or kp < 30
    kept = arith.jepa_train_flops_per_clip(c["model"], ke, kp, 4)
    assert kept < arith.jepa_train_flops_per_clip(c["model"], 169, 30, 4)


ATTENTION_SHAPES = [(48, 160, 12, 64), (48, 1568, 6, 64), (64, 1568, 12, 64),
                    (64, 392, 12, 64), (64, 169, 12, 64), (256, 199, 12, 32)]


def plain_attention(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def ms(flops: float, nbytes: float) -> float:
    """The least time of ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / arith.PEAK_BF16_FLOPS, nbytes / arith.PEAK_HBM_BYTES) * 1e3


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_bounds_count_no_more_than_the_work(shape):
    """A share above 100% is impossible: each bound's operations are the
    products the call cannot avoid (the forward's two; the backward's four
    and the recomputed scores), as PyTorch counts them on the same shapes,
    and its bytes no more than those of the tensors the call reads and
    writes once (bf16 q, k, v, o, dO, dQ, dK, dV; f32 LSE and D), so the
    bound is never above the least time of the work."""
    B, N, h, d = shape
    q, k, v = (torch.empty(shape, device="meta", requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        o = plain_attention(q, k, v)
    with FlopCounterMode(display=False) as bwd:
        o.backward(torch.empty(shape, device="meta"))
    t = B * N * h * d * 2  # one bf16 tensor [B, N, h, d]
    flops = fwd.get_total_flops()
    bound = arith.attention_bound_ms(B, N, h, d)[0]
    assert flops / arith.PEAK_BF16_FLOPS * 1e3 <= bound * (1 + 1e-9)
    assert bound <= ms(flops, 4 * t + B * h * N * 4) * (1 + 1e-9)
    flops = bwd.get_total_flops() + fwd.get_total_flops() / 2
    bound = arith.bwd_bound_ms(B, N, h, d, 5, 3)[0]
    assert flops / arith.PEAK_BF16_FLOPS * 1e3 <= bound * (1 + 1e-9)
    assert bound <= ms(flops, 8 * t + 2 * B * h * N * 4) * (1 + 1e-9)
    half = arith.attention_bound_ms(B, N, h, d, bias=True, keys=B * N // 2)[0]
    assert half < arith.attention_bound_ms(B, N, h, d, bias=True)[0]


@pytest.mark.parametrize("mkn", [(512, 3072, 768), (8192, 1024, 1024)])
def test_gemm_bound_counts_the_product(mkn):
    M, N, K = mkn
    a, b = torch.empty(M, K, device="meta"), torch.empty(N, K, device="meta")
    with FlopCounterMode(display=False) as fc:
        a @ b.T
    bound = arith.gemm_bound_ms(M, N, K, 2, 2, arith.PEAK_BF16_FLOPS)[0]
    assert bound == pytest.approx(ms(fc.get_total_flops(), 2 * (M * K + N * K + M * N)))
    assert fc.get_total_flops() / arith.PEAK_BF16_FLOPS * 1e3 <= bound * (1 + 1e-9)


def test_union_counts_overlap_once():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert arith.union_us(spans) == 12 + 10 + 1
    assert arith.merged(spans) == [(0, 12), (20, 30), (40, 41)]
    assert arith.uncovered_us([(0, 10), (20, 30)], [(5, 25)]) == 5 + 5
    rng = np.random.default_rng(0)
    for _ in range(20):
        lo = rng.uniform(0, 100, 30)
        s = list(zip(lo, lo + rng.uniform(0, 10, 30)))
        grid = np.linspace(0, 120, 120001)
        covered = np.zeros_like(grid, dtype=bool)
        for a, b in s:
            covered |= (grid >= a) & (grid < b)
        assert arith.union_us(s) == pytest.approx(covered.mean() * 120, abs=0.01)


def test_idle_share_never_counts_copies_as_busy():
    from portbench.trace import TraceView

    view = TraceView.__new__(TraceView)
    view.window_s, view.steps = 100e-6, 1
    view.kernels = [("k", 0.0, 30.0), ("k", 20.0, 50.0)]
    view.spans = [("step", 45.0, 80.0)]
    assert view.idle_share() == pytest.approx(0.5)
    assert view.idle_gaps() == []
    view.kernels.append(("k", 95.0, 100.0))
    assert view.idle_gaps() == [["step", pytest.approx(45e-6)]]
