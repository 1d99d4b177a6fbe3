"""The port's InfoNCE (``bvc_tpu_torch.objectives.contrastive``) against
``bvc_tpu.objectives.contrastive``: the pair masks equal, the loss in
both modes, with and without ``replica_ids``, within 1e-6 relative and its
gradient with respect to the features within 1e-5 (f32 on both sides,
sums in other orders; relative where one row's gradient is of order 1e8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bvc_tpu.objectives import contrastive as jax_contrastive
from bvc_tpu_torch.objectives import contrastive

LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-5


def feats_of(n: int, d: int = 16, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (n, d)).astype(np.float32)


def both(f: np.ndarray, **kw):
    """(port loss, port d/dfeats, JAX loss, JAX d/dfeats)."""
    ids = kw.pop("replica_ids", None)
    t = torch.from_numpy(f).requires_grad_(True)
    loss = contrastive.info_nce_loss(
        t, replica_ids=None if ids is None else torch.from_numpy(ids), **kw)
    loss.backward()
    jids = None if ids is None else jnp.asarray(ids)
    jloss, jgrad = jax.value_and_grad(
        lambda x: jax_contrastive.info_nce_loss(x, replica_ids=jids, **kw))(jnp.asarray(f))
    return loss.item(), t.grad.numpy(), float(jloss), np.asarray(jgrad)


@pytest.mark.parametrize("n", [2, 8, 10])
def test_pair_masks_match_jax(n):
    for ours, theirs in ((contrastive.interleaved_pair_masks, jax_contrastive.interleaved_pair_masks),
                         (contrastive.standard_pair_masks, jax_contrastive.standard_pair_masks)):
        for a, b in zip(ours(n), theirs(n)):
            np.testing.assert_array_equal(a, b)
    pos, _ = contrastive.interleaved_pair_masks(n)
    i, j = np.nonzero(pos)
    assert (np.abs(i - j) == 1).all() and len(i) == 2 * (n - 1)  # (2k+1, 2k+2) too


@pytest.mark.parametrize("mode", ["parity", "standard"])
@pytest.mark.parametrize("temperature", [0.1, 0.5])
@pytest.mark.parametrize("n", [4, 16])
def test_loss_and_gradient_match_jax(mode, temperature, n):
    loss, grad, jloss, jgrad = both(feats_of(n, seed=n), temperature=temperature, mode=mode)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("mode", ["parity", "standard"])
def test_replica_scoped_loss_matches_jax(mode):
    """Two replicas of 3 pairs each, and three of 2: each replica's own
    positives and log-partition, averaged."""
    for ids in (np.repeat([0, 1], 6), np.repeat([0, 1, 2], 4)):
        f = feats_of(len(ids), seed=len(set(ids)))
        loss, grad, jloss, jgrad = both(f, mode=mode, replica_ids=ids.astype(np.int32),
                                        n_replicas=len(set(ids)))
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(grad, jgrad, rtol=0, atol=GRAD_ATOL)
        pooled = both(f, mode=mode)[0]
        if mode == "parity":  # one pooled log-partition is another loss
            assert abs(pooled - loss) > 1e-3


def test_parity_log_partition_is_global():
    """``parity`` takes one logsumexp over every negative pair of the batch,
    not one per row."""
    f = feats_of(8, seed=3)
    sim = (F.normalize(torch.from_numpy(f), dim=-1) @ F.normalize(torch.from_numpy(f), dim=-1).T) / 0.1
    pos, neg = (torch.from_numpy(m) for m in contrastive.interleaved_pair_masks(8))
    want = sim[neg].logsumexp(0) - sim[pos].mean()
    got = contrastive.info_nce_loss(torch.from_numpy(f))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    per_row = (torch.where(neg, sim, float("-inf")).logsumexp(-1)[:, None] - sim)[pos].mean()
    assert abs(per_row.item() - got.item()) > 1.0


def test_norm_clamped_at_1e_8():
    """A row of norm 1e-10 is divided by 1e-8, as JAX does, not scaled to
    unit length as ``F.normalize`` (clamp 1e-12) would."""
    f = feats_of(6, seed=4)
    f[2] *= 1e-10 / np.linalg.norm(f[2])
    loss, grad, jloss, jgrad = both(f)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    # the tiny row's gradient is of order 1e8 / norm: within 1e-5 of it
    np.testing.assert_allclose(grad, jgrad, rtol=GRAD_ATOL, atol=GRAD_ATOL)
    unit = contrastive.info_nce_loss(F.normalize(torch.from_numpy(f), dim=-1, eps=1e-12))
    assert abs(unit.item() - loss) > 1e-3


def test_bf16_features_score_in_f32():
    f = feats_of(8, seed=5)
    t = torch.from_numpy(f).to(torch.bfloat16)
    got = contrastive.info_nce_loss(t)
    assert got.dtype == torch.float32
    want = jax_contrastive.info_nce_loss(jnp.asarray(f).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
