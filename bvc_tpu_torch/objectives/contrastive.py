"""NT-Xent / InfoNCE for SimCLR (counterpart of
:mod:`bvc_tpu.objectives.contrastive`).

The reference's ``info_nce_loss`` (``contrastive/pretrain_simclr.py:86-91,
114-128, 283-292``) with its two quirks, kept in ``mode='parity'`` (the
default):

1. the positive mask is ``|i - j| == 1`` over the interleaved ``[2B]``
   batch (anchor0, pos0, anchor1, pos1, ...): the true pairs in both
   directions and the cross-sample pairs (2k+1, 2k+2);
2. the log-partition is one logsumexp over every negative pair of the whole
   batch, not one per row: the loss is ``logsumexp(all negatives) -
   mean(positives)``.

``mode='standard'`` is the textbook per-anchor NT-Xent with only the true
pairs positive.  Rows are normalised with their norm clamped at 1e-8, as
the JAX package does (``F.normalize`` clamps at 1e-12, another function).
``replica_ids`` scores each replica's rows on their own and averages, the
reference's per-rank loss; the sharded per-replica form waits for the
multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch


def interleaved_pair_masks(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(pos_mask, neg_mask) over the ``[n, n]`` similarity matrix, n = 2 *
    batch: pos = ``|i - j| == 1``; neg = everything but pos and self."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    pos = np.abs(i - j) == 1
    return pos, ~(pos | (i == j))


def standard_pair_masks(n: int) -> tuple[np.ndarray, np.ndarray]:
    """True SimCLR pairing: positives only (2k, 2k+1) and (2k+1, 2k)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    pos = (i // 2 == j // 2) & (i != j)
    return pos, ~(pos | (i == j))


def _cosine_matrix(feats: torch.Tensor) -> torch.Tensor:
    f = feats.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    return f @ f.T


def info_nce_loss(feats: torch.Tensor, temperature: float = 0.1, mode: str = "parity",
                  replica_ids: torch.Tensor | None = None, n_replicas: int = 1
                  ) -> torch.Tensor:
    """Loss over interleaved ``[2B, D]`` features, in f32.

    ``replica_ids [2B]`` / ``n_replicas > 1``: each replica's positives and
    negatives only, its own log-partition, averaged over replicas (a pooled
    logsumexp over all replicas' negatives would weight them differently)."""
    n = feats.shape[0]
    sim = _cosine_matrix(feats) / temperature
    pos_np, neg_np = (interleaved_pair_masks if mode == "parity" else standard_pair_masks)(n)
    pos = torch.from_numpy(pos_np).to(sim.device)
    neg = torch.from_numpy(neg_np).to(sim.device)
    if replica_ids is not None and n_replicas > 1:
        same = replica_ids[:, None] == replica_ids[None, :]
        neg, pos = neg & same, pos & same
        if mode == "parity":
            # each replica's global logsumexp, a segment reduction over the
            # row's replica id
            seg = replica_ids[:, None].expand(n, n).reshape(-1).long()
            flat = sim.reshape(-1)
            flat_neg, flat_pos = neg.reshape(-1), pos.reshape(-1)
            masked = torch.where(flat_neg, flat, float("-inf"))
            seg_max = torch.full((n_replicas,), float("-inf"), device=sim.device)
            seg_max = seg_max.scatter_reduce(0, seg, masked, "amax").clamp(min=-1e30)
            seg_max = seg_max.detach()  # a shift only; the logsumexp does not depend on it
            exps = torch.where(flat_neg, torch.exp(masked - seg_max[seg]), 0.0)
            zeros = torch.zeros(n_replicas, device=sim.device)
            log_z = seg_max + torch.log(zeros.index_add(0, seg, exps))
            pos_sum = zeros.index_add(0, seg, torch.where(flat_pos, flat, 0.0))
            pos_cnt = zeros.index_add(0, seg, flat_pos.float())
            return (log_z - pos_sum / pos_cnt.clamp(min=1.0)).mean()
        # standard mode is per anchor already: the scoped masks suffice
    if mode == "parity":
        log_z = torch.where(neg, sim, float("-inf")).reshape(-1).logsumexp(0)
        return log_z - torch.where(pos, sim, 0.0).sum() / pos.sum()
    log_z_row = torch.where(neg | pos, sim, float("-inf")).logsumexp(-1)
    return (log_z_row - torch.where(pos, sim, 0.0).sum(-1)).mean()
