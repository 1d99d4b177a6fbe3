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
reference's per-rank loss, in one process; across ranks,
:func:`per_replica_info_nce_sharded` scores each rank's block and
:func:`global_info_nce` gathers every rank's rows first.
"""

from __future__ import annotations

import numpy as np
import torch

from bvc_tpu_torch.parallel.collectives import all_gather_grad


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


def per_replica_info_nce_sharded(feats: torch.Tensor, temperature: float = 0.1,
                                 mode: str = "parity") -> torch.Tensor:
    """The per-replica loss of this rank's ``[2b, D]`` block of the
    interleaved rows, the counterpart of JAX's ``shard_map`` form (each
    chip scores only its own block).  Each rank returns its own block's
    loss; DistributedDataParallel's mean of the gradients over ranks is
    then the gradient of the mean of the blocks' losses (JAX's ``pmean``,
    the reference's ``AllReduce`` of the per-rank loss), and the step's
    metric averages the values.  The block must hold whole (anchor,
    positive) pairs: an even row count."""
    if feats.shape[0] % 2:
        raise ValueError(f"per-replica blocks need whole pairs: {feats.shape[0]} rows")
    return info_nce_loss(feats, temperature, mode)


def global_info_nce(feats: torch.Tensor, temperature: float = 0.1,
                    mode: str = "parity") -> torch.Tensor:
    """The loss over every rank's rows, ``[2b, D]`` each, gathered with
    their gradient in rank order: the global ``[2B, 2B]`` matrix in the
    interleaved global order (rank r's block of pairs is JAX's shard r).
    Every rank computes the same value."""
    return info_nce_loss(all_gather_grad(feats), temperature, mode)
