#!/usr/bin/env python3
"""Drive the PyTorch port (``bvc_tpu_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py            # build, check, time; one card
    python3 chip_smoke.py --profile [FILE]  # also torch.profiler breakdowns of one
                                            # bf16 and one W8A8 embed call and one
                                            # VideoMAE and one JEPA training step,
                                            # written to FILE, profile_w8a8.txt,
                                            # profile_train.txt and profile_jepa.txt
    python3 chip_smoke.py --repeat-shard-ranks N  # only the sharding phase's two-rank
                                                  # gloo jobs, N times each, and how
                                                  # each run ended (a diagnostic)

1. Build every CUDA kernel of the port from ``bvc_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card, its power
   limit, its highest SM clock, the versions, the build time and each
   kernel's registers and spills (failing if a backward instantiation or a
   key-bias forward spills or ptxas serialises its wgmma).  Then the
   forward's two products on one tile (S = q k^T, O = bf16(S) v) and the
   backward's five (S^T, dP^T, dV, dK, dQ) at head widths 64 and 32 against
   f32 products, before anything runs on them.
2. Forward kernel against plain: the flash forward kernel against its plain
   PyTorch version on the card, at the extraction shape ``[8, 1568, 12, 64]``,
   the encoder's shape in training ``[8, 160, 12, 64]``, the V-JEPA target
   encoder's and extraction shape ``[8, 392, 12, 64]``, an odd N, the
   decoder shape ``[8, 1568, 6, 64]`` and extraction's launch at B=64
   ``[64, 1568, 12, 64]``; O within 2e-2 (bf16 output, accumulation in
   another order), LSE within 1e-3 (f32).  Times of the kernel, by events
   and in a CUDA graph (the short shapes are launch-bound), the plain
   version and ``F.scaled_dot_product_attention`` (a yardstick only: the
   port never calls it), beside the tensor-core or byte bound and the
   exponential roof; and of the kernel against the plain attention path at
   N in {160, 392, 784, 1568}, forward alone and forward plus backward, for
   the routing threshold.
3. The unmasked backward against plain (``csrc/flash_bwd_sm90.cu``: a
   pre-pass for D, the fused kernel, a post-pass for dQ): dQ, dK and dV
   against the plain version at ``[8, 1568, 6, 64]`` (decoder),
   ``[8, 160, 12, 64]`` (encoder in training) and ``[8, 197, 12, 64]`` (odd
   N), each within 2e-2 x max|ref| (bf16 outputs, sums in another order) and
   within 1e-3 in |err|/|ref|, and a second run within 1e-3 of the first
   (dQ's f32 sum over key tiles has no fixed order); the pre-pass's D against the plain
   one and the post-pass's dQ equal to bf16 of the accumulator.  Times of
   the whole backward (through ``flash_bwd_cuda``) and of each kernel, by
   events and in a CUDA graph, the pre- and post-pass also with L2 flushed,
   beside the 5-product bound, the plain version and SDPA's backward in a
   graph with its backend pinned (flash, and cuDNN where it runs; the
   faster is kept).
4. Key-bias kernels against plain: the forward and the backward (pre-pass,
   fused kernel, post-pass, the same three kernels as 3 at head widths 64
   and 32) with a per-sample key bias at JEPA's context shape
   ``[8, 169, 12, 64]`` and predictor shape ``[32, 199, 12, 32]`` (collator
   masks), an odd N with 40% of the keys masked, one batch element with
   every key masked at both head widths, and the B=64 step's own
   ``[64, 169, 12, 64]`` and ``[256, 199, 12, 32]``: the limits of 2 and 3,
   a second run's dQ within 1e-3, LSE +inf exactly on rows with no key, and
   dK = dV = 0 exactly at masked keys; at the step's shapes, times by events
   and in a CUDA graph of the forward, the whole backward and each of its
   kernels against the bound (K and V of attendable keys only), the plain
   version and SDPA with the bias as its mask (memory-efficient and cuDNN
   backends pinned, the faster kept and named); then the kernels against
   plain attention, forward plus backward, at B=64 and N in {128, 160, 256}
   at both widths, for the masked routing rule.
5. GEMM kernels against plain (``csrc/gemm.cu``): the s8 kernel's raw
   int32 product exactly equal to the plain one at 1024^3,
   ``[8192,1024] x [1024,1024]``, ``[1001,768] x [2300,768]``, with a
   partial last K stage ``[1001,784] x [2300,784]``, and with int32 rows
   of no multiple of 16 bytes ``[1001,768] x [2302,768]``; its dequant
   epilogue within one bf16 ulp / 1e-6 relative of the plain version at
   the W8A8 path's qkv and fc1 shapes for B=8 and B=64 and at the ragged
   ``[1001,768] x [2300,768]`` (both of the epilogue's store paths); the
   bf16 kernel exact on integer-valued inputs (at the probe's shape and at
   K = 784) and within 1e-3 of max|ref| on normal ones; times against the
   bound, the plain version and, as yardsticks, ``torch._int_mm`` and a
   bf16 ``torch.matmul``, with the wrappers' host time per call and, at the
   probe's shape, times in a CUDA graph, the bf16 ones at K = 1024, 2048
   and 4096 too, split into a time per 1024 of K and a fixed part.
6. The softmax probe kernel against plain (``csrc/softmax_probe.cu``) at
   ``[64,12,512,64]``, ``[64,12,392,64]`` and ``[48,6,1568,64]`` with f32
   and bf16 scores: O within 3e-3 of the plain version in the same score
   dtype, equal to it at 99% of the entries or more, and the kernel's two
   outputs apart at 99% or more of the entries where the plain ones differ,
   so that a kernel which ignored the score dtype would fail; times by
   events and in a CUDA graph against the bound, the exponential roof, the
   plain version and SDPA's forward; the probe's readout max|O_bf16 - O_f32|.
7. The two probes as their own paths (``python -m
   bvc_tpu_torch.probes.int8_dot`` and ``.softmax_dtype``): launch counts
   set to 0, the probe run, its kernels and no other launched.
8. Extraction at full width: VideoMAE-B (224 px, 16 frames, bf16) through
   ``untrained_embed_fn``; 12 launches of the forward kernel in one embed
   call, embeddings within cosine 0.999 per row of the plain attention path
   on the same weights; then clips/s, frames/s and MFU at the largest batch
   in {64, 32, 16} that fits.
9. W8A8 extraction at full width: VideoMAE-B and V-JEPA ViT-B through
   ``untrained_embed_fn(..., quantize="int8")``; at B=8 one embed call
   launches ``gemm_s8`` 24 times and ``flash_fwd`` 12 times and nothing
   else, cosine >= 0.995 per row to the bf16 path on the same weights; then
   clips/s, frames/s and peak memory at the largest batch that fits (V-JEPA
   at B=64) beside the bf16 path's clips/s, and ``qdense`` against bf16
   ``F.linear`` for qkv, proj, fc1 and fc2 at ``[64*1568, Din]``.
10. Training at full width: VideoMAE-B pretraining
   steps (tube mask 0.9, 160 visible tokens, SGD-Nesterov) through
   ``VideoMAEPretrain``, ``TrainState.create`` and
   ``make_videomae_train_step``.  At B=8 one step launches the forward
   kernel and each of the backward's three 16 times, and agrees with a step
   through the plain attention path from the same weights, batch and mask (loss within 1e-4
   relative, gradient cosine >= 0.99 for every top-level group and >= 0.9995
   for every parameter tensor).  Then clips/s, MFU
   and peak memory at the largest batch in {48, 32, 16} that fits.
11. JEPA extraction: V-JEPA ViT-B (224 px, 2 frames) through
   ``untrained_embed_fn("jepa", ...)``, 12 launches of the forward kernel,
   cosine 0.999 to the plain attention path, clips/s at B=64.
12. JEPA training at full width: V-JEPA ViT-B steps
   through ``JEPA``, ``mask_collate``, ``TrainState.create`` with the EMA
   target and ``make_jepa_train_step``.  At B=8 one step launches the
   key-bias forward and each of the key-bias backward's three kernels 18
   times and the unmasked forward kernel 12 times, agrees
   with the plain-attention step (loss within 1e-4 relative, gradient
   cosine >= 0.9995 per parameter tensor) and moves the EMA target.  Then
   clips/s, MFU and peak memory at the largest batch in {64, 32, 16} that
   fits, and the masked attention's forward plus backward, kernels against
   plain, at that batch's two masked shapes.
13. The entry point: ``extract_embeddings`` over a small synthetic dataset,
   then ``save_results``, with a bf16 and with an int8 embed function; row
   count and width 768.
14. The pretraining CLIs at full width (``python -m
   bvc_tpu_torch.cli.pretrain_videomae`` and ``.pretrain_jepa`` through
   their ``main``), over a synthetic corpus written from numpy: placeholder
   ``.jpg`` names under subject dirs of ``get_group('g0')`` and a packed
   shard of the port's format (nothing decodes a JPEG).  VideoMAE-B at the
   batch 10 picked, V-JEPA ViT-B with the CLI's defaults at B=64: a
   19-step stage (timed at steps 5-11, then timed and traced by
   ``--profile_dir`` at steps 12-18), a 3-step stage
   chained from its checkpoint, and ``--resume y`` of the finished stage,
   which returns at once.  VideoMAE's stages write their checkpoints by
   the async writer (``--async_save y``), and its chained stage keeps a
   val split (``--keep_val y``): each val batch launches the step's
   forward kernels, and its val rows and val loss are finite.  Each stage
   launches exactly its step's kernels a step, its CSV has a finite loss a
   step, and the checkpoint embeds a
   batch through ``make_embed_fn`` at cosine >= 0.999 to the trained
   encoder.  Prints the trainer's clips/s (steps 5-11, host clock between
   two synchronisations; and over the traced steps), the loader's alone (pinned buffers, side-stream
   copies, each batch's device sum held against its samples' host sum),
   the step's alone (CUDA events, the batch on the card; and the host time
   to dispatch one step into an empty queue), and the device's idle share
   over the traced steps (the share of them in which no kernel ran; the
   loader's copies are printed apart).
15. Remat: one VideoMAE-B step at ``remat=True`` against ``remat=False`` at
   the batch 10 picked: gradient cosine >= 0.9995 per parameter tensor,
   32 ``flash_fwd`` launches (the recompute) and no other change, and a
   lower peak memory (both printed).
16. The SimCLR step at full width (ResNet-18, 224 px, head 512, 16 pairs),
   through ``ResNet``, ``TrainState.create`` and ``make_simclr_train_step``:
   the f32 step on the card with TF32 off against the same step on the CPU
   (loss within 1e-4 relative, gradient cosine >= 0.9995 per parameter
   tensor, running statistics within 1e-4), and the bf16 step against the
   f32 one on the card under limits set from ``emulate_simclr_bf16`` on the
   CPU (loss 1e-3, cosine 0.8, statistics 5e-3), which two deliberately
   unsound bf16 steps (``unsound_bf16``: BatchNorm's statistics in bf16;
   InfoNCE's cosine matrix and logsumexp in bf16) must each fail.  Then the
   bf16 step alone
   at the largest batch in {256, 128, 64} pairs: pairs/s, images/s, MFU
   from ``simclr_train_flops_per_pair`` (21.30 GFLOP, counted by
   ``torch.utils.flop_counter``), peak memory.
17. SimCLR extraction through ``untrained_embed_fn("simclr", ...)``: clips/s
   at B=64 16-frame clips, cosine >= 0.999 per row to the CPU.
18. ``python -m bvc_tpu_torch.cli.pretrain_simclr`` through ``main`` with its
   defaults (``--interval 900 --augs cjo``) at the batch of 16, over 3 x
   2000 JPEG frames written with cv2 or PIL (the phase fails without
   either): a 19-step stage as in 14, a chained
   3-step stage and ``--resume y``; the trainer's, the loader's and the
   step's pairs/s, the idle share, the host's decode and augmentation ms a
   frame; the checkpoint through ``make_embed_fn("simclr")`` at cosine >=
   0.999 to the trained model.
19. ``python -m bvc_tpu_torch.cli.compute_embeddings`` through ``main`` over a
   synthetic CIFAR-10 (the reader's pickle format): ``--family simclr``
   with 18's checkpoint (10 rows of 512) and ``--family videomae``
   untrained (10 rows of 768, 12 ``flash_fwd`` launches).
20. The curriculum: ``python -m bvc_tpu_torch.cli.run_curriculum`` through
   ``main`` once a family at its preset's full width (``generative``:
   VideoMAE-B at B=16 with the untrained baseline; ``predictive``: V-JEPA
   ViT-B at B=16, the sweep under ``--extract_quantize int8``;
   ``contrastive``: ResNet-18 at B=32 pairs with its per-stage lr and
   interval), the ``dev`` curriculum's three stages of 3 steps (the only
   cut: ``--override n_epoch=1,max_epoch_iters=3,n_trainsamples=3B``) over
   4 x 2000 JPEG frames (subjects of g0, g1 and g2, 180-frame fold
   segments), each stage from the one before's ``model_{run_id}.pth.tar``,
   the extraction sweep over an SSv2 layout (2 x 8 clips, two classes) and
   ``python -m bvc_tpu_torch.cli.evaluate_embeddings`` (linear and nn: a
   row a run id, finite scores); then VideoMAE's stage 1 alone over the
   corpus packed by ``python -m bvc_tpu_torch.cli.pack_corpus`` (every
   frame read from the shard).  Run ids, folds, the checkpoint chain, the
   manifest's keys and every CSV are checked, and each run's launches
   must equal its steps' and embed calls' from the counts 8-12 read
   (VideoMAE 16 of each unmasked kernel a step and 12 ``flash_fwd`` a
   call; JEPA 18 of each key-bias kernel and 12 ``flash_fwd`` a step, 24
   ``gemm_s8`` and 12 ``flash_fwd`` an int8 call; SimCLR none).  Prints
   each stage's wall time and clips/s (pairs/s), the sweep's, the
   scoring's and the phase's wall time.
21. Serving export (``bvc_tpu_torch.serving``): VideoMAE-B in bf16 and
   W8A8, V-JEPA ViT-B and SimCLR ResNet-18 exported batch-polymorphic on
   the card (their graphs' kernel nodes counted) and saved, then loaded and
   called in a fresh process that imports no model module: at B=1 and at
   8's batch, cosine >= 0.9999 per row to extraction on the same weights
   (W8A8 to W8A8), one call's launches exactly the graph's kernels (12
   ``flash_fwd``; W8A8 also 24 ``gemm_s8``; SimCLR none); the artifact's
   clips/s beside extraction's, export, save, load and first-call seconds
   and bytes.
22. The image ViT: ViT-B/16 at 224 px, bf16, B=64: ``embed`` through 12
   ``flash_fwd`` against plain attention, and a forward with a ``keep_idx``
   of up to 147 of the 196 tokens through 12 ``flash_fwd_bias`` against the
   plain masked path, cosine >= 0.999 per row; images/s.

23. Data parallel (slice 7a, ``phase_ddp``).  (a) World 1 over NCCL, the
   group made by ``bvc_tpu_torch.parallel.distributed_init`` from torchrun's
   variables: the DDP-wrapped VideoMAE-B step at 10's batch with
   ``grad_accum=2`` and the V-JEPA step at B=64, each against the unwrapped
   step on the same batch and masks (loss within 1e-4 relative, gradient
   cosine >= 0.9995 per parameter tensor), launches equal to the
   unwrapped step's, clips/s of both (3 steps a turn), then the step's
   collectives (27).  (b) Two ranks on the one card over gloo (two
   processes, ``LOCAL_RANK`` 0 each): VideoMAE-B at 24 clips a rank and
   V-JEPA at 32, against the unwrapped steps at the global batch under the
   same limits; each rank's launches the one-GPU step's: run as
   ``replicated`` in 24's ``data=2`` job.  (c)
   ``pretrain_simclr --mesh data=1`` (3 steps) and ``compute_embeddings
   --mesh data=1 --quantize int8`` (24 ``gemm_s8`` and 12 ``flash_fwd``)
   through ``main`` under torchrun's variables.  With more than one card
   visible, also world = ``device_count()`` over NCCL, a card a rank,
   VideoMAE-B at 10's batch a card, against one card at the global batch,
   with per-card clips/s and the scaling efficiency (alone:
   ``c.ddp_multi_card(smi, n, 48, Path(d))`` after ``_build.build_all``).
24. Parameter sharding (slice 7b, ``phase_sharding``).  (a) World 1 over
   NCCL, ``--param_sharding`` ``zero1``, ``fsdp`` and ``tp`` (at
   ``model=1``): 23's VideoMAE-B and V-JEPA steps against the unwrapped
   step (loss within 1e-4 relative, every gradient, gathered whole, at
   cosine >= 0.9995 per tensor), launches equal to the unwrapped step's,
   clips/s of every layout in turns (unwrapped, the modes, unwrapped; 2
   steps a turn).  (b) Two ranks on the one card over gloo, two jobs: at
   ``data=1,model=2`` (each rank the whole batch) ``tp`` (half the heads a
   rank) and ``zero1`` and ``fsdp`` with the model ranks as replicas
   (VideoMAE-B); at ``data=2`` ``replicated`` (23 (b)), ``zero1`` and
   ``fsdp``; each against (a)'s unwrapped steps under the same limits,
   each rank's launches the one-GPU step's, each step's collectives (27).
   (c) The forward and backward kernels at ``tp``'s head
   counts (``[8,160,6,64]``, ``[8,1568,3,64]``; with a key bias
   ``[64,169,6,64]``, ``[256,199,6,32]``) against their plain versions.
   (d) Each rank's bytes of parameters, gradients and optimizer state
   under each mode at world 2.  (e) ``pretrain_videomae --mesh data=1
   --param_sharding fsdp`` for 3 steps, resumed under ``replicated`` for 3
   more, against an uninterrupted run's losses.  With more than one card,
   (f) ``fsdp`` at ``data=n`` and ``tp`` at ``data=n/2,model=2`` over NCCL
   against one card at the global batch, per-card clips/s and the scaling
   efficiency (alone: ``c.shard_multi_card(smi, n, 48, Path(d))``).
25. Sequence parallelism (slice 7c, ``phase_seqpar``), VideoMAE-B at 64
   frames (6272 tokens, 640 visible).  (a) ``ring_attention_chunks`` at S =
   4 and 2 over ``[2,6272,12,64]`` and ``[2,6272,6,64]``, and with a key
   mask at ``[64,200,12,32]`` (hops whose keys are all masked, samples with
   no key), forward and backward, against ``flash_attention`` over the
   whole sequence (O, LSE, dQ, dK, dV within phases 2-4's max-abs limits)
   and against f32 math (the ring's |err|/|ref| at most twice flash's: it
   rounds each hop's O and gradients to bf16 before summing them); S
   launches of each kernel a call; the hop times at 80 and 160 tokens
   against the plain hop.  (b) World 1 over NCCL at ``data=1,seq=1``: the
   seq step against the unwrapped step at B=4 (loss 1e-6 relative, cosine
   0.99995 per tensor, launches equal).  (c) Two gloo ranks on the card at
   ``data=1,seq=2`` against one process at B=4 (loss 1e-4 relative, cosine
   0.9995 per tensor), per-rank peak memory beside the one process's, each
   rank's launches (twice the step's: two hops), the K/V shift's time over
   the ring (through pinned host memory: gloo does not send CUDA tensors);
   the VideoMAE-B and V-JEPA seq embeds against one process's at cosine
   0.999 per row.  (d) Four gloo ranks at ``data=1,seq=2,model=2``, the same
   reference and limits.  (e) ``pretrain_videomae --mesh data=1,seq=2
   --num_frames 64`` on two gloo ranks for 3 steps, its checkpoint through
   ``make_embed_fn`` at cosine 0.999 to the trained model.  With more than
   one card, ``data=1,seq=n``, ``data=2,seq=n/2`` and
   ``data=1,seq=n/2,model=2`` over NCCL against one card at the global
   batch: per-card clips/s and peak memory (alone:
   ``c.seq_multi_card(smi, n, Path(d))``).
26. Pipeline parallelism (slice 7d, ``phase_pipeline``), VideoMAE-B (16
   frames, 1568 tokens) at B=16, 4 microbatches.  (a) World 1 over NCCL at
   ``data=1,pipe=1``: the pipe step against the unwrapped step at the same
   batch (the DDP limits), each kernel launched 4 times the step's (a
   layer a microbatch).  (b) Two gloo ranks on the card at
   ``data=1,pipe=2`` against one process (loss 1e-4 relative, cosine
   0.9995 per tensor, the stages' gradients together), each rank's
   launches ``16 * M / P`` of each kernel, its peak memory and state bytes
   beside one process's, the time of a hop of the encoder's and the
   decoder's activations (through pinned host memory), and the share of a
   step each rank waits in its hops beside the schedule's bubble
   ``(P - 1) / (M + P - 1)`` (on one card the two ranks share it: the
   reading is the schedule's and the transport's, not the card's idle
   share).  (c) With more than one card, ``pipe=2`` (and on four,
   ``data=2,pipe=2`` and ``pipe=4``) over NCCL against one card at the
   global batch: clips/s a card (alone: ``c.pipe_multi_card(smi, n,
   Path(d))``).  (d) ``pretrain_videomae --mesh data=1,pipe=2
   --pipe_microbatches 4`` on two gloo ranks for 3 steps: each rank's
   launches its steps', and the checkpoint whole (it loads strictly into
   the whole model, and each rank's stage equals its part of it).  (e)
   ``zero1`` and ``fsdp`` beside ``model``: in 24 (b).  Each stage's
   collectives in (b) (27).
27. Communication accounting (slice 9, ``bvc_tpu_torch.parallel.
   analysis``), folded into the jobs above: each step's ``comm_report``
   (the step once more, under ``record_collectives()``, its state then
   restored), printed as one ``{"comm": ...}`` line a layout and held to
   the JAX package's contract (``tests/test_collectives_analysis.py``),
   byte for byte where the port's counts are exact: DDP at world 1 (23 (a))
   and at ``data=2`` all-reduces exactly the trainable parameters' bytes,
   every bucket once, nothing in the accumulation loop, nothing gathered,
   scattered or broadcast; ``zero1`` adds one broadcast of every
   parameter; ``fsdp`` gathers and reduce-scatters (HSDP at
   ``data=1,model=2`` all-reduces over ``model``); ``tp`` all-reduces over
   ``model``; the seq step (25 (c)) sends the ring's bytes exactly and
   all-reduces the gradients once; each pipe stage (26 (b)) sends its hops'
   bytes exactly and all-reduces the edge's gradients.  A layout whose
   recording is empty fails.
28. The last parity gaps (slice 10).  (a) The 'svm' linear probe on the
   card's host, which has no scikit-learn (``native/linear_svc.cpp``,
   liblinear's LinearSVC solvers): twice over each of 20's sweep
   checkpoints (finite scores, the same from both fits), and at a real
   probe's width, 4000 rows of 768 in 12 seeded separable classes (the
   primal solver): the same weights from two fits, held-out accuracy >=
   0.9, each fit's seconds.  (b) The ring's plain route, which an f32 model
   or one with 16-wide heads takes: ``ring_attention_chunks`` at S = 2
   over ``[2,6272,12,64]`` in f32 (O and gradients within 1e-4 of max|ref|
   of f32 attention over the whole sequence) and ``[2,6272,12,16]`` in
   bf16 (the bf16 ring's limits), no kernel launched; the bf16 64-wide
   ring's launches are 25 (a)'s.  (c) ``block_attention_probs`` of a ViT-B
   block on ``[4,1568,768]`` against the CPU's: f32 within 1e-5, rows
   summing to 1 within 1e-4, no launch; with a W8A8 ``qkv``, one
   ``gemm_s8`` launch, within 1e-4.

Every path runs with every launch count set to 0 just before it and read
just after, and fails if a kernel other than its own launched (no SimCLR
path launches one: each kernel's ``launches_on_simclr_paths`` is the sum of
the counts read over them).
Prints each phase's seconds as it ends, the host's CUDA device and CPU
core counts, one JSON ``{"trainers": {...}}`` line (14-18 and 20-28), one
``{"phase_seconds": {...}}`` line, one JSON ``{"kernels":
[...]}`` line (with each kernel's ``launches_per_cli_step``,
``launches_per_curriculum``, ``launches_per_artifact_call``,
``launches_per_vit_image_embed``, ``launches_per_ddp_step``,
``launches_per_sharded_step``, ``launches_per_seq_step`` and
``launches_per_pipe_step``),
the script's wall time and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, without that last line,
when there is no CUDA device, when run outside a checkout, or when any phase
fails.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T0 = time.perf_counter()
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
EXP_PER_CLOCK = 16  # MUFU.EX2 results per clock on each SM (Hopper's SFUs)
O_TOL = 2e-2
LSE_TOL = 1e-3
BWD_TOL = 2e-2  # of max|ref|: bf16 outputs, sums in another order
BWD_REL_TOL = 1e-3  # |err|/|ref| of dQ, dK and dV (read: 0.8-1.4e-4)
COSINE_MIN = 0.999
TILE_TOL = 1e-4  # of max|ref|: one tile's S and P V against f32 products
# flash vs plain attention in one training step, bf16 activations
TRAIN_LOSS_RTOL = 1e-4  # read: 8.5e-7
GRAD_COSINE_MIN = 0.99  # per top-level group
TENSOR_COSINE_MIN = 0.9995  # per parameter tensor
# the same for one JEPA step (key-bias kernels against plain masked attention)
JEPA_LOSS_RTOL = 1e-4  # read: 2.16e-6
JEPA_TENSOR_COSINE_MIN = 0.9995  # read: lowest 0.999937
JEPA_TOTAL_STEPS = 10000  # the EMA ramp's horizon, as the JAX JEPA benchmark
GEMM_BF16_TOL = 1e-3  # of max|ref|: bf16 GEMM on normal inputs, f32 sums in another order
# the softmax probe kernel against its plain version in the same score dtype:
# the largest |dO| (read: 0.98-2.2e-3; the two score dtypes differ by
# 5.9-7.8e-3), and the share of entries equal to the plain version's, and of
# the entries where the plain f32 and bf16 outputs differ, the share where the
# kernel's differ too (both 0.9993 or more in a CPU emulation of the kernel's
# sum order; the other score dtype's plain version is equal at 0.33)
PROBE_O_TOL = 3e-3
PROBE_MATCH_MIN = 0.99
W8A8_COSINE_MIN = 0.995  # W8A8 against the unquantized embedding (tests/test_quant.py)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


SASS_OPS = ("HGMMA", "MUFU", "FFMA", "FADD", "FMUL", "FMNMX", "F2F", "F2FP")


def sass_census(name: str, kernel: str) -> dict[str, int]:
    """Opcode counts in the SASS of the kernel whose mangled name holds
    ``kernel``, in the built library of ``csrc/<name>.cu`` (``cuobjdump
    -sass``), with ``"all"`` the instruction count; empty where the toolkit
    has no cuobjdump."""
    import re
    from collections import Counter

    from bvc_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts = Counter()
    for block in sass.split("Function : ")[1:]:
        if kernel in block.split("\n", 1)[0]:
            for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", block):
                counts[op] += 1
                counts["all"] += 1
    return dict(counts)


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_no_spills_or_serialisation(name: str, kernel: str, args: str = "") -> None:
    """Fail unless ``ptxas -v`` reports no spill bytes for the kernel named
    ``kernel`` in ``csrc/<name>.cu``, and no wgmma serialisation warning for
    the source.  The entry is found by the kernel's own mangled name (its
    length, the name, then ``E`` or a template's ``I``; with ``args``, the
    instantiation whose template arguments mangle to them, such as
    ``ILi32ELb1EE`` for ``<32, true>``), not by a substring: the file's other
    kernels carry the file name in their namespace tag."""
    from bvc_tpu_torch.ops import _build

    log = _build.build_log(name)
    check("serialized" not in log, f"ptxas serialises wgmma in {name}.cu")
    tail = re.escape(args) if args else "[EI]"
    own = re.compile(rf"{len(kernel)}{re.escape(kernel)}{tail}")
    kernel += args
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and own.search(line):
            for after in lines[i + 1:i + 5]:
                if "Compiling entry" in after:
                    break
                if "spill" in after:
                    check(" 0 bytes spill stores, 0 bytes spill loads" in after,
                          f"{kernel} spills: {after.strip()}")
                    return
    fail(f"no ptxas -v report for {kernel} in {name}.cu's build log")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    from bvc_tpu_torch.utils.device import cuda_time_ms

    return cuda_time_ms(fn, iters, warmup)


def cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` by CUDA events, with the L2 cache
    flushed before each call (256 MiB written, five times the H100's L2):
    for a short kernel whose input a loop of back-to-back calls would find
    in L2, where a bound at the HBM rate would not hold."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def attention_bound_ms(B: int, N: int, h: int, d: int, bias: bool = False,
                       keys: int | None = None) -> tuple[float, str]:
    """Least time of the forward on the card: 4*h*N*K*d tensor-core
    operations at the bf16 peak against q/o (bf16) for every token, k/v
    (bf16) for the K keys the function needs, LSE (f32) and, with a key
    bias, the [B, N] f32 bias bytes at the HBM rate; the larger one bounds.
    K = ``keys``, the attendable keys summed over the batch where a key
    bias masks some (no kernel need read a masked key), else B*N."""
    keys = B * N if keys is None else keys
    ops_ms = 4 * h * N * keys * d / PEAK_BF16_FLOPS * 1e3
    nbytes = 2 * (B * N + keys) * h * d * 2 + B * h * N * 4 + (B * N * 4 if bias else 0)
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def exp_bound_ms(exps: int, clock_mhz: float, sms: int) -> float:
    """The second roof of an attention forward: ``exps`` exponentials (one
    per score, B*h*N^2) at EXP_PER_CLOCK a clock on each of ``sms`` SMs at
    ``clock_mhz`` (the card's ``clocks.max.sm``)."""
    return exps / (EXP_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz, as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.splitlines()[0])


def exp_roof(B: int, N: int, h: int) -> float:
    """:func:`exp_bound_ms` of a forward over ``[B, N, h, .]`` on this card."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exp_bound_ms(B * h * N * N, sm_clock_mhz(), sms)


def bwd_bound_ms(B: int, N: int, h: int, d: int, products: int, outputs: int,
                 bias: bool = False, keys: int | None = None) -> tuple[float, str]:
    """Least time of a backward on the card: ``products`` N x K x d
    tensor-core products (5 for the whole backward), 2*h*N*K*d operations
    each, at the bf16 peak, against reading qs and dO (bf16) for every
    token, k and v (bf16) for the K keys the function needs, L and D (f32)
    and, with a key bias, the [B, N] f32 bias once, and writing ``outputs``
    bf16 tensors (dQ, dK, dV: 3; a masked key's dK and dV rows are written
    too, as zeros) at the HBM rate; the larger one bounds.  K = ``keys``,
    the attendable keys summed over the batch where a key bias masks some,
    else B*N."""
    keys = B * N if keys is None else keys
    ops_ms = 2 * products * h * N * keys * d / PEAK_BF16_FLOPS * 1e3
    nbytes = ((2 + outputs) * B * N + 2 * keys) * h * d * 2 + 2 * B * h * N * 4 + (
        B * N * 4 if bias else 0)
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gemm_bound_ms(M: int, N: int, K: int, in_bytes: int, out_bytes: int, peak: float,
                  vector_bytes: int = 0) -> tuple[float, str]:
    """Least time of ``C [M, N] = A [M, K] B [N, K]^T`` on the card: 2MKN
    operations at ``peak`` against reading A and B once (``in_bytes`` an
    entry), writing C once (``out_bytes`` an entry) and ``vector_bytes`` of
    scales and bias, at the HBM rate; the larger one bounds."""
    ops_ms = 2 * M * N * K / peak * 1e3
    nbytes = (M * K + N * K) * in_bytes + M * N * out_bytes + vector_bytes
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def train_flops_per_clip(cfg, num_visible: int) -> float:
    """Model operations of one VideoMAE pretraining step per clip: 3 x the
    forward (the backward takes twice the forward's products).  The forward
    is the encoder at V visible tokens, 24*V*D^2 + 4*V^2*D per layer, the
    patch embedding at V, 2*V*(C*ts*p*p)*D, ``enc_to_dec`` 2*V*D*Dd, the
    decoder at all N tokens, 24*N*Dd^2 + 4*N^2*Dd per layer, and the head
    on the M = N - V masked tokens, 2*M*Dd*(C*ts*p*p)."""
    V, N, D, Dd = num_visible, cfg.seq_len, cfg.hidden_size, cfg.decoder_hidden_size
    patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
    fwd = (cfg.depth * (24 * V * D * D + 4 * V * V * D) + 2 * V * patch_dim * D
           + 2 * V * D * Dd + cfg.decoder_depth * (24 * N * Dd * Dd + 4 * N * N * Dd)
           + 2 * (N - V) * Dd * patch_dim)
    return 3 * fwd


def embed_flops_per_clip(cfg) -> float:
    """Model operations of one VideoMAE embed: per layer 24*N*D^2 for the
    qkv/proj/fc1/fc2 products and 4*N^2*D for attention, plus the patch
    embedding 2*N*(C*ts*p*p)*D."""
    N, D = cfg.seq_len, cfg.hidden_size
    patch_dim = cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2
    return cfg.depth * (24 * N * D * D + 4 * N * N * D) + 2 * N * patch_dim * D


def qkv_inputs(B: int, N: int, h: int, d: int, seed: int):
    """Pre-scaled q and strided k/v slices of one fused ``[B, N, 3, h, d]``
    bf16 tensor, as the encoder block hands them to the kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = 2 * torch.randn((B, N, 3, h, d), generator=gen, device="cuda")
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return q, (q * d ** -0.5).to(q.dtype), k, v


def phase_attn_tile() -> None:
    """The forward kernels' two products on one tile at head widths 64 and
    32, before anything runs on them (``attention_tile_check``): S = q k^T
    and O = bf16(S) v, each within 1e-4 x max|ref| of the f32 product on the
    card (the reference for O takes the kernel's own S, so that each product
    is checked alone)."""
    import torch

    from bvc_tpu_torch.ops.flash_attention import attention_tile_check

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    for d in (64, 32):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((64, d), (128, d), (128, d)))
        s, o = attention_tile_check(q, k, v, d)
        s_ref = q.float() @ k.float().T
        o_ref = s.to(torch.bfloat16).float() @ v.float()
        torch.cuda.synchronize()
        for name, x, ref in (("S = q k^T", s, s_ref), ("O = bf16(S) v", o, o_ref)):
            err, scale = (x - ref).abs().max().item(), ref.abs().max().item()
            print(f"attention tile check d={d}: {name} max abs err {err:.3e} (limit "
                  f"{TILE_TOL * scale:.3e} = {TILE_TOL} x max|ref|)", flush=True)
            check(err <= TILE_TOL * scale,
                  f"attention tile check d={d}: {name} is wrong, max err {err}")


def phase_kernel() -> dict:
    """Flash forward kernel against its plain version at every shape a path
    of this script gives it (the image ViT's ``[64, 196, 12, 64]``, a partial
    key tile of 68, among them): O within 2e-2, LSE within 1e-3.  Returns
    its record at the extraction shape, with every shape's times under
    ``"shapes"``."""
    import torch
    import torch.nn.functional as F

    from bvc_tpu_torch.ops.attention import (FLASH_MIN_TOKENS, flash_attention,
                                             multi_head_attention, plain_attention)
    from bvc_tpu_torch.ops.flash_attention import (flash_attention_fwd_ref,
                                                   flash_fwd_cuda)

    result, shapes = {}, {}
    for label, (B, N, h, d) in (("extraction", (8, 1568, 12, 64)),
                                ("encoder", (8, 160, 12, 64)),
                                ("jepa target", (8, 392, 12, 64)),
                                ("odd N", (8, 197, 12, 64)),
                                ("image vit", (VIT_IMAGE_B, 196, 12, 64)),
                                ("decoder", (8, 1568, 6, 64)),
                                ("extraction B=64", (64, 1568, 12, 64))):
        _, qs, k, v = qkv_inputs(B, N, h, d, seed=N + h + B - 8)
        o, lse = flash_fwd_cuda(qs, k, v)
        o_ref, lse_ref = flash_attention_fwd_ref(qs, k, v)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok_o = torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
        ok_lse = torch.allclose(lse, lse_ref, atol=LSE_TOL, rtol=LSE_TOL)
        del o, lse, o_ref, lse_ref
        ms = time_ms(lambda: flash_fwd_cuda(qs, k, v))
        g_ms = graph_ms(lambda: flash_fwd_cuda(qs, k, v))
        plain_ms = time_ms(lambda: flash_attention_fwd_ref(qs, k, v), iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)

        lib_ms, lib_g_ms = time_ms(sdpa), graph_ms(sdpa)
        bound, bound_by = attention_bound_ms(B, N, h, d)
        exp_ms = exp_roof(B, N, h)
        print(f"flash_fwd [{B},{N},{h},{d}] ({label}): max|dO| {err_o:.3e} "
              f"max|dLSE| {err_lse:.3e}; kernel {ms:.4f} ms, in a CUDA graph {g_ms:.4f} ms "
              f"({g_ms / B * 1e3:.2f} us/clip, {4 * B * h * N * N * d / g_ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (graph "
              f"{lib_g_ms:.4f}); bound {bound:.4f} ms ({bound_by}, {bound / g_ms:.3f} of it), "
              f"exponential roof {exp_ms:.4f} ms", flush=True)
        check(ok_o, f"flash_fwd O disagrees with the plain version at {label}: {err_o}")
        check(ok_lse, f"flash_fwd LSE disagrees with the plain version at {label}: {err_lse}")
        shapes[label] = {"at": [B, N, h, d], "max_abs_err": err_o, "max_abs_err_lse": err_lse,
                         "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_graph_ms": lib_g_ms, "bound_ms": bound, "bound_by": bound_by,
                         "exp_bound_ms": exp_ms}
        if label == "extraction":
            result = {k: x for k, x in shapes[label].items() if k != "at"}
        del qs, k, v, qt, kt, vt
    result["shapes"] = shapes

    # What the kernel does not take raises on the card: no plain fallback.
    q, _, k, v = qkv_inputs(2, 64, 2, 64, seed=0)
    mask = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    for what, call in (("f32", lambda: multi_head_attention(q.float(), k.float(), v.float(),
                                                            impl="flash")),
                       ("key mask at head width 48", lambda: multi_head_attention(
                           q[..., :48], k[..., :48], v[..., :48], impl="flash",
                           key_mask=mask)),
                       ("head width 32", lambda: flash_fwd_cuda(q[..., :32], k[..., :32],
                                                                v[..., :32]))):
        try:
            call()
        except (ValueError, NotImplementedError):
            continue
        fail(f"impl='flash' with {what} on CUDA ran instead of raising")

    # Routing: kernel (public flash_attention, scale folding included)
    # against the plain attention path that 'auto' picks below the threshold.
    faster = {}
    for N in (160, 392, 784, 1568):
        q, _, k, v = qkv_inputs(8, N, 12, 64, seed=N)
        k_ms = time_ms(lambda: flash_attention(q, k, v))
        p_ms = time_ms(lambda: plain_attention(q, k, v, 0.125), iters=5)
        faster[N] = k_ms < p_ms
        print(f"routing [8,{N},12,64]: flash {k_ms:.4f} ms, plain {p_ms:.4f} ms",
              flush=True)
    crossover = min((n for n in faster if all(faster[m] for m in faster if m >= n)),
                    default=None)
    print(f"routing: flash wins from N={crossover} of those measured; "
          f"FLASH_MIN_TOKENS = {FLASH_MIN_TOKENS}", flush=True)

    # The same, forward plus backward, as a training step runs them.
    for N in (160, 392, 784, 1568):
        q, _, k, v = qkv_inputs(8, N, 12, 64, seed=N)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)

        def fwd_bwd(impl):
            out = multi_head_attention(q, k, v, impl=impl)
            return torch.autograd.grad(out, (q, k, v), do)

        k_ms = time_ms(lambda: fwd_bwd("flash"))
        p_ms = time_ms(lambda: fwd_bwd("xla"), iters=5)
        print(f"routing fwd+bwd [8,{N},12,64]: flash {k_ms:.4f} ms, plain {p_ms:.4f} ms",
              flush=True)
    check(FLASH_MIN_TOKENS <= 1568, "FLASH_MIN_TOKENS must route the 1568-token path")
    return result


def phase_bwd_tile() -> None:
    """The backward kernel's five products on one tile at head widths 64
    and 32, before anything runs on them (``bwd_tile_check``): S^T = k qs^T,
    dP^T = v do^T, dV = bf16(S^T) do, dK = bf16(dP^T) qs and
    dQ = bf16(dP^T)^T k, each within 1e-4 x max|ref| of the f32 product on
    the card (the references for the last three take the kernel's own S^T
    and dP^T, so that each product is checked alone)."""
    import torch

    from bvc_tpu_torch.ops.flash_attention import bwd_tile_check

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    for d in (64, 32):
        qs, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                        for shape in ((64, d), (128, d), (128, d), (64, d)))
        st, dpt, dv, dk, dq = bwd_tile_check(qs, k, v, do, d)
        p, ds = (x.to(torch.bfloat16).float() for x in (st, dpt))
        refs = (("S^T = k qs^T", st, k.float() @ qs.float().T),
                ("dP^T = v do^T", dpt, v.float() @ do.float().T),
                ("dV = bf16(S^T) do", dv, p @ do.float()),
                ("dK = bf16(dP^T) qs", dk, ds @ qs.float()),
                ("dQ = bf16(dP^T)^T k", dq, ds.T @ k.float()))
        torch.cuda.synchronize()
        for name, x, ref in refs:
            err, scale = (x - ref).abs().max().item(), ref.abs().max().item()
            print(f"backward tile check d={d}: {name} max abs err {err:.3e} (limit "
                  f"{TILE_TOL * scale:.3e} = {TILE_TOL} x max|ref|)", flush=True)
            check(err <= TILE_TOL * scale,
                  f"backward tile check d={d}: {name} is wrong, max err {err}")


def sdpa_bwd_ms(qs, k, v, do, backends, attn_mask=None) -> tuple:
    """SDPA's backward at ``[B, N, h, d]`` inputs, a yardstick only (the
    port never calls it): for each backend of ``backends`` (pinned with
    ``torch.nn.attention.sdpa_kernel``) that runs here, forward plus
    backward less the forward alone, by events and as two CUDA graphs;
    returns ``(events ms, graph ms, backend)`` of the backend fastest in a
    graph, with every backend's readings printed, or ``(None, None, None)``
    where none runs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (qs, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=1.0)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    best = (None, None, None)
    for backend in backends:
        try:
            with sdpa_kernel(backend):
                ev = time_ms(fwd_bwd) - time_ms(fwd)
                gr = graph_ms(fwd_bwd) - graph_ms(fwd)
        except RuntimeError as exc:
            print(f"  sdpa {backend.name}: does not run here ({str(exc).splitlines()[0][:80]})",
                  flush=True)
            continue
        print(f"  sdpa {backend.name} backward: {ev:.4f} ms by events, {gr:.4f} in a graph",
              flush=True)
        if best[1] is None or gr < best[1]:
            best = (ev, gr, backend.name)
    return best


def bwd_inputs(B: int, N: int, h: int, d: int) -> tuple:
    """``(qs, k, v, o, lse, do)`` of a backward at ``[B, N, h, d]``: the
    inputs of :func:`qkv_inputs`, a random dO and the flash forward's O and
    LSE, seeded by the shape."""
    import torch

    from bvc_tpu_torch.ops.flash_attention import flash_fwd_cuda

    _, qs, k, v = qkv_inputs(B, N, h, d, seed=2 * N + h)
    gen = torch.Generator(device="cuda").manual_seed(N)
    do = torch.randn((B, N, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = flash_fwd_cuda(qs, k, v)
    return qs, k, v, o, lse, do


def bwd_entry_ms(qs, k, v, o, lse, do) -> dict:
    """The unmasked backward through its entry point ``flash_bwd_cuda``
    (every kernel it launches, its outputs and scratch allocated), by events
    and in a CUDA graph, beside SDPA's backward in a graph with its backend
    pinned.  It calls nothing but entry points the port has had since its
    first backward kernels, so this file, copied into an earlier tree of the
    port and run from its root, times that tree's backward the same way."""
    from torch.nn.attention import SDPBackend

    from bvc_tpu_torch.ops.flash_attention import flash_bwd_cuda

    def whole():
        flash_bwd_cuda(qs, k, v, o, lse, do)

    lib_ms, lib_g_ms, backend = sdpa_bwd_ms(
        qs, k, v, do, (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION))
    return {"whole_ms": time_ms(whole), "whole_graph_ms": graph_ms(whole),
            "library_ms": lib_ms, "library_graph_ms": lib_g_ms, "library_backend": backend}


def phase_bwd_kernel() -> dict:
    """The unmasked backward (pre-pass, fused kernel, post-pass of
    ``csrc/flash_bwd_sm90.cu``) against its plain version at the decoder,
    encoder-in-training and odd-N shapes, twice (the dQ sum's order is not
    fixed, so the runs agree within BWD_REL_TOL, not bit for bit), the
    pre- and post-pass each against their plain versions; times by events
    and in a CUDA graph of each kernel and of the whole backward
    (:func:`bwd_entry_ms`) beside the 5-product bound, the plain version and
    SDPA's backward with its backend pinned, the pre- and post-pass also
    with L2 flushed (:func:`cold_ms`).  Returns the three kernels' records
    at the decoder shape (``ms`` and ``graph_ms`` each kernel's own, the
    whole backward's under ``whole_ms`` and ``whole_graph_ms``), with every
    shape's numbers under ``"shapes"``."""
    import torch

    from bvc_tpu_torch.ops.flash_attention import (_delta, bwd_operands,
                                                   flash_attention_bwd_ref, flash_bwd_cuda,
                                                   flash_fwd_cuda, launch_bwd_fused,
                                                   launch_bwd_post, launch_bwd_prep,
                                                   padded_tokens)

    result, shapes = {}, {}
    for label, (B, N, h, d) in (("decoder", (8, 1568, 6, 64)),
                                ("encoder", (8, 160, 12, 64)),
                                ("odd N", (8, 197, 12, 64))):
        qs, k, v, o, lse, do = bwd_inputs(B, N, h, d)
        grads = flash_bwd_cuda(qs, k, v, o, lse, do)
        again = flash_bwd_cuda(qs, k, v, o, lse, do)
        refs = flash_attention_bwd_ref(qs, k, v, o, lse, do)
        torch.cuda.synchronize()
        errs = {}
        for name, x, y, ref in zip(("dq", "dk", "dv"), grads, again, refs):
            diff = (x.float() - ref.float())
            err, scale = diff.abs().max().item(), ref.float().abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            rerun = ((x.float() - y.float()).norm() / ref.float().norm()).item()
            errs[name] = err
            print(f"flash_bwd [{B},{N},{h},{d}] ({label}) {name}: max abs err {err:.3e} "
                  f"(bound {BWD_TOL * scale:.3e} = {BWD_TOL} x max|ref|), "
                  f"|err|/|ref| {rel:.3e} (bound {BWD_REL_TOL}); second run "
                  f"{'bitwise equal' if torch.equal(x, y) else 'differs'}, "
                  f"|run1 - run2|/|ref| {rerun:.3e} (bound {BWD_REL_TOL})", flush=True)
            check(err <= BWD_TOL * scale and math.isfinite(err),
                  f"flash_bwd {name} disagrees with the plain version at {label}: {err}")
            check(rel <= BWD_REL_TOL,
                  f"flash_bwd {name} at {label}: |err|/|ref| {rel} > {BWD_REL_TOL}")
            check(rerun <= BWD_REL_TOL,
                  f"flash_bwd {name} at {label}: two runs differ by {rerun} > {BWD_REL_TOL}")

        # the pre-pass alone: D and L log2 e against their plain versions,
        # the dQ accumulator zeroed; the post-pass alone: dQ = bf16(acc)
        w = bwd_operands(qs, k, v, o, lse, do)
        launch_bwd_prep(w)
        n_pad = padded_tokens(N)
        stats = w["stats"].view(B * h, 2, n_pad)
        delta = _delta(o, do).view(B * h, N)
        err_d = (stats[:, 1, :N] - delta).abs().max().item()
        err_l = (stats[:, 0, :N] - lse.view(B * h, N) * math.log2(math.e)).abs().max().item()
        pad_ok = bool((stats[:, :, N:] == 0).all()) and bool((w["dq_acc"] == 0).all())
        launch_bwd_fused(w)
        launch_bwd_post(w)
        acc = w["dq_acc"].view(B, h, n_pad, d)[:, :, :N].transpose(1, 2)
        err_post = (w["dq"].float() - acc.to(torch.bfloat16).float()).abs().max().item()
        torch.cuda.synchronize()
        print(f"flash_bwd_prep ({label}): max|dD| {err_d:.3e} (of max|D| "
              f"{delta.abs().max().item():.3e}), max|d(L log2 e)| {err_l:.3e}, padding and "
              f"accumulator zero {pad_ok}; flash_bwd_post: max|dQ - bf16(acc)| {err_post}",
              flush=True)
        check(err_d <= 1e-5 * max(1.0, delta.abs().max().item()) and err_l <= 1e-5 * max(
            1.0, lse.abs().max().item()) and pad_ok,
              f"flash_bwd_prep disagrees with the plain version at {label}")
        check(err_post == 0, f"flash_bwd_post disagrees with bf16(acc) at {label}: {err_post}")

        entry = bwd_entry_ms(qs, k, v, o, lse, do)
        parts = {}
        for name, fn in (("prep", lambda: launch_bwd_prep(w)),
                         ("fused", lambda: launch_bwd_fused(w)),
                         ("post", lambda: launch_bwd_post(w))):
            parts[name] = (time_ms(fn), graph_ms(fn))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(qs, k, v, o, lse, do), iters=5)
        bound, bound_by = bwd_bound_ms(B, N, h, d, 5, 3)
        g_ms = entry["whole_graph_ms"]
        print(f"flash_bwd [{B},{N},{h},{d}] ({label}): whole backward (flash_bwd_cuda) "
              f"{entry['whole_ms']:.4f} ms, in a CUDA graph {g_ms:.4f} ms "
              f"({10 * B * h * N * N * d / g_ms / 1e9:.1f} TFLOP/s); fused kernel "
              f"{parts['fused'][0]:.4f} / graph {parts['fused'][1]:.4f}, pre-pass "
              f"{parts['prep'][0]:.4f} / {parts['prep'][1]:.4f}, post-pass "
              f"{parts['post'][0]:.4f} / {parts['post'][1]:.4f}; bound {bound:.4f} ms "
              f"({bound_by}, {bound / g_ms:.3f} of the whole, {bound / parts['fused'][1]:.3f} "
              f"of the fused kernel); plain {plain_ms:.4f} ms; sdpa backward "
              f"({entry['library_backend']}) {ms_text(entry['library_ms'])}, graph "
              f"{ms_text(entry['library_graph_ms'])}", flush=True)
        shapes[label] = {
            "at": [B, N, h, d], "max_abs_err": max(errs.values()),
            "ms": parts["fused"][0], "graph_ms": parts["fused"][1], **entry,
            "prep_ms": parts["prep"][0], "prep_graph_ms": parts["prep"][1],
            "post_ms": parts["post"][0], "post_graph_ms": parts["post"][1],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
        if label == "decoder":
            # The pre- and post-pass each move a few tens of MB, which a loop
            # of back-to-back calls finds in L2: their records are timed with
            # L2 flushed (graph_ms stays the warm reading).  Their bounds
            # count the bytes each must move: the pre-pass reads O, dO and L
            # and writes the stats table and the whole zeroed accumulator;
            # the post-pass reads the accumulator's N rows and writes dQ.
            elems, rows = B * N * h * d, B * h * n_pad
            prep_bytes = 2 * elems * 2 + B * h * N * 4 + rows * 2 * 4 + rows * d * 4
            post_bytes = elems * 4 + elems * 2
            result = {
                "fused": {k_: x for k_, x in shapes[label].items()
                          if k_ != "at" and not k_.startswith(("prep", "post"))},
                "prep": {"max_abs_err": err_d, "ms": cold_ms(lambda: launch_bwd_prep(w)),
                         "graph_ms": parts["prep"][1], "l2": "flushed before each call",
                         "plain_ms": cold_ms(lambda: _delta(o, do)), "library_ms": None,
                         "bound_ms": prep_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes"},
                "post": {"max_abs_err": err_post, "ms": cold_ms(lambda: launch_bwd_post(w)),
                         "graph_ms": parts["post"][1], "l2": "flushed before each call",
                         "plain_ms": cold_ms(lambda: acc.to(torch.bfloat16)),
                         "library_ms": cold_ms(lambda: acc.to(torch.bfloat16)),
                         "bound_ms": post_bytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes"}}
            print(f"flash_bwd_prep with L2 flushed {result['prep']['ms']:.4f} ms (bound "
                  f"{result['prep']['bound_ms']:.4f}, plain D {result['prep']['plain_ms']:.4f}); "
                  f"flash_bwd_post {result['post']['ms']:.4f} ms (bound "
                  f"{result['post']['bound_ms']:.4f}, acc.to(bfloat16) "
                  f"{result['post']['library_ms']:.4f})", flush=True)
        del w, qs, k, v, o, lse, do, grads, again, refs
    result["fused"]["shapes"] = shapes

    # What the kernels do not take raises on the card: no plain fallback.
    q, qs, k, v = qkv_inputs(2, 64, 2, 64, seed=0)
    o, lse = flash_fwd_cuda(qs, k, v)
    for what, call in (("f32", lambda: flash_bwd_cuda(qs.float(), k.float(), v.float(),
                                                      o.float(), lse, o.float())),
                       ("head width 32", lambda: flash_bwd_cuda(
                           qs[..., :32], k[..., :32], v[..., :32], o[..., :32], lse,
                           o[..., :32])),
                       ("lse of another shape", lambda: flash_bwd_cuda(
                           qs, k, v, o, lse[:, :1], o))):
        try:
            call()
        except ValueError:
            continue
        fail(f"flash_bwd_cuda with {what} on CUDA ran instead of raising")
    return result


def phase_main_path(card: str, profile: str | None) -> tuple[int, int]:
    """VideoMAE-B extraction on the card; returns the kernel's launches in
    one embed call and the batch timed (the largest that fits)."""
    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()
    fn = untrained_embed_fn("videomae", cfg, seed=0)
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (8, cfg.num_frames, cfg.image_size, cfg.image_size,
                                  cfg.in_channels), dtype=np.uint8)

    reset_launches()
    emb = fn(clips)
    counts = read_launches()
    launches = counts["flash_fwd"]
    print(f"main path: one embed call at B=8 launched {counts}", flush=True)
    check(counts == {**{k: 0 for k in counts}, "flash_fwd": cfg.depth},
          f"expected {cfg.depth} flash_fwd launches and no other, got {counts}")
    check(emb.shape == (8, cfg.hidden_size) and bool(np.isfinite(emb).all()),
          f"embeddings of shape {emb.shape} or not finite")

    with torch.inference_mode():
        ref = fn.model.embed(torch.from_numpy(clips).cuda(), attn_impl="xla").cpu().numpy()
    cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    print(f"main path: cosine to the plain-attention path min {cos.min():.6f}, "
          f"max|diff| {np.abs(emb - ref).max():.4e}", flush=True)
    check(bool(cos.min() >= COSINE_MIN), f"embed cosine {cos.min()} < {COSINE_MIN}")

    flops = embed_flops_per_clip(cfg)
    for B in (64, 32, 16):
        try:
            batch = rng.integers(0, 256, (B,) + clips.shape[1:], dtype=np.uint8)
            x = torch.from_numpy(batch).cuda()
            with torch.inference_mode():
                dev_ms = time_ms(lambda: fn.model.embed(x), iters=5, warmup=2)
            fn(batch)
            t0 = time.perf_counter()
            for _ in range(3):
                fn(batch)
            host_s = (time.perf_counter() - t0) / 3
        except torch.cuda.OutOfMemoryError:
            print(f"main path: B={B} does not fit", flush=True)
            torch.cuda.empty_cache()
            continue
        clips_s = B / (dev_ms / 1e3)
        print(f"main path [{card}]: B={B} embed {dev_ms:.2f} ms on device -> "
              f"{clips_s:.1f} clips/s, {clips_s * cfg.num_frames:.1f} frames/s, "
              f"MFU {flops * clips_s / PEAK_BF16_FLOPS:.3f} "
              f"({flops / 1e9:.1f} GFLOP/clip); entry point with host copies "
              f"{B / host_s:.1f} clips/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        if profile is not None:
            profile_embed(fn.model, x, profile)
        break
    else:
        fail("no batch size in {64, 32, 16} fits")
    return launches, B


def profile_call(fn, what: str, out_file: str) -> float:
    """torch.profiler breakdown of one call of ``fn`` (after one untimed
    call): device time by kernel, and the device's idle share of the call's
    wall time; the table is also written to ``out_file`` unless it is
    empty.  Returns the device-busy microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only: an operator's row repeats the time of its kernels
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(table, flush=True)
    print(f"profile ({what}): device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms "
          f"wall, idle share {1 - busy_us / wall_us:.3f}", flush=True)
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(table)
    return busy_us


def profile_embed(model, x, out_file: str) -> None:
    """:func:`profile_call` of one embed call, then the plain-PyTorch GELU
    and LayerNorm timed alone at the block's shapes (the table cannot tell
    which elementwise kernels belong to which op)."""
    import torch

    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

    with torch.inference_mode():
        busy_us = profile_call(lambda: model.embed(x), "one embed call", out_file)
    cfg = model.cfg
    B, N, D = x.shape[0], cfg.seq_len, cfg.hidden_size
    h = torch.randn(B, N, int(D * cfg.mlp_ratio), device=x.device, dtype=torch.bfloat16)
    a = torch.randn(B, N, D, device=x.device, dtype=torch.bfloat16)
    w, b = torch.ones(D, device=x.device), torch.zeros(D, device=x.device)
    with torch.inference_mode():
        per_call = {"gelu_poly": (time_ms(lambda: gelu(h), iters=5), cfg.depth),
                    "layer_norm": (time_ms(lambda: layer_norm(a, w, b), iters=5),
                                   2 * cfg.depth)}
    for name, (ms, calls) in per_call.items():
        print(f"profile: {name} {ms:.3f} ms x {calls} calls = {ms * calls:.1f} ms, "
              f"{ms * calls * 1e3 / busy_us:.3f} of device time", flush=True)


def fwd_bwd(fn, *shape_of_x_and_params):
    """A call of ``fn`` on random CUDA inputs of the given (shape, dtype)s,
    forward plus backward into every input, for :func:`time_ms`."""
    import torch

    xs = [torch.randn(s, device="cuda", dtype=dt, requires_grad=True)
          for s, dt in shape_of_x_and_params]
    y = fn(*xs)
    return lambda: torch.autograd.grad(fn(*xs), xs, torch.ones_like(y))


def profile_train(step, state, video, num_visible: int, out_file: str) -> None:
    """:func:`profile_call` of one training step, then the plain-PyTorch
    GELU and LayerNorm, forward plus backward, timed alone at the step's
    shapes (encoder at the visible tokens, decoder at all of them)."""
    import torch

    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

    B = video.shape[0]
    busy_us = profile_call(lambda: step(state, video), f"one training step at B={B}",
                           out_file)
    cfg = state.model.cfg
    bf16, f32 = torch.bfloat16, torch.float32
    per_call = {}
    for where, n, d, layers, norms in (
            ("encoder", num_visible, cfg.hidden_size, cfg.depth, 2 * cfg.depth),
            ("decoder", cfg.seq_len, cfg.decoder_hidden_size, cfg.decoder_depth,
             2 * cfg.decoder_depth + 1)):
        hidden = int(d * cfg.mlp_ratio)
        per_call[f"gelu_poly {where}"] = (
            time_ms(fwd_bwd(gelu, ((B, n, hidden), bf16)), iters=5), layers)
        per_call[f"layer_norm {where}"] = (
            time_ms(fwd_bwd(layer_norm, ((B, n, d), bf16), ((d,), f32), ((d,), f32)),
                    iters=5), norms)
    for name, (ms, calls) in per_call.items():
        print(f"profile: {name} forward+backward {ms:.3f} ms x {calls} calls = "
              f"{ms * calls:.1f} ms, {ms * calls * 1e3 / busy_us:.3f} of device time",
              flush=True)


def profile_jepa(step, state, batch, enc_cap: int, pred_cap: int, npred: int,
                 out_file: str) -> None:
    """:func:`profile_call` of one JEPA training step, then the
    plain-PyTorch GELU and LayerNorm timed alone at the step's shapes: the
    target encoder's forward at all N tokens, forward plus backward in the
    context encoder at ``enc_cap`` tokens and in the predictor at
    ``enc_cap + pred_cap`` tokens for each of ``npred`` masks."""
    import torch

    from bvc_tpu_torch.models.vit import layer_norm
    from bvc_tpu_torch.ops.gelu import gelu

    B = batch["video"].shape[0]
    busy_us = profile_call(lambda: step(state, batch), f"one JEPA step at B={B}", out_file)
    cfg = state.model.cfg
    D, Dp = cfg.hidden_size, cfg.pred_emb_dim
    bf16, f32 = torch.bfloat16, torch.float32
    rows = (("target", (B, cfg.seq_len), D, cfg.depth, 2 * cfg.depth + 2, False),
            ("context", (B, enc_cap), D, cfg.depth, 2 * cfg.depth + 1, True),
            ("predictor", (npred * B, enc_cap + pred_cap), Dp, cfg.pred_depth,
             2 * cfg.pred_depth + 1, True))
    for where, lead, d, layers, norms, grad in rows:
        hidden = int(d * cfg.mlp_ratio)
        if grad:
            gelu_ms = time_ms(fwd_bwd(gelu, ((*lead, hidden), bf16)), iters=5)
            ln_ms = time_ms(fwd_bwd(layer_norm, ((*lead, d), bf16), ((d,), f32),
                                    ((d,), f32)), iters=5)
        else:
            h = torch.randn((*lead, hidden), device="cuda", dtype=bf16)
            x = torch.randn((*lead, d), device="cuda", dtype=bf16)
            w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            with torch.no_grad():
                gelu_ms = time_ms(lambda: gelu(h), iters=5)
                ln_ms = time_ms(lambda: layer_norm(x, w, b), iters=5)
        what = "forward+backward" if grad else "forward"
        for name, ms, calls in (("gelu_poly", gelu_ms, layers), ("layer_norm", ln_ms, norms)):
            print(f"profile: {name} {where} [{','.join(map(str, lead))}] {what} {ms:.3f} ms "
                  f"x {calls} calls = {ms * calls:.1f} ms, "
                  f"{ms * calls * 1e3 / busy_us:.3f} of device time", flush=True)


def time_train_steps(make_state, step, video, steps: int = 10) -> tuple:
    """Device time of one training step (``step(state, video)``), ms, by
    CUDA events over ``steps`` steps after 3 warm-up steps from a fresh
    ``make_state()``, with peak memory counted from that state's creation;
    returns ``(ms, losses, state)``."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    state = make_state()
    for _ in range(3):
        step(state, video)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(state, video)["loss"] for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, torch.stack(losses).tolist(), state


def phase_train(card: str, profile: str | None) -> tuple[dict[str, int], int]:
    """VideoMAE-B pretraining steps on the card through the port's entry
    points (``VideoMAEPretrain``, ``TrainState.create``,
    ``make_videomae_train_step``), as ``bench.py`` configures the JAX
    flagship.  Returns each kernel's launches in one step at B=8, and the
    batch timed."""
    import gc

    import numpy as np
    import torch

    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    cfg = ModelConfig()
    mask_cfg = MaskConfig(sampler="tube", mask_ratio=0.9)
    optim = OptimConfig(name="sgd", lr=0.1, momentum=0.9)
    num_visible = cfg.num_time_steps * (cfg.tokens_per_frame
                                        - int(mask_cfg.mask_ratio * cfg.tokens_per_frame))
    rng = np.random.default_rng(0)

    def clips(B):
        shape = (B, cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()

    # B=8: the kernels' launches in one step, and the step against the
    # plain attention path from the same weights, batch and mask (both
    # states draw the mask from generators of one seed).
    video = clips(8)
    state = TrainState.create(copy.deepcopy(base_model("videomae")), optim, seed=1)
    step = make_videomae_train_step(cfg, mask_cfg)
    reset_launches()
    metrics = step(state, video)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"train: one step at B=8 launched {launches}", flush=True)
    layers = cfg.depth + cfg.decoder_depth
    expected = {**{k: 0 for k in launches}, "flash_fwd": layers, "flash_bwd": layers,
                "flash_bwd_prep": layers, "flash_bwd_post": layers}
    check(launches == expected, f"expected {expected} in one step, got {launches}")

    plain = TrainState.create(copy.deepcopy(base_model("videomae")), optim, seed=1)
    plain_metrics = make_videomae_train_step(cfg, mask_cfg, attn_impl="xla")(plain, video)
    loss, plain_loss = metrics["loss"].item(), plain_metrics["loss"].item()
    rel = abs(loss - plain_loss) / abs(plain_loss)
    print(f"train: loss {loss:.6f}, plain attention {plain_loss:.6f} (rel {rel:.2e}); "
          f"grad_norm {metrics['grad_norm'].item():.4e} vs "
          f"{plain_metrics['grad_norm'].item():.4e}", flush=True)
    check(math.isfinite(loss) and rel <= TRAIN_LOSS_RTOL,
          f"train loss {loss} vs plain {plain_loss}: rel {rel} > {TRAIN_LOSS_RTOL}")
    groups = ("encoder.patch_embed.", "encoder.blocks.", "enc_to_dec.", "mask_token",
              "decoder.", "decoder_norm.", "decoder_head.")
    flash_grads = {n: p.grad.flatten() for n, p in state.model.named_parameters()}
    plain_grads = {n: p.grad.flatten() for n, p in plain.model.named_parameters()}
    cosine = torch.nn.functional.cosine_similarity
    for group in groups:
        names = [n for n in flash_grads if n.startswith(group)]
        cos = cosine(torch.cat([flash_grads[n] for n in names]),
                     torch.cat([plain_grads[n] for n in names]), dim=0).item()
        print(f"train: gradient cosine to the plain path, {group:<22} {cos:.6f}", flush=True)
        check(cos >= GRAD_COSINE_MIN, f"gradient cosine of {group} {cos} < {GRAD_COSINE_MIN}")
    # each tensor alone, so one wrong layer cannot hide in its group
    per_tensor = sorted((cosine(flash_grads[n], plain_grads[n], dim=0).item(), n)
                        for n in flash_grads)
    print(f"train: gradient cosine per tensor ({len(per_tensor)} tensors), lowest: "
          + ", ".join(f"{n} {c:.6f}" for c, n in per_tensor[:5]), flush=True)
    check(per_tensor[0][0] >= TENSOR_COSINE_MIN,
          f"gradient cosine of {per_tensor[0][1]} {per_tensor[0][0]} < {TENSOR_COSINE_MIN}")
    del state, plain, flash_grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()

    flops = train_flops_per_clip(cfg, num_visible)
    for B in (48, 32, 16):
        try:
            video = clips(B)
            ms, losses, state = time_train_steps(
                lambda: TrainState.create(copy.deepcopy(base_model("videomae")), optim, seed=1),
                step, video)
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler, whose traceback holds the step's tensors
            print(f"train: B={B} does not fit", flush=True)
            state = video = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
        clips_s = B / (ms / 1e3)
        print(f"train [{card}]: B={B} step {ms:.3f} ms -> {clips_s:.1f} clips/s, "
              f"MFU {flops * clips_s / PEAK_BF16_FLOPS:.4f} ({flops / 1e9:.1f} GFLOP/clip), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"losses {losses[0]:.4f} .. {losses[-1]:.4f}", flush=True)
        if profile is not None:
            profile_train(step, state, video, num_visible,
                          str(Path(profile).with_name("profile_train.txt")) if profile else "")
        break
    else:
        fail("no batch size in {48, 32, 16} fits")
    del state, video
    gc.collect()
    torch.cuda.empty_cache()
    return launches, B


def jepa_config():
    """The slice's V-JEPA configuration, as the JEPA CLI's defaults build it
    (``bvc_tpu/cli/pretrain_jepa.py``): ViT-B at 224 px, 2 frames, tubelet 1
    (392 tokens) and a 384-wide 6-layer predictor with 12 heads; the
    multi-block collator with enc_mask_scale (0.85, 1.0), pred_mask_scale
    (0.1, 0.15) and 4 prediction masks (caps 169 and 30); SGD-Nesterov at
    lr 0.03 without weight decay on biases and norms, EMA (0.996, 1.0)."""
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    cfg = ModelConfig(family="jepa", num_frames=2, tubelet_size=1)
    mask_cfg = MaskConfig(enc_mask_scale=(0.85, 1.0), pred_mask_scale=(0.1, 0.15))
    optim = OptimConfig(name="sgd", lr=0.03, momentum=0.9, nesterov=True,
                        exclude_bias_and_norm_from_wd=True)
    return cfg, mask_cfg, optim


def jepa_key_masks(batch: dict):
    """The key masks of a collated JEPA batch on the card, as the modules
    build them: the context encoder's ``[B, Ke]`` and the predictor's
    ``[M*B, Ke + Kp]`` (context rows tiled m-major, then each mask's
    prediction rows)."""
    import torch

    enc = torch.as_tensor(batch["enc_idx"], device="cuda") >= 0
    pred = torch.as_tensor(batch["pred_idx"], device="cuda") >= 0  # [B, M, Kp]
    B, M, Kp = pred.shape
    tiled = enc[None].expand(M, -1, -1).reshape(M * B, -1)
    return enc, torch.cat([tiled, pred.transpose(0, 1).reshape(M * B, Kp)], dim=1)


def jepa_train_flops_per_clip(cfg, enc_cap: int, pred_cap: int, npred: int) -> float:
    """Model operations of one JEPA pretraining step per clip, over the
    tokens the step computes, padding included: the target encoder's
    forward at all N tokens, 24*N*D^2 + 4*N^2*D per layer plus the patch
    embedding 2*N*(C*ts*p*p)*D; 3 x the context encoder's forward at the
    Ke = ``enc_cap`` gathered tokens (its patch embedding runs at all N
    before the gather); 3 x the predictor's forward: the embedding
    2*Ke*D*Dp, then for each of the ``npred`` masks its blocks at
    L = Ke + Kp (Kp = ``pred_cap``), 24*L*Dp^2 + 4*L^2*Dp per layer, and the
    projection 2*Kp*Dp*D."""
    N, D, Dp = cfg.seq_len, cfg.hidden_size, cfg.pred_emb_dim
    Ke, Kp = enc_cap, pred_cap
    L = Ke + Kp
    patch = 2 * N * cfg.in_channels * cfg.tubelet_size * cfg.patch_size ** 2 * D
    target = cfg.depth * (24 * N * D * D + 4 * N * N * D) + patch
    context = cfg.depth * (24 * Ke * D * D + 4 * Ke * Ke * D) + patch
    predictor = 2 * Ke * D * Dp + npred * (
        cfg.pred_depth * (24 * L * Dp * Dp + 4 * L * L * Dp) + 2 * Kp * Dp * D)
    return target + 3 * (context + predictor)


def sdpa_fwd_ms(qs, k, v, backends, attn_mask=None) -> tuple:
    """SDPA's forward at ``[B, N, h, d]`` inputs, a yardstick only (the port
    never calls it): for each backend of ``backends`` (pinned with
    ``torch.nn.attention.sdpa_kernel``) that runs here, by events and in a
    CUDA graph; returns ``(events ms, graph ms, backend)`` of the backend
    fastest in a graph, with every backend's readings printed, or
    ``(None, None, None)`` where none runs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, scale=1.0)

    best = (None, None, None)
    for backend in backends:
        try:
            with sdpa_kernel(backend), torch.no_grad():
                ev, gr = time_ms(fwd), graph_ms(fwd)
        except RuntimeError as exc:
            print(f"  sdpa {backend.name}: does not run here ({str(exc).splitlines()[0][:80]})",
                  flush=True)
            continue
        print(f"  sdpa {backend.name} forward: {ev:.4f} ms by events, {gr:.4f} in a graph",
              flush=True)
        if best[1] is None or gr < best[1]:
            best = (ev, gr, backend.name)
    return best


def phase_bias_kernel() -> dict:
    """The key-bias forward and backward (pre-pass, fused kernel, post-pass)
    against their plain versions at JEPA's context shape ``[8, 169, 12, 64]``
    (collator mask), its predictor shape ``[32, 199, 12, 32]`` (concatenated
    mask), an odd ``[8, 197, 12, 64]`` with about 40% of the keys masked, at
    both widths with one batch element whose every key is masked, at the
    image ViT's ``keep_idx`` shape ``[64, 147, 12, 64]`` with 140-147 keys
    kept a row (a partial key tile of 19), and at the B=64 step's own shapes ``[64, 169, 12, 64]`` and ``[256, 199, 12, 32]``:
    O within 2e-2, LSE within 1e-3 (+inf exactly where a row has no key),
    dQ/dK/dV within 2e-2 x max|ref| and 1e-3 in |err|/|ref|, a second run's
    dQ within 1e-3 of the first (its f32 sum over key tiles has no fixed
    order), and dK = dV = 0 exactly at masked keys.  At the step's shapes,
    times by events and in a CUDA graph of the forward, the whole backward
    and each of its kernels beside the bounds (K and V counted for the
    attendable keys only), the plain versions and SDPA with the bias as its
    mask, backend pinned and named; then forward plus backward of the
    kernels against plain attention at B=64 and N in {128, 160, 256} at
    both widths, for the masked routing rule.  Returns the four kernels'
    records at ``[64, 169, 12, 64]``, the predictor's under
    ``"predictor"``."""
    import torch
    from torch.nn.attention import SDPBackend

    from bvc_tpu_torch.masks.multiblock import mask_collate
    from bvc_tpu_torch.ops.attention import multi_head_attention
    from bvc_tpu_torch.ops.flash_attention import (_delta, bwd_operands,
                                                   flash_attention_bwd_ref,
                                                   flash_attention_fwd_ref, flash_bwd_cuda,
                                                   flash_fwd_cuda, key_bias, launch_bwd_fused,
                                                   launch_bwd_post, launch_bwd_prep,
                                                   padded_tokens)

    cfg, mask_cfg, _ = jepa_config()
    collate = mask_collate(cfg, mask_cfg, seed=0)
    enc_mask, pred_mask = jepa_key_masks(collate(8, step=0))
    enc_step, pred_step = jepa_key_masks(collate(64, step=0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def random_mask(B, N, keep, dead=None):
        mask = torch.rand((B, N), generator=gen, device="cuda") < keep
        if dead is not None:
            mask[dead] = False
        return mask

    # the image ViT's keep_idx rows: 140-147 kept tokens each, padded with -1
    kept = VIT_IMAGE_KEEP - torch.arange(VIT_IMAGE_B, device="cuda")[:, None] % 8
    keep_mask = torch.arange(VIT_IMAGE_KEEP, device="cuda") < kept

    cases = (("context", (8, 169, 12, 64), enc_mask),
             ("predictor", (32, 199, 12, 32), pred_mask),
             ("odd N", (8, 197, 12, 64), random_mask(8, 197, 0.6)),
             ("all masked d64", (4, 169, 12, 64), random_mask(4, 169, 0.5, dead=1)),
             ("all masked d32", (4, 199, 12, 32), random_mask(4, 199, 0.5, dead=2)),
             ("image vit keep", (VIT_IMAGE_B, VIT_IMAGE_KEEP, 12, 64), keep_mask),
             ("context step", (64, 169, 12, 64), enc_step),
             ("predictor step", (256, 199, 12, 32), pred_step))
    result = {}
    for label, (B, N, h, d), mask in cases:
        _, qs, k, v = qkv_inputs(B, N, h, d, seed=3 * N + d)
        bias = key_bias(mask)
        do = torch.randn((B, N, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash_fwd_cuda(qs, k, v, bias)
        o_ref, lse_ref = flash_attention_fwd_ref(qs, k, v, bias)
        grads = flash_bwd_cuda(qs, k, v, o, lse, do, bias)
        again = flash_bwd_cuda(qs, k, v, o, lse, do, bias)
        refs = flash_attention_bwd_ref(qs, k, v, o, lse, do, bias)
        torch.cuda.synchronize()
        shape = f"[{B},{N},{h},{d}] ({label}, {(~mask).float().mean().item():.2f} masked)"
        err_o = (o.float() - o_ref.float()).abs().max().item()
        no_key = torch.isinf(lse_ref)
        err_lse = (lse[~no_key] - lse_ref[~no_key]).abs().max().item()
        print(f"flash_fwd_bias {shape}: max|dO| {err_o:.3e} max|dLSE| {err_lse:.3e}, "
              f"{int(no_key.sum())} rows with no key", flush=True)
        check(torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL),
              f"flash_fwd_bias O disagrees with the plain version at {label}: {err_o}")
        check(torch.equal(torch.isinf(lse), no_key) and bool((lse[no_key] > 0).all())
              and torch.allclose(lse[~no_key], lse_ref[~no_key], atol=LSE_TOL, rtol=LSE_TOL),
              f"flash_fwd_bias LSE disagrees with the plain version at {label}: {err_lse}")
        errs = {}
        for name, x, y, ref in zip(("dq", "dk", "dv"), grads, again, refs):
            diff = x.float() - ref.float()
            err, scale = diff.abs().max().item(), ref.float().abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            rerun = ((x.float() - y.float()).norm() / ref.float().norm()).item()
            errs[name] = err
            at_masked = (x[~mask].abs().max().item()
                         if name != "dq" and bool((~mask).any()) else 0.0)
            print(f"flash_bwd_bias {shape} {name}: max abs err {err:.3e} (bound "
                  f"{BWD_TOL * scale:.3e}), |err|/|ref| {rel:.3e} (bound {BWD_REL_TOL}); "
                  f"second run {'bitwise equal' if torch.equal(x, y) else 'differs'}, "
                  f"|run1 - run2|/|ref| {rerun:.3e}"
                  + (f"; max|{name}| at masked keys {at_masked}" if name != "dq" else ""),
                  flush=True)
            check(err <= BWD_TOL * scale and rel <= BWD_REL_TOL,
                  f"flash_bwd_bias {name} disagrees with the plain version at {label}: "
                  f"{err}, rel {rel}")
            check(rerun <= BWD_REL_TOL,
                  f"flash_bwd_bias {name} at {label}: two runs differ by {rerun}")
            check(at_masked == 0, f"flash_bwd_bias {name} at {label}: masked keys get "
                                  f"{at_masked}, not 0")
        if "all masked" in label:
            dead = ~mask.any(dim=1)
            check(grads[0][dead].abs().max().item() == 0 and bool(o[dead].isfinite().all()),
                  f"flash_bias at {label}: a row with no key got a gradient or a NaN")
        del o_ref, lse_ref, again, refs
        if not label.endswith("step"):
            continue

        # the step's shapes: each kernel, the whole backward and SDPA (a
        # yardstick only: the port never calls it) with the bias as its
        # additive mask, backend pinned, forward and backward, in graphs
        keys = int(mask.sum())
        # the pre-pass alone: D and L log2 e against their plain versions;
        # the post-pass: dQ = bf16 of the accumulator
        w = bwd_operands(qs, k, v, o, lse, do, bias)
        n_pad = padded_tokens(N)
        launch_bwd_prep(w)
        stats = w["stats"].view(B * h, 2, n_pad)
        delta = _delta(o, do).view(B * h, N)
        err_d = (stats[:, 1, :N] - delta).abs().max().item()
        err_l = (stats[:, 0, :N] - lse.view(B * h, N) * math.log2(math.e)).abs().max().item()
        launch_bwd_fused(w)
        launch_bwd_post(w)
        acc = w["dq_acc"].view(B, h, n_pad, d)[:, :, :N].transpose(1, 2)
        err_post = (w["dq"].float() - acc.to(torch.bfloat16).float()).abs().max().item()
        torch.cuda.synchronize()
        print(f"flash_bwd_prep_bias ({label}): max|dD| {err_d:.3e}, max|d(L log2 e)| "
              f"{err_l:.3e}; flash_bwd_post_bias: max|dQ - bf16(acc)| {err_post}", flush=True)
        check(err_d <= 1e-5 * max(1.0, delta.abs().max().item())
              and err_l <= 1e-5 * max(1.0, lse.abs().max().item()),
              f"flash_bwd_prep_bias disagrees with the plain version at {label}")
        check(err_post == 0, f"flash_bwd_post_bias disagrees with bf16(acc) at {label}")
        calls = {"fwd": lambda: flash_fwd_cuda(qs, k, v, bias),
                 "whole": lambda: flash_bwd_cuda(qs, k, v, o, lse, do, bias),
                 "prep": lambda: launch_bwd_prep(w), "fused": lambda: launch_bwd_fused(w),
                 "post": lambda: launch_bwd_post(w)}
        t = {name: (time_ms(fn), graph_ms(fn)) for name, fn in calls.items()}
        plain = {"fwd": time_ms(lambda: flash_attention_fwd_ref(qs, k, v, bias), iters=3,
                                warmup=1),
                 "whole": time_ms(lambda: flash_attention_bwd_ref(qs, k, v, o, lse, do, bias),
                                  iters=3, warmup=1),
                 "prep": time_ms(lambda: _delta(o, do)),
                 "post": time_ms(lambda: acc.to(torch.bfloat16))}
        amask = bias.to(torch.bfloat16)[:, None, None, :]
        backends = (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION)
        lib_fwd = sdpa_fwd_ms(qs, k, v, backends, amask)
        lib_bwd = sdpa_bwd_ms(qs, k, v, do, backends, amask)
        elems, rows = B * N * h * d, B * h * n_pad
        bounds = {"fwd": attention_bound_ms(B, N, h, d, bias=True, keys=keys),
                  "whole": bwd_bound_ms(B, N, h, d, 5, 3, bias=True, keys=keys),
                  # the pre-pass reads O, dO and L and writes the stats table and
                  # the zeroed accumulator; the post-pass reads the
                  # accumulator's N rows and writes dQ
                  "prep": ((2 * elems * 2 + B * h * N * 4 + rows * 2 * 4 + rows * d * 4)
                           / PEAK_HBM_BYTES * 1e3, "bytes"),
                  "post": (elems * 6 / PEAK_HBM_BYTES * 1e3, "bytes")}
        bounds["fused"] = bounds["whole"]
        for name in ("fwd", "whole", "fused", "prep", "post"):
            bound, by = bounds[name]
            print(f"flash_bias {name} [{B},{N},{h},{d}] ({label}, {keys} of {B * N} keys "
                  f"attendable): {t[name][0]:.4f} ms by events, {t[name][1]:.4f} in a CUDA "
                  f"graph; bound {bound:.4f} ms ({by}, {bound / t[name][1]:.3f} of the graph "
                  f"time)" + (f"; plain {plain[name]:.4f} ms" if name in plain else ""),
                  flush=True)
        print(f"flash_bias [{B},{N},{h},{d}] ({label}): sdpa forward ({lib_fwd[2]}) "
              f"{ms_text(lib_fwd[0])}, graph {ms_text(lib_fwd[1])}; sdpa backward "
              f"({lib_bwd[2]}) {ms_text(lib_bwd[0])}, graph {ms_text(lib_bwd[1])}", flush=True)
        records = {
            "fwd": {"max_abs_err": err_o, "max_abs_err_lse": err_lse, "plain_ms": plain["fwd"],
                    "library_ms": lib_fwd[0], "library_graph_ms": lib_fwd[1],
                    "library_backend": lib_fwd[2]},
            "fused": {"max_abs_err": max(errs.values()), "whole_ms": t["whole"][0],
                      "whole_graph_ms": t["whole"][1], "plain_ms": plain["whole"],
                      "library_ms": lib_bwd[0], "library_graph_ms": lib_bwd[1],
                      "library_backend": lib_bwd[2]},
            "prep": {"max_abs_err": err_d, "plain_ms": plain["prep"], "library_ms": None},
            "post": {"max_abs_err": err_post, "plain_ms": plain["post"],
                     "library_ms": plain["post"]}}
        for name, rec in records.items():
            rec.update({"at": [B, N, h, d], "attendable_keys": keys, "ms": t[name][0],
                        "graph_ms": t[name][1], "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1]})
            if label == "context step":
                result[name] = rec
            else:
                result[name]["predictor"] = rec
        del w, acc, stats, delta, qs, k, v, o, lse, do, grads

    # Masked routing: the kernels (public entry, scale folding included)
    # against plain attention, forward plus backward, at B=64 and 12 heads
    # with about 60% of the keys kept; the JEPA step's own two shapes are
    # timed the same way in phase_jepa_train.
    for N in (128, 160, 256):
        for d in (64, 32):
            mask = random_mask(64, N, 0.6)
            q, _, k, v = qkv_inputs(64, N, 12, d, seed=N + d)
            q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)

            def fwd_bwd(impl):
                out = multi_head_attention(q, k, v, impl=impl, key_mask=mask)
                return torch.autograd.grad(out, (q, k, v), do)

            k_ms = time_ms(lambda: fwd_bwd("flash"))
            p_ms = time_ms(lambda: fwd_bwd("xla"), iters=5)
            print(f"routing masked fwd+bwd [64,{N},12,{d}]: flash {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms", flush=True)
    return result


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits), elementwise."""
    import torch

    mag = x.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def int8_operands(M: int, N: int, K: int, seed: int):
    """int8 ``a [M, K]`` and ``b [N, K]`` over the full range, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randint(-128, 128, shape, generator=gen, device="cuda",
                               dtype=torch.int8) for shape in ((M, K), (N, K)))


def int_mm_ms(a, b) -> float | None:
    """``torch._int_mm`` (cuBLASLt int8 -> int32) on ``a @ b.T``, a
    yardstick only: the port never calls it.  None where it refuses the
    shape."""
    import torch

    try:
        return time_ms(lambda: torch._int_mm(a, b.T))
    except RuntimeError as e:
        print(f"  torch._int_mm refused [{a.shape[0]},{a.shape[1]}]x[{b.shape[1]},"
              f"{b.shape[0]}]: {str(e).splitlines()[0]}", flush=True)
        return None


def host_ms(fn, iters: int = 200) -> float:
    """Host time per call of ``fn()`` over back-to-back calls, no sync
    between them: the pace at which the host can launch it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn()``, ``calls`` of them captured in one
    CUDA graph and replayed: the kernel's time without the host's launch
    pace."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return time_ms(graph.replay, iters=replays, warmup=1) / calls


def check_dequant(what: str, got, want, dtype) -> float:
    """The dequant epilogue's output against the plain version's: within
    one bf16 ulp (bf16 out) or 1e-6 relative (f32 out); returns max|err|."""
    import torch

    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        ok, limit = bool((err <= bf16_ulp(want)).all()), "one bf16 ulp"
    else:
        ok, limit = bool((err <= 1e-6 * want.float().abs()).all()), "1e-6 relative"
    print(f"gemm_s8 dequant ({what}, {dtype}): max abs err {err.max().item():.3e} "
          f"(limit {limit})", flush=True)
    check(ok, f"gemm_s8 dequant disagrees with the plain version at {what} {dtype}")
    return err.max().item()


def phase_gemm_kernel() -> dict:
    """The s8 and bf16 kernels of ``csrc/gemm.cu`` against their plain
    versions: s8 raw exactly equal to the int32 product at 1024^3, at the
    probe's ``[8192,1024] x [1024,1024]``, at an odd ``[1001,768] x
    [2300,768]``, at ``[1001,784] x [2300,784]``, whose K is no multiple of
    the 128-byte stage, and at ``[1001,768] x [2302,768]``, whose int32 rows
    are no multiple of 16 bytes (the epilogue's plain stores, not TMA's); the
    dequant epilogue through ``qdense`` within one bf16 ulp (bf16 out) or
    1e-6 relative (f32 out) of ``qdense_ref`` at the path's qkv and fc1
    shapes for B=8 and at the ragged ``[1001,768] x [2300,768]`` (bf16 rows
    of 4600 bytes take the plain stores, f32 ones TMA's), and of
    ``int8_matmul_ref`` at the qkv and fc1 shapes for B=64, where every CTA
    walks about 100 tiles; the bf16 kernel exactly equal to the int32
    product on integer-valued inputs at the probe's shape and at K = 784,
    and within 1e-3 of max|ref| on normal ones.  Times against the bound,
    the plain version and, as yardsticks, ``torch._int_mm`` and a bf16
    ``torch.matmul``, at the path's B=64 shapes and at the probe's shape,
    each beside the wrapper's host time per call; at the probe's shape also
    in a CUDA graph, which the host's launch pace cannot slow, and the bf16
    product (kernel and ``torch.matmul``) at K = 1024, 2048 and 4096, split
    into a time per 1024 of K and a part that does not grow with K.  Returns the
    records of ``gemm_s8`` (qkv at B=64, the others under ``"fc1"`` and
    ``"probe_raw"``) and ``gemm_bf16`` (the probe's shape)."""
    import numpy as np
    import torch

    from bvc_tpu_torch.ops.gemm import (bf16_matmul_cuda, bf16_matmul_ref, int8_matmul_cuda,
                                        int8_matmul_ref)
    from bvc_tpu_torch.ops.quant import qdense, qdense_ref, quantize_linear, quantize_tokens

    # K = 784 leaves a partial last stage: 16 bytes of s8, 32 of bf16
    for M, N, K in ((1024, 1024, 1024), (8192, 1024, 1024), (1001, 2300, 768),
                    (1001, 2300, 784), (1001, 2302, 768)):
        a, b = int8_operands(M, N, K, seed=M + N)
        got, want = int8_matmul_cuda(a, b), int8_matmul_ref(a, b)
        torch.cuda.synchronize()
        diff = int((got != want).sum().item())
        print(f"gemm_s8 raw [{M},{K}]x[{N},{K}]: {diff} entries differ from the exact "
              f"int32 product", flush=True)
        check(diff == 0, f"gemm_s8 raw is not exact at [{M},{K}]x[{N},{K}]: {diff} entries")

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, M, N in (("qkv", 8 * 1568, 2304), ("fc1", 8 * 1568, 3072),
                       ("ragged", 1001, 2300)):
        layer = torch.nn.Linear(768, N).cuda()
        torch.nn.init.normal_(layer.weight, std=0.02, generator=gen)
        torch.nn.init.normal_(layer.bias, std=0.02, generator=gen)
        q = quantize_linear(layer)
        x = torch.randn((M, 768), generator=gen, device="cuda").to(torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            check_dequant(f"{name}, [{M},768]x[{N},768]", qdense(x, q, dtype),
                          qdense_ref(x, q, dtype), dtype)

    # integer-valued bf16 inputs in [-127, 127]: every partial sum is exact in f32;
    # the probe's shape last, as its operands are timed below
    for M, N, K in ((1001, 2300, 784), (8192, 1024, 1024)):
        a, b = int8_operands(M, N, K, seed=1)
        a.clamp_(min=-127)
        b.clamp_(min=-127)
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        got = bf16_matmul_cuda(a16, b16)
        exact = torch.equal(got, int8_matmul_ref(a, b).float())
        print(f"gemm_bf16 [{M},{K}]x[{N},{K}]: integer-valued inputs exact: {exact}",
              flush=True)
        check(exact, f"gemm_bf16 is not exact on integer-valued inputs at [{M},{K}]x[{N},{K}]")
    gn = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    hn = torch.randn((N, K), generator=gen, device="cuda").to(torch.bfloat16)
    ref_n = bf16_matmul_ref(gn, hn)
    err_n = (bf16_matmul_cuda(gn, hn) - ref_n).abs().max().item()
    scale_n = ref_n.abs().max().item()
    print(f"gemm_bf16 [{M},{K}]x[{N},{K}]: normal inputs max abs err {err_n:.3e} (limit "
          f"{GEMM_BF16_TOL * scale_n:.3e})", flush=True)
    check(err_n <= GEMM_BF16_TOL * scale_n, f"gemm_bf16 disagrees with plain: {err_n}")

    # times: the probe's shape, raw int8 and bf16; the kernels take about as
    # long as the host's launch, so also in a CUDA graph (kernel and library)
    ops = 2 * M * N * K
    records = {}
    for name, kernel, plain, lib, bound in (
            ("probe_raw", lambda: int8_matmul_cuda(a, b), lambda: int8_matmul_ref(a, b),
             lambda: torch._int_mm(a, b.T), gemm_bound_ms(M, N, K, 1, 4, PEAK_INT8_OPS)),
            ("gemm_bf16", lambda: bf16_matmul_cuda(a16, b16), lambda: bf16_matmul_ref(a16, b16),
             lambda: torch.matmul(a16, b16.T), gemm_bound_ms(M, N, K, 2, 4, PEAK_BF16_FLOPS))):
        rec = {"at": [M, N, K], "max_abs_err": 0.0 if name == "probe_raw" else err_n,
               "ms": time_ms(kernel), "host_ms": host_ms(kernel), "graph_ms": graph_ms(kernel),
               "plain_ms": time_ms(plain, iters=5), "library_ms": time_ms(lib),
               "library_graph_ms": graph_ms(lib), "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"{'gemm_s8 raw' if name == 'probe_raw' else name} [{M},{K}]x[{N},{K}]: kernel "
              f"{rec['ms']:.4f} ms (host {rec['host_ms']:.4f} ms per call), in a CUDA graph "
              f"{rec['graph_ms']:.4f} ms ({ops / rec['graph_ms'] / 1e9:.1f} T(FL)OP/s), bound "
              f"{bound[0]:.4f} ms ({bound[1]}, {bound[0] / rec['graph_ms']:.3f} of it), plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms (in a graph "
              f"{rec['library_graph_ms']:.4f} ms)", flush=True)
        records[name] = rec
    del a, b, a16, b16, gn, hn, got, ref_n

    # the probe's bf16 product at K = 1024, 2048 and 4096 in a CUDA graph, and
    # a line through the three times: its slope is the products' time per
    # 1024 of K, its intercept what does not grow with K (the f32 output's
    # 32 MB store, the ring's fill, the last epilogue)
    sweep = {}
    for k in (1024, 2048, 4096):
        gk = torch.randn((M, k), generator=gen, device="cuda").to(torch.bfloat16)
        hk = torch.randn((N, k), generator=gen, device="cuda").to(torch.bfloat16)
        sweep[k] = (graph_ms(lambda: bf16_matmul_cuda(gk, hk)),
                    graph_ms(lambda: torch.matmul(gk, hk.T)))
    del gk, hk
    for i, who in enumerate(("gemm_bf16", "torch.matmul")):
        times = [sweep[k][i] for k in sweep]
        slope, fixed = np.polyfit(np.array(list(sweep)) / 1024, times, 1)
        records["gemm_bf16"][f"k_sweep_{'kernel' if i == 0 else 'library'}"] = {
            "graph_ms": dict(zip(map(str, sweep), times)), "ms_per_1024_k": slope,
            "fixed_ms": fixed}
        print(f"{who} [{M},K]x[{N},K] -> f32 in a CUDA graph at K = "
              f"{', '.join(f'{k}: {t:.4f}' for k, t in zip(sweep, times))} ms; a line through "
              f"them: {slope:.4f} ms per 1024 of K ({2 * M * N * 1024 / slope / 1e9:.1f} "
              f"TFLOP/s) and {fixed:.4f} ms that does not grow with K", flush=True)

    # the path's products at B=64, dequant epilogue, bf16 out
    M = 64 * 1568
    x = torch.randn((M, 768), generator=gen, device="cuda").to(torch.bfloat16)
    xq, xscale = quantize_tokens(x)
    xscale = xscale.reshape(-1)
    path = {}
    for name, N in (("qkv", 2304), ("fc1", 3072)):
        layer = torch.nn.Linear(768, N).cuda()
        torch.nn.init.normal_(layer.weight, std=0.02, generator=gen)
        q = quantize_linear(layer)
        args = (xq, q.weight_q, xscale, q.scale, q.bias, torch.bfloat16)
        err = check_dequant(f"{name} at B=64, [{M},768]x[{N},768]", int8_matmul_cuda(*args),
                            int8_matmul_ref(*args), torch.bfloat16)
        ms = time_ms(lambda: int8_matmul_cuda(*args))
        host = host_ms(lambda: int8_matmul_cuda(*args), iters=50)
        plain = time_ms(lambda: int8_matmul_ref(*args), iters=3, warmup=1)
        lib = int_mm_ms(xq, q.weight_q)
        bound = gemm_bound_ms(M, N, 768, 1, 2, PEAK_INT8_OPS, vector_bytes=4 * M + 8 * N)
        print(f"gemm_s8 dequant ({name}, B=64) [{M},768]x[{N},768] -> bf16: kernel "
              f"{ms:.4f} ms ({2 * M * N * 768 / ms / 1e9:.1f} TOP/s; host {host:.4f} ms per "
              f"call), bound {bound[0]:.4f} ms ({bound[1]}, {bound[0] / ms:.3f} of it), plain "
              f"{plain:.4f} ms, torch._int_mm (int32 out, no dequant) "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}", flush=True)
        path[name] = {"at": [M, N, 768], "max_abs_err": err, "ms": ms, "host_ms": host,
                      "plain_ms": plain, "library_ms": lib, "bound_ms": bound[0],
                      "bound_by": bound[1]}
    return {"gemm_s8": {**path["qkv"], "fc1": path["fc1"], "probe_raw": records["probe_raw"]},
            "gemm_bf16": records["gemm_bf16"]}


def phase_softmax_probe_kernel() -> dict:
    """The softmax-dtype probe's kernel against its plain version at
    ``[64,12,512,64]`` (the JEPA target as the TPU padded it),
    ``[64,12,392,64]`` (its real N) and ``[48,6,1568,64]`` (the VideoMAE
    decoder), with f32 and bf16 scores: O within ``PROBE_O_TOL`` of the
    plain version in the same score dtype and equal to it at a share of
    ``PROBE_MATCH_MIN`` of the entries or more, and the kernel's f32 and
    bf16 outputs apart at that share of the entries where the plain ones
    differ; the probe's readout max|O_bf16 - O_f32|; times against the bound, the plain version
    and SDPA's forward, by events and in a CUDA graph, beside the
    exponential roof; the plain ``xla_attn`` with f32 against bf16 logits
    at ``[64,12,392,64]``.  Returns the record at ``[48,6,1568,64]`` with
    the other shapes under their labels."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bvc_tpu_torch.probes.softmax_dtype import (probe_inputs, softmax_probe_fwd_cuda,
                                                    softmax_probe_fwd_ref, xla_attn)

    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16
    records = {}
    for label, shape in (("padded", (64, 12, 512, 64)), ("jepa_target", (64, 12, 392, 64)),
                         ("decoder", (48, 6, 1568, 64))):
        B, h, N, d = shape
        q, k, v = probe_inputs(shape, rng, torch.device("cuda"))
        outs, refs, rec = {}, {}, {"at": list(shape)}
        for sd, tag in ((f32, ""), (bf16, "_bf16_scores")):
            o, ref = softmax_probe_fwd_cuda(q, k, v, sd), softmax_probe_fwd_ref(q, k, v, sd)
            err = (o.float() - ref.float()).abs().max().item()
            outs[sd], refs[sd] = o, ref
            rec["max_abs_err" + tag] = err
            rec["ms" + tag] = time_ms(lambda: softmax_probe_fwd_cuda(q, k, v, sd))
            rec["graph_ms" + tag] = graph_ms(lambda: softmax_probe_fwd_cuda(q, k, v, sd))
            rec["plain_ms" + tag] = time_ms(lambda: softmax_probe_fwd_ref(q, k, v, sd),
                                            iters=3, warmup=1)
        # each output against the plain version in its own score dtype and,
        # to show that the check tells the two apart, in the other one
        for sd, other, tag in ((f32, bf16, ""), (bf16, f32, "_bf16_scores")):
            err = rec["max_abs_err" + tag]
            own = (outs[sd] == refs[sd]).float().mean().item()
            cross = (outs[sd] == refs[other]).float().mean().item()
            rec["equal_share" + tag] = own
            print(f"softmax_probe_fwd {list(shape)} ({label}, {sd} scores): max|dO| {err:.3e} "
                  f"(limit {PROBE_O_TOL}); equal to plain at {own:.5f} of entries (limit "
                  f"{PROBE_MATCH_MIN}), to plain with {other} scores at {cross:.5f}", flush=True)
            check(err <= PROBE_O_TOL and own >= PROBE_MATCH_MIN,
                  f"softmax_probe_fwd disagrees with plain at {label} {sd}: max|dO| {err}, "
                  f"equal at {own}")
        plain_apart = refs[f32] != refs[bf16]
        follows = (outs[f32] != outs[bf16])[plain_apart].float().mean().item()
        rec["apart_where_plain_apart"] = follows
        print(f"softmax_probe_fwd {list(shape)} ({label}): the plain f32 and bf16 outputs "
              f"differ at {plain_apart.float().mean().item():.5f} of entries; the kernel's "
              f"differ at {follows:.5f} of those (limit {PROBE_MATCH_MIN})", flush=True)
        check(follows >= PROBE_MATCH_MIN,
              f"softmax_probe_fwd's score dtype does not follow plain's at {label}: {follows}")
        del refs, plain_apart
        readout = (outs[f32].float() - outs[bf16].float()).abs().max().item()
        # yardstick only (the port never calls it): SDPA's forward
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, scale=1.0)

        rec["library_ms"], rec["library_graph_ms"] = time_ms(sdpa), graph_ms(sdpa)
        rec["exp_bound_ms"] = exp_roof(B, N, h)
        # the function's 4*B*h*N^2*d operations against q, k, v and o (no LSE)
        ops_ms = 4 * B * h * N * N * d / PEAK_BF16_FLOPS * 1e3
        bytes_ms = 4 * B * h * N * d * 2 / PEAK_HBM_BYTES * 1e3
        rec["bound_ms"], rec["bound_by"] = ((ops_ms, "operations") if ops_ms >= bytes_ms
                                            else (bytes_ms, "bytes"))
        rec["max_abs_err_bf16_vs_f32"] = readout
        print(f"softmax_probe_fwd {list(shape)} ({label}): kernel f32 scores "
              f"{rec['ms']:.4f} ms (graph {rec['graph_ms']:.4f}), bf16 scores "
              f"{rec['ms_bf16_scores']:.4f} ms (graph {rec['graph_ms_bf16_scores']:.4f}); bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {rec['bound_ms'] / rec['graph_ms']:.3f}"
              f" of it), exponential roof {rec['exp_bound_ms']:.4f} ms; plain "
              f"{rec['plain_ms']:.4f} / {rec['plain_ms_bf16_scores']:.4f} ms; sdpa "
              f"{rec['library_ms']:.4f} ms (graph {rec['library_graph_ms']:.4f}); "
              f"probe readout max|O_bf16 - O_f32| {readout:.5f}", flush=True)
        records[label] = rec
        del q, k, v, outs
    q, k, v = probe_inputs((64, 12, 392, 64), rng, torch.device("cuda"))
    times = {sd: time_ms(lambda: xla_attn(q, k, v, sd), iters=3, warmup=1) for sd in (f32, bf16)}
    err = (xla_attn(q, k, v, f32).float() - xla_attn(q, k, v, bf16).float()).abs().max().item()
    print(f"xla_attn [64,12,392,64]: f32 logits {times[f32]:.4f} ms, bf16 logits "
          f"{times[bf16]:.4f} ms, max|O_bf16 - O_f32| {err:.5f}", flush=True)
    main = records.pop("decoder")
    return {**main, **records, "xla_attn_ms": times[f32], "xla_attn_ms_bf16_logits": times[bf16]}


def probe_path(name: str, run, expected: set) -> dict[str, int]:
    """A probe's entry point as its own path: every launch count set to 0,
    ``run()``, then the counts read: only the kernels in ``expected`` may
    have launched, each at least once.  Prints the probe's readings and
    returns the counts."""
    reset_launches()
    lines = run()
    counts = read_launches()
    for line in lines if isinstance(lines, list) else [lines]:
        print(f"{name} probe: {json.dumps(line)}", flush=True)
    print(f"{name} probe launched {counts}", flush=True)
    check(all(counts[k] > 0 for k in expected)
          and all(n == 0 for k, n in counts.items() if k not in expected),
          f"the {name} probe launched {counts}, expected only {sorted(expected)}")
    return counts


def phase_w8a8(card: str, profile: str | None) -> dict:
    """W8A8 extraction at full width, this slice's path: VideoMAE-B (224 px,
    16 frames, bf16) through ``untrained_embed_fn(..., quantize="int8")``.
    At B=8 one embed call launches the s8 GEMM 24 times (qkv and fc1 of 12
    layers) and the flash forward 12 times, and nothing else; embeddings
    finite, per-row cosine >= 0.995 to the unquantized path on the same
    weights.  Then clips/s, frames/s and peak memory at the largest B in
    {64, 32, 16} that fits, beside the unquantized extraction's clips/s
    from the same run.  The same for V-JEPA ViT-B at B=8 and B=64.  Then
    ``qdense`` (quantisation pass plus kernel) against the bf16 ``F.linear``
    the unquantized path runs, for each block matmul at ``[64*1568, Din]``.
    Returns each family's launches in one embed call at B=8."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.ops.gemm import int8_matmul_cuda
    from bvc_tpu_torch.ops.quant import qdense, quantize_linear, quantize_tokens
    from bvc_tpu_torch.utils.config import ModelConfig

    rng = np.random.default_rng(2)
    launches = {}
    for family, cfg, batches in (("videomae", ModelConfig(), (64, 32, 16)),
                                 ("jepa", jepa_config()[0], (64,))):
        fn = untrained_embed_fn(family, cfg, seed=0, quantize="int8")
        plain = untrained_embed_fn(family, cfg, seed=0)
        shape = (cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
        clips = rng.integers(0, 256, (8,) + shape, dtype=np.uint8)
        reset_launches()
        emb = fn(clips)
        counts = read_launches()
        launches[family] = counts
        print(f"w8a8 {family}: one embed call at B=8 launched {counts}", flush=True)
        expected = {**{k: 0 for k in counts}, "gemm_s8": 2 * cfg.depth, "flash_fwd": cfg.depth}
        check(counts == expected, f"expected {expected} in one W8A8 embed call, got {counts}")
        check(emb.shape == (8, cfg.hidden_size) and bool(np.isfinite(emb).all()),
              f"W8A8 {family} embeddings of shape {emb.shape} or not finite")
        ref = plain(clips)
        cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
        print(f"w8a8 {family}: cosine to the unquantized bf16 path min {cos.min():.6f}, "
              f"max|diff| {np.abs(emb - ref).max():.4e}", flush=True)
        check(bool(cos.min() >= W8A8_COSINE_MIN),
              f"W8A8 {family} cosine {cos.min()} < {W8A8_COSINE_MIN}")
        for B in batches:
            try:
                torch.cuda.reset_peak_memory_stats()
                x = torch.from_numpy(rng.integers(0, 256, (B,) + shape, dtype=np.uint8)).cuda()
                with torch.inference_mode():
                    q_ms = time_ms(lambda: fn.model.embed(x), iters=5, warmup=2)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    p_ms = time_ms(lambda: plain.model.embed(x), iters=5, warmup=2)
                fits = True
            except torch.cuda.OutOfMemoryError:
                fits = False
            if not fits:  # outside the handler, whose traceback holds the tensors
                print(f"w8a8 {family}: B={B} does not fit", flush=True)
                x = None
                gc.collect()
                torch.cuda.empty_cache()
                continue
            print(f"w8a8 {family} [{card}]: B={B} W8A8 embed {q_ms:.2f} ms on device -> "
                  f"{B / q_ms * 1e3:.1f} clips/s, {B / q_ms * 1e3 * cfg.num_frames:.1f} "
                  f"frames/s, peak memory {peak:.1f} GiB; unquantized bf16 embed "
                  f"{p_ms:.2f} ms -> {B / p_ms * 1e3:.1f} clips/s (W8A8 / bf16 time "
                  f"{q_ms / p_ms:.3f})", flush=True)
            if profile is not None and family == "videomae":
                out = str(Path(profile).with_name("profile_w8a8.txt")) if profile else ""
                profile_embed(fn.model, x, out)
            break
        else:
            fail(f"no W8A8 {family} batch size in {batches} fits")
        del fn, plain, x
        gc.collect()
        torch.cuda.empty_cache()

    # per block matmul at [64*1568, Din]: W8A8 against the bf16 dense
    gen = torch.Generator(device="cuda").manual_seed(3)
    M = 64 * 1568
    for name, din, dout in (("qkv", 768, 2304), ("proj", 768, 768), ("fc1", 768, 3072),
                            ("fc2", 3072, 768)):
        layer = torch.nn.Linear(din, dout).cuda()
        torch.nn.init.normal_(layer.weight, std=0.02, generator=gen)
        q = quantize_linear(layer)
        x = torch.randn((M, din), generator=gen, device="cuda").to(torch.bfloat16)
        w, b = layer.weight.to(torch.bfloat16), layer.bias.to(torch.bfloat16)
        xq, xscale = quantize_tokens(x)
        xscale = xscale.reshape(-1)
        with torch.inference_mode():
            q_ms = time_ms(lambda: qdense(x, q, torch.bfloat16), iters=10)
            quant_ms = time_ms(lambda: quantize_tokens(x), iters=10)
            kern_ms = time_ms(lambda: int8_matmul_cuda(xq, q.weight_q, xscale, q.scale, q.bias,
                                                       torch.bfloat16), iters=10)
            bf_ms = time_ms(lambda: F.linear(x, w, b), iters=10)
        print(f"w8a8 per matmul {name} [{M},{din}] -> {dout}: qdense {q_ms:.3f} ms "
              f"(quantisation pass {quant_ms:.3f}, kernel {kern_ms:.3f}) against bf16 "
              f"F.linear {bf_ms:.3f} ms: {bf_ms / q_ms:.2f}x", flush=True)
        del layer, q, x, xq, w, b
    return launches


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn, attr in _launch_counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in _launch_counters().items()}


def _launch_counters() -> dict:
    from bvc_tpu_torch.ops.flash_attention import flash_bwd_cuda, flash_fwd_cuda
    from bvc_tpu_torch.ops.gemm import bf16_matmul_cuda, int8_matmul_cuda
    from bvc_tpu_torch.probes.softmax_dtype import softmax_probe_fwd_cuda

    return {"flash_fwd": (flash_fwd_cuda, "launches"),
            "flash_bwd_prep": (flash_bwd_cuda, "launches_prep"),
            "flash_bwd": (flash_bwd_cuda, "launches_fused"),
            "flash_bwd_post": (flash_bwd_cuda, "launches_post"),
            "flash_fwd_bias": (flash_fwd_cuda, "launches_bias"),
            "flash_bwd_prep_bias": (flash_bwd_cuda, "launches_prep_bias"),
            "flash_bwd_bias": (flash_bwd_cuda, "launches_fused_bias"),
            "flash_bwd_post_bias": (flash_bwd_cuda, "launches_post_bias"),
            "gemm_s8": (int8_matmul_cuda, "launches"),
            "gemm_bf16": (bf16_matmul_cuda, "launches"),
            "softmax_probe_fwd": (softmax_probe_fwd_cuda, "launches")}


def phase_jepa_embed(card: str) -> int:
    """V-JEPA ViT-B extraction on the card through
    ``untrained_embed_fn("jepa", ...)``: 12 launches of the forward kernel
    (and no other) in one embed call, embeddings within cosine 0.999 per
    row of the plain attention path on the same weights, then clips/s at
    B=64.  Returns the forward kernel's launches in one call."""
    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn

    cfg, _, _ = jepa_config()
    fn = untrained_embed_fn("jepa", cfg, seed=0)
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 256, (8, cfg.num_frames, cfg.image_size, cfg.image_size,
                                  cfg.in_channels), dtype=np.uint8)
    reset_launches()
    emb = fn(clips)
    launches = read_launches()
    print(f"jepa embed: one embed call at B=8 launched {launches}", flush=True)
    check(launches == {**{k: 0 for k in launches}, "flash_fwd": cfg.depth},
          f"expected {cfg.depth} flash_fwd launches and no other, got {launches}")
    check(emb.shape == (8, cfg.hidden_size) and bool(np.isfinite(emb).all()),
          f"JEPA embeddings of shape {emb.shape} or not finite")
    with torch.inference_mode():
        ref = fn.model.embed(torch.from_numpy(clips).cuda(), attn_impl="xla").cpu().numpy()
    cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    print(f"jepa embed: cosine to the plain-attention path min {cos.min():.6f}, "
          f"max|diff| {np.abs(emb - ref).max():.4e}", flush=True)
    check(bool(cos.min() >= COSINE_MIN), f"JEPA embed cosine {cos.min()} < {COSINE_MIN}")
    x = torch.from_numpy(rng.integers(0, 256, (64,) + clips.shape[1:], dtype=np.uint8)).cuda()
    with torch.inference_mode():
        ms = time_ms(lambda: fn.model.embed(x), iters=5, warmup=2)
    print(f"jepa embed [{card}]: B=64 embed {ms:.2f} ms on device -> "
          f"{64 / (ms / 1e3):.1f} clips/s", flush=True)
    return launches["flash_fwd"]


def phase_jepa_train(card: str, profile: str | None) -> dict[str, int]:
    """V-JEPA ViT-B pretraining steps on the card through the port's entry
    points (``JEPA``, ``mask_collate``, ``TrainState.create`` with the EMA
    target, ``make_jepa_train_step``).  At B=8 one step launches the
    key-bias forward and each of the key-bias backward's three kernels 18
    times (12 context-encoder and 6 predictor layers) and the unmasked
    forward kernel 12 times (the target encoder), agrees with a
    step through the plain attention path from the same weights, batch and
    masks, and moves the EMA target.  Then clips/s, MFU and peak memory at
    the largest batch in {64, 32, 16} that fits, and the masked attention's
    forward plus backward, kernels against plain, at that batch's two masked
    shapes.  Returns each kernel's launches in one step at B=8."""
    import copy
    import gc

    import numpy as np
    import torch

    from bvc_tpu_torch.masks.multiblock import mask_collate
    from bvc_tpu_torch.ops.attention import multi_head_attention
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_jepa_train_step

    cfg, mask_cfg, optim = jepa_config()
    collate = mask_collate(cfg, mask_cfg, seed=0)
    rng = np.random.default_rng(0)

    def batch_of(B, step):
        video = rng.integers(0, 256, (B, cfg.num_frames, cfg.image_size, cfg.image_size,
                                      cfg.in_channels), dtype=np.uint8)
        return {k: torch.from_numpy(x).cuda()
                for k, x in {"video": video, **collate(B, step)}.items()}

    def new_state():
        model = copy.deepcopy(base_model("jepa"))
        return TrainState.create(model, optim, seed=1, target=copy.deepcopy(model.encoder))

    def make_step(attn_impl="auto"):
        return make_jepa_train_step(cfg, JEPA_TOTAL_STEPS, optim.ema, optim.ema_fallback,
                                    attn_impl=attn_impl)

    batch = batch_of(8, 0)
    state = new_state()
    target0 = [p.clone() for p in state.target.parameters()]
    step = make_step()
    reset_launches()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"jepa train: one step at B=8 launched {launches}", flush=True)
    masked_layers = cfg.depth + cfg.pred_depth
    expected = {**{k: 0 for k in launches}, "flash_fwd": cfg.depth,
                **{name: masked_layers for name in ("flash_fwd_bias", "flash_bwd_prep_bias",
                                                    "flash_bwd_bias", "flash_bwd_post_bias")}}
    check(launches == expected, f"expected {expected} in one JEPA step, got {launches}")

    plain = new_state()
    plain_metrics = make_step("xla")(plain, batch)
    loss, plain_loss = metrics["loss"].item(), plain_metrics["loss"].item()
    rel = abs(loss - plain_loss) / abs(plain_loss)
    print(f"jepa train: loss {loss:.6f}, plain attention {plain_loss:.6f} (rel {rel:.2e}); "
          f"grad_norm {metrics['grad_norm'].item():.4e} vs "
          f"{plain_metrics['grad_norm'].item():.4e}; mask_a {metrics['mask_a'].item()}, "
          f"mask_b {metrics['mask_b'].item()}, ema_m {metrics['ema_m'].item():.6f}",
          flush=True)
    check(math.isfinite(loss) and rel <= JEPA_LOSS_RTOL,
          f"JEPA loss {loss} vs plain {plain_loss}: rel {rel} > {JEPA_LOSS_RTOL}")
    flash_grads = {n: p.grad.flatten() for n, p in state.model.named_parameters()}
    plain_grads = {n: p.grad.flatten() for n, p in plain.model.named_parameters()}
    cosine = torch.nn.functional.cosine_similarity
    per_tensor = sorted((cosine(flash_grads[n], plain_grads[n], dim=0).item(), n)
                        for n in flash_grads)
    print(f"jepa train: gradient cosine per tensor ({len(per_tensor)} tensors), lowest: "
          + ", ".join(f"{n} {c:.6f}" for c, n in per_tensor[:5]), flush=True)
    check(per_tensor[0][0] >= JEPA_TENSOR_COSINE_MIN,
          f"JEPA gradient cosine of {per_tensor[0][1]} {per_tensor[0][0]} "
          f"< {JEPA_TENSOR_COSINE_MIN}")
    moved = max((p - p0).abs().max().item() for p, p0 in zip(state.target.parameters(),
                                                              target0))
    print(f"jepa train: the EMA target moved by up to {moved:.3e}", flush=True)
    check(moved > 0 and abs(metrics["ema_m"].item() - optim.ema[0]) < 1e-6,
          f"the EMA target did not move ({moved}) or ema_m {metrics['ema_m'].item()}")
    del state, plain, flash_grads, plain_grads, target0
    gc.collect()
    torch.cuda.empty_cache()

    coll = collate.collator
    flops = jepa_train_flops_per_clip(cfg, coll.enc_cap, coll.pred_cap, coll.npred)
    for B in (64, 32, 16):
        try:
            torch.cuda.reset_peak_memory_stats()
            state = new_state()
            batches = [batch_of(B, i) for i in range(13)]
            for b in batches[:3]:
                step(state, b)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = [step(state, b)["loss"] for b in batches[3:]]
            end.record()
            torch.cuda.synchronize()
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler, whose traceback holds the step's tensors
            print(f"jepa train: B={B} does not fit", flush=True)
            state = batches = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        ms = start.elapsed_time(end) / 10
        losses = torch.stack(losses).tolist()
        check(all(math.isfinite(x) for x in losses), f"non-finite JEPA loss: {losses}")
        clips_s = B / (ms / 1e3)
        print(f"jepa train [{card}]: B={B} step {ms:.2f} ms -> {clips_s:.1f} clips/s, "
              f"MFU {flops * clips_s / PEAK_BF16_FLOPS:.4f} ({flops / 1e9:.1f} GFLOP/clip, "
              f"padding included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"losses {losses[0]:.4f} .. {losses[-1]:.4f}", flush=True)
        if profile is not None:
            profile_jepa(step, state, batches[3], coll.enc_cap, coll.pred_cap, coll.npred,
                         str(Path(profile).with_name("profile_jepa.txt")) if profile else "")
        # the masked attention of the step, kernels against plain, forward
        # plus backward, for a routing rule from this card's numbers
        enc_mask, pred_mask = jepa_key_masks(batches[3])
        del state, batches
        gc.collect()
        torch.cuda.empty_cache()
        for label, mask, h, d in (("context", enc_mask, cfg.num_heads, 64),
                                  ("predictor", pred_mask, cfg.num_heads, 32)):
            Bm, N = mask.shape
            q, _, k, v = qkv_inputs(Bm, N, h, d, seed=N)
            q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
            do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)

            def fwd_bwd(impl):
                out = multi_head_attention(q, k, v, impl=impl, key_mask=mask)
                return torch.autograd.grad(out, (q, k, v), do)

            k_ms = time_ms(lambda: fwd_bwd("flash"))
            p_ms = time_ms(lambda: fwd_bwd("xla"), iters=5)
            print(f"routing masked fwd+bwd [{Bm},{N},{h},{d}] ({label}): flash "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
        break
    else:
        fail("no batch size in {64, 32, 16} fits")
    return launches


# steps [a, b) of a CLI stage timed as rec[key]: the trainer's clips/s untraced,
# then the same number of steps under --profile_dir's trace (its idle share)
CLI_WINDOWS = {"ms": (5, 12), "traced_ms": (12, 19)}
CLI_ITERS = 19  # training steps of a CLI stage
CORPUS_FRAMES = 1000  # frames per subject: JEPA's pairs 300 apart need > 300 + B*iters/2
REMAT_COSINE_MIN = 0.9995  # per parameter tensor, remat against no remat


def write_corpus(root: Path, image_size: int = 224, subjects: int = 2) -> tuple[str, str]:
    """A synthetic corpus in the HOMEview layout: ``jpg/<subject>/<frame>.jpg``
    placeholders (the readers list the names; nothing decodes them) for
    the first ``subjects`` subjects of the port's ``get_group('g0')``, and
    their frames, uniform random uint8 from numpy, in a packed shard of the
    port's format (``pack/<subject>/frames_<S>.u8`` and ``.json``): a frame
    the packed reader lacked would fail loudly rather than decode.  Returns
    the two roots."""
    import numpy as np

    from bvc_tpu_torch.data.indexing import get_group
    from bvc_tpu_torch.data.packed import write_shard

    rng = np.random.default_rng(0)
    jpg, pack = root / "jpg", root / "pack"
    for subject in get_group("g0")[:subjects]:
        (jpg / subject).mkdir(parents=True)
        names = [f"frame_{i:05d}.jpg" for i in range(CORPUS_FRAMES)]
        for name in names:
            (jpg / subject / name).touch()
        chunks = (rng.integers(0, 256, (100, image_size, image_size, 3), dtype=np.uint8)
                  for _ in range(CORPUS_FRAMES // 100))
        write_shard(str(pack), subject, names, chunks, image_size)
    return str(jpg), str(pack)


def captured_loaders(module) -> tuple[list, object]:
    """Patch the trainer ``module``'s ``DataLoader`` so the loaders it
    builds are kept; returns (the list, an undo function)."""
    loader_cls, kept = module.DataLoader, []

    class Kept(loader_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept.append(self)

    module.DataLoader = Kept
    return kept, lambda: setattr(module, "DataLoader", loader_cls)


def timed_steps(module, factory: str) -> dict:
    """Patch the trainer ``module``'s step factory so each step it makes is
    recorded: the state (``rec['state']``, ``rec['step']``), the batches'
    count, and for each of ``CLI_WINDOWS`` the host clock at the start of
    its first step and after its last, both after a device synchronisation
    (``rec[key]``: ms a step over the window); and its ``StepTraceWindow``
    so that ``--profile_dir`` traces the ``traced_ms`` window."""
    import torch

    make, window = getattr(module, factory), module.StepTraceWindow
    rec = {"calls": 0}

    def patched(*args, **kw):
        step = make(*args, **kw)

        def wrapped(state, batch):
            i = rec["calls"]
            rec.update(calls=i + 1, state=state, step=step, batch=batch)
            for key, (a, _) in CLI_WINDOWS.items():
                if i == a:
                    torch.cuda.synchronize()
                    rec[key] = time.perf_counter()
            out = step(state, batch)
            for key, (a, b) in CLI_WINDOWS.items():
                if i == b - 1:
                    torch.cuda.synchronize()
                    rec[key] = (time.perf_counter() - rec[key]) * 1e3 / (b - a)
            return out

        wrapped.eval_step = step.eval_step
        return wrapped

    setattr(module, factory, patched)
    a, b = CLI_WINDOWS["traced_ms"]
    module.StepTraceWindow = lambda logdir: window(logdir, start=a, n=b - a)

    def restore():
        setattr(module, factory, make)
        module.StepTraceWindow = window

    rec["restore"] = restore
    return rec


def loader_alone(ds, B: int, collate=None, want: str = "packed",
                 checked: int = CLI_ITERS, batches: int = CLI_ITERS) -> tuple[float, int]:
    """Clips/s of the port's ``DataLoader`` alone on the card (pinned
    buffers, side-stream copies; no step), over batches 2 .. ``batches`` - 1
    of epoch 0, with the uint8 sum of each of the first ``checked`` batches
    taken on the device held against the sum of its samples on the host (a
    pinned buffer refilled before its copy finished would break it), and
    every frame read by path ``want``.  Returns (clips/s, batches
    checked)."""
    import numpy as np
    import torch

    from bvc_tpu_torch.data.loader import DataLoader

    loader = DataLoader(ds, B, seed=0, max_batches=batches, collate_fn=collate,
                        device="cuda")
    sums = []
    for i, batch in enumerate(loader.epoch(0)):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        video = batch["video"] if isinstance(batch, dict) else batch
        check(video.is_cuda and video.dtype == torch.uint8, f"loader batch {video.device}")
        sums.append(video.sum(dtype=torch.int64))
    torch.cuda.synchronize()
    clips_s = (len(sums) - 2) * B / (time.perf_counter() - t0)
    check(set(ds.served) == {want}, f"frames read by path {dict(ds.served)}: want {want} only")
    for i, idxs in enumerate(loader.sampler.batches(0)[:checked]):
        # the loader's per-sample generator: (seed, epoch, index)
        host = sum(int(ds[(int(j), np.random.default_rng((0, 0, int(j))))].sum(dtype=np.int64))
                   for j in idxs)
        check(int(sums[i]) == host, f"loader batch {i}: device sum {int(sums[i])} != host {host}")
    return clips_s, min(checked, len(sums))


def run_cli_stage(main, argv: list[str], what: str) -> tuple[dict, dict, float]:
    """``main(argv)`` with every launch count set to 0 just before and read
    just after; returns (summary, launches, wall seconds)."""
    import torch

    reset_launches()
    t0 = time.perf_counter()
    summary = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"{what}: main() in {wall:.1f} s launched {launches}", flush=True)
    return summary, launches, wall


def check_cli_launches(launches: dict, per_step: dict, steps: int, what: str) -> None:
    expected = {**{k: 0 for k in launches}, **{k: v * steps for k, v in per_step.items()}}
    check(launches == expected, f"{what}: expected {expected} ({steps} steps), got {launches}")


def check_csv(path: Path, rows: int, loss_col: int, what: str) -> list[float]:
    lines = path.read_text().splitlines()
    losses = [float(line.split(",")[loss_col]) for line in lines[1:]]
    check(len(losses) == rows and all(math.isfinite(x) for x in losses),
          f"{what}: {path.name} has {len(losses)} rows (want {rows}) or a non-finite loss")
    return losses


def check_embed(family: str, ckpt: str, cfg, encoder, clips, what: str) -> float:
    """The checkpoint through ``make_embed_fn`` against the trained encoder
    in memory, cosine per row; returns the lowest."""
    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import make_embed_fn

    emb = make_embed_fn(family, ckpt, cfg)(clips)
    with torch.inference_mode():
        ref = encoder.embed(torch.from_numpy(clips).cuda()).cpu().numpy()
    cos = (emb * ref).sum(1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    print(f"{what}: checkpoint embed vs trained model, cosine min {cos.min():.6f}", flush=True)
    check(bool(cos.min() >= COSINE_MIN), f"{what}: checkpoint embed cosine {cos.min()}")
    return float(cos.min())


def step_only_ms(rec: dict, steps: int = 5) -> tuple[float, float]:
    """Device ms of the CLI's own step on the last batch, already on the
    card, back to back (CUDA events), from the state the CLI trained; and
    the host ms to dispatch one step into an empty queue (the least of 3,
    host clock from a synchronisation to the step's return)."""
    import torch

    state, step, batch = rec["state"], rec["step"], rec["batch"]
    dispatch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        dispatch.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, min(dispatch)


def report_cli(what: str, card: str, B: int, rec: dict, loader_clips_s: float,
               profile_dir: Path, unit: str = "clips") -> dict:
    """The CLI stage's rates in ``unit`` (clips, or SimCLR's pairs) a
    second, printed and returned."""
    summary = json.loads((profile_dir / "summary.json").read_text())
    (a, b), (ta, tb) = CLI_WINDOWS["ms"], CLI_WINDOWS["traced_ms"]
    check(summary["steps"] == tb - ta, f"{what}: traced {summary['steps']} steps, want {tb - ta}")
    trainer = B / (rec["ms"] / 1e3)
    step_ms, dispatch_ms = step_only_ms(rec)
    out = {f"trainer_{unit}_s": trainer, "trainer_ms": rec["ms"],
           f"traced_trainer_{unit}_s": B / (rec["traced_ms"] / 1e3),
           "traced_trainer_ms": rec["traced_ms"], f"loader_{unit}_s": loader_clips_s,
           f"step_only_{unit}_s": B / (step_ms / 1e3), "step_only_ms": step_ms,
           "host_dispatch_ms": dispatch_ms, "loader_stall_ms": rec["stall_ms"],
           "idle_share": summary["idle_share"], "traced_steps": summary["steps"],
           "device_copy_ms": summary["device_copy_ms"]}
    print(f"{what} [{card}]: B={B} trainer {rec['ms']:.2f} ms/step -> {trainer:.1f} {unit}/s "
          f"(steps {a}-{b - 1}); loader alone {loader_clips_s:.1f} "
          f"{unit}/s; step alone {step_ms:.2f} ms -> {out[f'step_only_{unit}_s']:.1f} {unit}/s, "
          f"its host dispatch {dispatch_ms:.1f} ms; the trainer waited "
          f"{rec['stall_ms']:.1f} ms a batch for its loader; traced steps {ta}-{tb - 1}: "
          f"trainer {rec['traced_ms']:.2f} ms/step -> {out[f'traced_trainer_{unit}_s']:.1f} "
          f"{unit}/s, device idle share {summary['idle_share']:.3f} "
          f"(kernels {summary['device_busy_ms']:.1f} of {summary['wall_ms']:.1f} ms; "
          f"copies {summary['device_copy_ms']:.1f} ms)", flush=True)
    return out


def phase_pretrain_cli_videomae(card: str, corpus: tuple[str, str], B: int,
                                per_step: dict) -> dict:
    """``python -m bvc_tpu_torch.cli.pretrain_videomae`` on the card through
    ``main``, at full width (VideoMAE-B, 224 px, 16 frames, tube mask 0.9)
    and the batch ``phase_train`` picked: a 19-step stage from the packed
    corpus (timed at steps 5-11, then timed and traced by ``--profile_dir``
    at steps 12-18), then a 3-step stage
    chained from its checkpoint, then ``--resume y`` of the finished first
    stage, which returns at once.  Each stage launches exactly
    ``per_step`` (the step's own kernels, ``phase_train``) a step, its CSV
    has a finite loss a step, and the first checkpoint embeds a batch
    through ``make_embed_fn`` at cosine >= 0.999 to the trained encoder.
    Both stages write their checkpoint by the async writer
    (``--async_save y``); the chained one keeps a val split (``--keep_val
    y``): each of its val batches launches the step's ``flash_fwd`` count
    and no backward kernel, and its CSV's val rows and the summary's val
    loss are finite.
    Prints the trainer's clips/s, the loader's alone, the step's alone (and
    its host dispatch time), and the device's idle share over the traced
    steps beside the trainer's clips/s over them."""
    import numpy as np

    from bvc_tpu_torch.cli import pretrain_videomae
    from bvc_tpu_torch.data.factory import make_dataset
    from bvc_tpu_torch.training import trainer_videomae

    jpg, pack = corpus
    with tempfile.TemporaryDirectory() as d:
        out, prof = Path(d) / "out", Path(d) / "profile"
        base = ["-jpg_root", jpg, "--pack_root", pack, "-savedir", str(out),
                "--batch_size", str(B), "--n_trainsamples", str(B * CLI_ITERS),
                "--async_save", "y"]
        stage1 = base + ["--run_id", "dev_1_g0_default_0_0", "--max_epoch_iters",
                         str(CLI_ITERS), "--profile_dir", str(prof)]
        rec = timed_steps(trainer_videomae, "make_videomae_train_step")
        loaders, undo = captured_loaders(trainer_videomae)
        try:
            s1, launches, wall = run_cli_stage(pretrain_videomae.main, stage1,
                                               "videomae cli stage 1")
        finally:
            rec["restore"]()
            undo()
        rec["stall_ms"] = loaders[0].stall_ms
        check(rec["calls"] == CLI_ITERS, f"{rec['calls']} steps, want {CLI_ITERS}")
        check_cli_launches(launches, per_step, CLI_ITERS, "videomae cli stage 1")
        losses = check_csv(out / "csvlog_dev_1_g0_default_0_0.csv", CLI_ITERS, 2,
                           "videomae cli stage 1")
        print(f"videomae cli stage 1: losses {losses[0]:.4f} .. {losses[-1]:.4f}", flush=True)
        cfg = pretrain_videomae.config_from_args(pretrain_videomae.build_parser().parse_args(stage1))
        clips = np.random.default_rng(5).integers(0, 256, (4, 16, 224, 224, 3), dtype=np.uint8)
        check_embed("videomae", s1["checkpoint"], cfg.model, rec["state"].model.encoder, clips,
                    "videomae cli")
        result = report_cli("videomae cli", card, B, rec,
                            loader_alone(make_dataset("videomae", cfg.data)["train"], B)[0], prof)
        del rec
        stage2 = base + ["--run_id", "dev_2_g0_default_0_0", "--max_epoch_iters", "3",
                         "-init_checkpoint_path", s1["checkpoint"], "--keep_val", "y"]
        loaders, undo = captured_loaders(trainer_videomae)
        try:
            s2, launches2, _ = run_cli_stage(pretrain_videomae.main, stage2,
                                             "videomae cli stage 2 (--keep_val y)")
        finally:
            undo()
        n_val = len(loaders[1]) if len(loaders) > 1 else 0
        check(n_val >= 1, f"videomae cli stage 2: {n_val} val batches with --keep_val y")
        # each val batch runs the step's forward: its flash_fwd launches, no backward
        check_cli_launches({**launches2, "flash_fwd": launches2["flash_fwd"]
                            - n_val * per_step["flash_fwd"]}, per_step, 3,
                           "videomae cli stage 2 (train steps)")
        rows = check_csv(out / "csvlog_dev_2_g0_default_0_0.csv", 3 + n_val, 2,
                         "videomae cli stage 2")
        val = check_csv(out / "csvlog_dev_2_g0_default_0_0.csv", 3 + n_val, 3,
                        "videomae cli stage 2")[3:]
        check(rows[3:] == [0.0] * n_val and all(v > 0 for v in val)
              and math.isfinite(s2["val_loss"]) and s2["val_loss"] > 0,
              f"videomae cli stage 2: val rows {val}, val loss {s2['val_loss']}")
        print(f"videomae cli stage 2: {n_val} val batches, val loss {s2['val_loss']:.4f}",
              flush=True)
        s3, launches3, wall3 = run_cli_stage(pretrain_videomae.main, stage1 + ["--resume", "y"],
                                             "videomae cli resume of the finished stage")
        check(s3["checkpoint"] == s1["checkpoint"] and not any(launches3.values()) and wall3 < 10,
              f"resume of a finished stage: {s3}, {launches3}, {wall3:.1f} s")
    return {**result, "launches_per_cli_step": {k: v // CLI_ITERS for k, v in launches.items()}}


def phase_pretrain_cli_jepa(card: str, corpus: tuple[str, str], B: int, per_step: dict) -> dict:
    """``python -m bvc_tpu_torch.cli.pretrain_jepa`` on the card through
    ``main``, with the CLI's defaults (V-JEPA ViT-B, 224 px, 2 frames,
    pairs 300 frames apart) at B=64, as
    :func:`phase_pretrain_cli_videomae` does: a 19-step stage (timed steps
    5-11, timed and traced steps 12-18), a 3-step stage chained from it (its epochs count on), and the
    finished stage's ``--resume y``."""
    import numpy as np

    from bvc_tpu_torch.cli import pretrain_jepa
    from bvc_tpu_torch.data.factory import make_dataset
    from bvc_tpu_torch.training import trainer_jepa

    jpg, pack = corpus
    with tempfile.TemporaryDirectory() as d:
        out, prof = Path(d) / "out", Path(d) / "profile"
        base = ["-jpg_root", jpg, "--pack_root", pack, "-savedir", str(out),
                "--batch_size", str(B), "--n_trainsamples", str(B * CLI_ITERS)]
        stage1 = base + ["--run_id", "dev_1_g0_default_0_0", "--max_epoch_iters",
                         str(CLI_ITERS), "--profile_dir", str(prof)]
        rec = timed_steps(trainer_jepa, "make_jepa_train_step")
        loaders, undo = captured_loaders(trainer_jepa)
        try:
            s1, launches, _ = run_cli_stage(pretrain_jepa.main, stage1, "jepa cli stage 1")
        finally:
            rec["restore"]()
            undo()
        rec["stall_ms"] = loaders[0].stall_ms
        check(rec["calls"] == CLI_ITERS, f"{rec['calls']} steps, want {CLI_ITERS}")
        check_cli_launches(launches, per_step, CLI_ITERS, "jepa cli stage 1")
        losses = check_csv(out / "csvlog_dev_1_g0_default_0_0.csv", CLI_ITERS, 2,
                           "jepa cli stage 1")
        print(f"jepa cli stage 1: losses {losses[0]:.4f} .. {losses[-1]:.4f}", flush=True)
        cfg = pretrain_jepa.config_from_args(pretrain_jepa.build_parser().parse_args(stage1))
        clips = np.random.default_rng(6).integers(0, 256, (8, 2, 224, 224, 3), dtype=np.uint8)
        check_embed("jepa", s1["checkpoint"], cfg.model, rec["state"].model.encoder, clips,
                    "jepa cli")
        collate = trainer_jepa.make_mask_collate(cfg, CLI_ITERS)[0]
        result = report_cli("jepa cli", card, B, rec,
                            loader_alone(make_dataset("jepa", cfg.data)["train"], B, collate)[0],
                            prof)
        del rec
        stage2 = base + ["--run_id", "dev_2_g0_default_0_0", "--max_epoch_iters", "3",
                         "-init_checkpoint_path", s1["checkpoint"]]
        _, launches2, _ = run_cli_stage(pretrain_jepa.main, stage2, "jepa cli stage 2")
        check_cli_launches(launches2, per_step, 3, "jepa cli stage 2")
        rows = (out / "csvlog_dev_2_g0_default_0_0.csv").read_text().splitlines()[1:]
        check(len(rows) == 3 and {r.split(",")[0] for r in rows} == {"2"},
              f"jepa cli stage 2 rows {rows}: want 3 of epoch 2 (chained epochs count on)")
        s3, launches3, wall3 = run_cli_stage(pretrain_jepa.main, stage1 + ["--resume", "y"],
                                             "jepa cli resume of the finished stage")
        check(s3["checkpoint"] == s1["checkpoint"] and not any(launches3.values()) and wall3 < 10,
              f"resume of a finished stage: {s3}, {launches3}, {wall3:.1f} s")
    return {**result, "launches_per_cli_step": {k: v // CLI_ITERS for k, v in launches.items()}}


def phase_remat(card: str, B: int) -> dict:
    """One VideoMAE-B step at ``remat=True`` against ``remat=False`` from the
    same weights, clips and mask at batch ``B``: gradient cosine >= 0.9995
    per parameter tensor, both peak memories, and the launches (the
    recompute runs each block's forward again: 32 ``flash_fwd`` a step)."""
    import gc

    import numpy as np
    import torch

    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    video = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (B, 16, 224, 224, 3), dtype=np.uint8)).cuda()
    grads, peaks, launches, ms = {}, {}, {}, {}
    for remat in (False, True):
        cfg = ModelConfig(remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = TrainState.create(VideoMAEPretrain(cfg, seed=0), OptimConfig(), seed=1)
        step = make_videomae_train_step(cfg, MaskConfig())
        reset_launches()
        step(state, video)
        torch.cuda.synchronize()
        launches[remat] = read_launches()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
        grads[remat] = {n: p.grad.flatten().float() for n, p in state.model.named_parameters()}
        ms[remat] = time_ms(lambda: step(state, video), iters=3, warmup=1)
        del state, step
    cosine = torch.nn.functional.cosine_similarity
    per_tensor = sorted((cosine(grads[True][n], grads[False][n], dim=0).item(), n)
                        for n in grads[False])
    print(f"remat [{card}]: B={B} step {ms[False]:.2f} ms without remat, {ms[True]:.2f} ms "
          f"with; peak memory {peaks[False]:.2f} GiB without, "
          f"{peaks[True]:.2f} GiB with; flash_fwd launches {launches[False]['flash_fwd']} -> "
          f"{launches[True]['flash_fwd']}; gradient cosine per tensor, lowest: "
          + ", ".join(f"{n} {c:.6f}" for c, n in per_tensor[:3]), flush=True)
    check(per_tensor[0][0] >= REMAT_COSINE_MIN,
          f"remat gradient cosine of {per_tensor[0][1]} {per_tensor[0][0]} < {REMAT_COSINE_MIN}")
    layers = cfg.depth + cfg.decoder_depth
    expected = {**launches[False], "flash_fwd": 2 * layers}
    check(launches[True] == expected, f"remat step launched {launches[True]}, want {expected}")
    check(peaks[True] < peaks[False], f"remat peak {peaks[True]} >= {peaks[False]} GiB")
    del grads, video
    gc.collect()
    torch.cuda.empty_cache()
    return {"peak_gib": peaks, "launches": launches[True], "ms": ms,
            "min_cosine": per_tensor[0][0]}


SIMCLR_ARCH, SIMCLR_HEAD, SIMCLR_SIZE = "resnet18", 512, 224
SIMCLR_AGREE_PAIRS = 16  # the agreement checks' batch
SIMCLR_BATCHES = (256, 128, 64)  # pairs, the ladder of tools/bench_families.py:119
SIMCLR_LOSS_RTOL = 1e-4  # f32 step on the card (TF32 off) against the CPU
SIMCLR_STATS_RTOL = 1e-4  # running statistics: max|diff| over max|CPU|, per buffer
# bf16 step against the f32 step on the card, set from emulate_simclr_bf16(224,
# 16) on the CPU, where the sound step read at worst 7.6e-5, 0.872 at a
# BatchNorm bias and 3.3e-3, and its unsound_bf16 controls 'bn' (1.6e-4, 0.644,
# 7.9e-3 at best for them) and 'info_nce' (3.5e-3, 0.692, 3.3e-3) each fail two
SIMCLR_BF16_LOSS_RTOL = 1e-3
SIMCLR_BF16_COSINE_MIN = 0.8  # per parameter tensor
SIMCLR_BF16_STATS_RTOL = 5e-3
SIMCLR_CORPUS = (3, 2000)  # subjects x frames: 19 x 256 pairs 900 frames apart need 5765


class tf32_off:
    """cuDNN and cuBLAS in full f32 (no TF32) inside the block."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def simclr_pairs(B: int, size: int, seed: int):
    """``[B, 2, size, size, 3]`` uint8 pairs from numpy."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (B, 2, size, size, 3), dtype=np.uint8)


def simclr_step_readings(model, pairs, device: str, dtype, fault: str | None = None) -> dict:
    """One SimCLR step of a copy of ``model`` at compute ``dtype`` on
    ``device`` through the port's entry points (``TrainState.create``,
    ``make_simclr_train_step``, the CLI's SGD defaults), under ``fault``
    (:class:`unsound_bf16`) if given: the loss, every parameter's gradient
    and every running statistic, on the CPU in f32."""
    import contextlib
    import copy

    import torch

    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_simclr_train_step
    from bvc_tpu_torch.utils.config import OptimConfig

    m = copy.deepcopy(model)
    m.dtype = dtype
    state = TrainState.create(m, OptimConfig(), seed=1, device=device)
    with unsound_bf16(fault) if fault else contextlib.nullcontext():
        loss = make_simclr_train_step(0.1)(state, torch.from_numpy(pairs))["loss"].item()
    return {"loss": loss,
            "grads": {n: p.grad.float().cpu() for n, p in state.model.named_parameters()},
            "stats": {n: b.float().cpu() for n, b in state.model.named_buffers()
                      if "running" in n}}


class unsound_bf16:
    """A bf16 step in lower precision than the port's, the control that the
    bf16 limits must fail: ``'bn'``, BatchNorm's statistics taken and
    applied in bf16 (the port takes them in f32); ``'info_nce'``, InfoNCE's
    cosine matrix and logsumexp in bf16 (the port's are f32)."""

    KINDS = ("bn", "info_nce")

    def __init__(self, kind: str):
        assert kind in self.KINDS, kind
        self.kind = kind

    def __enter__(self):
        import torch

        from bvc_tpu_torch.objectives import contrastive

        if self.kind == "bn":
            self.saved = torch.nn.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward
            torch.nn.BatchNorm2d.forward = _bn_in_bf16
        else:
            self.saved = contrastive, "_cosine_matrix", contrastive._cosine_matrix

            def cosine_bf16(feats):
                f = feats.bfloat16()
                f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-8)
                return f @ f.T

            contrastive._cosine_matrix = cosine_bf16

    def __exit__(self, *exc):
        setattr(*self.saved)


def _bn_in_bf16(bn, x):
    """``BatchNorm2d.forward`` with its statistics, running statistics'
    update and affine in ``x``'s dtype."""
    import torch

    dims = (0, 2, 3)
    if bn.training:
        mean = x.mean(dims)
        var = (x - mean[:, None, None]).square().mean(dims)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            bn.running_mean.copy_((0.9 * bn.running_mean.to(x.dtype) + 0.1 * mean))
            bn.running_var.copy_((0.9 * bn.running_var.to(x.dtype) + 0.1 * var * n / (n - 1)))
            bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype)
    scale = bn.weight.to(x.dtype) * torch.rsqrt(var + bn.eps)
    return (x - mean[:, None, None]) * scale[:, None, None] + bn.bias.to(x.dtype)[:, None, None]


def compare_simclr_readings(got: dict, want: dict) -> dict:
    """Loss relative difference, the lowest gradient cosine over the
    parameter tensors, and the largest running-statistic difference over
    its buffer's largest magnitude."""
    import torch

    cos = sorted((torch.nn.functional.cosine_similarity(
        got["grads"][n].flatten(), want["grads"][n].flatten(), dim=0).item(), n)
        for n in want["grads"])
    stats = sorted(((got["stats"][n] - w).abs().max().item() / w.abs().max().item(), n)
                   for n, w in want["stats"].items())
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "min_cosine": cos[0][0], "min_cosine_tensor": cos[0][1],
            "stats_rel": stats[-1][0], "stats_buffer": stats[-1][1]}


def emulate_simclr_bf16(size: int, pairs: int, seeds=(0, 1, 2), device: str = "cpu",
                        fault: str | None = None) -> list[dict]:
    """The bf16 SimCLR step (under ``fault``, :class:`unsound_bf16`, if
    given) against the f32 one (``compare_simclr_readings``) from the same
    weights and pairs, for each seed, on ``device``: how the limits of the
    card's check were set, from the CPU (``python3 -c "import chip_smoke;
    print(chip_smoke.emulate_simclr_bf16(224, 4))"``)."""
    import torch

    from bvc_tpu_torch.models.resnet import ResNet

    out = []
    for seed in seeds:
        model = ResNet(SIMCLR_ARCH, SIMCLR_HEAD, seed=seed)
        batch = simclr_pairs(pairs, size, seed=seed + 1)
        out.append(compare_simclr_readings(
            simclr_step_readings(model, batch, device, torch.bfloat16, fault),
            simclr_step_readings(model, batch, device, torch.float32)))
    return out


def within_bf16_limits(r: dict) -> bool:
    return (r["loss_rel"] <= SIMCLR_BF16_LOSS_RTOL and r["min_cosine"] >= SIMCLR_BF16_COSINE_MIN
            and r["stats_rel"] <= SIMCLR_BF16_STATS_RTOL)


def simclr_train_flops_per_pair(arch: str = SIMCLR_ARCH, head: int = SIMCLR_HEAD,
                                size: int = SIMCLR_SIZE) -> tuple[float, float]:
    """Operations of one SimCLR training step a pair: the convolutions'
    and linears' FLOPs of the forward and backward of one pair (2 images),
    as ``torch.utils.flop_counter`` counts them on the CPU (the stem's
    input gradient is not computed); and 3 x the forward's, for a check."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from bvc_tpu_torch.models.resnet import ResNet
    from bvc_tpu_torch.objectives.contrastive import info_nce_loss

    model = ResNet(arch, head)
    x = torch.zeros(2, size, size, 3)
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            model(x)
    with FlopCounterMode(display=False) as step:
        info_nce_loss(model(x)).backward()
    return float(step.get_total_flops()), 3.0 * fwd.get_total_flops()


def sum_launches(*counts: dict[str, int]) -> dict[str, int]:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def no_launches(what: str) -> dict[str, int]:
    """Fail if any port kernel launched since the last ``reset_launches``;
    returns the counts read."""
    launches = read_launches()
    check(not any(launches.values()), f"{what} launched port kernels: {launches}")
    return launches


def phase_simclr_step(card: str) -> dict:
    """The SimCLR step at full width (ResNet-18, 224 px, head 512, B=16
    pairs) from the same weights and pairs: the f32 step on the card with
    TF32 off against the same port step on the CPU (loss within 1e-4
    relative, every parameter's gradient cosine >= 0.9995, running
    statistics within 1e-4), then the bf16 step against the f32 step on the
    card under the limits set from a CPU emulation; no port kernel
    launches."""
    import torch

    from bvc_tpu_torch.models.resnet import ResNet

    model = ResNet(SIMCLR_ARCH, SIMCLR_HEAD, seed=0)
    pairs = simclr_pairs(SIMCLR_AGREE_PAIRS, SIMCLR_SIZE, seed=1)
    reset_launches()
    with tf32_off():
        card32 = simclr_step_readings(model, pairs, "cuda", torch.float32)
    card16 = simclr_step_readings(model, pairs, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    launches = no_launches("the SimCLR steps")
    cpu32 = simclr_step_readings(model, pairs, "cpu", torch.float32)
    f32 = compare_simclr_readings(card32, cpu32)
    bf16 = compare_simclr_readings(card16, card32)
    controls = {kind: compare_simclr_readings(
        simclr_step_readings(model, pairs, "cuda", torch.bfloat16, kind), card32)
        for kind in unsound_bf16.KINDS}
    for what, r in (("f32 card (TF32 off) vs CPU", f32), ("bf16 vs f32, card", bf16),
                    *((f"control: bf16 with {k} in bf16, vs f32, card", r)
                      for k, r in controls.items())):
        print(f"simclr step, {what}: loss {r['loss_rel']:.2e} relative; lowest gradient "
              f"cosine {r['min_cosine']:.6f} ({r['min_cosine_tensor']}); running statistics "
              f"{r['stats_rel']:.2e} ({r['stats_buffer']})", flush=True)
    print(f"simclr step: losses CPU f32 {cpu32['loss']:.6f}, card f32 {card32['loss']:.6f}, "
          f"card bf16 {card16['loss']:.6f}", flush=True)
    check(f32["loss_rel"] <= SIMCLR_LOSS_RTOL and f32["min_cosine"] >= TENSOR_COSINE_MIN
          and f32["stats_rel"] <= SIMCLR_STATS_RTOL, f"simclr f32 step, card vs CPU: {f32}")
    limits = (SIMCLR_BF16_LOSS_RTOL, SIMCLR_BF16_COSINE_MIN, SIMCLR_BF16_STATS_RTOL)
    check(within_bf16_limits(bf16), f"simclr bf16 step vs f32: {bf16} (limits {limits})")
    for kind, r in controls.items():
        check(not within_bf16_limits(r), f"the bf16 limits {limits} pass the unsound "
              f"control {kind!r}: {r}")
    return {"f32_vs_cpu": f32, "bf16_vs_f32": bf16, "controls": controls, "launches": launches}


def phase_simclr_rate(card: str) -> dict:
    """The bf16 SimCLR step alone (ResNet-18, 224 px, head 512, the CLI's
    SGD) at the largest batch in ``SIMCLR_BATCHES`` that fits: device time
    of 10 steps after 3 (CUDA events), pairs/s and images/s, MFU against
    989 TFLOP/s from :func:`simclr_train_flops_per_pair`, peak memory; no
    port kernel launches."""
    import gc

    import torch

    from bvc_tpu_torch.models.resnet import ResNet
    from bvc_tpu_torch.training.state import TrainState
    from bvc_tpu_torch.training.steps import make_simclr_train_step
    from bvc_tpu_torch.utils.config import OptimConfig

    flops, flops_3fwd = simclr_train_flops_per_pair()
    print(f"simclr: {flops / 1e9:.2f} GFLOP a pair counted (forward and backward), "
          f"3 x forward {flops_3fwd / 1e9:.2f}", flush=True)
    step = make_simclr_train_step(0.1)
    for B in SIMCLR_BATCHES:
        try:
            pairs = torch.from_numpy(simclr_pairs(B, SIMCLR_SIZE, seed=2)).cuda()
            reset_launches()
            ms, losses, state = time_train_steps(
                lambda: TrainState.create(ResNet(SIMCLR_ARCH, SIMCLR_HEAD, "bfloat16", seed=0),
                                          OptimConfig(), seed=1), step, pairs)
            fits = True
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:
            print(f"simclr: B={B} does not fit", flush=True)
            state = pairs = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        launches = no_launches("the SimCLR rate steps")
        check(all(math.isfinite(x) for x in losses), f"non-finite SimCLR loss: {losses}")
        pairs_s = B / (ms / 1e3)
        out = {"launches": launches, "B": B, "step_ms": ms, "pairs_s": pairs_s, "images_s": 2 * pairs_s,
               "mfu": flops * pairs_s / PEAK_BF16_FLOPS, "gflop_per_pair": flops / 1e9,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"simclr train [{card}]: B={B} pairs, step {ms:.3f} ms -> {pairs_s:.1f} pairs/s, "
              f"{2 * pairs_s:.1f} images/s, MFU {out['mfu']:.4f}, peak memory "
              f"{out['peak_gib']:.2f} GiB; losses {losses[0]:.4f} .. {losses[-1]:.4f}",
              flush=True)
        break
    else:
        fail(f"no SimCLR batch in {SIMCLR_BATCHES} fits")
    del state, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_decoder() -> str | None:
    """The JPEG decoder the augmented transforms would use: 'cv2', 'PIL' or
    None."""
    for name in ("cv2", "PIL.Image"):
        try:
            __import__(name)
            return name.split(".")[0]
        except ImportError:
            pass
    return None


def save_jpeg(path: Path, img, decoder: str) -> None:
    """One uint8 RGB frame as a JPEG at quality 90, by ``decoder``'s package."""
    if decoder == "cv2":
        import cv2

        cv2.imwrite(str(path), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    else:
        from PIL import Image

        Image.fromarray(img).save(path, quality=90)


def write_simclr_corpus(root: Path, decoder: str, subjects: list[str] | None = None) -> str:
    """``subjects`` (default: the first ``SIMCLR_CORPUS[0]`` of
    ``get_group('g0')``) x ``SIMCLR_CORPUS[1]`` frames of smooth random
    images (56 px noise, upsampled 4x), as JPEGs written by ``decoder``'s
    package; returns the JPEG root."""
    import concurrent.futures as cf

    import numpy as np

    from bvc_tpu_torch.data.indexing import get_group

    n_subjects, n_frames = SIMCLR_CORPUS
    rng = np.random.default_rng(3)
    with cf.ThreadPoolExecutor(8) as pool:
        for subject in subjects or get_group("g0")[:n_subjects]:
            (root / subject).mkdir(parents=True)
            small = rng.integers(0, 256, (n_frames, 56, 56, 3), dtype=np.uint8)
            imgs = small.repeat(4, axis=1).repeat(4, axis=2)
            list(pool.map(lambda i: save_jpeg(root / subject / f"frame_{i:05d}.jpg", imgs[i],
                                              decoder), range(n_frames)))
    return str(root)


def phase_simclr_embed(card: str) -> dict:
    """SimCLR extraction through ``untrained_embed_fn("simclr", ...)``:
    clips/s at B=64 16-frame clips (host clock over 10 calls after 2,
    numpy in and out), and cosine >= 0.999 per row to the port on the CPU
    from the same weights (cuDNN at its default TF32 setting); no port
    kernel launches."""
    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(family="simclr", architecture=SIMCLR_ARCH)
    clips = np.zeros((64, 16, SIMCLR_SIZE, SIMCLR_SIZE, 3), np.float32)
    clips[:, -1] = np.random.default_rng(4).standard_normal(clips[:, -1].shape)
    reset_launches()
    fn = untrained_embed_fn("simclr", cfg, seed=5)
    for _ in range(2):
        out = fn(clips)
    t0 = time.perf_counter()
    for _ in range(10):
        out = fn(clips)
    clips_s = 10 * 64 / (time.perf_counter() - t0)
    launches = no_launches("SimCLR extraction")
    ref = untrained_embed_fn("simclr", cfg, seed=5, device="cpu")(clips[:4])
    cos = (out[:4] * ref).sum(1) / (np.linalg.norm(out[:4], axis=1) * np.linalg.norm(ref, axis=1))
    print(f"simclr embed [{card}]: B=64 16-frame clips, {clips_s:.1f} clips/s; cosine to the "
          f"CPU min {cos.min():.6f} (TF32 {torch.backends.cudnn.allow_tf32})", flush=True)
    check(out.shape == (64, 512) and bool(np.isfinite(out).all()), f"simclr embed {out.shape}")
    check(bool(cos.min() >= COSINE_MIN), f"simclr embed cosine to the CPU {cos.min()}")
    return {"clips_s": clips_s, "min_cosine_to_cpu": float(cos.min()), "launches": launches}


def write_cifar(root: Path, n: int = 10) -> str:
    """A synthetic CIFAR-10 test split in the reader's own pickle format."""
    import pickle

    import numpy as np

    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.default_rng(6)
    with open(base / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                     b"labels": list(range(n))}, f)
    return str(root)


def phase_compute_embeddings(card: str, simclr_ckpt: str, root: Path) -> dict[str, int]:
    """``python -m bvc_tpu_torch.cli.compute_embeddings`` through ``main``
    over a synthetic CIFAR-10 test split (10 images as 16-frame clips):
    ``--family simclr`` with the CLI stage's checkpoint (512 wide, no
    launches) and ``--family videomae`` untrained (768 wide, 12
    ``flash_fwd`` launches: one embed call).  Returns the SimCLR run's
    launch counts."""
    import pandas as pd

    from bvc_tpu_torch.cli import compute_embeddings

    cifar = write_cifar(root / "cifar")
    for family, ckpt, width, per_call in (("simclr", simclr_ckpt, 512, {}),
                                          ("videomae", "na", 768, {"flash_fwd": 12})):
        argv = ["-ds_task", "cifar10", "-vid_root", cifar, "-savedir", str(root / "emb"),
                "--family", family, "--dataset_split", "test", "-init_checkpoint_path", ckpt]
        results, launches, wall = run_cli_stage(compute_embeddings.main, argv,
                                                f"compute_embeddings {family}")
        check_cli_launches(launches, per_call, 1, f"compute_embeddings {family}")
        if family == "simclr":
            simclr_launches = launches
        df = pd.read_csv(results[0]["csv"])
        print(f"compute_embeddings {family} [{card}]: {df.shape[0]} rows of width "
              f"{df.shape[1] - 1} in {wall:.1f} s", flush=True)
        check(len(results) == 1 and df.shape == (10, width + 1)
              and bool(df.iloc[:, 1:].notna().all().all()),
              f"compute_embeddings {family}: {results}, CSV {df.shape}")
    return simclr_launches


def host_frame_ms(ds, frames: int = 64) -> dict:
    """Host ms a frame of a SimCLR pair dataset's Python path, one thread:
    the JPEG decode, then the augmentations (``FrameTransform``)."""
    import numpy as np

    from bvc_tpu_torch.data.transforms import decode_jpeg

    paths = [fp for pair in ds.pairlist[:frames // 2] for fp in pair]
    t0 = time.perf_counter()
    imgs = [decode_jpeg(fp) for fp in paths]
    t1 = time.perf_counter()
    for i, img in enumerate(imgs):
        ds.transform(img, np.random.default_rng(i))
    t2 = time.perf_counter()
    out = {"decode_ms_per_frame": (t1 - t0) * 1e3 / len(paths),
           "augment_ms_per_frame": (t2 - t1) * 1e3 / len(paths)}
    print(f"simclr host path, one thread: decode {out['decode_ms_per_frame']:.2f} ms a frame, "
          f"augment ({ds.transform.augs}) {out['augment_ms_per_frame']:.2f} ms a frame", flush=True)
    return out


def phase_pretrain_cli_simclr(card: str, B: int, root: Path) -> dict:
    """``python -m bvc_tpu_torch.cli.pretrain_simclr`` through ``main`` with
    the CLI's defaults (ResNet-18, head 512, ``--interval 900``, ``--augs
    cjo``) at batch ``B``: a 19-step stage (timed at steps 5-11, timed and
    traced at 12-18), a 3-step stage chained from its checkpoint, and
    ``--resume y`` of the finished stage, over JPEGs (the augmented
    transforms decode with cv2 or PIL: the phase fails without either).  No
    stage launches a port kernel; the checkpoint embeds through
    ``make_embed_fn("simclr")`` at cosine >= 0.999 to the trained model;
    ``compute_embeddings`` then runs over a synthetic CIFAR-10.  Returns the
    stage's rates and, under ``"launches"``, the counts read over all of
    these runs."""
    import copy

    import numpy as np
    import torch

    from bvc_tpu_torch.cli import pretrain_simclr
    from bvc_tpu_torch.data.factory import make_dataset
    from bvc_tpu_torch.training import trainer_simclr

    decoder = host_decoder()
    check(decoder is not None, "neither cv2 nor PIL imports: --augs cjo cannot decode JPEGs")
    t0 = time.perf_counter()
    jpg = write_simclr_corpus(root / "simclr_corpus", decoder)
    print(f"simclr cli: corpus of {SIMCLR_CORPUS[0]} x {SIMCLR_CORPUS[1]} frames written in "
          f"{time.perf_counter() - t0:.1f} s (JPEGs by {decoder})", flush=True)
    out, prof = root / "simclr_out", root / "simclr_profile"
    base = ["-jpg_root", jpg, "-savedir", str(out), "--batch_size", str(B),
            "--n_trainsamples", str(B * CLI_ITERS)]
    stage1 = base + ["--run_id", "dev_1_g0_default_0_0", "--max_epoch_iters", str(CLI_ITERS),
                     "--profile_dir", str(prof)]
    rec = timed_steps(trainer_simclr, "make_simclr_train_step")
    loaders, undo = captured_loaders(trainer_simclr)
    try:
        s1, launches, _ = run_cli_stage(pretrain_simclr.main, stage1, "simclr cli stage 1")
    finally:
        rec["restore"]()
        undo()
    rec["stall_ms"] = loaders[0].stall_ms
    check(rec["calls"] == CLI_ITERS, f"{rec['calls']} steps, want {CLI_ITERS}")
    check_cli_launches(launches, {}, CLI_ITERS, "simclr cli stage 1")
    losses = check_csv(out / "csvlog_dev_1_g0_default_0_0.csv", CLI_ITERS, 2,
                       "simclr cli stage 1")
    print(f"simclr cli stage 1: losses {losses[0]:.4f} .. {losses[-1]:.4f}; frames by path "
          f"{dict(loaders[0].dataset.served)}", flush=True)
    cfg = pretrain_simclr.config_from_args(pretrain_simclr.build_parser().parse_args(stage1))
    trained = copy.deepcopy(rec["state"].model).eval()
    trained.dtype = torch.float32  # make_embed_fn embeds in f32
    clips = np.random.default_rng(7).standard_normal((4, 2, 224, 224, 3)).astype(np.float32)
    reset_launches()
    check_embed("simclr", s1["checkpoint"], cfg.model, trained, clips, "simclr cli")
    embed_launches = no_launches("the SimCLR checkpoint embed")
    del trained
    ds = make_dataset("simclr", cfg.data)["train"]
    host = host_frame_ms(ds)
    # one batch's host check: each of its 512 frames is decoded and augmented again
    # 8 batches: at the host's 190-220 pairs/s each takes over a second
    loader_pairs_s = loader_alone(ds, B, want="python", checked=1, batches=8)[0]
    result = {**report_cli("simclr cli", card, B, rec, loader_pairs_s, prof, unit="pairs"),
              "augs": cfg.data.augs, "decoder": decoder, **host}
    del rec
    stage2 = base + ["--run_id", "dev_2_g0_default_0_0", "--max_epoch_iters", "3",
                     "-init_checkpoint_path", s1["checkpoint"]]
    _, launches2, _ = run_cli_stage(pretrain_simclr.main, stage2, "simclr cli stage 2")
    check_cli_launches(launches2, {}, 3, "simclr cli stage 2")
    check_csv(out / "csvlog_dev_2_g0_default_0_0.csv", 3, 2, "simclr cli stage 2")
    s3, launches3, wall3 = run_cli_stage(pretrain_simclr.main, stage1 + ["--resume", "y"],
                                         "simclr cli resume of the finished stage")
    check(s3["checkpoint"] == s1["checkpoint"] and not any(launches3.values()) and wall3 < 10,
          f"resume of a finished stage: {s3}, {launches3}, {wall3:.1f} s")
    ce_launches = phase_compute_embeddings(card, s1["checkpoint"], root)
    result["launches"] = sum_launches(launches, embed_launches, launches2, launches3,
                                      ce_launches)
    return result


# the curriculum phase: (preset, family, batch, extra flags); stage length is
# its only cut, CURRICULUM_ITERS steps a stage, and the corpus is written small
CURRICULUM_RUNS = (("generative", "videomae", 16, ["--untrained_baseline", "y"]),
                   ("predictive", "jepa", 16, ["--extract_quantize", "int8"]),
                   ("contrastive", "simclr", 32, []))
CURRICULUM_ITERS = 3
# 180-frame fold segments: each fold of a 2000-frame subject holds 540 or more
# frames, and stage 1's two g0 subjects 1440, enough for contrastive pairs 900
# frames apart
CURRICULUM_SEGMENT_MINUTES = 0.1
CURRICULUM_CLIPS = 8  # SSv2 clips a split: two classes of four
CURRICULUM_WIDTHS = {"videomae": 768, "jepa": 768, "simclr": 512}  # embedding widths
MANIFEST_KEYS = {"curriculum", "stages", "final_checkpoint", "extraction"}
STAGE_KEYS = {"stage", "train_group", "fold", "run_id", "overrides", "checkpoint"}


def write_ssv2(root: Path, decoder: str) -> str:
    """An SSv2 layout (``{train,val}/<id>/<n>.jpg``, ``CURRICULUM_CLIPS``
    clips a split of 8 frames of 112 px noise) and its label CSVs
    (``train_labels.csv``, ``val_labels.csv``: ``<id>.webm`` -> one of two
    classes).  Returns the root."""
    import numpy as np

    rng = np.random.default_rng(8)
    for split, first in (("train", 0), ("val", 100)):
        rows = ["fname,label"]
        for i in range(CURRICULUM_CLIPS):
            clip = root / split / str(first + i)
            clip.mkdir(parents=True)
            for f in range(8):
                save_jpeg(clip / f"{f}.jpg", rng.integers(0, 256, (112, 112, 3), dtype=np.uint8),
                          decoder)
            rows.append(f"{first + i}.webm,{'ab'[i % 2]}")
        (root / f"{split}_labels.csv").write_text("\n".join(rows) + "\n")
    return str(root)


class curriculum_timers:
    """Time each stage's trainer and each extraction sweep that
    ``run_curriculum`` starts, on the host clock, by wrapping the driver's
    ``_trainer_for`` and ``_run_extraction`` while the ``with`` lasts (no
    synchronisation is added: a stage ends with its checkpoint copied to the
    host, a sweep with its CSVs written).  ``stages``: (run id, seconds);
    ``sweeps``: (CSVs written, seconds)."""

    def __init__(self):
        self.stages, self.sweeps = [], []

    def __enter__(self):
        from bvc_tpu_torch.curriculum import driver

        make, extract = driver._trainer_for, driver._run_extraction

        def trainer_for(family):
            run = make(family)

            def stage(cfg, **kw):
                t0 = time.perf_counter()
                summary = run(cfg, **kw)
                self.stages.append((cfg.run_id, time.perf_counter() - t0))
                return summary
            return stage

        def sweep(*args, **kw):
            t0 = time.perf_counter()
            outs = extract(*args, **kw)
            self.sweeps.append((len(outs), time.perf_counter() - t0))
            return outs

        self.restore = (make, extract)
        driver._trainer_for, driver._run_extraction = trainer_for, sweep
        return self

    def __exit__(self, *exc):
        from bvc_tpu_torch.curriculum import driver

        driver._trainer_for, driver._run_extraction = self.restore


def check_curriculum(family: str, out: Path, results: dict, sweep_ids: list[str],
                     width: int) -> None:
    """Each stage's run id and fold, stage k+1 started from stage k's
    ``model_{run_id}.pth.tar``, the manifest with the JAX package's keys,
    and a train and a test CSV of ``CURRICULUM_CLIPS`` finite rows a run id
    of ``sweep_ids``."""
    import numpy as np
    import pandas as pd
    import yaml

    from bvc_tpu_torch.curriculum import CURRICULA

    what = f"curriculum {family}"
    stages = results["stages"]
    want = [(f"dev_{k}_{g}_default_{k % 3}_0", k % 3)
            for k, g in enumerate(CURRICULA["dev"][:len(stages)], start=1)]
    check([(st["run_id"], st["fold"]) for st in stages] == want,
          f"{what}: stages {[(st['run_id'], st['fold']) for st in stages]}, want {want}")
    init = "na"
    for st in stages:
        params = yaml.safe_load((out / f"params_{st['run_id']}.yaml").read_text())
        check(params["init_checkpoint_path"] == init,
              f"{what}: {st['run_id']} started from {params['init_checkpoint_path']}, not {init}")
        init = str(out / f"model_{st['run_id']}.pth.tar")
        check(st["checkpoint"] == init and Path(init).is_file(), f"{what}: no {init}")
    manifest = json.loads((out / "curriculum_dev_default_0.json").read_text())
    check(set(manifest) == MANIFEST_KEYS - ({"extraction"} if not sweep_ids else set())
          and all(STAGE_KEYS <= set(st) for st in manifest["stages"])
          and manifest["final_checkpoint"] == init,
          f"{what}: manifest keys {sorted(manifest)}, stage keys "
          f"{[sorted(st) for st in manifest['stages']]}")
    for rid in sweep_ids:
        for sub in ("", "test"):
            path = out / "benchmarks" / "ssv2" / sub / f"embeddings_{rid}.csv"
            check(path.is_file(), f"{what}: no {path}")
            dims = pd.read_csv(path).filter(like="dim").to_numpy()
            check(dims.shape == (CURRICULUM_CLIPS, width) and bool(np.isfinite(dims).all()),
                  f"{what}: {path.name} ({sub or 'train'}) of shape {dims.shape} or not finite")


def score_curriculum(family: str, out: Path, ssv2: str, sweep_ids: list[str]) -> float:
    """``python -m bvc_tpu_torch.cli.evaluate_embeddings`` through ``main``
    over the sweep's CSVs, ``--eval_type linear`` and ``nn``: one row a run
    id, finite scores.  Returns the wall seconds of both."""
    import numpy as np

    from bvc_tpu_torch.cli import evaluate_embeddings

    t0 = time.perf_counter()
    for eval_type, cols in (("linear", ["category"]), ("nn", ["Top1", "Top5", "Top10"])):
        df = evaluate_embeddings.main(
            ["-emb_root", str(out / "benchmarks" / "ssv2"), "-ds_task", "ssv2",
             "--ssv2_train_labels", f"{ssv2}/train_labels.csv",
             "--ssv2_test_labels", f"{ssv2}/val_labels.csv", "--eval_type", eval_type])
        check(sorted(df["Stage"]) == sorted(int(r.split("_")[1]) for r in sweep_ids)
              and bool(np.isfinite(df[cols].to_numpy(dtype=float)).all()),
              f"curriculum {family}: {eval_type} scores\n{df}")
    svm_sweep(family, out, ssv2, sweep_ids)
    return time.perf_counter() - t0


def svm_sweep(family: str, out: Path, ssv2: str, sweep_ids: list[str]) -> None:
    """The 'svm' probe (``get_separability_score(..., method="svm")``,
    liblinear's LinearSVC in ``native/linear_svc.cpp``) twice over each
    sweep checkpoint's train and test CSVs: finite scores, the same scores
    and predictions from both fits; prints each fit's seconds."""
    import numpy as np
    import pandas as pd

    from bvc_tpu_torch.evalbench.evaluators import SSv2Eval
    from bvc_tpu_torch.evalbench.scores import get_separability_score

    labels = SSv2Eval({"train": f"{ssv2}/train_labels.csv", "test": f"{ssv2}/val_labels.csv"})
    emb, secs = out / "benchmarks" / "ssv2", []
    for rid in sweep_ids:
        train, test = (labels.add_labels_to_df(pd.read_csv(emb / sub / f"embeddings_{rid}.csv"),
                                                phase)
                       for phase, sub in (("train", ""), ("test", "test")))
        fits = []
        for _ in range(2):
            t0 = time.perf_counter()
            fits.append(get_separability_score(train, test, "category", method="svm",
                                               ret_preds=True))
            secs.append(time.perf_counter() - t0)
        check(bool(np.isfinite(fits[0][:2]).all()) and fits[0][:2] == fits[1][:2]
              and np.array_equal(fits[0][2], fits[1][2]),
              f"curriculum {family}: svm probe of {rid}: {fits[0][:2]} then {fits[1][:2]}")
    print(f"curriculum {family}: svm probe of {len(sweep_ids)} checkpoints ({len(train)} "
          f"train rows of {train.filter(like='dim').shape[1]}), twice each, same scores; fits "
          + ", ".join(f"{t:.3f}" for t in secs) + " s", flush=True)


def expected_launches(per_step: dict, steps: int, per_call: dict, calls: int) -> dict:
    return {k: per_step.get(k, 0) * steps + per_call.get(k, 0) * calls for k in read_launches()}


def phase_curriculum(card: str, root: Path, train_step: dict, embed_call: int,
                     jepa_step: dict, jepa_w8a8_call: dict) -> dict:
    """``python -m bvc_tpu_torch.cli.run_curriculum`` through ``main``, once
    a family at each preset's full width (VideoMAE-B at B=16, V-JEPA ViT-B
    at B=16, ResNet-18 at B=32 pairs, with its per-stage lr and interval),
    the ``dev`` curriculum's three chained stages of ``CURRICULUM_ITERS``
    steps over JPEG frames (subjects of g0, g1 and g2), the sweep over an
    SSv2 layout (VideoMAE with the untrained baseline, JEPA under
    ``--extract_quantize int8``), then ``evaluate_embeddings``; and
    VideoMAE's first stage again on the corpus packed by ``python -m
    bvc_tpu_torch.cli.pack_corpus``.  Each run's launches equal the sum of
    its steps' and embed calls' (``train_step``, ``embed_call``,
    ``jepa_step``, ``jepa_w8a8_call``: the counts the earlier phases read;
    none for SimCLR).  Returns each run's launches and readings."""
    import gc

    import torch

    from bvc_tpu_torch.cli import pack_corpus, run_curriculum
    from bvc_tpu_torch.data.indexing import get_group
    from bvc_tpu_torch.training import trainer_videomae

    t_phase = time.perf_counter()
    decoder = host_decoder()
    check(decoder is not None, "neither cv2 nor PIL imports: the curriculum reads JPEGs")
    subjects = get_group("g0")[:2] + get_group("g1")[:1] + get_group("g2")[:1]
    jpg = write_simclr_corpus(root / "curriculum_corpus", decoder, subjects)
    ssv2 = write_ssv2(root / "ssv2", decoder)
    print(f"curriculum: corpus of {len(subjects)} x {SIMCLR_CORPUS[1]} JPEG frames and SSv2 "
          f"of 2 x {CURRICULUM_CLIPS} clips written in {time.perf_counter() - t_phase:.1f} s "
          f"(by {decoder})", flush=True)
    per = {"videomae": (train_step, {"flash_fwd": embed_call}),
           "jepa": (jepa_step, jepa_w8a8_call), "simclr": ({}, {})}
    out = {}
    runs = [(preset, family, B, extra, 3, None) for preset, family, B, extra in CURRICULUM_RUNS]
    runs.append(("generative", "videomae_packed", 16, [], 1, root / "pack"))
    for preset, family, B, extra, n_stages, pack in runs:
        model = family.removesuffix("_packed")
        unit = "pairs" if model == "simclr" else "clips"
        savedir = root / f"curriculum_{family}"
        argv = ["-jpg_root", jpg, "-savedir", str(savedir), "--preset", preset,
                "--curriculum", "dev", "--seed", "0", "--n_stages", str(n_stages),
                "--segment_minutes", str(CURRICULUM_SEGMENT_MINUTES),
                "--override", f"n_epoch=1,max_epoch_iters={CURRICULUM_ITERS},"
                              f"n_trainsamples={B * CURRICULUM_ITERS}"] + extra
        if pack is None:
            argv += ["--extract", f"ssv2={ssv2}"]
        else:
            t0 = time.perf_counter()
            counts = pack_corpus.main(["-jpg_root", jpg, "-pack_root", str(pack), "--group", "g0"])
            check(counts == {s: SIMCLR_CORPUS[1] for s in get_group("g0")[:2]},
                  f"pack_corpus packed {counts}")
            print(f"curriculum: pack_corpus of g0 ({sum(counts.values())} frames) in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            argv += ["--pack_root", str(pack)]
        loaders, undo = captured_loaders(trainer_videomae)
        try:
            with curriculum_timers() as timers:
                results, launches, wall = run_cli_stage(run_curriculum.main, argv,
                                                        f"curriculum {family}")
        finally:
            undo()
        baseline = ["dev_0_na_default_0_0"] if "--untrained_baseline" in extra else []
        sweep_ids = [] if pack else baseline + [st["run_id"] for st in results["stages"]]
        check_curriculum(family, savedir, results, sweep_ids, CURRICULUM_WIDTHS[model])
        steps = 0
        for st in results["stages"]:
            steps += len(check_csv(savedir / f"csvlog_{st['run_id']}.csv", CURRICULUM_ITERS, 2,
                                   f"curriculum {family} {st['run_id']}"))
        calls = len(sweep_ids) * 2 * math.ceil(CURRICULUM_CLIPS / 64)  # train and test splits
        per_step, per_call = per[model]
        want = expected_launches(per_step, steps, per_call, calls)
        check(launches == want, f"curriculum {family}: {steps} steps and {calls} embed calls "
                                f"want launches {want}, got {launches}")
        if model == "videomae":  # the packed run reads its shard, the others decode JPEGs
            served = {k for ld in loaders for k, n in ld.dataset.served.items() if n}
            check(served and (served == {"packed"}) == bool(pack),
                  f"curriculum {family}: frames read by path {served}")
        rec = {"launches": launches, "wall_s": wall, "steps": steps, "embed_calls": calls,
               "stages": [{"run_id": rid, "wall_s": dt, f"{unit}_s": B * CURRICULUM_ITERS / dt}
                          for rid, dt in timers.stages]}
        for st in rec["stages"]:
            print(f"curriculum {family} [{card}]: stage {st['run_id']}: {st['wall_s']:.2f} s "
                  f"(model build, steps, checkpoint), B={B} x {CURRICULUM_ITERS} steps -> "
                  f"{st[f'{unit}_s']:.2f} {unit}/s", flush=True)
        if sweep_ids:
            rows = sum(csvs for csvs, _ in timers.sweeps) * CURRICULUM_CLIPS
            sweep_s = sum(dt for _, dt in timers.sweeps)
            rec.update(sweep_s=sweep_s, sweep_clips_s=rows / sweep_s,
                       score_s=score_curriculum(family, savedir, ssv2, sweep_ids))
            print(f"curriculum {family} [{card}]: sweep of {len(sweep_ids)} checkpoints, "
                  f"{rows} clips in {sweep_s:.2f} s -> {rows / sweep_s:.2f} clips/s "
                  f"(checkpoint loads included); scoring (linear and nn) "
                  f"{rec['score_s']:.2f} s", flush=True)
        out[family] = rec
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"curriculum phase [{card}]: {out['wall_s']:.1f} s", flush=True)
    return out


def phase_entry_point() -> None:
    """extract_embeddings over a synthetic dataset, then save_results, with
    a bf16 and with an int8 (W8A8) embed function."""
    import numpy as np
    import pandas as pd

    from bvc_tpu_torch.evalbench.extract import (extract_embeddings, save_results,
                                                 untrained_embed_fn)
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()

    class SyntheticClips:
        """11 uint8 clips, one of them unreadable, as a reader reports it."""

        def __len__(self):
            return 11

        def __getitem__(self, i):
            if i == 5:
                return None, f"clip_{i:02d}"
            rng = np.random.default_rng(i)
            shape = (cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
            return rng.integers(0, 256, shape, dtype=np.uint8), f"clip_{i:02d}"

    for quantize in ("none", "int8"):
        fn = untrained_embed_fn("videomae", cfg, seed=1, quantize=quantize)
        names, embs = extract_embeddings(fn, SyntheticClips(), batch_size=4, num_workers=2)
        check(len(names) == 10 and embs.shape == (10, cfg.hidden_size),
              f"extract_embeddings ({quantize}) gave {len(names)} names and {embs.shape}")
        check(bool(np.isfinite(embs).all()), f"extracted embeddings ({quantize}) not finite")
        with tempfile.TemporaryDirectory() as d:
            path = save_results(names, embs, "test", "untrained_0", d)
            df = pd.read_csv(path)
            check(Path(path).parent.name == "test", f"test split written to {path}")
            check(df.shape == (10, cfg.hidden_size + 1), f"CSV of shape {df.shape}")
            check(list(df["fnames"]) == sorted(names), "CSV rows not sorted by fname")
        print(f"entry point (quantize={quantize}): extract_embeddings -> save_results wrote "
              f"{df.shape[0]} rows of width {df.shape[1] - 1}", flush=True)


EXPORT_COSINE_MIN = 0.9999  # artifact against extraction on the same weights, per row
EXPORT_TIMED_CALLS = 3  # host clock over these calls, after one untimed


def export_specs() -> list[tuple]:
    """The artifacts of :func:`phase_export`, ``(name, family, config,
    quantize)``, each from random weights of seed 0: VideoMAE-B in bf16 and
    W8A8 (``ModelConfig()``: 224 px, 16 frames), V-JEPA ViT-B as the JEPA
    CLI's defaults build it, and SimCLR's ResNet-18 at 224 px."""
    from bvc_tpu_torch.utils.config import ModelConfig

    return [("videomae_bf16", "videomae", ModelConfig(), "none"),
            ("videomae_w8a8", "videomae", ModelConfig(), "int8"),
            ("vjepa_bf16", "jepa", jepa_config()[0], "none"),
            ("simclr_resnet18", "simclr", ModelConfig(family="simclr", architecture=SIMCLR_ARCH),
             "none")]


def artifact_kernels(family: str, cfg, quantize: str) -> dict[str, int]:
    """The kernel launches of one call of an artifact, which are its graph's
    kernel nodes: a ``flash_fwd`` a ViT block, two ``gemm_s8`` a block in
    W8A8 (qkv and fc1), none for SimCLR."""
    if family == "simclr":
        return {}
    return {"flash_fwd": cfg.depth, **({"gemm_s8": 2 * cfg.depth} if quantize == "int8" else {})}


def timed_calls_s(fn, x) -> float:
    """Host seconds a call of ``fn(x)`` (numpy in, numpy out, so each call
    ends in a synchronisation) over :data:`EXPORT_TIMED_CALLS` calls after
    one untimed."""
    fn(x)
    t0 = time.perf_counter()
    for _ in range(EXPORT_TIMED_CALLS):
        fn(x)
    return (time.perf_counter() - t0) / EXPORT_TIMED_CALLS


def serve_artifacts(job: str) -> None:
    """The loading side of :func:`phase_export`, run in a fresh process
    that imports ``bvc_tpu_torch.serving`` (the launch counters' kernel
    modules come with it) and no model module.  ``job`` is a JSON file
    listing artifact directories, their devices and their uint8 input
    files; each artifact is loaded by ``load_artifact`` (seconds, the kernel
    build included),
    called at B=1 (its first call, seconds), at the input's batch with every
    launch count set to 0 just before and read just after, and timed there
    (:func:`timed_calls_s`).  Outputs go to ``out.npz`` beside the job, the
    readings and the ``bvc_tpu_torch.models`` modules imported to
    ``out.json``."""
    import numpy as np

    from bvc_tpu_torch.serving import load_artifact

    job_path = Path(job)
    outputs, readings = {}, {}
    for art in json.loads(job_path.read_text()):
        clips = np.load(art["input"])
        t0 = time.perf_counter()
        fn = load_artifact(art["path"], device=art["device"])
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outputs[art["name"] + "_1"] = fn(clips[:1])
        first_s = time.perf_counter() - t0
        reset_launches()
        outputs[art["name"] + "_B"] = fn(clips)
        launches = read_launches()
        readings[art["name"]] = {
            "load_s": load_s, "first_call_s": first_s, "launches": launches,
            "clips_s": len(clips) / timed_calls_s(fn, clips),
            "models_imported": sorted(k for k in sys.modules
                                      if k.startswith("bvc_tpu_torch.models"))}
    np.savez(job_path.with_name("out.npz"), **outputs)
    job_path.with_name("out.json").write_text(json.dumps(readings))


def phase_export(card: str, B: int, root: Path) -> dict:
    """Serving export at full width (:func:`export_specs`): each artifact
    exported from the extraction model's weights through
    ``bvc_tpu_torch.serving.export_embed`` (batch-polymorphic, on the card),
    its graph's kernel nodes counted, saved by ``save_artifact``; then all of
    them loaded and called in one fresh process (:func:`serve_artifacts`),
    which must import no ``bvc_tpu_torch.models`` module.  Each artifact's
    embeddings at B=1 and at ``B`` (the extraction batch
    ``phase_main_path`` picked) against extraction's (``untrained_embed_fn``,
    the function ``make_embed_fn`` returns, on the same weights; W8A8
    against W8A8 extraction; SimCLR's frames normalized as its readers
    give them): cosine >= 0.9999 per row, max|diff| printed; the launches of
    one call equal the graph's kernel nodes (:func:`artifact_kernels`).
    Prints clips/s of the artifact and of extraction at ``B`` (both by
    :func:`timed_calls_s`), export, save, load and first-call seconds and
    the artifact's bytes; returns them by artifact."""
    import gc

    import numpy as np
    import torch

    from bvc_tpu_torch.evalbench.extract import untrained_embed_fn
    from bvc_tpu_torch.models.videomae import normalize_on_device
    from bvc_tpu_torch.serving import export_embed, save_artifact
    from bvc_tpu_torch.serving.export import kernel_ops

    rng = np.random.default_rng(7)
    inputs, plain, jobs, results, refs = {}, {}, [], {}, {}
    for name, family, cfg, quantize in export_specs():
        shape = (cfg.num_frames, cfg.image_size, cfg.image_size, cfg.in_channels)
        if shape not in inputs:
            inputs[shape] = root / f"clips_{len(inputs)}.npy"
            np.save(inputs[shape], rng.integers(0, 256, (B,) + shape, dtype=np.uint8))
        clips = np.load(inputs[shape])
        if family not in plain:
            plain[family] = untrained_embed_fn(family, cfg, seed=0)
        ref = (plain[family] if quantize == "none"
               else untrained_embed_fn(family, cfg, seed=0, quantize=quantize))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exported, meta = export_embed(family, plain[family].model, cfg, quantize=quantize)
        export_s = time.perf_counter() - t0
        nodes = dict(kernel_ops(exported))
        want = artifact_kernels(family, cfg, quantize)
        check(nodes == want and meta["platforms"] == ["cuda"] and meta["batch"] == "polymorphic",
              f"export {name}: kernel nodes {nodes} (want {want}), meta {meta}")
        t0 = time.perf_counter()
        path = Path(save_artifact(root / name, exported, meta))
        save_s = time.perf_counter() - t0
        del exported
        if family == "simclr":  # the last frame, normalized as the readers give it
            clips = normalize_on_device(torch.from_numpy(clips[:, -1:])).numpy()
        refs[name] = (ref(clips[:1]), ref(clips))
        results[name] = {"export_s": export_s, "save_s": save_s,
                         "bytes": sum(f.stat().st_size for f in path.iterdir()),
                         "extraction_clips_s": B / timed_calls_s(ref, clips)}
        jobs.append({"name": name, "path": str(path), "input": str(inputs[shape]),
                     "device": meta["platforms"][0], "want": want})
        del ref, clips
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    job = root / "job.json"
    job.write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c",
                           f"import chip_smoke; chip_smoke.serve_artifacts({str(job)!r})"],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"loading the artifacts failed:\n{proc.stderr[-6000:]}")
    print(f"export: the loading process ran in {time.perf_counter() - t0:.1f} s", flush=True)
    outputs = np.load(root / "out.npz")
    readings = json.loads((root / "out.json").read_text())
    for art in jobs:
        name, r = art["name"], readings[art["name"]]
        check(r["models_imported"] == [],
              f"loading {name} imported model modules {r['models_imported']}")
        want = {**{k: 0 for k in r["launches"]}, **art["want"]}
        check(r["launches"] == want, f"artifact {name}: one call launched {r['launches']}, "
                                     f"want {want}")
        cosines, diffs = [], []
        for tag, ref in zip(("1", "B"), refs[name]):
            got = outputs[f"{name}_{tag}"]
            check(got.shape == ref.shape and bool(np.isfinite(got).all()),
                  f"artifact {name}: output {got.shape} (want {ref.shape}) or not finite")
            cosines.append(float(((got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                                         * np.linalg.norm(ref, axis=1))).min()))
            diffs.append(float(np.abs(got - ref).max()))
        check(min(cosines) >= EXPORT_COSINE_MIN,
              f"artifact {name}: cosine to extraction {cosines} < {EXPORT_COSINE_MIN}")
        res = results[name]
        res.update(load_s=r["load_s"], first_call_s=r["first_call_s"], clips_s=r["clips_s"],
                   min_cosine=min(cosines), max_abs_diff=max(diffs),
                   launches={k: v for k, v in r["launches"].items() if v})
        print(f"export {name} [{card}]: export {res['export_s']:.2f} s, save "
              f"{res['save_s']:.2f} s, {res['bytes']} bytes; load {r['load_s']:.2f} s, first "
              f"call (B=1) {r['first_call_s']:.2f} s; one call launched {res['launches']}; "
              f"cosine to extraction min {min(cosines):.6f} (B=1, B={B}), max|diff| "
              f"{diffs[0]:.3e}, {diffs[1]:.3e}; B={B}: artifact {r['clips_s']:.1f} clips/s, "
              f"extraction {res['extraction_clips_s']:.1f} clips/s (numpy in and out)",
              flush=True)
    return results


VIT_IMAGE_B = 64
VIT_IMAGE_KEEP = 147  # kept tokens of ViT-B/16's 196 at 224 px (0.75)
VIT_IMAGE_DIFF_MAX = 2e-2  # embedding through the kernels against the plain path


def phase_vit_image(card: str) -> dict:
    """The image ViT at full width: ViT-B/16 at 224 px, bf16, B=64, random
    weights of seed 0 and normal images.  ``embed`` through the kernels (12
    ``flash_fwd``, 196 tokens) against ``attn_impl="xla"``; the forward with
    a ``keep_idx`` of up to 147 tokens an image (rows of 140-147, padded
    with -1; 12 ``flash_fwd_bias``), mean-pooled over the kept tokens,
    against the plain masked path: cosine >= 0.999 per row and max|diff|
    <= 2e-2 each, launches exactly those.  The kernels themselves are held
    at these shapes by ``phase_kernel`` and ``phase_bias_kernel``.  Prints
    images/s of both (CUDA events)."""
    import numpy as np
    import torch

    from bvc_tpu_torch.models.vit_image import ImageViT
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(image_size=224, patch_size=16)
    n = (cfg.image_size // cfg.patch_size) ** 2
    model = ImageViT(cfg, seed=0).cuda().eval()
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((VIT_IMAGE_B, 224, 224, 3), dtype=np.float32))
    x = x.cuda()
    keep = np.full((VIT_IMAGE_B, VIT_IMAGE_KEEP), -1, np.int64)
    for i in range(VIT_IMAGE_B):
        k = VIT_IMAGE_KEEP - i % 8
        keep[i, :k] = np.sort(rng.permutation(n)[:k])
    keep = torch.from_numpy(keep).cuda()
    valid = (keep >= 0)[..., None].float()

    def pooled(h):
        return (h.float() * valid).sum(1) / valid.sum(1)

    out = {}
    with torch.inference_mode():
        for what, run, plain, want in (
                ("unmasked", lambda: model.embed(x), lambda: model.embed(x, attn_impl="xla"),
                 {"flash_fwd": cfg.depth}),
                ("keep_idx", lambda: pooled(model(x, keep)),
                 lambda: pooled(model(x, keep, attn_impl="xla")), {"flash_fwd_bias": cfg.depth})):
            reset_launches()
            got = run().cpu().numpy()
            launches = read_launches()
            want = {**{k: 0 for k in launches}, **want}
            check(launches == want, f"vit_image {what}: launched {launches}, want {want}")
            ref = plain().cpu().numpy()
            check(got.shape == (VIT_IMAGE_B, cfg.hidden_size) and bool(np.isfinite(got).all()),
                  f"vit_image {what}: {got.shape} or not finite")
            cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
            diff = float(np.abs(got - ref).max())
            check(bool(cos.min() >= COSINE_MIN), f"vit_image {what}: cosine {cos.min()}")
            check(diff <= VIT_IMAGE_DIFF_MAX, f"vit_image {what}: max|diff| {diff}")
            ms = time_ms(run, iters=10)
            plain_ms = time_ms(plain, iters=5)
            out[what] = {"launches": launches, "min_cosine": float(cos.min()), "max_abs_diff": diff,
                         "images_s": VIT_IMAGE_B / ms * 1e3,
                         "plain_images_s": VIT_IMAGE_B / plain_ms * 1e3}
            print(f"vit_image {what} [{card}]: ViT-B/16 224 px B={VIT_IMAGE_B} launched "
                  f"{ {k: v for k, v in launches.items() if v} }, cosine to the plain path min "
                  f"{cos.min():.6f}, max|diff| {diff:.3e} (limit {VIT_IMAGE_DIFF_MAX}); "
                  f"{ms:.2f} ms -> "
                  f"{out[what]['images_s']:.1f} images/s (plain attention "
                  f"{out[what]['plain_images_s']:.1f})", flush=True)
    return out


DDP_LOSS_RTOL = 1e-4  # the DDP step against the unwrapped step, same batch and masks
DDP_TENSOR_COSINE_MIN = 0.9995  # per parameter tensor
DDP_JEPA_B = 64
DDP_TIMED_STEPS = 3  # steps a turn of (a)'s timing and of the N-card runs
DDP_SIMCLR_B = 16  # pairs a step of the SimCLR CLI at --mesh data=1


class rendezvous:
    """torchrun's variables of a world of one (rank 0 on card 0, a free
    port on localhost) in this process's environment while inside; on exit
    the process group, if one was made, is destroyed and the variables are
    restored."""

    def __init__(self):
        self.env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        import torch

        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def base_model(family: str, frames: int = 0, dtype: str = "bfloat16"):
    """The full-width model of ``family`` from seed 0 on the host (VideoMAE-B,
    at ``frames`` frames when given and computing in ``dtype``, or
    :func:`jepa_config`'s V-JEPA ViT-B), built once a process: building one
    takes seconds, and every state of a phase starts from a copy of the same
    weights."""
    from bvc_tpu_torch.models.jepa import JEPA
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.utils.config import ModelConfig

    if family == "jepa":
        return JEPA(jepa_config()[0], seed=0)
    cfg = ModelConfig(num_frames=frames, dtype=dtype) if frames else ModelConfig(dtype=dtype)
    return VideoMAEPretrain(cfg, seed=0)


def ddp_family(family: str, B: int, grad_accum: int = 1):
    """``(new_state, step, args)`` of a family's full-width step at global
    batch ``B``: VideoMAE-B with a tube mask (0.9) drawn once from a CPU
    generator, or V-JEPA ViT-B with the collator's indices of the global
    batch; clips from seed 0, on the host.  ``new_state(mode='replicated')``
    builds the state from seed 0, laid out by ``mode`` (``--param_sharding``)
    under a process group (DDP-wrapped under ``replicated``)."""
    import copy

    import numpy as np
    import torch

    from bvc_tpu_torch.training.state import TrainState

    rng = np.random.default_rng(0)
    if family == "videomae":
        from bvc_tpu_torch.masks.tube import tube_mask
        from bvc_tpu_torch.training.steps import make_videomae_train_step
        from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

        cfg = ModelConfig()
        mask_cfg = MaskConfig(sampler="tube", mask_ratio=0.9)
        optim = OptimConfig(name="sgd", lr=0.1, momentum=0.9)
        video = rng.integers(0, 256, (B, cfg.num_frames, cfg.image_size, cfg.image_size,
                                      cfg.in_channels), dtype=np.uint8)
        grid = (cfg.num_time_steps, cfg.image_size // cfg.patch_size,
                cfg.image_size // cfg.patch_size)
        mask = tube_mask(torch.Generator().manual_seed(0), B, grid, 0.9)
        return (lambda mode="replicated": TrainState.create(
                    copy.deepcopy(base_model("videomae")), optim, seed=1, param_sharding=mode),
                make_videomae_train_step(cfg, mask_cfg, grad_accum=grad_accum),
                {"video": torch.from_numpy(video), "mask": mask})
    from bvc_tpu_torch.masks.multiblock import mask_collate
    from bvc_tpu_torch.training.steps import make_jepa_train_step

    cfg, mask_cfg, optim = jepa_config()
    video = rng.integers(0, 256, (B, cfg.num_frames, cfg.image_size, cfg.image_size,
                                  cfg.in_channels), dtype=np.uint8)
    batch = {k: torch.from_numpy(x) for k, x in
             {"video": video, **mask_collate(cfg, mask_cfg, seed=0)(B, 0)}.items()}

    def new_state(mode="replicated"):
        model = copy.deepcopy(base_model("jepa"))
        return TrainState.create(model, optim, seed=1, target=copy.deepcopy(model.encoder),
                                 param_sharding=mode)

    return (new_state, make_jepa_train_step(cfg, JEPA_TOTAL_STEPS, optim.ema, optim.ema_fallback,
                                            grad_accum=grad_accum), batch)


def ddp_call(family: str, step, state, args: dict):
    """One step of ``family`` on ``args`` (the VideoMAE step takes the
    video and the mask, the JEPA step the batch dict)."""
    if family == "videomae":
        return step(state, args["video"], args["mask"])
    return step(state, args)


def rank_rows(args: dict, world: int, rank: int) -> dict:
    """Rank ``rank``'s contiguous block of every tensor of a global batch."""
    b = next(iter(args.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in args.items()}


def step_readings(family: str, step, state, args: dict, record: bool = False) -> dict:
    """:func:`call_readings` of one step of ``family`` on ``args`` (its
    collectives with ``record``)."""
    return call_readings(lambda: ddp_call(family, step, state, args), state,
                         step.computation if record else None)


def check_ddp_against(what: str, got: dict, want: dict, loss_rtol: float = DDP_LOSS_RTOL,
                      cosine_min: float = DDP_TENSOR_COSINE_MIN) -> dict:
    """The loss within ``loss_rtol`` relative and every parameter tensor's
    gradient within cosine ``cosine_min`` (the DDP limits unless given);
    returns the readings."""
    import torch

    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    cos = sorted((torch.nn.functional.cosine_similarity(
        got["grads"][n].float().cuda(), g.float().cuda(), dim=0).item(), n)
        for n, g in want["grads"].items())
    print(f"{what}: loss {got['loss']:.6f} vs {want['loss']:.6f} (rel {rel:.2e}); gradient "
          f"cosine per tensor ({len(cos)} tensors), lowest {cos[0][1]} {cos[0][0]:.6f}",
          flush=True)
    check(math.isfinite(got["loss"]) and rel <= loss_rtol,
          f"{what}: loss rel {rel} > {loss_rtol}")
    check(cos[0][0] >= cosine_min,
          f"{what}: gradient cosine of {cos[0][1]} {cos[0][0]} < {cosine_min}")
    return {"loss_rel": rel, "min_cosine": cos[0][0], "min_cosine_tensor": cos[0][1]}


COMM_BIG = 1024  # bytes: scalar metrics' all-reduces are smaller, gradient buffers larger
JAX_VIDEOMAE_GRAD_MB = 376.9  # SCALING.md:79-85, JAX's HLO count of VideoMAE-B's gradients


def ddp_args(family: str, args: dict) -> tuple:
    """A step's positional arguments after the state (the VideoMAE step
    takes the video and the mask, the JEPA step the batch dict)."""
    return (args["video"], args["mask"]) if family == "videomae" else (args,)


def comm_ops(ops) -> list[dict]:
    """Recorded ops as dicts (what a rank process hands back)."""
    import dataclasses

    return [dataclasses.asdict(op) for op in ops]


def comm_record(what: str, card: str, ops: list[dict], **extra) -> tuple:
    """``(report, record)`` of a recorded step's ops; prints the record as
    one ``{"comm": ...}`` line and fails when the recorder found nothing
    (every layout recorded here communicates)."""
    from bvc_tpu_torch.parallel.analysis import CollectiveOp, CommReport

    report = CommReport([CollectiveOp(**op) for op in ops])
    check(bool(report.ops), f"{what}: the recorder found no collective")
    s = report.summary()
    big = {k: report.bytes_for(k, COMM_BIG) for k in report.by_kind}
    rec = {"layout": what, "card": card, **s, "bytes_of_big_ops": big,
           "big_ops_in_loop": sum(op.payload_bytes >= COMM_BIG for op in report.loop_ops),
           **extra}
    print(json.dumps({"comm": rec}), flush=True)
    return report, rec


def check_no_big(what: str, report, *kinds: str) -> None:
    for kind in kinds:
        check(report.bytes_for(kind, COMM_BIG) == 0,
              f"{what}: {report.bytes_for(kind, COMM_BIG)} bytes of {kind} of "
              f"{COMM_BIG} bytes or more, want none")


def check_ddp_comm(what: str, report, grad_bytes: int) -> int:
    """DDP's contract: the all-reduces of 1024 bytes or more are the
    gradients' bytes, each bucket once (returns the bucket count), none of
    them inside the accumulation loop, and nothing gathered, scattered or
    broadcast."""
    ar = report.bytes_for("all-reduce", COMM_BIG)
    check(ar == grad_bytes, f"{what}: all-reduces of {ar} bytes, want the gradients' "
                            f"{grad_bytes}")
    loop = [(op.kind, op.payload_bytes, op.line) for op in report.loop_ops
            if op.payload_bytes >= COMM_BIG]
    check(not loop, f"{what}: collectives inside the accumulation loop: {loop}")
    buckets = sorted(int(op.line.split()[-1]) for op in report.ops
                     if op.line.startswith("ddp bucket"))
    check(buckets and buckets == list(range(len(buckets))),
          f"{what}: buckets all-reduced a step {buckets}: want each of the buckets once")
    check_no_big(what, report, "all-gather", "reduce-scatter", "broadcast")
    return len(buckets)


def steps_ms(family: str, step, state, args: dict, steps: int = DDP_TIMED_STEPS) -> float:
    """Device time of one step, ms, by CUDA events over ``steps`` steps."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        ddp_call(family, step, state, args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def ddp_world1(card: str, family: str, B: int, grad_accum: int) -> tuple[dict, dict]:
    """(a) The DDP-wrapped step at world 1 over NCCL (the port's
    ``distributed_init`` from torchrun's variables) against the unwrapped
    step on the same batch and masks; its launches (the unwrapped step's)
    and both steps' clips/s; then its collectives (``step.comm_report``):
    the all-reduces of 1024 bytes or more exactly the trainable parameters'
    bytes, every bucket once, none inside the accumulation loop.  Returns
    (the record, the unwrapped step's readings on the host)."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init, tree_bytes

    new_state, step, args = ddp_family(family, B, grad_accum)
    args = {k: v.cuda() for k, v in args.items()}
    plain = new_state()
    check(plain.ddp is None, "a DDP wrapper without a process group")
    want = step_readings(family, step, plain, args)
    with rendezvous():
        distributed_init()
        check(torch.distributed.get_backend() == "nccl"
              and torch.distributed.get_world_size() == 1,
              f"world 1 on cuda: backend {torch.distributed.get_backend()}")
        state = new_state()
        check(state.ddp is not None, "no DDP wrapper under a process group")
        got = step_readings(family, step, state, args)
        what = f"ddp world 1 [{family}, B={B}, grad_accum {grad_accum}]"
        record = check_ddp_against(what, got, want)
        check(got["launches"] == want["launches"],
              f"{what}: launches {got['launches']} vs the unwrapped step's {want['launches']}")
        # timed in turns, unwrapped, DDP, DDP, unwrapped, before any recording
        times: dict[str, list[float]] = {"plain": [], "ddp": []}
        for turn in ("plain", "ddp", "ddp", "plain"):
            times[turn].append(steps_ms(family, step, plain if turn == "plain" else state,
                                        args))
        grad_bytes = tree_bytes(state.model)
        report, comm = comm_record(what, card, comm_ops(step.comm_report(
            state, *ddp_args(family, args)).ops), grad_bytes=grad_bytes,
            jax_grad_mb=JAX_VIDEOMAE_GRAD_MB if family == "videomae" else None)
        n_buckets = check_ddp_comm(what, report, grad_bytes)
        del state, plain
    gc.collect()
    torch.cuda.empty_cache()
    ddp_ms, plain_ms = (sum(times[k]) / 2 for k in ("ddp", "plain"))
    record.update({"B": B, "grad_accum": grad_accum, "allreduces_per_step": n_buckets,
                   "grad_bytes": grad_bytes, "comm": comm, "launches": got["launches"],
                   "ms": ddp_ms,
                   "plain_ms": plain_ms, "ms_turns": times["ddp"],
                   "plain_ms_turns": times["plain"], "clips_s": B / (ddp_ms / 1e3),
                   "plain_clips_s": B / (plain_ms / 1e3)})
    print(f"{what} [{card}]: {n_buckets} NCCL all-reduces a step (one a bucket, "
          f"{grad_bytes / 1e6:.1f} MB in all); launches equal the unwrapped step's; "
          f"{record['clips_s']:.1f} clips/s ({ddp_ms:.3f} ms; turns {times['ddp']}) against "
          f"the unwrapped step's {record['plain_clips_s']:.1f} ({plain_ms:.3f} ms; turns "
          f"{times['plain']})", flush=True)
    want["grads"] = {n: g.cpu() for n, g in want["grads"].items()}
    return record, want


def ddp_rank_worker(out: str, families: str, per_rank: str, backend: str,
                    timed: int) -> None:
    """One rank of a data-parallel run started by :func:`run_ddp_ranks`
    (torchrun's variables in the environment): for each family, one step on
    this rank's block of the global batch (``per_rank`` clips a rank),
    then ``timed`` timed ones; rank 0 writes the loss and the averaged
    gradients, every rank its launches and step time, to ``out``."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init, rank, world_size

    distributed_init(backend=backend)
    result = {}
    for family, b in zip(families.split(","), map(int, per_rank.split(","))):
        world, r = world_size(), rank()
        new_state, step, args = ddp_family(family, b * world)
        args = {k: v.cuda() for k, v in rank_rows(args, world, r).items()}
        state = new_state()
        readings = step_readings(family, step, state, args)
        ms = steps_ms(family, step, state, args, timed) if timed else None
        result[family] = {"launches": readings["launches"], "ms": ms, "loss": readings["loss"],
                          "grads": ({n: g.cpu() for n, g in readings["grads"].items()}
                                    if r == 0 else None)}
        del state, readings
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def rank_processes(world: int, call: str, one_card: bool,
                   timeout: float = 600) -> list[tuple[int, str]]:
    """``world`` processes running ``call`` (a call of this module's, as
    torchrun would start it: its variables in the environment), on card 0
    each when ``one_card``, else on card r; each one's exit code and
    output, in rank order.  This process hosts the job's ``TCPStore`` and
    the ranks join it as clients (``TORCHELASTIC_USE_AGENT_STORE``, as
    under torchrun's agent).  A failed worker's peers are killed."""
    import torch

    # the job's store, held here until the ranks end: no other job can take its port
    store = torch.distributed.TCPStore("localhost", 0, is_master=True, wait_for_workers=False)
    code = f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; chip_smoke.{call}"
    procs = []
    try:
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(0 if one_card else r), "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(store.port), "TORCHELASTIC_USE_AGENT_STORE": "True"}
            # faulthandler: a rank that dies on a signal prints its Python stack
            procs.append(subprocess.Popen([sys.executable, "-X", "faulthandler", "-c", code],
                                          env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        del store
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def run_rank_workers(world: int, call: str, out: str, one_card: bool) -> list[dict]:
    """:func:`rank_processes` of ``call``, each of which must exit 0; the
    results each wrote to ``{out}.rank{r}``, in rank order."""
    import torch

    for r, (code, log) in enumerate(rank_processes(world, call, one_card)):
        check(code == 0, f"rank {r} of {world} ({call.split('(')[0]}) exited {code}:\n"
                         f"{log[-3000:]}")
    return [torch.load(f"{out}.rank{r}", weights_only=False) for r in range(world)]


def run_ddp_ranks(out_dir: Path, world: int, families: list[str], per_rank: list[int],
                  backend: str, one_card: bool, timed: int = 0) -> list[dict]:
    """``world`` processes of :func:`ddp_rank_worker` (``timed`` steps timed
    after the checked one); their results in rank order."""
    out = str(out_dir / "ddp")
    call = (f"ddp_rank_worker({out!r}, {','.join(families)!r}, "
            f"{','.join(map(str, per_rank))!r}, {backend!r}, {timed})")
    return run_rank_workers(world, call, out, one_card)


def phase_ddp(card: str, train_B: int, root: Path, simclr_jpg: str) -> dict:
    """Data parallel on the card (slice 7a).  (a) World 1 over NCCL: the
    DDP-wrapped VideoMAE-B step at ``train_B`` with ``grad_accum=2`` and the
    V-JEPA step at B=64, each against the unwrapped step on the same batch
    and masks (loss 1e-4 relative, gradient cosine 0.9995 per tensor),
    launches equal to the unwrapped step's, clips/s beside it (timed in
    turns: unwrapped, DDP, DDP, unwrapped), then its collectives
    (``comm_report``: every bucket's all-reduce once a step, the gradients'
    bytes in all, none in the accumulation loop).  (b) Two ranks on the
    one card over gloo run as ``replicated`` in :func:`phase_sharding`'s
    ``data=2`` job.  (c) The entry points at ``--mesh data=1`` under
    torchrun's variables (NCCL): ``pretrain_simclr`` for 3 steps over the
    JPEGs at ``simclr_jpg`` (no kernel) and
    ``compute_embeddings --quantize int8`` (24 ``gemm_s8`` and 12
    ``flash_fwd`` a call).  With more than one card visible, also world =
    ``device_count()`` over NCCL against one card at the global batch, with
    per-card clips/s and the scaling efficiency.  Returns the records and,
    under ``"launches"``, each run's counts."""
    import gc

    import torch

    t0 = time.perf_counter()
    videomae, videomae_ref = ddp_world1(card, "videomae", train_B, 2)
    jepa, jepa_ref = ddp_world1(card, "jepa", DDP_JEPA_B, 1)
    gc.collect()
    torch.cuda.empty_cache()

    del videomae_ref, jepa_ref
    gc.collect()

    # (c): the entry points at --mesh data=1, NCCL from torchrun's variables
    from bvc_tpu_torch.cli import compute_embeddings, pretrain_simclr
    from bvc_tpu_torch.training.checkpoint import load_meta

    cifar = write_cifar(root / "ddp_cifar")
    with rendezvous():
        out = root / "ddp_simclr"
        summary, simclr_launches, simclr_wall = run_cli_stage(pretrain_simclr.main, [
            "-jpg_root", simclr_jpg, "-savedir", str(out), "--mesh", "data=1", "--batch_size",
            str(DDP_SIMCLR_B), "--n_trainsamples", str(DDP_SIMCLR_B * 3), "--max_epoch_iters",
            "3", "--run_id", "dev_1_g0_default_0_0"], "pretrain_simclr --mesh data=1")
        check(torch.distributed.is_initialized()
              and torch.distributed.get_backend() == "nccl",
              "pretrain_simclr --mesh data=1 under torchrun's variables made no NCCL group")
        check_cli_launches(simclr_launches, {}, 3, "pretrain_simclr --mesh data=1")
        check_csv(out / "csvlog_dev_1_g0_default_0_0.csv", 3, 2, "pretrain_simclr --mesh data=1")
        check(load_meta(summary["checkpoint"])["world_size"] == 1, "world_size in the meta")
        results, int8_launches, int8_wall = run_cli_stage(compute_embeddings.main, [
            "-ds_task", "cifar10", "-vid_root", cifar, "-savedir", str(root / "ddp_emb"),
            "--family", "videomae", "--dataset_split", "test", "--mesh", "data=1",
            "--quantize", "int8"], "compute_embeddings --mesh data=1 --quantize int8")
        check_cli_launches(int8_launches, {"gemm_s8": 24, "flash_fwd": 12}, 1,
                           "compute_embeddings --mesh data=1 --quantize int8")
        check(len(results) == 1 and results[0]["rows"] == 10, f"int8 rows: {results}")
    entry = {"simclr_wall_s": simclr_wall, "int8_wall_s": int8_wall}

    multi = None
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        multi = ddp_multi_card(card, n_cards, train_B, root)
    wall = time.perf_counter() - t0
    print(f"ddp: phase in {wall:.1f} s", flush=True)
    return {"world1": {"videomae": {k: v for k, v in videomae.items() if k != "launches"},
                       "jepa": {k: v for k, v in jepa.items() if k != "launches"}},
            "entry_points": entry, "multi_card": multi,
            "wall_s": wall,
            "launches": {"videomae_step": videomae["launches"], "jepa_step": jepa["launches"],
                         "int8_call": int8_launches, "simclr_stage": simclr_launches}}


def ddp_multi_card(card: str, n: int, B: int, root: Path) -> dict:
    """World ``n`` over NCCL, a card a rank, VideoMAE-B at ``B`` clips a
    card, against one card at the global batch (``grad_accum`` 2n, the same
    mean): loss and gradient limits as (a); per-card clips/s (the slowest
    rank's CUDA-event time) and the scaling efficiency against one card's
    rate at ``B`` (the unwrapped step, this call)."""
    import gc

    import torch

    new_state, step, args = ddp_family("videomae", B * n, grad_accum=2 * n)
    ref_state = new_state()
    ref = step_readings("videomae", step, ref_state, {k: v.cuda() for k, v in args.items()})
    ref["grads"] = {k: v.cpu() for k, v in ref["grads"].items()}
    del ref_state, args
    one_new, one_step, one_args = ddp_family("videomae", B)
    one_state = one_new()
    one_args = {k: v.cuda() for k, v in one_args.items()}
    ddp_call("videomae", one_step, one_state, one_args)  # warm-up
    one_card_clips_s = B / (steps_ms("videomae", one_step, one_state, one_args) / 1e3)
    del one_state, one_args
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_ddp_ranks(root, n, ["videomae"], [B], "nccl", one_card=False,
                          timed=DDP_TIMED_STEPS)
    what = f"ddp world {n} over NCCL, a card a rank [videomae, {B} a card]"
    record = check_ddp_against(what, ranks[0]["videomae"], ref)
    ms = [r["videomae"]["ms"] for r in ranks]
    per_card = B / (max(ms) / 1e3)
    record.update({"world": n, "B_per_card": B, "ms": ms, "clips_s_per_card": per_card,
                   "clips_s": per_card * n, "one_card_clips_s": one_card_clips_s,
                   "scaling_efficiency": per_card / one_card_clips_s})
    print(f"{what} [{card}]: {per_card:.1f} clips/s a card ({n * per_card:.1f} in all) against "
          f"one card's {one_card_clips_s:.1f}: scaling efficiency "
          f"{record['scaling_efficiency']:.3f}", flush=True)
    return record


SHARD_MODES = ("zero1", "fsdp", "tp")
SHARD_TIMED_STEPS = 2  # steps a turn of (a)'s timing
SHARD_JEPA_B = 64
# the attention shapes of a tp step at model=2: each rank's heads
SHARD_TP_SHAPES = (("VideoMAE-B encoder", (8, 160, 6, 64), None),
                   ("VideoMAE-B decoder", (8, 1568, 3, 64), None),
                   ("V-JEPA context", (64, 169, 6, 64), "context"),
                   ("V-JEPA predictor", (256, 199, 6, 32), "predictor"))


def state_bytes(state) -> dict:
    """Bytes this rank holds of the parameters, their gradients and the
    optimizer state (ZeRO: its partition; FSDP: the local shards), and of
    the EMA target where there is one."""
    from bvc_tpu_torch.parallel.sharding import local_tensor

    def nbytes(tensors):
        return sum(local_tensor(t).numel() * local_tensor(t).element_size() for t in tensors)

    opt = getattr(state.optimizer, "optim", state.optimizer)  # ZeRO's local optimizer
    params = list(state.model.parameters())
    out = {"params": nbytes(params), "grads": nbytes(p.grad for p in params
                                                     if p.grad is not None),
           "optimizer": nbytes(v for st in opt.state.values() for v in st.values()
                               if hasattr(v, "numel") and v.ndim)}
    out["total"] = sum(out.values())
    if state.target is not None:
        out["target"] = nbytes(state.target.parameters())
    return out


def shard_world1(card: str, family: str, B: int, grad_accum: int) -> tuple[dict, dict]:
    """(a) Each of ``zero1``, ``fsdp`` and ``tp`` (at ``model=1``) at world 1
    over NCCL against the unwrapped step on the same batch and masks (loss,
    every whole gradient, launches), then every layout's clips/s in turns
    (unwrapped, zero1, fsdp, tp, unwrapped; CUDA events over
    ``SHARD_TIMED_STEPS`` steps a turn).  Returns (the records, the unwrapped
    step's readings with its gradients on the host and its state's bytes)."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init, make_mesh

    new_state, step, args = ddp_family(family, B, grad_accum)
    args = {k: v.cuda() for k, v in args.items()}
    states = {"plain": new_state()}
    want = step_readings(family, step, states["plain"], args)
    want["bytes"] = state_bytes(states["plain"])
    records: dict = {}
    with rendezvous():
        distributed_init()
        check(torch.distributed.get_backend() == "nccl"
              and torch.distributed.get_world_size() == 1,
              f"world 1 on cuda: backend {torch.distributed.get_backend()}")
        make_mesh({"data": 1, "model": 1})
        for mode in SHARD_MODES:
            states[mode] = new_state(mode)
            got = step_readings(family, step, states[mode], args)
            what = f"{mode} world 1 [{family}, B={B}, grad_accum {grad_accum}]"
            records[mode] = check_ddp_against(what, got, want)
            check(got["launches"] == want["launches"],
                  f"{what}: launches {got['launches']} vs the unwrapped step's "
                  f"{want['launches']}")
            records[mode]["launches"] = got["launches"]
        times: dict[str, list[float]] = {k: [] for k in states}
        for turn in ("plain", *SHARD_MODES, "plain"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(SHARD_TIMED_STEPS):
                ddp_call(family, step, states[turn], args)
            end.record()
            torch.cuda.synchronize()
            times[turn].append(start.elapsed_time(end) / SHARD_TIMED_STEPS)
        del states
        gc.collect()
    torch.cuda.empty_cache()
    plain_ms = sum(times["plain"]) / len(times["plain"])
    for mode in SHARD_MODES:
        ms = sum(times[mode]) / len(times[mode])
        records[mode].update({"ms": ms, "ms_turns": times[mode], "clips_s": B / (ms / 1e3),
                              "of_unwrapped": plain_ms / ms})
        print(f"{mode} world 1 [{family}, B={B}] [{card}]: {records[mode]['clips_s']:.1f} clips/s "
              f"({ms:.3f} ms; turns {times[mode]}), {plain_ms / ms:.3f} of the unwrapped "
              f"step's {B / (plain_ms / 1e3):.1f} ({plain_ms:.3f} ms; turns {times['plain']})",
              flush=True)
    records["plain"] = {"ms": plain_ms, "ms_turns": times["plain"],
                        "clips_s": B / (plain_ms / 1e3)}
    want["grads"] = {n: g.cpu() for n, g in want["grads"].items()}
    return records, want


def shard_rank_worker(out: str, jobs: str, backend: str) -> None:
    """One rank of a sharded run started by :func:`run_shard_ranks`
    (torchrun's variables in the environment): for each job (name -> its
    ``mesh``, ``runs`` of ``[mode, family, global batch, grad_accum]``,
    ``timed`` and ``comm``) the job's mesh, then for each run one step on
    this rank's data block of the global batch (with ``comm`` its
    collectives recorded) and ``timed`` timed ones; the loss, launches,
    step time, state bytes and collectives of every rank, and rank 0's
    whole gradients, to ``out``, keyed ``(job, mode, family)``."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init, make_mesh, rank, tree_bytes

    distributed_init(backend=backend)
    result: dict = {}
    for name, job in json.loads(jobs).items():
        mesh = make_mesh(job["mesh"])
        for mode, family, B, grad_accum in job["runs"]:
            new_state, step, args = ddp_family(family, B, grad_accum)
            args = {k: v.cuda() for k, v in rank_rows(args, mesh.axis_size("data"),
                                                      mesh.coord("data")).items()}
            state = new_state(mode)
            readings = step_readings(family, step, state, args, record=job.get("comm", False))
            ms = steps_ms(family, step, state, args, job["timed"]) if job["timed"] else None
            result[name, mode, family] = {
                "launches": readings["launches"], "ms": ms, "loss": readings["loss"],
                "bytes": state_bytes(state), "comm": readings["comm"],
                "held_bytes": tree_bytes(state.model),
                "grads": ({n: g.cpu() for n, g in readings["grads"].items()}
                          if rank() == 0 else None)}
            del state, readings
            gc.collect()
            torch.cuda.empty_cache()
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def run_shard_ranks(out_dir: Path, world: int, jobs: dict, backend: str,
                    one_card: bool) -> list[dict]:
    """``world`` processes of :func:`shard_rank_worker` on ``jobs`` (name ->
    ``mesh``, ``runs`` as ``[mode, family, global batch, grad_accum]``,
    ``timed``, ``comm``), one after the other in the same processes; their
    results in rank order."""
    out = str(out_dir / "shard")
    return run_rank_workers(world, f"shard_rank_worker({out!r}, {json.dumps(jobs)!r}, "
                                   f"{backend!r})", out, one_card)


def shard_two_rank_jobs(train_B: int) -> dict[str, dict]:
    """(b)'s jobs on two ranks: at ``data=1,model=2`` (each rank on the
    whole batch) ``tp``, and ``zero1`` and ``fsdp`` with the model ranks as
    replicas; at ``data=2`` ``replicated`` (DDP, slice 7a), ``zero1`` and
    ``fsdp``.  VideoMAE-B at ``train_B`` (``grad_accum=2`` on the whole
    batch at ``data=1``, one pass of half of it at ``data=2``) and V-JEPA
    at ``SHARD_JEPA_B`` (``replicated``, ``zero1``, ``fsdp``, ``tp``)."""
    jepa = ["jepa", SHARD_JEPA_B, 1]
    return {"model2": {"mesh": {"data": 1, "model": 2}, "timed": 0, "comm": True,
                       "runs": [["tp", "videomae", train_B, 2], ["tp", *jepa],
                                ["zero1", "videomae", train_B, 2],
                                ["fsdp", "videomae", train_B, 2]]},
            "data2": {"mesh": {"data": 2}, "timed": 0, "comm": True,
                      "runs": [[mode, *fam] for mode in ("replicated", "zero1", "fsdp")
                               for fam in (["videomae", train_B, 1], jepa)]}}


def repeat_shard_ranks(n: int, train_B: int, root: Path) -> None:
    """``--repeat-shard-ranks N``: each of (b)'s two-rank jobs over gloo on
    the one card ``n`` times, in turns, printing each run's exit codes and
    wall time and the output's end of a rank that did not exit 0 (each rank
    runs under ``-X faulthandler``); exits 1 if any run failed."""
    failed = 0
    for i in range(n):
        for name, job in shard_two_rank_jobs(train_B).items():
            t0 = time.perf_counter()
            ended = rank_processes(2, f"shard_rank_worker({str(root / name)!r}, "
                                      f"{json.dumps({name: job})!r}, 'gloo')", one_card=True)
            codes = [code for code, _ in ended]
            print(f"repeat {i + 1}/{n} {name}: exit codes {codes} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for r, (code, log) in enumerate(ended):
                if code != 0:
                    failed += 1
                    print(f"  rank {r} exited {code}:\n{log[-3000:]}", flush=True)
    print(f"repeat: {failed} ranks failed in {n} runs of each job (two ranks a run)",
          flush=True)
    sys.exit(1 if failed else 0)


def check_shard_comm(what: str, card: str, mode: str, res: dict, replicas: bool) -> dict:
    """A two-rank step's collectives (rank 0's) against JAX's contract for
    ``mode``: ``replicated`` is DDP's (:func:`check_ddp_comm`); ``zero1``
    all-reduces the gradients (DDP) and broadcasts each parameter once from
    its owner (JAX: one all-gather of the parameters); ``fsdp`` gathers the
    parameters and reduce-scatters the gradients, its shards together at
    least the gradients' bytes, or with ``replicas`` (``data=1,model=2``:
    HSDP with one rank a shard) all-reduces the gradients over ``model``
    and gathers nothing; ``tp`` all-reduces activations over the two
    ``model`` ranks and the rank's parts of the gradients over ``data``
    (DDP).  Returns the comm record."""
    held = res["held_bytes"]
    report, rec = comm_record(what, card, res["comm"], held_bytes=held)
    if mode == "replicated":
        check_ddp_comm(what, report, held)
    elif mode == "fsdp" and replicas:
        ar = report.bytes_for("all-reduce", COMM_BIG)
        check(ar == held, f"{what}: HSDP all-reduced {ar} bytes, want the gradients' {held}")
        check_no_big(what, report, "all-gather", "reduce-scatter")
    elif mode == "zero1":
        check(report.bytes_for("all-reduce", COMM_BIG) == held,
              f"{what}: all-reduces {report.bytes_for('all-reduce', COMM_BIG)}, want {held}")
        bc = report.bytes_for("broadcast")
        check(bc == held, f"{what}: broadcast {bc} bytes, want the parameters' {held}")
        check_no_big(what, report, "all-gather", "reduce-scatter")
    elif mode == "fsdp":
        check(report.bytes_for("all-gather", COMM_BIG) > 0, f"{what}: no parameter gathers")
        rs = report.bytes_for("reduce-scatter", COMM_BIG)
        check(rs * 2 >= held, f"{what}: reduce-scatters of {rs} bytes a rank for {held} "
                              "bytes of gradients over two ranks")
    else:
        model = [op for op in report.ops if op.group_size == 2 and op.payload_bytes >= COMM_BIG]
        check(bool(model), f"{what}: no all-reduce over the model ranks")
        buckets = sum(op.payload_bytes for op in report.ops if op.line.startswith("ddp bucket"))
        check(buckets == held, f"{what}: DDP all-reduced {buckets} bytes, want the rank's "
                               f"parts' {held}")
    return rec


def phase_tp_kernels() -> dict:
    """(c) The forward and backward kernels at the shapes a ``tp`` step at
    ``model=2`` gives them (each rank's half of the heads): unmasked at the
    VideoMAE-B encoder's and decoder's, with a key bias (the collator's
    masks at B=64) at V-JEPA's context and predictor; against their plain
    versions under phases 2-4's limits.  Returns each shape's errors."""
    import torch

    from bvc_tpu_torch.masks.multiblock import mask_collate
    from bvc_tpu_torch.ops.flash_attention import (flash_attention_bwd_ref,
                                                   flash_attention_fwd_ref, flash_bwd_cuda,
                                                   flash_fwd_cuda, key_bias)

    cfg, mask_cfg, _ = jepa_config()
    masks = dict(zip(("context", "predictor"),
                     jepa_key_masks(mask_collate(cfg, mask_cfg, seed=0)(SHARD_JEPA_B, 0))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, (B, N, h, d), mask_of in SHARD_TP_SHAPES:
        _, qs, k, v = qkv_inputs(B, N, h, d, seed=5 * N + h)
        bias = None if mask_of is None else key_bias(masks[mask_of])
        do = torch.randn((B, N, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash_fwd_cuda(qs, k, v, bias)
        o_ref, lse_ref = flash_attention_fwd_ref(qs, k, v, bias)
        grads = flash_bwd_cuda(qs, k, v, o, lse, do, bias)
        refs = flash_attention_bwd_ref(qs, k, v, o, lse, do, bias)
        torch.cuda.synchronize()
        rows = torch.isfinite(lse_ref)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse[rows] - lse_ref[rows]).abs().max().item()
        check(torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
              and torch.allclose(lse[rows], lse_ref[rows], atol=LSE_TOL, rtol=LSE_TOL),
              f"tp shape {label} [{B},{N},{h},{d}]: forward O {err_o}, LSE {err_lse}")
        rec = {"shape": [B, N, h, d], "bias": bias is not None, "o": err_o, "lse": err_lse}
        for name, x, ref in zip(("dq", "dk", "dv"), grads, refs):
            diff = x.float() - ref.float()
            err, scale = diff.abs().max().item(), ref.float().abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            check(err <= BWD_TOL * scale and rel <= BWD_REL_TOL,
                  f"tp shape {label} [{B},{N},{h},{d}]: {name} err {err} rel {rel}")
            rec[name] = err
            rec[f"{name}_rel"] = rel
        print(f"tp shape {label} [{B},{N},{h},{d}]{' key bias' if bias is not None else ''}: "
              f"max|dO| {err_o:.3e}, max|dLSE| {err_lse:.3e}; |err|/|ref| dq "
              f"{rec['dq_rel']:.3e} dk {rec['dk_rel']:.3e} dv {rec['dv_rel']:.3e}", flush=True)
        out[label] = rec
        del o_ref, lse_ref, refs, grads
    torch.cuda.empty_cache()
    return out


def sharding_entry_point(root: Path, corpus: tuple[str, str], per_step: dict) -> dict:
    """(e) ``pretrain_videomae --mesh data=1 --param_sharding fsdp`` for one
    3-step epoch (world 1 over NCCL under torchrun's variables), then the
    same stage resumed for a second epoch under ``replicated``, against an
    uninterrupted 2-epoch stage: the second epoch's losses within
    ``DDP_LOSS_RTOL``, each stage's launches its steps'."""
    import torch

    from bvc_tpu_torch.cli import pretrain_videomae
    from bvc_tpu_torch.training.checkpoint import load_checkpoint

    B, rid = 16, "dev_1_g0_default_0_0"
    jpg, pack = corpus
    base = ["-jpg_root", jpg, "--pack_root", pack, "--batch_size", str(B), "--n_trainsamples",
            str(3 * B), "--max_epoch_iters", "3", "--run_id", rid, "--mesh", "data=1"]
    walls = {}
    with rendezvous():
        split, straight = root / "shard_split", root / "shard_straight"
        argv = base + ["-savedir", str(split), "--n_epoch", "1", "--param_sharding", "fsdp"]
        _, launches, walls["fsdp"] = run_cli_stage(pretrain_videomae.main, argv,
                                                   "pretrain_videomae --param_sharding fsdp")
        check(torch.distributed.get_backend() == "nccl", "no NCCL group under torchrun's variables")
        check_cli_launches(launches, per_step, 3, "pretrain_videomae --param_sharding fsdp")
        ckpt = load_checkpoint(split / f"model_{rid}.pth.tar")
        n_params = sum(len(g["params"]) for g in ckpt["opt"]["param_groups"])
        check(ckpt["epoch"] == 1 and ckpt["step"] == 3 and "qkv_k_bias" in ckpt
              and len(ckpt["opt"]["state"]) == n_params,
              "the fsdp stage's checkpoint lacks the export layout or its optimizer state")
        argv = base + ["-savedir", str(split), "--n_epoch", "2", "--resume", "y"]
        _, launches, walls["resumed"] = run_cli_stage(pretrain_videomae.main, argv,
                                                      "resumed under replicated")
        check_cli_launches(launches, per_step, 3, "resumed under replicated")
        argv = base + ["-savedir", str(straight), "--n_epoch", "2"]
        _, launches, walls["straight"] = run_cli_stage(pretrain_videomae.main, argv,
                                                       "uninterrupted under replicated")
    got = check_csv(split / f"csvlog_{rid}.csv", 6, 2, "fsdp then replicated")
    want = check_csv(straight / f"csvlog_{rid}.csv", 6, 2, "uninterrupted")
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"entry point: fsdp 3 steps, resumed under replicated: losses {got} against the "
          f"uninterrupted run's {want} (max rel {rel:.2e})", flush=True)
    check(rel <= DDP_LOSS_RTOL, f"resumed losses {got} vs uninterrupted {want}: rel {rel}")
    return {"max_loss_rel": rel, "wall_s": walls}


def phase_sharding(card: str, train_B: int, root: Path, corpus: tuple[str, str],
                   per_step: dict) -> dict:
    """Parameter sharding on the card (slice 7b).  (a) World 1 over NCCL,
    ``zero1``, ``fsdp`` and ``tp`` at ``model=1``: VideoMAE-B at ``train_B``
    with ``grad_accum=2`` and V-JEPA at B=64, each against the unwrapped step
    on the same batch and masks (loss 1e-4 relative, whole gradients at
    cosine >= 0.9995 per tensor), launches equal, clips/s in turns.  (b) Two
    ranks on the one card over gloo: ``tp`` at ``data=1,model=2`` (each rank
    the whole batch and half the heads), ``zero1`` and ``fsdp`` at
    ``data=2``, against (a)'s unwrapped steps at the global batch under the
    same limits, each rank's launches the one-GPU step's.  (c) The kernels at
    the ``tp`` shapes against their plain versions.  (d) Each rank's bytes
    of parameters, gradients and optimizer state under each mode at world 2.
    (e) The entry point: ``pretrain_videomae --param_sharding fsdp``
    resumed under ``replicated``.  (f) With more than one card: world =
    ``device_count()`` over NCCL, ``tp`` at ``data=n/2,model=2`` and
    ``fsdp`` at ``data=n``, against one card at the global batch, per-card
    clips/s and the scaling efficiency.  Returns the records and, under
    ``"launches"``, each run's counts."""
    import gc

    import torch

    t0 = time.perf_counter()
    world1, refs = {}, {}
    for family, B, accum in (("videomae", train_B, 2), ("jepa", SHARD_JEPA_B, 1)):
        world1[family], refs[family] = shard_world1(card, family, B, accum)
    gc.collect()
    torch.cuda.empty_cache()

    # (b): tp, and zero1 and fsdp beside it, with each rank on the whole
    # batch; replicated, zero1 and fsdp at data=2 (gloo carries DDP, ZeRO and
    # FSDP2's collectives on CUDA tensors too)
    gloo, launches, nbytes, comm = {}, {}, {}, {}
    jobs = shard_two_rank_jobs(train_B)
    ranks = run_shard_ranks(root, 2, jobs, "gloo", one_card=True)
    for name, job in jobs.items():
        for mode, family, _, accum in job["runs"]:
            key = f"{mode}_{family}" if name == "data2" or mode == "tp" else \
                f"{mode}_model2_{family}"
            what = (f"{mode} over gloo, two ranks on one card "
                    f"[{family}, {'data=1,model=2' if name == 'model2' else 'data=2'}]")
            res = [r[name, mode, family] for r in ranks]
            gloo[key] = check_ddp_against(what, res[0], refs[family])
            # a rank's launches: the one-GPU step's (data=2: half the batch in one pass)
            want = {k: v * accum // (2 if family == "videomae" else 1)
                    for k, v in refs[family]["launches"].items()}
            for r, got in enumerate(res):
                check(got["launches"] == want,
                      f"{what}: rank {r} launched {got['launches']}, want {want}")
            launches[f"{key}_per_rank"] = res[0]["launches"]
            comm[key] = check_shard_comm(what, card, mode, res[0], replicas=name == "model2")
            if family == "videomae" and key == f"{mode}_{family}":
                nbytes[mode] = [got["bytes"] for got in res]
    del ranks
    gc.collect()
    nbytes["one_process"] = [refs["videomae"]["bytes"]]
    gib = {m: [b["total"] / 2**30 for b in v] for m, v in nbytes.items()}
    print(f"per-rank state of VideoMAE-B (parameters, gradients, optimizer state), GiB at "
          f"world 2 [{card}]: {json.dumps(gib)}", flush=True)

    tp_kernels = phase_tp_kernels()
    entry = sharding_entry_point(root, corpus, per_step)
    multi = None
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        multi = shard_multi_card(card, n_cards, train_B, root)
    wall = time.perf_counter() - t0
    print(f"sharding: phase in {wall:.1f} s", flush=True)
    for family in world1:
        for mode in SHARD_MODES:
            launches[f"{mode}_{family}_world1"] = world1[family][mode].pop("launches")
    return {"world1": world1, "gloo_two_ranks": gloo, "bytes": nbytes, "tp_kernels": tp_kernels,
            "entry_point": entry, "multi_card": multi, "wall_s": wall, "launches": launches,
            "comm": comm}


def shard_multi_card(card: str, n: int, B: int, root: Path) -> dict:
    """(f) World ``n`` over NCCL, a card a rank: ``fsdp`` at ``data=n`` with
    VideoMAE-B at ``B`` clips a card, and ``tp`` at ``data=n/2,model=2`` with
    ``B`` clips a data row (each of its two cards on the whole block), each
    against one card at the global batch (``grad_accum`` keeping 24 clips a
    microbatch): loss and gradient limits as (a); per-card clips/s (the
    slowest rank's CUDA events over ``DDP_TIMED_STEPS`` steps, clips of the
    global batch over the cards) and the scaling efficiency against one
    card's unwrapped rate at ``B``."""
    import gc

    import torch

    one_new, one_step, one_args = ddp_family("videomae", B)
    one_state = one_new()
    one_args = {k: v.cuda() for k, v in one_args.items()}
    ddp_call("videomae", one_step, one_state, one_args)  # warm-up
    one_card = B / (steps_ms("videomae", one_step, one_state, one_args) / 1e3)
    del one_state, one_args
    out = {"one_card_clips_s": one_card}
    for mode, mesh in (("fsdp", {"data": n}), ("tp", {"data": n // 2, "model": 2})):
        global_B = B * mesh["data"]
        new_state, step, args = ddp_family("videomae", global_B, grad_accum=global_B // 24)
        ref_state = new_state()
        ref = step_readings("videomae", step, ref_state, {k: v.cuda() for k, v in args.items()})
        ref["grads"] = {k: v.cpu() for k, v in ref["grads"].items()}
        del ref_state, args
        gc.collect()
        torch.cuda.empty_cache()
        ranks = run_shard_ranks(root, n, {mode: {"mesh": mesh,
                                                 "runs": [[mode, "videomae", global_B, B // 24]],
                                                 "timed": DDP_TIMED_STEPS}}, "nccl",
                                one_card=False)
        what = f"{mode} world {n} over NCCL, a card a rank [videomae, {mesh}]"
        record = check_ddp_against(what, ranks[0][mode, mode, "videomae"], ref)
        ms = [r[mode, mode, "videomae"]["ms"] for r in ranks]
        per_card = global_B / n / (max(ms) / 1e3)
        record.update({"mesh": mesh, "global_B": global_B, "ms": ms,
                       "clips_s_per_card": per_card, "clips_s": per_card * n,
                       "scaling_efficiency": per_card / one_card,
                       "bytes": [r[mode, mode, "videomae"]["bytes"] for r in ranks]})
        print(f"{what} [{card}]: {per_card:.1f} clips/s a card ({n * per_card:.1f} in all) "
              f"against one card's {one_card:.1f}: scaling efficiency "
              f"{record['scaling_efficiency']:.3f}", flush=True)
        out[mode] = record
        del ranks
        gc.collect()
    return out


# ---------------------------------------------------------------- slice 7c

SEQ_FRAMES = 64  # VideoMAE-B at 64 frames, tubelet 2, 224 px: 6272 tokens, 640 visible at 0.9
SEQ_B = 4  # clips a ring in (b)-(d)
SEQ_WORLD1_LOSS_RTOL = 1e-6  # the seq step at seq=1 against the unwrapped step
SEQ_WORLD1_COSINE_MIN = 0.99995  # per parameter tensor
# The ring rounds each hop's O and each hop's dQ, dK, dV partial to bf16
# before its f32 merge or sum (S + 1 roundings against flash's one), so
# phase 3's 1e-3 |err|/|ref| between two single roundings of one f32 sum
# does not apply to it (the card read 5.0e-3 for dQ at S = 4 against flash
# over the whole sequence).  Both are held instead against the same
# attention in f32 math: the ring's |err|/|ref| at most this multiple of
# flash's own (the CPU emulation in bf16 read 3.0e-3 against flash's 2.4e-3
# at N = 1024)
RING_REL_FACTOR = 2.0
SEQ_RING_CASES = ((2, 6272, 12, 64), (2, 6272, 6, 64))  # encoder's and decoder's heads
SEQ_MASKED_CASE = (64, 200, 12, 32)  # 4 chunks of 50 keys, key bias at d = 32
SEQ_HOP_SHAPES = ((8, 80, 12, 64), (8, 160, 12, 64))  # the encoder's visible block at S = 8, 4
SEQ_TIMED_STEPS = 3
SEQ_CLI_STEPS = 3
# (c)'s f32 step at seq=2 (the ring's plain route, f32 K/V on the ring)
# against the unwrapped f32 step: the same math summed in another order
SEQ_F32_LOSS_RTOL = 1e-5
SEQ_F32_COSINE_MIN = 0.99999  # per parameter tensor


def seq_config(frames: int = SEQ_FRAMES, dtype: str = "bfloat16"):
    """VideoMAE-B at ``frames`` frames (tubelet 2, 224 px, computing in
    ``dtype``), the tube mask at 0.9 and SGD with momentum."""
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig, OptimConfig

    return (ModelConfig(num_frames=frames, dtype=dtype),
            MaskConfig(sampler="tube", mask_ratio=0.9),
            OptimConfig(name="sgd", lr=0.1, momentum=0.9))


def seq_batch(B: int, frames: int = SEQ_FRAMES):
    """``(video, mask)`` on the host: ``B`` uint8 clips from seed 0 and the
    tube mask of the whole clips' ``[B, N]`` tokens drawn from a CPU
    generator seeded 0."""
    import numpy as np
    import torch

    from bvc_tpu_torch.masks.tube import tube_mask

    cfg = seq_config(frames)[0]
    g = cfg.image_size // cfg.patch_size
    video = np.random.default_rng(0).integers(0, 256, (B, frames, cfg.image_size,
                                                       cfg.image_size, 3), dtype=np.uint8)
    mask = tube_mask(torch.Generator().manual_seed(0), B, (cfg.num_time_steps, g, g), 0.9)
    return torch.from_numpy(video), mask


def seq_state(mode: str = "replicated", frames: int = SEQ_FRAMES, dtype: str = "bfloat16"):
    """VideoMAE-B from seed 0 on the card, computing in ``dtype``, laid out
    by ``mode`` over the process's mesh."""
    from bvc_tpu_torch.training.state import TrainState

    optim = seq_config(frames)[2]
    return TrainState.create(copy.deepcopy(base_model("videomae", frames, dtype)), optim,
                             seed=1, param_sharding=mode)


def seq_step_for(mesh, frames: int = SEQ_FRAMES, dtype: str = "bfloat16"):
    """``(layout, step)`` on ``mesh``: the seq x TP step (state ``tp``)
    where it has a ``model`` axis, else the seq step (``replicated``)."""
    from bvc_tpu_torch.parallel.seqpar import (make_seq_tp_videomae_train_step,
                                               make_seq_videomae_train_step)

    cfg, mask_cfg, _ = seq_config(frames, dtype)
    if "model" in mesh.axis_names:
        return "tp", make_seq_tp_videomae_train_step(cfg, mask_cfg, mesh=mesh)
    return "replicated", make_seq_videomae_train_step(cfg, mask_cfg, mesh=mesh)


def call_readings(call, state, record: str | None = None) -> dict:
    """``call()`` (one step) with the launch counts set to 0 just before it:
    its loss, launches and every parameter's whole gradient on the card
    (gathered from the ranks' parts under ``fsdp`` and ``tp``: a
    collective); with ``record`` (the step's name) also the collectives the
    step issued, as dicts under ``"comm"`` (recorded around the call alone,
    so the gathers of the gradients are not among them)."""
    import contextlib

    import torch

    from bvc_tpu_torch.parallel import record_collectives
    from bvc_tpu_torch.parallel.sharding import full_tensor

    reset_launches()
    with record_collectives(record) if record else contextlib.nullcontext([]) as ops:
        metrics = call()
    torch.cuda.synchronize()
    launches = read_launches()
    return {"loss": metrics["loss"].item(), "launches": launches, "comm": comm_ops(ops),
            "grads": {n: full_tensor(p, p.grad).detach().flatten().clone()
                      for n, p in state.model.named_parameters()}}


def events_ms(fn, n: int) -> float:
    """Device time of one ``fn()``, ms, by CUDA events over ``n`` calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def dispatch_ms(fn) -> float:
    """Host time to dispatch one ``fn()`` (a step) into an empty queue, ms:
    beside the step's device time, how far the host's pace holds it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def rel_err(x, ref) -> tuple[float, float, float]:
    """(max |x - ref|, max |ref|, |x - ref| / |ref|) in f32."""
    diff = x.float() - ref.float()
    return diff.abs().max().item(), ref.float().abs().max().item(), (
        diff.norm() / ref.float().norm()).item()


def ring_case(label: str, B: int, N: int, h: int, d: int, S: int, key_mask=None) -> dict:
    """``ring_attention_chunks`` over ``S`` chunks, forward and backward,
    against ``flash_attention`` over the whole sequence on the same inputs:
    O and the merged LSE within phase 2's limits, dQ, dK and dV within
    phase 3's ``BWD_TOL`` of max|ref|, rows without a key +inf in both; O
    and the gradients of both against the same attention in f32 math, the
    ring's |err|/|ref| within ``RING_REL_FACTOR`` times flash's; and the
    call's launches: S of the forward kernel and S of each backward kernel
    (the key-bias ones with a mask)."""
    import torch

    from bvc_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd_ref,
                                                   flash_attention_fwd,
                                                   flash_attention_fwd_ref, key_bias)
    from bvc_tpu_torch.ops.ring_attention import ring_attention_chunks

    q, qs, k, v = qkv_inputs(B, N, h, d, seed=7 * N + h + S)
    gen = torch.Generator(device="cuda").manual_seed(S)
    do = torch.randn((B, N, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    reset_launches()
    o, lse = ring_attention_chunks(*leaves, S, key_mask=key_mask, return_lse=True)
    o.backward(do)
    torch.cuda.synchronize()
    launches = read_launches()
    grads = [x.grad for x in leaves]
    refs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = flash_attention(*refs, key_mask=key_mask)
    o_ref.backward(do)
    bias = None if key_mask is None else key_bias(key_mask)
    lse_ref = flash_attention_fwd(qs, k, v, bias)[1]
    torch.cuda.synchronize()
    suffix = "" if key_mask is None else "_bias"
    want = {f"flash_fwd{suffix}": S, **{f"flash_bwd{p}{suffix}": S for p in ("_prep", "", "_post")}}
    want = {**{name: 0 for name in launches}, **want}
    check(launches == want, f"ring {label}: launches {launches}, want {want}")
    # the same attention in f32 math on the same (bf16) inputs
    f32 = [x.float() for x in (qs, k, v)]
    o32, lse32 = flash_attention_fwd_ref(*f32, bias)
    exact = [o32, *flash_attention_bwd_ref(*f32, o32, lse32, do.float(), bias)]
    exact[1] = exact[1] * d ** -0.5  # dQ from dQs
    rows = torch.isfinite(lse_ref)
    check(bool(torch.equal(rows, torch.isfinite(lse))), f"ring {label}: rows without a key differ")
    err_lse = (lse[rows] - lse_ref[rows]).abs().max().item() if rows.any() else 0.0
    err_o = rel_err(o, o_ref)[0]
    check(torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
          and torch.allclose(lse[rows], lse_ref[rows], atol=LSE_TOL, rtol=LSE_TOL),
          f"ring {label}: O max {err_o}, LSE {err_lse}")
    rec = {"shape": [B, N, h, d], "S": S, "bias": key_mask is not None, "o": err_o,
           "lse": err_lse, "launches": launches}
    for i, (name, x, ref) in enumerate(zip(("o", "dq", "dk", "dv"), [o, *grads],
                                           [o_ref, *(r.grad for r in refs)])):
        if name != "o":
            err, scale, _ = rel_err(x, ref)
            check(err <= BWD_TOL * scale,
                  f"ring {label}: {name} max {err} against flash's (max|ref| {scale})")
            rec[name] = err
        ring_rel, flash_rel = rel_err(x, exact[i])[2], rel_err(ref, exact[i])[2]
        check(ring_rel <= RING_REL_FACTOR * flash_rel,
              f"ring {label}: {name} |err|/|ref| {ring_rel} against f32 math, flash's {flash_rel}")
        rec[f"{name}_rel_f32"], rec[f"{name}_flash_rel_f32"] = ring_rel, flash_rel
    del exact, o32, lse32, f32
    print(f"ring {label} [{B},{N},{h},{d}] S={S}: O max {err_o:.3e}, LSE {err_lse:.3e} against "
          f"flash; |err|/|ref| against f32 math, ring (flash): " + ", ".join(
              f"{n} {rec[f'{n}_rel_f32']:.3e} ({rec[f'{n}_flash_rel_f32']:.3e})"
              for n in ("o", "dq", "dk", "dv")) + f"; launches {S} of each kernel", flush=True)
    return rec


def ring_masks(B: int, N: int):
    """A ``[B, N]`` key mask on the card: 60% of the keys kept, then
    elements 0-7 with every key of chunk ``b % 4`` (of 4) masked, 8-11 with
    the first half masked (every key of a hop at S = 2 and of two at S =
    4), 12 and 13 with every key masked."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    keep = torch.rand((B, N), generator=gen, device="cuda") < 0.6
    c = N // 4
    for b in range(8):
        keep[b, (b % 4) * c:(b % 4 + 1) * c] = False
    keep[8:12, :N // 2] = False
    keep[12:14] = False
    return keep


def seq_hop_times(card: str) -> dict:
    """A forward hop (the kernel, then the merge into f32 accumulators) and
    a backward hop (the three kernels, then the f32 sums) at the encoder's
    visible block of 80 and 160 tokens, against the same hops through the
    plain versions, by CUDA events (the host's launch pace: a hop is a
    dozen small launches) and in a CUDA graph (the device's time)."""
    import math as _math

    import torch

    from bvc_tpu_torch.ops.flash_attention import (flash_attention_bwd_ref,
                                                   flash_attention_fwd_ref, flash_bwd_cuda,
                                                   flash_fwd_cuda)
    from bvc_tpu_torch.ops.ring_attention import merge_hop

    out = {}
    for B, n, h, d in SEQ_HOP_SHAPES:
        _, qs, k, v = qkv_inputs(B, n, h, d, seed=n)
        acc = torch.zeros((B, n, h, d), dtype=torch.float32, device="cuda")
        lse0 = torch.full((B, h, n), -_math.inf, dtype=torch.float32, device="cuda")
        o, lse = flash_fwd_cuda(qs, k, v)
        do = torch.randn_like(o)
        sums = [torch.zeros((B, n, h, d), dtype=torch.float32, device="cuda") for _ in range(3)]

        def bwd_hop(fn):
            for s, g in zip(sums, fn(qs, k, v, o, lse, do)):
                s += g.float()

        hops = {"fwd": lambda: merge_hop(acc, lse0, *flash_fwd_cuda(qs, k, v), 1),
                "fwd_plain": lambda: merge_hop(acc, lse0, *flash_attention_fwd_ref(qs, k, v), 1),
                "bwd": lambda: bwd_hop(flash_bwd_cuda),
                "bwd_plain": lambda: bwd_hop(flash_attention_bwd_ref)}
        rec = {"shape": [B, n, h, d]}
        for name, fn in hops.items():  # events (the host's pace) and in a CUDA graph
            rec[f"{name}_ms"], rec[f"{name}_graph_ms"] = time_ms(fn), graph_ms(fn)
        print(f"ring hop [{B},{n},{h},{d}] [{card}], ms by events / in a graph: forward "
              f"{rec['fwd_ms']:.4f} / {rec['fwd_graph_ms']:.4f} (plain "
              f"{rec['fwd_plain_ms']:.4f} / {rec['fwd_plain_graph_ms']:.4f}), backward "
              f"{rec['bwd_ms']:.4f} / {rec['bwd_graph_ms']:.4f} (plain "
              f"{rec['bwd_plain_ms']:.4f} / {rec['bwd_plain_graph_ms']:.4f})", flush=True)
        out[f"{n}_tokens"] = rec
    return out


def seq_ring_phase(card: str) -> dict:
    """(a) The ring's hop math at full width in one process
    (``ring_attention_chunks``): S = 4 and 2 over the encoder's and the
    decoder's heads at 6272 tokens, and with a key mask at d = 32; then the
    hop times."""
    import torch

    out = {}
    for B, N, h, d in SEQ_RING_CASES:
        for S in (4, 2):
            out[f"{B}x{N}x{h}x{d}_S{S}"] = ring_case("unmasked", B, N, h, d, S)
            torch.cuda.empty_cache()
    B, N, h, d = SEQ_MASKED_CASE
    mask = ring_masks(B, N)
    for S in (4, 2):
        out[f"{B}x{N}x{h}x{d}_S{S}_bias"] = ring_case("key mask", B, N, h, d, S, mask)
    out["hops"] = seq_hop_times(card)
    return out


def seq_reference(B: int, frames: int = SEQ_FRAMES, dtype: str = "bfloat16",
                  timed: bool = True) -> dict:
    """One process on the card, no process group: the unwrapped VideoMAE-B
    step in ``dtype`` at ``B`` clips of ``frames`` frames on
    :func:`seq_batch`'s clips and mask; its loss, launches, gradients (on
    the host), peak memory (above what the process held before: earlier
    phases' tensors do not count, as a rank's fresh process holds none)
    and, with ``timed``, step time (CUDA events over ``SEQ_TIMED_STEPS``
    further steps) and dispatch time."""
    import gc

    import torch

    from bvc_tpu_torch.training.steps import make_videomae_train_step

    cfg, mask_cfg, _ = seq_config(frames, dtype)
    held = torch.cuda.memory_allocated()
    video, mask = (x.cuda() for x in seq_batch(B, frames))
    state = seq_state(frames=frames, dtype=dtype)
    step = make_videomae_train_step(cfg, mask_cfg)
    torch.cuda.reset_peak_memory_stats()
    want = call_readings(lambda: step(state, video, mask), state)
    want["peak_bytes"] = torch.cuda.max_memory_allocated() - held
    if timed:
        want["ms"] = events_ms(lambda: step(state, video, mask), SEQ_TIMED_STEPS)
        want["dispatch_ms"] = dispatch_ms(lambda: step(state, video, mask))
    want["grads"] = {n: g.cpu() for n, g in want["grads"].items()}
    del state, video, mask
    gc.collect()
    torch.cuda.empty_cache()
    return want


def seq_world1(card: str, want: dict, B: int) -> dict:
    """(b) World 1 over NCCL at ``--mesh data=1,seq=1``: the seq step (a
    ring of one, DDP over the world) against the unwrapped step on the
    same clips and mask: loss within ``SEQ_WORLD1_LOSS_RTOL``, gradient
    cosine >= ``SEQ_WORLD1_COSINE_MIN`` per tensor, launches equal; its
    step time beside the seq step's without a process group (no DDP) and
    the unwrapped step's."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init, make_mesh

    video, mask = (x.cuda() for x in seq_batch(B))
    # the seq step without a process group (no DDP): what the ring of one
    # costs apart from DDP's
    _, step = seq_step_for(make_mesh({"data": 1, "seq": 1}))
    alone = seq_state()
    step(alone, video, mask)
    alone_ms = events_ms(lambda: step(alone, video, mask), SEQ_TIMED_STEPS)
    del alone
    gc.collect()
    with rendezvous():
        distributed_init()
        check(torch.distributed.get_backend() == "nccl", "world 1 on cuda: not NCCL")
        mesh = make_mesh({"data": 1, "seq": 1})
        _, step = seq_step_for(mesh)
        state = seq_state()
        check(state.ddp is not None, "no DDP wrapper under a process group")
        got = call_readings(lambda: step(state, video[:, step.time_slice], mask), state)
        ms = events_ms(lambda: step(state, video[:, step.time_slice], mask), SEQ_TIMED_STEPS)
        del state
        gc.collect()
    torch.cuda.empty_cache()
    what = f"seq world 1 over NCCL [data=1,seq=1, B={B}, {SEQ_FRAMES} frames]"
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    cos = min((torch.nn.functional.cosine_similarity(
        got["grads"][n].float(), g.float().cuda(), dim=0).item(), n)
        for n, g in want["grads"].items())
    print(f"{what} [{card}]: loss {got['loss']:.7f} vs {want['loss']:.7f} (rel {rel:.2e}), "
          f"lowest gradient cosine {cos[1]} {cos[0]:.7f}, launches {got['launches']}; step "
          f"{ms:.1f} ms (without DDP {alone_ms:.1f}) against the unwrapped step's "
          f"{want['ms']:.1f}", flush=True)
    check(rel <= SEQ_WORLD1_LOSS_RTOL, f"{what}: loss rel {rel} > {SEQ_WORLD1_LOSS_RTOL}")
    check(cos[0] >= SEQ_WORLD1_COSINE_MIN, f"{what}: gradient cosine {cos}")
    check(got["launches"] == want["launches"],
          f"{what}: launches {got['launches']} vs the unwrapped step's {want['launches']}")
    return {"loss_rel": rel, "min_cosine": cos[0], "min_cosine_tensor": cos[1],
            "launches": got["launches"], "ms": ms, "no_ddp_ms": alone_ms,
            "unwrapped_ms": want["ms"]}


def shift_ms(tensors: list, group, reps: int = 5) -> float:
    """Host time of one ``ring_shift`` of ``tensors`` over ``group`` after a
    synchronisation, to its received tensors on the card; the median of
    ``reps``."""
    import torch

    from bvc_tpu_torch.parallel.collectives import ring_shift

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring_shift(tensors, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def seq_rank_worker(out: str, job: str, backend: str) -> None:
    """One rank of a sequence-parallel run (torchrun's variables in the
    environment): the job's mesh; with ``train``, one step of VideoMAE-B on
    this rank's data block and time slice of :func:`seq_batch` (loss,
    launches, peak memory, the whole gradients on rank 0), ``timed`` timed
    steps, with ``comm`` the step's collectives, and the transport time of
    the encoder's and decoder's K/V blocks over the ring; with ``f32``, one
    step of the same model computing in f32 (the ring's plain route): its
    loss, launches, collectives, peak memory and gradients on rank 0, under
    ``"f32"``; with ``embeds``, the VideoMAE-B and V-JEPA seq embeds of
    the clips (rows and launches of a call).  Writes its result to
    ``{out}.rank{r}``."""
    import gc

    import torch

    from bvc_tpu_torch.models.jepa import JEPAEncoder
    from bvc_tpu_torch.models.videomae import VideoMAEEncoder
    from bvc_tpu_torch.parallel import distributed_init, make_mesh, rank, tree_bytes
    from bvc_tpu_torch.parallel.seqpar import seq_embed, time_slice

    job = json.loads(job)
    distributed_init(backend=backend)
    mesh = make_mesh(job["mesh"])
    B = job["B"]
    D, d_rank = mesh.axis_size("data"), mesh.coord("data")
    b = B // D
    video, mask = seq_batch(B)
    video, mask = video[d_rank * b:(d_rank + 1) * b], mask[d_rank * b:(d_rank + 1) * b]
    result: dict = {"coords": mesh.coords}
    if job["train"]:
        layout, step = seq_step_for(mesh)
        local = video[:, step.time_slice].cuda()
        state = seq_state(layout)
        torch.cuda.reset_peak_memory_stats()
        readings = call_readings(lambda: step(state, local, mask), state,
                                 step.computation if job.get("comm") else None)
        result["peak_bytes"] = torch.cuda.max_memory_allocated()
        result["ms"] = result["dispatch_ms"] = None
        if job["timed"]:
            result["ms"] = events_ms(lambda: step(state, local, mask), job["timed"])
            result["dispatch_ms"] = dispatch_ms(lambda: step(state, local, mask))
        result.update(loss=readings["loss"], launches=readings["launches"],
                      grads=({n: g.cpu() for n, g in readings["grads"].items()}
                             if rank() == 0 else None),
                      comm=readings["comm"], held_bytes=tree_bytes(state.model))
        del state, readings
        gc.collect()
        torch.cuda.empty_cache()
        cfg = seq_config()[0]
        S, M = mesh.axis_size("seq"), mesh.axis_size("model")
        n_vis, n_all = cfg.seq_len // 10 // S, cfg.seq_len // S
        blocks = {"encoder": (b, n_vis, 12 // M, 64), "decoder": (b, n_all, 6 // M, 64)}
        result["shift_ms"] = {
            k: shift_ms([torch.zeros(s, dtype=torch.bfloat16, device="cuda")] * 2,
                        mesh.group("seq")) for k, s in blocks.items()}
    if job.get("f32"):
        t0 = time.perf_counter()
        _, step = seq_step_for(mesh, dtype="float32")
        local = video[:, step.time_slice].cuda()
        state = seq_state(dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        readings = call_readings(lambda: step(state, local, mask), state, step.computation)
        result["f32"] = {"loss": readings["loss"], "launches": readings["launches"],
                         "comm": readings["comm"], "held_bytes": tree_bytes(state.model),
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "grads": ({n: g.cpu() for n, g in readings["grads"].items()}
                                   if rank() == 0 else None),
                         "s": time.perf_counter() - t0}
        del state, readings
        gc.collect()
        torch.cuda.empty_cache()
    if job["embeds"]:
        cfg = seq_config()[0]
        jcfg = jepa_config()[0]
        result["embeds"] = {}
        for family, enc_cfg, clips in (("videomae", cfg, video),
                                       ("jepa", jcfg, video[:, :jcfg.num_frames])):
            encoder = (VideoMAEEncoder if family == "videomae" else JEPAEncoder)(
                enc_cfg, seed=0).cuda().eval()
            x = clips[:, time_slice(enc_cfg, mesh)].cuda()
            reset_launches()
            with torch.inference_mode():
                emb = seq_embed(encoder, x, mesh)
            torch.cuda.synchronize()
            result["embeds"][family] = {"rows": emb.cpu(), "launches": read_launches()}
            del encoder
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def run_seq_ranks(out_dir: Path, world: int, job: dict, backend: str,
                  one_card: bool) -> list[dict]:
    out = str(out_dir / "seq")
    return run_rank_workers(world, f"seq_rank_worker({out!r}, {json.dumps(job)!r}, "
                                   f"{backend!r})", out, one_card)


def check_seq_ranks(what: str, ranks: list[dict], want: dict, per_rank: dict) -> dict:
    """Rank 0's loss and whole gradients against ``want`` under the DDP
    limits (every rank's loss is the mean over the gradient group), each
    rank's launches ``per_rank``; returns the readings with each rank's
    peak memory."""
    rec = check_ddp_against(what, ranks[0], want)
    for r, res in enumerate(ranks):
        check(res["launches"] == per_rank,
              f"{what}: rank {r} launched {res['launches']}, want {per_rank}")
        check(abs(res["loss"] - ranks[0]["loss"]) <= 1e-6 * abs(ranks[0]["loss"]),
              f"{what}: rank {r}'s loss {res['loss']} differs from rank 0's")
    rec.update(launches_per_rank=ranks[0]["launches"],
               peak_gib_per_rank=[res["peak_bytes"] / 2**30 for res in ranks],
               peak_gib_one_process=want["peak_bytes"] / 2**30,
               shift_ms=ranks[0]["shift_ms"], ms_per_rank=[res["ms"] for res in ranks],
               dispatch_ms_per_rank=[res["dispatch_ms"] for res in ranks])
    print(f"{what}: peak memory a rank {rec['peak_gib_per_rank']} GiB against one process's "
          f"{rec['peak_gib_one_process']:.2f}; K/V shift over the ring {rec['shift_ms']} ms",
          flush=True)
    return rec


def ring_send_bytes(cfg, S: int, b: int, mask_ratio: float) -> int:
    """Bytes a rank of a seq ring of ``S`` sends in a step of ``b`` clips:
    in each attention layer its K and V blocks ``S - 1`` times forward and
    ``S - 1`` times backward, and their f32 dK and dV ``S`` times
    (``ops/ring_attention.py``); the encoder over the rank's visible
    tokens, the decoder over its grid."""
    item = 2 if cfg.dtype == "bfloat16" else 4
    space = (cfg.image_size // cfg.patch_size) ** 2
    sheets = cfg.num_time_steps // S
    visible = (space - int(mask_ratio * space)) * sheets
    total = 0
    for n, width, layers in ((visible, cfg.hidden_size, cfg.depth),
                             (space * sheets, cfg.decoder_hidden_size, cfg.decoder_depth)):
        block = b * n * width
        total += layers * (2 * (S - 1) * 2 * block * item + S * 2 * block * 4)
    return total


def check_seq_comm(what: str, card: str, res: dict, dtype: str = "bfloat16") -> dict:
    """The seq step's collectives (rank 0's at ``seq=2``, computing in
    ``dtype``): one gradient all-reduce of the parameters' bytes (DDP over
    the gradient group), the ring's sends byte for byte
    (:func:`ring_send_bytes`), nothing gathered or scattered.  Returns the
    comm record."""
    held = res["held_bytes"]
    cfg, mask_cfg, _ = seq_config(dtype=dtype)
    sends = ring_send_bytes(cfg, 2, SEQ_B, mask_cfg.mask_ratio)
    report, rec = comm_record(what, card, res["comm"], held_bytes=held, ring_send_bytes=sends)
    check(report.bytes_for("all-reduce", COMM_BIG) == held,
          f"{what}: all-reduces {report.bytes_for('all-reduce', COMM_BIG)}, want {held}")
    got = report.bytes_for("collective-permute")
    check(got == sends, f"{what}: the ring sent {got} bytes, want {sends}")
    check_no_big(what, report, "all-gather", "reduce-scatter", "broadcast")
    return rec


def seq_launches(per_step: dict, hops: int) -> dict:
    """The launches of a seq rank's step: the unwrapped step's, each
    attention ``hops`` times."""
    return {k: v * hops for k, v in per_step.items()}


def seq_cli_worker(out: str, argv: str) -> None:
    """One rank of ``pretrain_videomae`` (torchrun's variables in the
    environment, gloo): ``main(argv)`` with the launch counts set to 0
    before; rank 0 then embeds clips through ``make_embed_fn`` of the
    stage's checkpoint and through the trained encoder in memory (captured
    from the step)."""
    import numpy as np
    import torch

    from bvc_tpu_torch.cli import pretrain_videomae
    from bvc_tpu_torch.evalbench.extract import make_embed_fn
    from bvc_tpu_torch.parallel import distributed_init, rank
    from bvc_tpu_torch.training import trainer_videomae

    distributed_init(backend="gloo")
    seen: dict = {}
    make = trainer_videomae.make_seq_videomae_train_step

    def patched(*args, **kw):
        step = make(*args, **kw)

        def wrapped(state, batch):
            seen["state"] = state
            return step(state, batch)

        wrapped.eval_step, wrapped.time_slice = step.eval_step, step.time_slice
        return wrapped

    trainer_videomae.make_seq_videomae_train_step = patched
    argv = json.loads(argv)
    reset_launches()
    summary = pretrain_videomae.main(argv)
    torch.cuda.synchronize()
    result = {"summary": summary, "launches": read_launches()}
    if rank() == 0:
        cfg = pretrain_videomae.config_from_args(pretrain_videomae.build_parser().parse_args(argv))
        clips = np.random.default_rng(5).integers(0, 256, (2, SEQ_FRAMES, 224, 224, 3),
                                                  dtype=np.uint8)
        emb = make_embed_fn("videomae", summary["checkpoint"], cfg.model)(clips)
        with torch.inference_mode():
            ref = seen["state"].model.encoder.embed(torch.from_numpy(clips).cuda()).cpu().numpy()
        result["cosine"] = float(((emb * ref).sum(1) / (np.linalg.norm(emb, axis=1)
                                                        * np.linalg.norm(ref, axis=1))).min())
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def seq_entry_point(root: Path, corpus: tuple[str, str], per_step: dict) -> dict:
    """(e) ``pretrain_videomae --mesh data=1,seq=2 --num_frames 64`` on two
    gloo ranks on the card, 3 steps: the CSV's losses finite, each rank's
    launches its steps', and the checkpoint through ``make_embed_fn`` at
    cosine >= 0.999 to the trained model in memory."""
    jpg, pack = corpus
    rid = "dev_1_g0_default_0_0"
    argv = ["-jpg_root", jpg, "--pack_root", pack, "-savedir", str(root / "seq_cli"),
            "--batch_size", "2", "--n_trainsamples", str(2 * SEQ_CLI_STEPS),
            "--max_epoch_iters", str(SEQ_CLI_STEPS), "--run_id", rid, "--num_frames",
            str(SEQ_FRAMES), "--mesh", "data=1,seq=2", "--num_workers", "2"]
    out = str(root / "seq_cli_rank")
    t0 = time.perf_counter()
    ranks = run_rank_workers(2, f"seq_cli_worker({out!r}, {json.dumps(argv)!r})", out, True)
    wall = time.perf_counter() - t0
    losses = check_csv(root / "seq_cli" / f"csvlog_{rid}.csv", SEQ_CLI_STEPS, 2,
                       "pretrain_videomae --mesh data=1,seq=2")
    for r, res in enumerate(ranks):
        check_cli_launches(res["launches"], per_step, SEQ_CLI_STEPS,
                           f"pretrain_videomae --mesh data=1,seq=2, rank {r}")
    cos = ranks[0]["cosine"]
    print(f"pretrain_videomae --mesh data=1,seq=2 --num_frames {SEQ_FRAMES}: losses {losses}, "
          f"launches a rank {ranks[0]['launches']}, checkpoint embed cosine min {cos:.6f}, "
          f"{wall:.1f} s", flush=True)
    check(cos >= COSINE_MIN, f"seq cli: checkpoint embed cosine {cos}")
    return {"losses": losses, "cosine": cos, "wall_s": wall}


def seq_one_process_embeds(video) -> dict:
    """The VideoMAE-B and V-JEPA embeds of one process (no ring) on the
    clips (V-JEPA on their first frames), on the host."""
    import torch

    from bvc_tpu_torch.models.jepa import JEPAEncoder
    from bvc_tpu_torch.models.videomae import VideoMAEEncoder

    cfg, jcfg = seq_config()[0], jepa_config()[0]
    out = {}
    with torch.inference_mode():
        for family, enc_cfg, clips in (("videomae", cfg, video),
                                       ("jepa", jcfg, video[:, :jcfg.num_frames])):
            encoder = (VideoMAEEncoder if family == "videomae" else JEPAEncoder)(
                enc_cfg, seed=0).cuda().eval()
            out[family] = encoder.embed(clips.cuda()).cpu()
            del encoder
    return out


def check_seq_f32(what: str, card: str, ranks: list[dict], want: dict, ref_s: float) -> dict:
    """The f32 step of the ``seq=2`` ranks (their ``"f32"`` readings)
    against the unwrapped f32 step ``want`` (``ref_s`` seconds on the
    card): within ``SEQ_F32_LOSS_RTOL`` and ``SEQ_F32_COSINE_MIN``, no
    kernel launched by either, the ring's sends in f32 byte for byte;
    returns the readings with the ranks' peak memory and seconds (the
    model's build and the step)."""
    got = [res["f32"] for res in ranks]
    rec = check_ddp_against(what, got[0], want, SEQ_F32_LOSS_RTOL, SEQ_F32_COSINE_MIN)
    for r, res in enumerate([want, *got]):
        check(not any(res["launches"].values()),
              f"{what}: {'the unwrapped step' if r == 0 else f'rank {r - 1}'} launched "
              f"{res['launches']}")
    rec["comm"] = check_seq_comm(what, card, got[0], dtype="float32")
    rec.update(peak_gib_per_rank=[res["peak_bytes"] / 2**30 for res in got],
               peak_gib_one_process=want["peak_bytes"] / 2**30, reference_s=ref_s,
               rank_s=[res["s"] for res in got])
    print(f"{what} [{card}]: no kernel launched; peak memory a rank "
          f"{rec['peak_gib_per_rank']} GiB against one process's "
          f"{rec['peak_gib_one_process']:.2f}; the unwrapped f32 step {ref_s:.1f} s, the "
          f"ranks' f32 legs {max(rec['rank_s']):.1f} s", flush=True)
    return rec


def phase_seqpar(card: str, root: Path, corpus: tuple[str, str], per_step: dict) -> dict:
    """Sequence parallelism on the card (slice 7c).  (a) The ring's hop
    math at full width in one process, and the hop times.  (b) World 1
    over NCCL at ``data=1,seq=1`` against the unwrapped step.  (c) Two gloo
    ranks on the card at ``data=1,seq=2``, VideoMAE-B at 64 frames, B=4,
    against one process at the same batch (the DDP limits), per-rank peak
    memory, launches and the K/V shift time; then the same step computing
    in f32 (the ring's plain route: f32 K/V on the ring) against the
    unwrapped f32 step, loss within ``SEQ_F32_LOSS_RTOL`` and gradient
    cosine >= ``SEQ_F32_COSINE_MIN`` per tensor, no kernel launched, the
    ring's sends byte for byte; the VideoMAE-B (64 frames) and V-JEPA (2
    frames) seq embeds against one process's, cosine >= 0.999 per row.  (d) Four gloo ranks at ``data=1,seq=2,model=2`` against the same
    reference.  (e) The CLI at ``--mesh data=1,seq=2``.  With more than one
    card, :func:`seq_multi_card`.  Returns the records and, under
    ``"launches"``, each run's counts."""
    import gc

    import torch

    t0 = time.perf_counter()
    ring = seq_ring_phase(card)
    want = seq_reference(SEQ_B)
    t32 = time.perf_counter()
    want32 = seq_reference(SEQ_B, dtype="float32", timed=False)
    f32_s = time.perf_counter() - t32
    world1 = seq_world1(card, want, SEQ_B)
    video, _ = seq_batch(SEQ_B)
    embeds_want = seq_one_process_embeds(video)
    gc.collect()
    torch.cuda.empty_cache()
    records, launches = {}, {"world1": world1["launches"]}
    for name, world, mesh, embeds in (("seq2", 2, {"data": 1, "seq": 2}, True),
                                      ("seq2_tp2", 4, {"data": 1, "seq": 2, "model": 2}, False)):
        job = {"mesh": mesh, "B": SEQ_B, "train": True, "embeds": embeds, "timed": 0,
               "comm": name == "seq2", "f32": name == "seq2"}
        ranks = run_seq_ranks(root, world, job, "gloo", one_card=True)
        what = f"seq over gloo, {world} ranks on one card [{mesh}, B={SEQ_B}, {SEQ_FRAMES} frames]"
        records[name] = check_seq_ranks(what, ranks, want, seq_launches(want["launches"], 2))
        if job["comm"]:
            records[name]["comm"] = check_seq_comm(what, card, ranks[0])
        launches[f"{name}_per_rank"] = ranks[0]["launches"]
        if job["f32"]:
            records[f"{name}_f32"] = check_seq_f32(what.replace("[", "[f32, "), card, ranks,
                                                   want32, f32_s)
        if embeds:
            for family, ref in embeds_want.items():
                rows = [res["embeds"][family]["rows"] for res in ranks]
                cos = min(torch.nn.functional.cosine_similarity(r.float(), ref.float(), dim=1)
                          .min().item() for r in rows)
                call = ranks[0]["embeds"][family]["launches"]
                print(f"{family} seq embed at seq=2: cosine min {cos:.6f} against one process, "
                      f"launches a call a rank {call}", flush=True)
                check(cos >= COSINE_MIN, f"{family} seq embed cosine {cos}")
                check(call["flash_fwd"] == 24 and sum(call.values()) == 24,
                      f"{family} seq embed launches {call}: want 24 flash_fwd (12 layers, 2 hops)")
                records[f"{family}_embed"] = {"min_cosine": cos}
                launches[f"{family}_embed_per_rank"] = call
        del ranks
        gc.collect()
    entry = seq_entry_point(root, corpus, seq_launches(per_step, 2))
    multi = None
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        multi = seq_multi_card(card, n_cards, root)
    wall = time.perf_counter() - t0
    print(f"seqpar: phase in {wall:.1f} s", flush=True)
    return {"ring": ring, "world1": world1, "gloo": records, "entry_point": entry,
            "one_process": {"peak_gib": want["peak_bytes"] / 2**30, "ms": want["ms"]},
            "multi_card": multi, "wall_s": wall, "launches": launches}


def seq_multi_card(card: str, n: int, root: Path) -> dict:
    """With ``n`` > 1 cards (a host with four), over NCCL, a card a
    rank, VideoMAE-B at 64 frames: ``data=1,seq=n`` at B=4 a ring,
    ``data=2,seq=n/2`` (B=8 in all) and ``data=1,seq=n/2,model=2`` (B=4),
    each against one card at the global batch (the DDP limits); per-card
    clips/s (the slowest rank's CUDA events over ``SEQ_TIMED_STEPS`` steps)
    and peak memory beside one card's."""
    import gc

    import torch

    out = {}
    refs = {}
    for name, mesh, B in (("seq", {"data": 1, "seq": n}, SEQ_B),
                          ("data_seq", {"data": 2, "seq": n // 2}, 2 * SEQ_B),
                          ("seq_tp", {"data": 1, "seq": n // 2, "model": 2}, SEQ_B)):
        if B not in refs:
            refs[B] = seq_reference(B)
        want = refs[B]
        ranks = run_seq_ranks(root, n, {"mesh": mesh, "B": B, "train": True, "embeds": False,
                                        "timed": SEQ_TIMED_STEPS}, "nccl", one_card=False)
        what = f"seq over NCCL, {n} cards [{mesh}, B={B}, {SEQ_FRAMES} frames]"
        hops = mesh["seq"]
        rec = check_seq_ranks(what, ranks, want, seq_launches(want["launches"], hops))
        ms = max(rec["ms_per_rank"])
        one_card = B / (want["ms"] / 1e3)
        rec.update(mesh=mesh, B=B, clips_s=B / (ms / 1e3), clips_s_per_card=B / (ms / 1e3) / n,
                   one_card_clips_s=one_card, one_card_ms=want["ms"],
                   one_card_dispatch_ms=want["dispatch_ms"])
        print(f"{what} [{card}]: {rec['clips_s']:.2f} clips/s ({rec['clips_s_per_card']:.2f} a "
              f"card) against one card's {one_card:.2f}; a step {ms:.1f} ms on the slowest "
              f"card, its dispatch {max(rec['dispatch_ms_per_rank']):.1f} ms (one card "
              f"{want['ms']:.1f} and {want['dispatch_ms']:.1f}); peak a card "
              f"{max(rec['peak_gib_per_rank']):.2f} GiB against one card's "
              f"{rec['peak_gib_one_process']:.2f}", flush=True)
        out[name] = rec
        del ranks
        gc.collect()
    return out


# ---------------------------------------------------------------- slice 7d

PIPE_B = 16  # VideoMAE-B clips a step in (a)-(c) and (e)
PIPE_M = 4  # microbatches a step
PIPE_TIMED_STEPS = 3
PIPE_CLI_STEPS = 3
PIPE_CLI_B = 4


def pipe_bubble(P: int, M: int) -> float:
    """GPipe's bubble: the share of a stage's ticks without work."""
    return (P - 1) / (M + P - 1)


def pipe_reference(B: int) -> dict:
    """One process on the card, no process group: the unwrapped VideoMAE-B
    step at ``B`` on :func:`ddp_family`'s clips and mask; its loss,
    launches, gradients (on the host), peak memory above what the process
    held before, state bytes and step time (CUDA events over
    ``PIPE_TIMED_STEPS`` further steps)."""
    import gc

    import torch

    held = torch.cuda.memory_allocated()
    new_state, step, args = ddp_family("videomae", B)
    args = {k: v.cuda() for k, v in args.items()}
    state = new_state()
    torch.cuda.reset_peak_memory_stats()
    want = step_readings("videomae", step, state, args)
    want["peak_bytes"] = torch.cuda.max_memory_allocated() - held
    want["bytes"] = state_bytes(state)
    want["ms"] = steps_ms("videomae", step, state, args, PIPE_TIMED_STEPS)
    want["grads"] = {n: g.cpu() for n, g in want["grads"].items()}
    del state, args
    gc.collect()
    torch.cuda.empty_cache()
    return want


def pipe_step_for(mesh, M: int = PIPE_M):
    """The pipe step of :func:`ddp_family`'s VideoMAE-B on ``mesh``."""
    from bvc_tpu_torch.parallel.pipeline import make_pipe_videomae_train_step
    from bvc_tpu_torch.utils.config import MaskConfig, ModelConfig

    return make_pipe_videomae_train_step(ModelConfig(), MaskConfig(sampler="tube",
                                                                   mask_ratio=0.9),
                                         num_microbatches=M, mesh=mesh)


def pipe_launches(per_step: dict, M: int, P: int) -> dict:
    """A stage's launches a step: each of its ``16 / P`` layers once a
    microbatch, so the one-card step's times ``M / P``."""
    return {k: v * M // P for k, v in per_step.items()}


def hop_wait_share(step, state, args: dict) -> tuple[float, float]:
    """One step with every hop timed on the host after the rank's own work
    has drained (``torch.cuda.synchronize`` before and after each):
    ``(share of the step's wall time spent in hops, the step's wall ms)``,
    the time this stage waits for its neighbours plus the transport."""
    import torch

    from bvc_tpu_torch.parallel import pipeline

    real, spent = pipeline.hop, [0.0]

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    pipeline.hop = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddp_call("videomae", step, state, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.hop = real
    return spent[0] / wall, wall * 1e3


def pipe_hop_ms(mesh, b: int, reps: int = 5) -> dict:
    """Host time of one hop from stage 0 to stage 1 of the encoder's
    (``[b/M, 160, 768]``) and the decoder's (``[b/M, 1568, 384]``) bf16
    activations, to the received tensor on the card; the median of
    ``reps`` on the receiving stage, None elsewhere."""
    import torch

    from bvc_tpu_torch.parallel.collectives import hop

    s, group, mb = mesh.coord("pipe"), mesh.group("pipe"), b // PIPE_M
    out = {}
    for name, shape in (("encoder", (mb, 160, 768)), ("decoder", (mb, 1568, 384))):
        x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hop(x if s == 0 else None, 1, (shape, x.dtype) if s == 1 else None, 0, group,
                x.device)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(times[1:])[reps // 2] if s == 1 else None
    return out


def pipe_rank_worker(out: str, job: str, backend: str) -> None:
    """One rank of a pipeline run started by :func:`run_pipe_ranks`
    (torchrun's variables in the environment): the job's ``(data, pipe)``
    mesh, one step of VideoMAE-B on this rank's data block of
    :func:`ddp_family`'s batch (loss, launches, the stage's gradients, peak
    memory, state bytes), then ``timed`` timed steps, one step with its
    hops timed, with ``comm`` the step's collectives and, on a mesh of two
    stages or more, the hop times.
    Writes its result to ``{out}.rank{r}``."""
    import torch

    from bvc_tpu_torch.parallel import distributed_init, rank, tree_bytes
    from bvc_tpu_torch.parallel.pipeline import _stack_layer, make_pipe_mesh

    job = json.loads(job)
    distributed_init(backend=backend)
    mesh = make_pipe_mesh(job["data"], job["pipe"])
    new_state, _, args = ddp_family("videomae", job["B"])
    args = {k: v.cuda() for k, v in rank_rows(args, mesh.axis_size("data"),
                                              mesh.coord("data")).items()}
    step = pipe_step_for(mesh, job["M"])
    torch.cuda.reset_peak_memory_stats()
    state = new_state()
    readings = step_readings("videomae", step, state, args, record=job.get("comm", False))
    result = {"coords": mesh.coords, "loss": readings["loss"], "launches": readings["launches"],
              "grads": {n: g.cpu() for n, g in readings["grads"].items()},
              "peak_bytes": torch.cuda.max_memory_allocated(), "bytes": state_bytes(state),
              "ms": None, "wait_share": None, "hop_ms": None, "comm": readings["comm"],
              "held_bytes": tree_bytes(state.model),
              "edge_bytes": tree_bytes(p for n, p in state.model.named_parameters()
                                       if _stack_layer(n) is None)}
    if job["timed"]:
        result["ms"] = steps_ms("videomae", step, state, args, job["timed"])
        result["wait_share"], result["instrumented_ms"] = hop_wait_share(step, state, args)
    if job["pipe"] > 1:
        result["hop_ms"] = pipe_hop_ms(mesh, args["video"].shape[0])
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def run_pipe_ranks(out_dir: Path, world: int, job: dict, backend: str,
                   one_card: bool) -> list[dict]:
    out = str(out_dir / "pipe")
    return run_rank_workers(world, f"pipe_rank_worker({out!r}, {json.dumps(job)!r}, "
                                   f"{backend!r})", out, one_card)


def check_pipe_ranks(what: str, ranks: list[dict], want: dict, per_rank: dict) -> dict:
    """Every stage's gradients together (rank 0's data row) against
    ``want``'s under the DDP limits, every rank's loss rank 0's, every
    rank's launches ``per_rank``; returns the readings with each rank's
    peak memory, state bytes, hop times and hop-wait share."""
    grads: dict = {}
    for res in ranks:
        if res["coords"]["data"] == 0:
            grads.update(res["grads"])
    rec = check_ddp_against(what, {"loss": ranks[0]["loss"], "grads": grads}, want)
    for r, res in enumerate(ranks):
        check(res["launches"] == per_rank,
              f"{what}: rank {r} launched {res['launches']}, want {per_rank}")
        check(abs(res["loss"] - ranks[0]["loss"]) <= 1e-6 * abs(ranks[0]["loss"]),
              f"{what}: rank {r}'s loss {res['loss']} differs from rank 0's")
    rec.update(launches_per_rank=ranks[0]["launches"],
               peak_gib_per_rank=[res["peak_bytes"] / 2**30 for res in ranks],
               peak_gib_one_process=want["peak_bytes"] / 2**30,
               state_gib_per_rank=[res["bytes"]["total"] / 2**30 for res in ranks],
               state_gib_one_process=want["bytes"]["total"] / 2**30,
               ms_per_rank=[res["ms"] for res in ranks],
               wait_share_per_rank=[res["wait_share"] for res in ranks],
               hop_ms=next((res["hop_ms"] for res in ranks
                            if res["hop_ms"] and res["hop_ms"]["encoder"] is not None), None))
    print(f"{what}: peak memory a rank {rec['peak_gib_per_rank']} GiB against one process's "
          f"{rec['peak_gib_one_process']:.3f}; state a rank {rec['state_gib_per_rank']} GiB "
          f"against one process's {rec['state_gib_one_process']:.3f}; a hop {rec['hop_ms']} "
          f"ms; share of a step waiting in hops {rec['wait_share_per_rank']}", flush=True)
    return rec


def check_pipe_comm(what: str, card: str, res: dict) -> dict:
    """A stage's collectives at ``data=1,pipe=2``: its hops byte for byte
    (the activations of each microbatch to the next stage, or their
    gradients back, and the relay between the stacks: ``b (2 V D + N Dd)``
    in bf16 either way), one all-reduce of the edge parameters' gradients
    over ``pipe`` and none over ``data`` (one rank), nothing gathered or
    scattered.  Returns the comm record."""
    from bvc_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()
    space = (cfg.image_size // cfg.patch_size) ** 2
    visible = cfg.seq_len - int(0.9 * space) * cfg.num_time_steps
    hops = PIPE_B * (2 * visible * cfg.hidden_size + cfg.seq_len * cfg.decoder_hidden_size) * 2
    report, rec = comm_record(what, card, res["comm"], edge_bytes=res["edge_bytes"],
                              held_bytes=res["held_bytes"], hop_bytes=hops)
    got = report.bytes_for("collective-permute")
    check(got == hops, f"{what}: the hops sent {got} bytes, want {hops}")
    ar = report.bytes_for("all-reduce", COMM_BIG)
    check(ar == res["edge_bytes"], f"{what}: all-reduces {ar}, want the edge's "
                                   f"{res['edge_bytes']}")
    check_no_big(what, report, "all-gather", "reduce-scatter", "broadcast")
    return rec


def pipe_world1(card: str, want: dict, B: int) -> dict:
    """(a) World 1 over NCCL at ``data=1,pipe=1``: the pipe step (one
    stage, ``PIPE_M`` microbatches, no DDP) against the unwrapped step on
    the same clips and mask under the DDP limits; its launches the step's
    times ``PIPE_M``; its step time beside the unwrapped step's."""
    import gc

    import torch

    from bvc_tpu_torch.parallel import distributed_init
    from bvc_tpu_torch.parallel.pipeline import make_pipe_mesh

    new_state, _, args = ddp_family("videomae", B)
    args = {k: v.cuda() for k, v in args.items()}
    with rendezvous():
        distributed_init()
        check(torch.distributed.get_backend() == "nccl", "world 1 on cuda: not NCCL")
        step = pipe_step_for(make_pipe_mesh(1, 1))
        state = new_state()
        check(state.ddp is None and state.plan.params == "pipe",
              f"pipe state: ddp {state.ddp}, plan {state.plan}")
        got = step_readings("videomae", step, state, args)
        ms = steps_ms("videomae", step, state, args, PIPE_TIMED_STEPS)
        del state
        gc.collect()
    torch.cuda.empty_cache()
    what = f"pipe world 1 over NCCL [data=1,pipe=1, B={B}, M={PIPE_M}]"
    rec = check_ddp_against(what, got, want)
    per = pipe_launches(want["launches"], PIPE_M, 1)
    check(got["launches"] == per, f"{what}: launches {got['launches']}, want {per}")
    print(f"{what} [{card}]: step {ms:.1f} ms against the unwrapped step's {want['ms']:.1f}",
          flush=True)
    rec.update(launches=got["launches"], ms=ms, unwrapped_ms=want["ms"])
    return rec


def pipe_cli_worker(out: str, argv: str) -> None:
    """One rank of ``pretrain_videomae`` (torchrun's variables in the
    environment, gloo): ``main(argv)`` with the launch counts set to 0
    before; then the stage's checkpoint: it must load strictly into the
    whole model, and each of this rank's tensors must equal the
    checkpoint's."""
    import torch

    from bvc_tpu_torch.cli import pretrain_videomae
    from bvc_tpu_torch.models.videomae import VideoMAEPretrain
    from bvc_tpu_torch.parallel import distributed_init, rank
    from bvc_tpu_torch.training import trainer_videomae
    from bvc_tpu_torch.training.checkpoint import load_checkpoint

    distributed_init(backend="gloo")
    seen: dict = {}
    make = trainer_videomae.make_pipe_videomae_train_step

    def patched(*args, **kw):
        step = make(*args, **kw)

        def wrapped(state, batch):
            seen["state"] = state
            return step(state, batch)

        wrapped.eval_step = step.eval_step
        return wrapped

    trainer_videomae.make_pipe_videomae_train_step = patched
    argv = json.loads(argv)
    reset_launches()
    summary = pretrain_videomae.main(argv)
    torch.cuda.synchronize()
    result = {"summary": summary, "launches": read_launches()}
    cfg = pretrain_videomae.config_from_args(pretrain_videomae.build_parser().parse_args(argv))
    whole = trainer_videomae.videomae_model_state(load_checkpoint(summary["checkpoint"]),
                                                  cfg.model)
    VideoMAEPretrain(cfg.model).load_state_dict(whole)  # strict: every tensor, whole
    own = seen["state"].model.state_dict()
    result["own_tensors"] = len(own)
    result["whole_tensors"] = len(whole)
    result["max_diff"] = max((v.float().cpu() - whole[k].float()).abs().max().item()
                             for k, v in own.items())
    torch.save(result, f"{out}.rank{rank()}")
    torch.distributed.destroy_process_group()


def pipe_entry_point(root: Path, corpus: tuple[str, str], per_step: dict) -> dict:
    """(d) ``pretrain_videomae --mesh data=1,pipe=2 --pipe_microbatches 4``
    on two gloo ranks on the card, 3 steps: the CSV's losses finite, each
    rank's launches its steps', the checkpoint whole and equal to the
    ranks' stages."""
    jpg, pack = corpus
    rid = "dev_1_g0_default_0_0"
    argv = ["-jpg_root", jpg, "--pack_root", pack, "-savedir", str(root / "pipe_cli"),
            "--batch_size", str(PIPE_CLI_B), "--n_trainsamples", str(PIPE_CLI_B * PIPE_CLI_STEPS),
            "--max_epoch_iters", str(PIPE_CLI_STEPS), "--run_id", rid, "--mesh", "data=1,pipe=2",
            "--pipe_microbatches", str(PIPE_M), "--num_workers", "2"]
    out = str(root / "pipe_cli_rank")
    t0 = time.perf_counter()
    ranks = run_rank_workers(2, f"pipe_cli_worker({out!r}, {json.dumps(argv)!r})", out, True)
    wall = time.perf_counter() - t0
    what = "pretrain_videomae --mesh data=1,pipe=2"
    losses = check_csv(root / "pipe_cli" / f"csvlog_{rid}.csv", PIPE_CLI_STEPS, 2, what)
    for r, res in enumerate(ranks):
        check_cli_launches(res["launches"], per_step, PIPE_CLI_STEPS, f"{what}, rank {r}")
        check(res["max_diff"] == 0.0 and res["own_tensors"] < res["whole_tensors"],
              f"{what}: rank {r}'s stage against the checkpoint: {res['own_tensors']} of "
              f"{res['whole_tensors']} tensors, max diff {res['max_diff']}")
    print(f"{what} --pipe_microbatches {PIPE_M}: losses {losses}, launches a rank "
          f"{ranks[0]['launches']}, checkpoint whole ({ranks[0]['whole_tensors']} tensors; "
          f"the stages hold {[res['own_tensors'] for res in ranks]}), {wall:.1f} s", flush=True)
    return {"losses": losses, "wall_s": wall}


def phase_pipeline(card: str, root: Path, corpus: tuple[str, str], per_step: dict) -> dict:
    """Pipeline parallelism on the card (slice 7d), (a)-(d) of the module's
    item 26.  Returns the records and, under ``"launches"``, each run's
    counts."""
    import gc

    import torch

    t0 = time.perf_counter()
    want = pipe_reference(PIPE_B)
    check(want["launches"] == per_step,
          f"the unwrapped step at B={PIPE_B} launched {want['launches']}, want {per_step}")
    world1 = pipe_world1(card, want, PIPE_B)
    job = {"data": 1, "pipe": 2, "B": PIPE_B, "M": PIPE_M, "timed": PIPE_TIMED_STEPS,
           "comm": True}
    ranks = run_pipe_ranks(root, 2, job, "gloo", one_card=True)
    what = f"pipe over gloo, 2 ranks on one card [data=1,pipe=2, B={PIPE_B}, M={PIPE_M}]"
    gloo = check_pipe_ranks(what, ranks, want, pipe_launches(per_step, PIPE_M, 2))
    gloo["comm"] = [check_pipe_comm(f"{what}, stage {r}", card, res)
                    for r, res in enumerate(ranks)]
    gloo["bubble"] = pipe_bubble(2, PIPE_M)
    print(f"{what} [{card}]: step {max(gloo['ms_per_rank']):.1f} ms on the slower rank "
          f"against one process's {want['ms']:.1f}; waiting in hops "
          f"{gloo['wait_share_per_rank']} of a step against the bubble {gloo['bubble']:.2f}",
          flush=True)
    del ranks
    gc.collect()
    entry = pipe_entry_point(root, corpus, pipe_launches(per_step, PIPE_M, 2))
    multi = None
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        multi = pipe_multi_card(card, n_cards, root, want)
    wall = time.perf_counter() - t0
    print(f"pipeline: phase in {wall:.1f} s", flush=True)
    return {"world1": world1, "gloo": gloo, "entry_point": entry,
            "one_process": {"peak_gib": want["peak_bytes"] / 2**30,
                            "state_gib": want["bytes"]["total"] / 2**30, "ms": want["ms"]},
            "multi_card": multi, "wall_s": wall,
            "launches": {"world1": world1["launches"], "pipe2_per_rank": gloo["launches_per_rank"]}}


def pipe_multi_card(card: str, n: int, root: Path, want16: dict | None = None) -> dict:
    """(c) With ``n`` > 1 cards, over NCCL, a card a rank: ``pipe=2`` at
    B=16, and on four cards ``data=2,pipe=2`` at B=32 and ``pipe=4`` at
    B=16, each against one card at the global batch (the DDP limits, the
    launches ``16 * M / P``); clips/s a card (the slowest rank's CUDA events
    over ``PIPE_TIMED_STEPS`` steps) against one card's, each rank's share
    of a step waiting in hops, peak memory a card."""
    import gc

    out, refs = {}, {PIPE_B: want16} if want16 else {}
    cases = [("pipe2", 1, 2, PIPE_B)]
    if n >= 4:
        cases += [("data2_pipe2", 2, 2, 2 * PIPE_B), ("pipe4", 1, 4, PIPE_B)]
    for name, data, pipe, B in cases:
        if B not in refs:
            refs[B] = pipe_reference(B)
        want = refs[B]
        world = data * pipe
        ranks = run_pipe_ranks(root, world, {"data": data, "pipe": pipe, "B": B, "M": PIPE_M,
                                             "timed": PIPE_TIMED_STEPS}, "nccl", one_card=False)
        what = f"pipe over NCCL, {world} cards [data={data},pipe={pipe}, B={B}, M={PIPE_M}]"
        rec = check_pipe_ranks(what, ranks, want, pipe_launches(want["launches"], PIPE_M, pipe))
        ms = max(rec["ms_per_rank"])
        one_card = B / (want["ms"] / 1e3)
        rec.update(data=data, pipe=pipe, B=B, clips_s=B / (ms / 1e3),
                   clips_s_per_card=B / (ms / 1e3) / world, one_card_clips_s=one_card,
                   one_card_ms=want["ms"], bubble=pipe_bubble(pipe, PIPE_M))
        print(f"{what} [{card}]: {rec['clips_s']:.2f} clips/s ({rec['clips_s_per_card']:.2f} a "
              f"card, {rec['clips_s_per_card'] / one_card:.3f} of one card's {one_card:.2f}); a "
              f"step {ms:.1f} ms on the slowest card; waiting in hops "
              f"{rec['wait_share_per_rank']} against the bubble {rec['bubble']:.2f}", flush=True)
        out[name] = rec
        del ranks
        gc.collect()
    return out


SVM_PROBLEM = (4000, 768, 12, 0.5)  # rows, width, classes, spread of the class centres
SVM_TEST_ROWS = 1200
SVM_ACCURACY_MIN = 0.9  # held-out accuracy on the separable problem
SVM_THREADS = 8  # get_separability_score's n_jobs
RING_PLAIN_S = 2
RING_F32_SHAPE = (2, 6272, 12, 64)  # the encoder's heads at 64 frames, in f32
RING_W16_SHAPE = (2, 6272, 12, 16)  # bf16 at a head width no kernel takes
RING_F32_TOL = 1e-4  # of max|ref|: O, dQ, dK, dV of the f32 ring against f32 attention
# of max|ref|: O of the bf16 ring at width 16 against f32 attention, above one
# bf16 ulp of max|ref| (3.9e-3) and far below a hop merged wrong (read:
# 2.6-3.3e-3)
RING_W16_O_TOL = 1e-2
PROBS_SHAPE = (4, 1568, 768, 12)  # B, N, D, heads: ViT-B at 16 frames
PROBS_TOL = 1e-5  # max|card - CPU| of f32 probabilities
PROBS_INT8_TOL = 1e-4  # the same with a W8A8 qkv (per-token quantization of LN1's output)
PROBS_ROW_TOL = 1e-4  # |row sum - 1|


def phase_svm_probe(card: str) -> dict:
    """(a) The 'svm' probe on the card's host, where scikit-learn is absent:
    ``LinearProbe(method="svm")`` (StandardScaler, then liblinear's LinearSVC
    carried in ``native/linear_svc.cpp``) at a real probe's width, 4000
    rows of 768 in 12 seeded separable classes (rows >= features: the
    primal trust-region solver, one-vs-rest on ``SVM_THREADS`` threads),
    fitted twice: the same weights, iterations and scores, held-out accuracy
    >= ``SVM_ACCURACY_MIN``; each fit's seconds, and the BLAS that the
    primal solver summed with (scipy's, which the fit requires)."""
    import importlib.util

    import numpy as np
    import scipy

    from bvc_tpu_torch.evalbench.scores import LinearProbe

    rows, width, classes, spread = SVM_PROBLEM
    rng = np.random.default_rng(0)
    centres = spread * rng.standard_normal((classes, width))
    y, y_test = np.arange(rows) % classes, np.arange(SVM_TEST_ROWS) % classes
    x = centres[y] + rng.standard_normal((rows, width))
    x_test = centres[y_test] + rng.standard_normal((SVM_TEST_ROWS, width))
    fits, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        fits.append(LinearProbe(SVM_THREADS, "svm").fit(x, y))
        secs.append(time.perf_counter() - t0)
    a, b = (f.clf for f in fits)
    check(not a.dual_, "svm probe: the dual solver at rows >= features")
    check(np.array_equal(a.coef_, b.coef_) and np.array_equal(a.intercept_, b.intercept_)
          and a.n_iter_ == b.n_iter_, "svm probe: two fits differ")
    train, test = fits[0].score(x, y), fits[0].score(x_test, y_test)
    check(math.isfinite(train) and math.isfinite(test) and test >= SVM_ACCURACY_MIN,
          f"svm probe: train accuracy {train}, held-out {test}")
    sklearn = importlib.util.find_spec("sklearn") is not None
    blas = f"scipy {scipy.__version__}'s cython_blas"
    print(f"svm probe [{card}]: {rows} x {width}, {classes} classes, primal, {a.n_iter_} "
          f"iterations, train {train:.4f}, held-out {test:.4f}; fits {secs[0]:.2f} s and "
          f"{secs[1]:.2f} s on {SVM_THREADS} threads, the same weights; BLAS {blas}; "
          f"scikit-learn importable: {sklearn}", flush=True)
    return {"fit_s": secs, "n_iter": a.n_iter_, "train": train, "test": test, "blas": blas,
            "sklearn_importable": sklearn}


def phase_ring_plain(card: str) -> dict:
    """(b) The ring's plain route: ``ring_attention_chunks`` at S = 2 over
    an f32 ``[2, 6272, 12, 64]`` sequence and a bf16 one at head width 16,
    forward and backward, against plain attention over the whole sequence
    in f32 math (``plain_attention`` on the inputs in f32): f32 O, dQ, dK
    and dV within ``RING_F32_TOL`` of max|ref|, bf16 O within
    ``RING_W16_O_TOL`` and gradients within ``BWD_TOL`` of max|ref|; no kernel
    launched by either (the bf16 64-wide ring's launches: 25 (a))."""
    import torch

    from bvc_tpu_torch.ops.attention import plain_attention
    from bvc_tpu_torch.ops.flash_attention import kernel_route
    from bvc_tpu_torch.ops.ring_attention import ring_attention_chunks

    out = {}
    for label, dtype, (B, N, h, d) in (("f32", torch.float32, RING_F32_SHAPE),
                                       ("bf16 d=16", torch.bfloat16, RING_W16_SHAPE)):
        check(kernel_route("cuda", dtype, d, False) == "xla", f"ring {label}: not the plain route")
        gen = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, do = (torch.randn((B, N, h, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        reset_launches()
        t0 = time.perf_counter()
        o = ring_attention_chunks(*leaves, RING_PLAIN_S)
        o.backward(do)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(not any(launches.values()), f"ring {label}: kernels launched {launches}")
        refs = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
        o_ref = plain_attention(*refs, d ** -0.5)
        o_ref.backward(do.float())
        rec = {"shape": [B, N, h, d], "S": RING_PLAIN_S, "fwd_bwd_s": wall}
        for name, x, ref in zip(("o", "dq", "dk", "dv"), [o, *(x.grad for x in leaves)],
                                [o_ref, *(r.grad for r in refs)]):
            err, scale, _ = rel_err(x, ref)
            tol = (RING_F32_TOL if dtype == torch.float32 else
                   RING_W16_O_TOL if name == "o" else BWD_TOL)
            ok = err <= tol * scale
            check(ok, f"ring {label}: {name} max {err} (max|ref| {scale})")
            rec[name] = err
            rec[f"{name}_max_ref"] = scale
        del o, o_ref, leaves, refs
        torch.cuda.empty_cache()
        print(f"ring plain route {label} [{B},{N},{h},{d}] S={RING_PLAIN_S} [{card}]: max|err| "
              "against f32 attention " + ", ".join(
                  f"{n} {rec[n]:.3e} (max|ref| {rec[f'{n}_max_ref']:.3e})"
                  for n in ("o", "dq", "dk", "dv"))
              + f"; no kernel launched; forward and backward {wall:.3f} s", flush=True)
        out[label] = rec
    return out


def phase_attention_probs(card: str) -> dict:
    """(c) ``block_attention_probs`` of a ViT-B block (768 wide, 12 heads)
    on ``[4, 1568, 768]`` f32 on the card against the CPU's on the same
    weights and input: within ``PROBS_TOL``, rows summing to 1 within
    ``PROBS_ROW_TOL``, no kernel launched; then with the block's ``qkv``
    quantized (W8A8): one ``gemm_s8`` launch and nothing else, within
    ``PROBS_INT8_TOL`` of the CPU's plain ``qdense``."""
    import torch

    from bvc_tpu_torch.models.vit import Block, block_attention_probs
    from bvc_tpu_torch.ops.quant import quantize_linear

    B, N, D, heads = PROBS_SHAPE
    block = Block(D, heads, generator=torch.Generator().manual_seed(0))
    x = torch.randn((B, N, D), generator=torch.Generator().manual_seed(1))
    out = {}
    for label, tol, want_launches in (("f32", PROBS_TOL, {}), ("int8", PROBS_INT8_TOL,
                                                               {"gemm_s8": 1})):
        if label == "int8":
            block.qkv = quantize_linear(block.qkv)
        on_card = copy.deepcopy(block).cuda()
        with torch.no_grad():
            t0 = time.perf_counter()
            want = block_attention_probs(block, x)
            cpu_s = time.perf_counter() - t0
            reset_launches()
            got = block_attention_probs(on_card, x.cuda())
            torch.cuda.synchronize()
            launches = read_launches()
        want_launches = {**{name: 0 for name in launches}, **want_launches}
        check(launches == want_launches, f"attention probs {label}: launches {launches}")
        err = (got.cpu() - want).abs().max().item()
        row = (got.sum(-1) - 1).abs().max().item()
        check(got.shape == (B, heads, N, N) and got.dtype == torch.float32
              and err <= tol and row <= PROBS_ROW_TOL,
              f"attention probs {label}: {tuple(got.shape)} {got.dtype}, max|card - CPU| {err}, "
              f"row sums off by {row}")
        print(f"attention probs {label} [{B},{N},{D}], {heads} heads [{card}]: max|card - CPU| "
              f"{err:.3e}, rows sum to 1 within {row:.3e}, launches "
              f"{ {k: v for k, v in launches.items() if v} }; CPU {cpu_s:.2f} s", flush=True)
        out[label] = {"max_abs_err": err, "row_sum_err": row, "cpu_s": cpu_s,
                      "launches": launches}
        del on_card, got
        torch.cuda.empty_cache()
    return out


class PhaseClock:
    """Calls a phase and notes its wall seconds under its name
    (``seconds``, in call order)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds[name] = time.perf_counter() - t0
            print(f"{name}: {self.seconds[name]:.1f} s", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", nargs="?", const="", default=None, metavar="FILE",
                        help="print torch.profiler breakdowns of one bf16 and one W8A8 "
                             "embed call and one VideoMAE and one JEPA training step "
                             "(and write them to FILE and to profile_w8a8.txt, "
                             "profile_train.txt and profile_jepa.txt beside it if given)")
    parser.add_argument("--repeat-shard-ranks", type=int, default=0, metavar="N",
                        help="only build the kernels and run the sharding phase's two-rank "
                             "gloo jobs (tp at data=1,model=2; zero1 and fsdp at data=2) N "
                             "times each at B=48, printing how each run ended")
    args = parser.parse_args()
    if not (REPO / "bvc_tpu_torch" / "csrc").is_dir():
        fail(f"no bvc_tpu_torch package beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    from bvc_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(f"host: {torch.cuda.device_count()} CUDA devices, {os.cpu_count()} CPU cores",
          flush=True)
    t0 = time.perf_counter()
    kernels = ["flash_fwd", "flash_bwd_sm90", "gemm", "softmax_probe"]
    _build.build_all(kernels)
    print(f"built {kernels} in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.repeat_shard_ranks:
        with tempfile.TemporaryDirectory() as d:
            repeat_shard_ranks(args.repeat_shard_ranks, 48, Path(d))
    for name in kernels:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "serialized", "Compiling entry")):
                print(f"  {name}: {line.strip()}", flush=True)
    for name, kernel, template_args in (("flash_bwd_sm90", "flash_bwd_sm90", "ILi64ELb0EE"),
                                        ("flash_bwd_sm90", "flash_bwd_sm90", "ILi64ELb1EE"),
                                        ("flash_bwd_sm90", "flash_bwd_sm90", "ILi32ELb1EE"),
                                        ("flash_fwd", "flash_fwd_bias_sm90", "ILi64EE"),
                                        ("flash_fwd", "flash_fwd_bias_sm90", "ILi32EE")):
        check_no_spills_or_serialisation(name, kernel, template_args)

    from bvc_tpu_torch.probes import int8_dot, softmax_dtype

    for name, kernel in (("flash_fwd", "flash_fwd_sm90"), ("softmax_probe", "sm90ILb0E"),
                         ("softmax_probe", "sm90ILb1E")):
        ops = sass_census(name, kernel)
        fp32 = sum(ops.get(op, 0) for op in ("FFMA", "FADD", "FMUL", "FMNMX"))
        print(f"  SASS of {kernel}: " + (", ".join(f"{op} {ops.get(op, 0)}" for op in SASS_OPS)
              + f" of {ops['all']}; FP32 instructions per MUFU {fp32 / ops['MUFU']:.2f}"
              if ops else "not measured (no cuobjdump)"), flush=True)
    print(f"SM clock (clocks.max.sm) {sm_clock_mhz():.0f} MHz, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    phase = PhaseClock()
    phase("phase_attn_tile", phase_attn_tile)
    phase("phase_bwd_tile", phase_bwd_tile)
    flash = phase("phase_kernel", phase_kernel)
    bwd = phase("phase_bwd_kernel", phase_bwd_kernel)
    bias = phase("phase_bias_kernel", phase_bias_kernel)
    gemm = phase("phase_gemm_kernel", phase_gemm_kernel)
    probe = phase("phase_softmax_probe_kernel", phase_softmax_probe_kernel)
    int8_probe = phase("probe_path int8", probe_path, "int8 dot", int8_dot.run,
                       {"gemm_s8", "gemm_bf16"})
    softmax_probe = phase("probe_path softmax", probe_path, "softmax dtype", softmax_dtype.run,
                          {"softmax_probe_fwd"})
    embed_launches, embed_B = phase("phase_main_path", phase_main_path, smi, args.profile)
    w8a8_launches = phase("phase_w8a8", phase_w8a8, smi, args.profile)
    train_launches, train_B = phase("phase_train", phase_train, smi, args.profile)
    jepa_embed_launches = phase("phase_jepa_embed", phase_jepa_embed, smi)
    jepa_launches = phase("phase_jepa_train", phase_jepa_train, smi, args.profile)
    phase("phase_entry_point", phase_entry_point)
    with tempfile.TemporaryDirectory() as d:
        export = phase("phase_export", phase_export, smi, embed_B, Path(d))
    vit_image = phase("phase_vit_image", phase_vit_image, smi)
    with tempfile.TemporaryDirectory() as d:
        corpus = phase("write_corpus", write_corpus, Path(d))
        cli = phase("phase_pretrain_cli_videomae", phase_pretrain_cli_videomae, smi, corpus,
                    train_B, train_launches)
        jepa_cli = phase("phase_pretrain_cli_jepa", phase_pretrain_cli_jepa, smi, corpus, 64,
                         jepa_launches)
        sharding = phase("phase_sharding", phase_sharding, smi, train_B, Path(d), corpus,
                         train_launches)
        seqpar = phase("phase_seqpar", phase_seqpar, smi, Path(d), corpus, train_launches)
        pipeline = phase("phase_pipeline", phase_pipeline, smi, Path(d), corpus, train_launches)
    remat = phase("phase_remat", phase_remat, smi, train_B)
    simclr_step = phase("phase_simclr_step", phase_simclr_step, smi)
    simclr_rate = phase("phase_simclr_rate", phase_simclr_rate, smi)
    simclr_embed = phase("phase_simclr_embed", phase_simclr_embed, smi)
    with tempfile.TemporaryDirectory() as d:
        simclr_cli = phase("phase_pretrain_cli_simclr", phase_pretrain_cli_simclr, smi,
                           simclr_rate["B"], Path(d))
        ddp = phase("phase_ddp", phase_ddp, smi, train_B, Path(d),
                    str(Path(d) / "simclr_corpus"))
    with tempfile.TemporaryDirectory() as d:
        curriculum = phase("phase_curriculum", phase_curriculum, smi, Path(d), train_launches,
                           embed_launches, jepa_launches, w8a8_launches["jepa"])
    svm_probe = phase("phase_svm_probe", phase_svm_probe, smi)
    ring_plain = phase("phase_ring_plain", phase_ring_plain, smi)
    attention_probs = phase("phase_attention_probs", phase_attention_probs, smi)

    # launches: per step of the path that runs the kernel most (VideoMAE
    # training for the unmasked kernels, JEPA training for the key-bias
    # ones, W8A8 VideoMAE extraction for the s8 GEMM, the probes' own runs
    # for the bf16 GEMM and the softmax probe kernel), with the other paths'
    # counts beside them
    fwd_src = "bvc_tpu_torch/csrc/flash_fwd.cu"
    bwd_sm90_src = "bvc_tpu_torch/csrc/flash_bwd_sm90.cu"
    replaces = "bvc_tpu/ops/flash_attention.py"
    records = [
        {"name": "flash_fwd", "route": "cuda", "source": fwd_src,
         "replaces": f"{replaces}:109", "launches": train_launches["flash_fwd"],
         "launches_per_embed": embed_launches,
         "launches_per_w8a8_embed": w8a8_launches["videomae"]["flash_fwd"],
         "launches_per_jepa_step": jepa_launches["flash_fwd"],
         "launches_per_jepa_embed": jepa_embed_launches,
         "launches_per_remat_step": remat["launches"]["flash_fwd"], "at": [8, 1568, 12, 64],
         **flash},
        {"name": "flash_bwd", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:250 and :278", "launches": train_launches["flash_bwd"],
         "at": [8, 1568, 6, 64], **bwd["fused"]},
        {"name": "flash_bwd_prep", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:315 (D of _bwd, for :250 and :278)",
         "launches": train_launches["flash_bwd_prep"], "at": [8, 1568, 6, 64], **bwd["prep"]},
        {"name": "flash_bwd_post", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:250 (dQ's bf16 store)",
         "launches": train_launches["flash_bwd_post"], "at": [8, 1568, 6, 64], **bwd["post"]},
        {"name": "flash_fwd_bias", "route": "cuda", "source": fwd_src,
         "replaces": f"{replaces}:74", "launches": jepa_launches["flash_fwd_bias"],
         **bias["fwd"]},
        {"name": "flash_bwd_bias", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:187 and :212", "launches": jepa_launches["flash_bwd_bias"],
         **bias["fused"]},
        {"name": "flash_bwd_prep_bias", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:315 (D of _bwd, for :187 and :212)",
         "launches": jepa_launches["flash_bwd_prep_bias"], **bias["prep"]},
        {"name": "flash_bwd_post_bias", "route": "cuda", "source": bwd_sm90_src,
         "replaces": f"{replaces}:187 (dQ's bf16 store)",
         "launches": jepa_launches["flash_bwd_post_bias"], **bias["post"]},
        {"name": "gemm_s8", "route": "cuda", "source": "bvc_tpu_torch/csrc/gemm.cu",
         "replaces": "tools/probe_pallas_int8.py:37",
         "launches": w8a8_launches["videomae"]["gemm_s8"],
         "launches_per_jepa_w8a8_embed": w8a8_launches["jepa"]["gemm_s8"],
         "launches_in_int8_probe": int8_probe["gemm_s8"],
         "launches_per_w8a8_artifact_call": export["videomae_w8a8"]["launches"]["gemm_s8"],
         "launches_per_w8a8_attention_probs": attention_probs["int8"]["launches"]["gemm_s8"],
         **gemm["gemm_s8"]},
        {"name": "gemm_bf16", "route": "cuda", "source": "bvc_tpu_torch/csrc/gemm.cu",
         "replaces": "tools/probe_pallas_int8.py:42", "launches": int8_probe["gemm_bf16"],
         **gemm["gemm_bf16"]},
        {"name": "softmax_probe_fwd", "route": "cuda",
         "source": "bvc_tpu_torch/csrc/softmax_probe.cu",
         "replaces": "tools/probe_softmax_dtype.py:45",
         "launches": softmax_probe["softmax_probe_fwd"], **probe},
    ]
    # launches a step of the CLIs' stages: the unmasked kernels' from the
    # VideoMAE CLI, the key-bias ones' from the JEPA CLI (flash_fwd's JEPA
    # count beside)
    for r in records:
        if r["name"] in cli["launches_per_cli_step"] and r["name"].startswith("flash"):
            source = jepa_cli if r["name"].endswith("_bias") else cli
            r["launches_per_cli_step"] = source["launches_per_cli_step"][r["name"]]
    records[0]["launches_per_jepa_cli_step"] = jepa_cli["launches_per_cli_step"]["flash_fwd"]
    # the counts read over every SimCLR path: steps, rate, extraction, the
    # CLI stages, their checkpoint's embed and compute_embeddings --family simclr
    # and its curriculum
    simclr_launches = sum_launches(*(phase.pop("launches") for phase in (
        simclr_step, simclr_rate, simclr_embed, simclr_cli)), curriculum["simclr"]["launches"])
    runs = [k for k in curriculum if k != "wall_s"]
    ddp_launches = ddp.pop("launches")
    shard_launches = sharding.pop("launches")
    seq_launches_read = seqpar.pop("launches")
    pipe_launches_read = pipeline.pop("launches")
    for r in records:
        r["launches_per_ddp_step"] = {
            "videomae_world1_grad_accum2": ddp_launches["videomae_step"][r["name"]],
            "jepa_world1": ddp_launches["jepa_step"][r["name"]],
            **{f"{family}_per_gloo_rank":
               shard_launches[f"replicated_{family}_per_rank"][r["name"]]
               for family in ("videomae", "jepa")},
            "int8_call_mesh_data1": ddp_launches["int8_call"][r["name"]],
            "simclr_stage_mesh_data1": ddp_launches["simclr_stage"][r["name"]]}
        r["launches_per_sharded_step"] = {k: v[r["name"]] for k, v in shard_launches.items()}
        r["launches_per_seq_step"] = {k: v[r["name"]] for k, v in seq_launches_read.items()}
        r["launches_per_pipe_step"] = {k: v[r["name"]] for k, v in pipe_launches_read.items()}
        r["launches_on_simclr_paths"] = simclr_launches[r["name"]]
        r["launches_per_curriculum"] = {k: curriculum[k]["launches"][r["name"]] for k in runs}
        r["launches_per_artifact_call"] = {k: a["launches"].get(r["name"], 0)
                                           for k, a in export.items()}
        r["launches_per_vit_image_embed"] = {k: v["launches"][r["name"]]
                                             for k, v in vit_image.items()}
    trainers = {"videomae_cli": {k: v for k, v in cli.items() if k != "launches_per_cli_step"},
                "jepa_cli": {k: v for k, v in jepa_cli.items() if k != "launches_per_cli_step"},
                "remat": {"B": train_B, "peak_gib_without": remat["peak_gib"][False],
                          "peak_gib_with": remat["peak_gib"][True],
                          "step_ms_without": remat["ms"][False],
                          "step_ms_with": remat["ms"][True],
                          "min_grad_cosine": remat["min_cosine"]},
                "ddp": ddp, "sharding": sharding, "seqpar": seqpar, "pipeline": pipeline,
                "simclr_cli": simclr_cli, "simclr_step": {**simclr_rate, **simclr_step},
                "simclr_embed": simclr_embed,
                "export": {k: {f: v for f, v in a.items() if f != "launches"}
                           for k, a in export.items()},
                "vit_image": {k: {f: v for f, v in a.items() if f != "launches"}
                              for k, a in vit_image.items()},
                "curriculum": {"wall_s": curriculum["wall_s"],
                               **{k: {f: v for f, v in curriculum[k].items() if f != "launches"}
                                  for k in runs}},
                "svm_probe": svm_probe, "ring_plain": ring_plain,
                "attention_probs": {k: {f: v for f, v in a.items() if f != "launches"}
                                    for k, a in attention_probs.items()}}
    print(json.dumps({"trainers": trainers}), flush=True)
    print(json.dumps({"phase_seconds": phase.seconds}), flush=True)
    check(all(math.isfinite(r[k]) for r in records
              for k in ("max_abs_err", "ms", "plain_ms", "bound_ms"))
          and all(r["library_ms"] is None or math.isfinite(r["library_ms"]) for r in records),
          "non-finite timing")
    print(json.dumps({"kernels": records}), flush=True)
    print(f"chip_smoke wall time {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
