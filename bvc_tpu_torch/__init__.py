"""bvc_tpu_torch: the PyTorch / CUDA port of ``bvc_tpu`` for NVIDIA Hopper.

The JAX package ``bvc_tpu`` stays beside this one, unchanged, as the
reference: every slice of the port is tested against it.  So far the port
serves VideoMAE, JEPA and SimCLR embeddings of the benchmark sets (the ViT
families bf16 or W8A8; ``cli.compute_embeddings``, ``evalbench``,
``ops.quant``), and trains VideoMAE, V-JEPA and SimCLR curriculum stages on
one GPU (``cli.pretrain_videomae``, ``cli.pretrain_jepa``,
``cli.pretrain_simclr``: the input pipeline of ``data``, the trainers,
steps and checkpoints of ``training``), and freezes extraction into
``torch.export`` artifacts (``serving``, ``cli.export_serving``); the ViT
families run through
hand-written CUDA kernels (SimCLR's ResNet on cuDNN's convolutions, as on
XLA's): the flash-attention forward (``csrc/flash_fwd.cu``) and backward
(``csrc/flash_bwd_sm90.cu``), without a key mask or with a per-sample key
bias, the tensor-core GEMM (``csrc/gemm.cu``) whose int8 instantiation
runs the W8A8 products, and the MLP's GELU forward and backward on bf16
(``csrc/gelu.cu``), each reached through a ``torch.library`` custom
operator (``torch.ops.bvc_tpu_torch``).  ``probes`` holds the counterparts of the JAX
package's two kernel probes (``csrc/gemm.cu`` in bf16,
``csrc/softmax_probe.cu``).

Ground rules:

- This package imports ``torch`` and never ``jax``, and nothing of
  ``bvc_tpu``, not even its JAX-free modules: what it needs from them it
  keeps its own copy of.  Only the tests import both packages.
- Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
  with no GPU and no device named they raise.  A kernel wrapper given CUDA
  tensors launches its kernel or raises; given CPU tensors it runs the
  kernel's plain PyTorch version.
- PyTorch idiom (``nn.Module``s, plain tensor functions, an explicit
  device, ``torch.Generator`` for init) with the JAX package's dtype policy
  kept by explicit casts, not autocast: f32 parameters, bf16 activations,
  f32 LayerNorm statistics and softmax.
- The JAX package's public layouts: video ``[B, T, H, W, C]``, attention
  ``[B, N, h, d]``, flat patch order (c, dt, dh, dw).
- Kernels are built at first use from ``csrc/`` with ``nvcc`` for
  ``sm_90a`` into ``_build/`` (``ops/_build.py``).
"""
