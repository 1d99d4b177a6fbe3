"""Attention, GELU, LayerNorm, patchify and W8A8 ops, and the CUDA kernel wrappers and
build."""
