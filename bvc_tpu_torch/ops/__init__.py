"""Attention, GELU and patchify ops, and the CUDA kernel wrappers and build."""
