"""Embedding extraction and the benchmark datasets' readers."""
