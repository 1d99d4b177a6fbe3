"""Embedding extraction."""
