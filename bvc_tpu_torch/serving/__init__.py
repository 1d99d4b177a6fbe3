"""Serving: freeze a family's embedding function into a ``torch.export``
artifact for one device."""

from bvc_tpu_torch.serving.export import export_embed, load_artifact, save_artifact

__all__ = ["export_embed", "load_artifact", "save_artifact"]
