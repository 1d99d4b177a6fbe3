"""Command-line entry points of the port (``python -m bvc_tpu_torch.cli.<name>``)."""
