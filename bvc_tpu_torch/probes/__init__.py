"""Probes of the card: counterparts of the JAX package's probe tools that
hold a kernel (``tools/probe_pallas_int8.py``, ``tools/probe_softmax_dtype.py``).
Each runs on the card as ``python -m bvc_tpu_torch.probes.<name>`` and
raises without one."""
