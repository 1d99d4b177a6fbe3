"""The benchmark of the PyTorch / H100 port (``bvc_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own here, found by its name (:mod:`portbench.manifest`); the plain
reference that decides ``correct`` is :mod:`portbench.reference`.  Nothing
here imports JAX or the JAX package.
"""
