"""The benchmark of ``dddmr_navigation_tpu_torch``: ``BENCHMARK.json``
names its cells, ``run.py`` runs one."""
