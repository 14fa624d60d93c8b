"""The benchmark of ``myscaledb_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the repository; the harness finds each
one's files here by that name (``spec.py``).  See ``README.md``.
"""
