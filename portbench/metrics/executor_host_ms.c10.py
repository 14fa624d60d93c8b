"""executor_host_ms.c10: what ``executor_host_ms.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("executor_host_ms").read(r)
