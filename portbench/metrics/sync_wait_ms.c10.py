"""sync_wait_ms.c10: what ``sync_wait_ms.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("sync_wait_ms").read(r)
