"""device_ms_per_query.c10: what ``device_ms_per_query.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("device_ms_per_query").read(r)
