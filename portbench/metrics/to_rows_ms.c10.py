"""to_rows_ms.c10: what ``to_rows_ms.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("to_rows_ms").read(r)
