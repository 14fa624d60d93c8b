"""sq8_fallback_share.c10: what ``sq8_fallback_share.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("sq8_fallback_share").read(r)
