"""k1_roofline.c10: what ``k1_roofline.py`` reads, in the cells
whose one end-to-end metric besides set-up is ``qps``, which it moves."""

from portbench import spec


def read(r):
    return spec.metric_reader("k1_roofline").read(r)
