"""sq8_fallback_share: K2 launches over K1 launches in the window, in %,
from the kernel wrappers' ``launches`` counters
(``ops/kernels/distance.py``, ``distance_q.py``).  A statement whose int8
certificate fails reruns the scan over the whole float32 table in K2."""


def read(r):
    k1 = r.launches.get("segmin_sq8", 0)
    if not k1:
        return None
    return 100.0 * r.launches.get("segmin_f32", 0) / k1
