"""The share of the window the build jobs spend replaying the counted
k-mers into the exact table on the host: the stage ``count.replay``
(``core/modset.py``'s ``add_batch``, ``native/modset_native.cpp``)."""


def read(w):
    s = w.stage_s("count.replay")
    return None if s is None else 100.0 * s / w.span_s
