"""The share of the window the mapping jobs spend in the native chaining
and the writing of the Q and M lines: the stage ``map.chain``
(``native/modasm_native.cpp``'s ``mm_query_emit``)."""


def read(w):
    s = w.stage_s("map.chain")
    return None if s is None else 100.0 * s / w.span_s
