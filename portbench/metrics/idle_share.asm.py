"""The share of the window in which the card ran nothing: 1 less the
union of its kernel, copy and set intervals over the window."""


def read(w):
    if not w.window_s or w.busy_s is None:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
