"""Device: the share of the profiled slice in which no operation ran on
the card, on any stream: 1 - union of busy intervals / slice wall."""


def read(r):
    sl = r.slice
    if sl is None or sl.window_s <= 0 or not sl.ops:
        return None
    return 1.0 - sl.busy_s / sl.window_s
