"""The share of the card's idle time, over the host-traced validation
groups, that overlaps the producer thread's pre-process (`val.pre`: load +
affine warp + upload of a frame).  The profiler records no operation of
that thread, so its spans come from the program's buffer, moved onto the
trace's clock by the pass's anchor; in %."""

from portbench.metrics.spans import (host_trace, idle_share, on_trace_clock,
                                     pre_calls)


def read(d):
    t = host_trace(d, "val_pass")
    calls = pre_calls()
    if t is None or not calls:
        return None
    ivs = on_trace_clock(t, calls[-1], "val.pre")
    return None if ivs is None else idle_share(t, ivs)
