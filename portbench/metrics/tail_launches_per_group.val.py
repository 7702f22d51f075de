"""The host's CUDA calls that enqueue device work (kernel launches,
asynchronous copies and sets) inside the device tail's `tail` spans of the
host-traced validation groups, per group (per `val.dispatch` span)."""

from portbench.metrics.spans import enqueues_inside, host_trace, side


def read(d):
    t = host_trace(d, "val_pass")
    if t is None:
        return None
    tails, groups = side(t, "tail"), len(side(t, "val.dispatch"))
    if not tails or not groups:
        return None
    return enqueues_inside(t, tails) / groups
