"""The share of the card's idle time, over the host-traced validation
groups, during which the main thread was finishing a group (`val.finish`:
the whole-device fence, the fetch of the rows, bucketing, score filter and
the per-frame log lines), in %."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "val_pass", "val.finish")
