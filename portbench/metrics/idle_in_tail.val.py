"""The share of the card's idle time, over the host-traced validation
groups, during which the main thread was inside the device tail (the
`tail` span: run_tail_batch's calibration packs, uploads, box solve, dense
alignment and re-solve, all launched from the host), in %."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "val_pass", "tail")
