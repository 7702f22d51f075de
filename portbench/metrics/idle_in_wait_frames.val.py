"""The share of the card's idle time, over the host-traced validation
groups, during which the main thread was waiting for the producer's frames
(`val.wait_frames`: run_pass's blocking queue reads), in %."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "val_pass", "val.wait_frames")
