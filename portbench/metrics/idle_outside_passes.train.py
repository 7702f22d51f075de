"""The share of the card's idle time, over the host-traced training steps,
during which the main thread was outside the forward and backward: in the
loader's handout (`train.data`), the upload (`train.upload`), Adam
(`train.optimizer`) or the per-step `.item()` reads and log line
(`train.meters`), in %."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "train_loop", "train.data", "train.upload",
                       "train.optimizer", "train.meters")
