"""The share of the card's idle time, over the host-traced training steps,
during which the main thread was in the forward (`train.forward`:
normalisation, the model and the loss), in %."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "train_loop", "train.forward")
