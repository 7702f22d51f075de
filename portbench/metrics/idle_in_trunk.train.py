"""The share of the card's idle time, over the host-traced training steps,
during which the main thread was inside the ResNet trunk's forward
(`net.trunk`, models/resnet_dcn.py: the stem and the bottleneck blocks over
both views), in %.  None where the model has no such span."""

from portbench.metrics.spans import idle_inside


def read(d):
    return idle_inside(d, "train_loop", "net.trunk")
