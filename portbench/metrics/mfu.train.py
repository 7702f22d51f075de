"""The whole training step's share of the chip's peak: the operations of
the window's steps (convolutions and matrix products, forward and
backward, counted on the plain reference, metrics/flops.py) over the
window's time and the peak of the configuration's dtype, in %."""

from portbench.metrics.roofline import PEAK_FLOPS


def read(d):
    if d.get("kind") != "train_loop" or not d.get("flops") or \
            d.get("device") != "cuda":
        return None
    w = d["window"]
    return 100.0 * d["flops"] * w["steps"] / w["seconds"] / \
        PEAK_FLOPS[d["dtype"]]
