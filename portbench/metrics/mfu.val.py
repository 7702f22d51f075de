"""The inference path's share of the chip's peak: the operations of the
network and the depth path per frame (counted on the plain reference,
metrics/flops.py) times the frames the window completed, over the window's
time and the peak of the configuration's dtype, in %."""

from portbench.metrics.roofline import PEAK_FLOPS


def read(d):
    if d.get("kind") != "val_pass" or not d.get("flops") or \
            d.get("device") != "cuda":
        return None
    w = d["window"]
    return 100.0 * d["flops"] * w["frames"] / w["seconds"] / \
        PEAK_FLOPS[d["dtype"]]
