"""The DCN kernels' share of their roofline over the traced training steps:
the least time of the 16 DCN layers' K1, K2 and K3 work (from the layers'
shapes, metrics/roofline.py) times the steps, over the device time of
every dcn_fwd, dcn_bwd_dx and dcn_bwd_dcoord launch in the trace, in %."""

from portbench.metrics.roofline import dcn_bound_s
from portbench.metrics.trace import DCN_KINDS, kind


def read(d):
    if d.get("kind") != "train_loop" or not d.get("trace"):
        return None
    us = sum(e - s for name, s, e in d["trace"].kernels
             if kind(name) in DCN_KINDS)
    if us <= 0:
        return None
    bound = d["trace_steps"] * dcn_bound_s(d["dcn_layers"], d["dtype"], True)
    return 100.0 * bound / (us / 1e6)
