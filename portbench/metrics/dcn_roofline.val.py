"""The DCN forward kernel's share of its roofline over the traced
validation groups: the least time of the 16 DCN layers' forward work (from
their shapes) times the groups, over the device time of every dcn_fwd
launch in the trace, in %."""

from portbench.metrics.roofline import dcn_bound_s
from portbench.metrics.trace import kind


def read(d):
    if d.get("kind") != "val_pass" or not d.get("trace"):
        return None
    us = sum(e - s for name, s, e in d["trace"].kernels
             if kind(name) in ("dcn_fwd", "dcn_fwd_om (K4)"))
    if us <= 0:
        return None
    bound = d["trace_groups"] * dcn_bound_s(d["dcn_layers"], d["dtype"],
                                            False)
    return 100.0 * bound / (us / 1e6)
