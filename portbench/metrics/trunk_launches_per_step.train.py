"""The host's CUDA calls that enqueue device work (kernel launches,
asynchronous copies and sets) inside the ResNet trunk's forward
(`net.trunk`, models/resnet_dcn.py) over the host-traced training steps,
per step (per `train.forward` span).  None where the model has no such
span."""

from portbench.metrics.spans import enqueues_inside, host_trace, side


def read(d):
    t = host_trace(d, "train_loop")
    if t is None:
        return None
    trunk, steps = side(t, "net.trunk"), len(side(t, "train.forward"))
    if not trunk or not steps:
        return None
    return enqueues_inside(t, trunk) / steps
