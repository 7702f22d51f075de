"""Device operations (kernels, copies, sets) per traced training step."""


def read(d):
    if d.get("kind") != "train_loop" or not d.get("trace") or \
            not d["trace"].kernels:
        return None
    return len(d["trace"].kernels) / d["trace_steps"]
