"""Device operations per traced validation group: the device tail's
launches set most of them."""


def read(d):
    if d.get("kind") != "val_pass" or not d.get("trace") or \
            not d["trace"].kernels:
        return None
    return len(d["trace"].kernels) / d["trace_groups"]
