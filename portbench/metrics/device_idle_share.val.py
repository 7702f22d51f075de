"""The card's idle share over the traced validation groups: 100 x (1 - the
union of kernel intervals / the traced window)."""


def read(d):
    if d.get("kind") != "val_pass" or not d.get("trace") or \
            not d["trace"].kernels:
        return None
    t = d["trace"]
    return 100.0 * (1.0 - t.busy_us / t.window_us)
