"""The reference runs on one device: no mesh, so every collective that the
program's copies would call is unreachable."""


def active_mesh():
    return None


def all_reduce_sum(*args, **kwargs):
    raise RuntimeError("the reference runs on one device")


all_reduce_ = all_reduce_sum
