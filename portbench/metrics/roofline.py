# The bound formulas are frozen copies of chip_smoke.py's `_bound_ms` and
# `_bwd_bound_ms` at commit ca59ff401c87, kept with the benchmark.
"""The chip's peaks and the least time of each DCN kernel's work.

A DCN layer's work is counted from its shapes, whatever kernel runs it:
K1 (forward), K2 (d_x) and K3 (d_offset, d_mask, d_weight).  The bound is
the larger of operations over the peak rate and bytes over the memory rate
(inputs read once, outputs written once)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEM = {"bfloat16": 2, "float32": 4}


def _bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def fwd_bound_s(batch, h, w, cin, cout, dtype) -> float:
    pix = batch * h * w
    flops = pix * 9 * cin * (2 * cout + 8)   # contraction + bilinear sample
    item = ITEM[dtype]
    nbytes = (pix * cin * item + pix * 27 * 4 + 9 * cin * cout * 4
              + cout * 4 + pix * cout * item)
    return _bound_s(flops, nbytes, dtype)


def bwd_bounds_s(batch, h, w, cin, cout, dtype) -> tuple:
    """(K2, K3) least times."""
    pix = batch * h * w
    item = ITEM[dtype]
    mac = pix * 9 * cin * cout
    geo = pix * 27 * 4 + 9 * cin * cout * 4          # offsets, mask, weight
    g_bytes = pix * cout * item
    dx = _bound_s(2 * mac + pix * 9 * cin * 9,
                  g_bytes + geo + pix * cin * item, dtype)
    dc = _bound_s(4 * mac + pix * 9 * cin * 30,
                  pix * cin * item + g_bytes + geo + pix * 27 * 4
                  + 9 * cin * cout * 4, dtype)
    return dx, dc


def dcn_bound_s(layers, dtype: str, backward: bool) -> float:
    """Least time of one pass over `layers` [(batch, h, w, cin, cout)]: K1
    for each, and K2 + K3 with `backward`."""
    total = 0.0
    for shape in layers:
        total += fwd_bound_s(*shape, dtype)
        if backward:
            total += sum(bwd_bounds_s(*shape, dtype))
    return total
