# `KINDS`, `_kind` and `_busy_us` are frozen copies of
# side_tpu_torch/stage_profile.py at commit ca59ff401c87; `profile_call`
# follows its `profile_call`, keeping every event the readers need.
"""A device trace of one stretch of work, and what the readers take from
it: kernel intervals, their union (busy time), launches, device time by
kernel kind, and the idle gaps with what the host was doing in each."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

KINDS = (  # first match wins; lower-case substrings of kernel names
    ("dcn_fwd_om (K4)", ("dcn_fwd_om", "omgeom")),
    ("dcn_fwd", ("dcn_fwd",)),
    ("dcn_bwd_dx (K2)", ("dcn_bwd_dx",)),
    ("dcn_bwd_dcoord (K3)", ("dcn_bwd_dcoord",)),
    ("optimizer (foreach)", ("multi_tensor",)),
    ("convolution", ("conv", "implicit", "cudnn", "winograd", "fprop")),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "transpose")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
DCN_KINDS = ("dcn_fwd", "dcn_bwd_dx (K2)", "dcn_bwd_dcoord (K3)")


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(s in low for s in keys):
            return k
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """Kernel events [(name, start_us, end_us)], host events likewise, and
    the wall time of the traced call."""

    def __init__(self, kernels, host, wall_us: float):
        self.kernels = kernels
        self.host = host
        self.wall_us = wall_us

    @property
    def busy_us(self) -> float:
        return busy_us((s, e) for _, s, e in self.kernels)

    @property
    def window_us(self) -> float:
        """From the first kernel's start to the last one's end, or the
        call's wall time where that is longer."""
        if not self.kernels:
            return self.wall_us
        span = (max(e for _, _, e in self.kernels)
                - min(s for _, s, _ in self.kernels))
        return max(span, self.wall_us)

    def by_kind_us(self) -> dict:
        out = defaultdict(float)
        for name, s, e in self.kernels:
            out[kind(name)] += e - s
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time between kernels, summed by the innermost
        host operation running at each gap's middle; the n largest."""
        ivs = sorted((s, e) for _, s, e in self.kernels)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_op = defaultdict(float)
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(i - 400, -1), -1):
                name, hs, he = host[j]
                if he >= mid:
                    best = name
                    break
            by_op[best or "(no host op)"] += g1 - g0
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]


def profile_call(fn, device, host: bool = False) -> Trace:
    """fn() under torch.profiler, ended by a device fence.  With `host`
    the host's operations are traced too (for the idle gaps' causes); they
    slow the host by some microseconds an operation, so a trace read for
    busy and idle time leaves them out."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"

    def fence():
        if cuda:
            torch.cuda.synchronize(device)
    fence()
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        fence()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(item)
        else:
            host.append(item)
    return Trace(kernels, host, wall_us)
