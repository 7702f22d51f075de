"""Driver of the `val_pass` traffic: the port's batched validation pass,
`side_tpu_torch.val.run_pass(..., eval_batch=B)`, pipelined, over a source
that cycles a pool of rendered frames and stops yielding when the window
ends; `load_and_pre`'s affine warp runs in the window, on the pass's
producer thread, as users run it.  No result files and no evaluator.

Set-up warms the pass's shapes with `warmup_groups` groups.  After the
window, one of the window's groups, drawn from the seed, runs again
through the same Detector's network, decode and device tail, and each
stage is compared with the reference on the program's own inputs to it;
the rows the window returned for that group are compared with the
reference's score filter over the tail's rows (check.val_numbers)."""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np
import torch

from .. import check, weights
from ..metrics import flops as flop_count
from ..metrics.trace import profile_call
from ..reference import float32, layers, model as ref_model
from ..reference.decode import ddd_decode
from ..reference.detect import pre_process, tail_on
from ..reference.detect import results as bucketed
from ..traffic import generator


class _Frames:
    """(frame id, (left, right), calib) in turn from the pool: `n` of them,
    or until `deadline` (perf_counter seconds) has passed."""

    def __init__(self, pool, start: int, n: int = None, deadline=None):
        self.pool, self.start, self.n, self.deadline = pool, start, n, deadline
        self.handed = 0

    def __iter__(self):
        i = 0
        while (self.n is None or i < self.n) and \
                (self.deadline is None or time.perf_counter() < self.deadline):
            _, pair, calib = self.pool[(self.start + i) % len(self.pool)]
            self.handed += 1
            yield self.start + i, pair, calib
            i += 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def group_stages(det, frames) -> dict:
    """One group of frames, each stage between device fences; times in ms.
    (side_tpu_torch/stage_profile.py's `group_stages` at commit
    ca59ff401c87.)"""
    from side_tpu_torch.postprocess.device_tail import run_tail_batch

    def fenced(fn):
        _sync(det.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(det.device)
        return out, (time.perf_counter() - t0) * 1e3
    pres, t_pre = fenced(lambda: [det.load_and_pre(pair, calib)
                                  for _, pair, calib in frames])
    batch = {k: torch.cat([p["batch"][k] for p in pres], dim=0)
             for k in pres[0]["batch"]}
    out, t_net = fenced(lambda: det.network(batch))
    (dets, dets_r, info), t_dec = fenced(lambda: det.decode(out))
    with torch.inference_mode():
        (rows, _), t_tail = fenced(lambda: run_tail_batch(
            dets, dets_r, info, [p["image"] for p in pres],
            [p["image_right"] for p in pres], [p["meta"] for p in pres],
            det.cfg))
    _, t_fetch = fenced(lambda: rows.cpu().numpy())
    return {"pre": t_pre, "network": t_net, "decode": t_dec,
            "tail": t_tail, "fetch": t_fetch}


MAPS = ("hm", "kept_type", "dim", "orien", "wh", "reg")


def program_group(det, frames, align: bool) -> dict:
    """One group through the program's network, decode and device tail, as
    `dispatch_batch` runs it: the head maps the decode read, the decoded
    detections and the tail's rows and classes, on the host."""
    from side_tpu_torch.postprocess.device_tail import run_tail_batch
    pres = [det.load_and_pre(pair, calib) for pair, calib in frames]
    batch = {k: torch.cat([p["batch"][k] for p in pres], dim=0)
             for k in pres[0]["batch"]}
    kept, unhook = layers.capture(det.model)
    with torch.inference_mode():
        out = det.network(batch)
        unhook()
        dets, dets_r, info = det.decode(out)
        rows, classes = run_tail_batch(
            dets, dets_r, info, [p["image"] for p in pres],
            [p["image_right"] for p in pres], [p["meta"] for p in pres],
            det.cfg, run_align=align)
    got = {k: out[k].float().cpu() for k in MAPS}
    got.update({k: v.float().cpu() for k, v in (
        ("dets", dets), ("dets_r", dets_r), ("info", info), ("rows", rows))})
    got["classes"] = classes.cpu()
    got["layers"] = kept
    return got


def run(run) -> None:
    from side_tpu_torch.config import Config as PortConfig
    from side_tpu_torch.runtime.detector import Detector
    from side_tpu_torch.val import run_pass

    mix, device = run.mix, run.device
    keys = dict(run.config_keys)
    cfg = run.ref_config(keys)
    port_cfg = PortConfig(**keys)
    B = int(mix["eval_batch"])
    align = bool(mix["align"])
    run.mark("imports")
    pool = generator.val_pool(cfg, mix, run.seed)
    run.mark(f"{len(pool)} frames rendered")
    w = weights.draw(ref_model.build(cfg), run.seed, device)
    run.mark("weights drawn")
    det = Detector(port_cfg, device=device)
    det.model.load_state_dict(w, strict=True)
    run.mark("detector built")

    def pass_over(frames):
        """run_pass over `frames`, its per-frame lines to /dev/null."""
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return run_pass(port_cfg, frames, det, n=2 ** 62, eval_batch=B,
                            no_align=not align)[0]

    pass_over(_Frames(pool, 0, n=B * int(mix["warmup_groups"])))
    _sync(device)
    run.mark("warm-up pass")

    # ---------------------------------------------------------- the window
    run.window_opened()
    source = _Frames(pool, 0, deadline=time.perf_counter() + run.seconds)
    t0 = time.perf_counter()
    results = pass_over(source)
    _sync(device)
    t1 = time.perf_counter()
    run.attempted = source.handed
    run.failed = source.handed - len(results)
    run.end_to_end = {"val_frames_per_s": len(results) / (t1 - t0)}
    run.data.update(kind="val_pass", window={"frames": len(results),
                                              "seconds": t1 - t0})
    if run.trace:
        n = int(mix["trace_groups"])
        start = source.handed
        run.data["trace"] = profile_call(
            lambda: pass_over(_Frames(pool, start, n=n * B)), device)
        run.data["trace_groups"] = n
        run.data["trace_host"] = profile_call(
            lambda: pass_over(_Frames(pool, start + n * B, n=2 * B)), device,
            host=True)
        stages = []
        for g in range(int(mix["stage_groups"])):
            first = start + (n + 2 + g) * B
            stages.append(group_stages(det, [
                (i, pool[i % len(pool)][1], pool[i % len(pool)][2])
                for i in range(first, first + B)]))
        run.data["stages"] = stages
        f, dcn = flop_count.count(cfg, B, train=False)
        run.data.update(flops=f / B, dcn_layers=dcn)
    run.read_memory()
    run.mark("traced" if run.trace else "window closed")

    # ------------------------------------------- the check, after the window
    rng = np.random.RandomState(generator.derived_seed(run.seed, 3))
    g = int(rng.randint(max(len(results) // B, 1)))
    ids = list(range(g * B, (g + 1) * B))
    group = [pool[i % len(pool)][1:] for i in ids]
    prog = program_group(det, group, align)
    del det
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with float32():
        model = ref_model.loaded(cfg, w, device)
        staged = judge_group(cfg, model, group, prog, align, device)
    staged["window"] = [results.get(i) for i in ids]
    run.compared = staged
    run.numbers = check.val_numbers(staged)
    run.mark("reference compared")


def judge_group(cfg, model, group, prog: dict, align: bool, device) -> dict:
    """The reference over one group's stages, each on the program's own
    inputs to it: single layers of the network (reference.layers; the stem
    on the reference's own pre-process of the first frame), the decode on
    the program's head maps, the tail on the program's decoded detections,
    and the score filter on the program's tail rows."""
    rows, classes = prog["rows"].numpy(), prog["classes"].numpy()
    (image, image_right), calib = group[0]
    out = {"layers": layers.gaps(model, prog["layers"], device,
                                 layers.stem_input(cfg, pre_process(
                                     cfg, image, image_right, calib)[0][0],
                                     device))}
    maps = {k: prog[k].to(device) for k in MAPS}
    ref_dec = ddd_decode(torch.sigmoid(maps["hm"]), maps["kept_type"],
                         maps["dim"], maps["orien"], maps["wh"], maps["reg"],
                         grid_size=cfg.grid, K=cfg.K)
    del maps
    out["decode"] = [(a, b) for a, b in zip(
        ref_dec, (prog["dets"], prog["dets_r"], prog["info"][..., :9]))]
    dev = {k: prog[k].to(device) for k in ("dets", "dets_r", "info")}
    out["rows"] = rows.astype(np.float64)
    out["ref_rows"] = tail_on(cfg, dev["dets"], dev["dets_r"], dev["info"],
                              group, align)
    out["mask"] = check.tail_rows(out["rows"], cfg.peak_thresh,
                                  cfg.align_topk)
    out["filtered"] = [bucketed(cfg, r, c, r[:, 12] > cfg.peak_thresh)
                       for r, c in zip(rows, classes)]
    return out
