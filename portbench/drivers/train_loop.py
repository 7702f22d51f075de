"""Driver of the `train_loop` traffic: the port's training loop,
`Trainer.run_epoch("train", ...)`, closed loop over a pool of batches.

Set-up builds one Trainer on the benchmark's weights and drives it through
its first `warmup_steps` steps by the window's own call and feed (one
`run_epoch` over one batch each, on distinct batches), keeping the losses,
the first step's single layers (reference.layers), Adam's first moment
after step 1 and the parameters before and after; the
reference follows those steps after the window.  The window hands the
pool's batches to `run_epoch` until `--seconds` have passed; each handout
marks a step boundary, and `run_epoch`'s per-step `.item()` reads fence
the steps."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import check, weights
from ..metrics import flops as flop_count
from ..metrics.trace import profile_call
from ..reference import float32, layers, model as ref_model
from ..reference.train import run_steps, stereo_images
from ..traffic import generator


class _Batches:
    """A loader that hands out `batches` in turn, `n` of them, or until
    `deadline` (perf_counter seconds) has passed; `marks` holds the time of
    every handout and of the last call."""

    def __init__(self, pool, start: int, n: int = None, deadline=None):
        self.pool, self.start, self.n, self.deadline = pool, start, n, deadline
        self.marks = []

    def __len__(self):
        return self.n if self.n is not None else 2 ** 62

    def __iter__(self):
        i = 0
        while True:
            now = time.perf_counter()
            self.marks.append(now)
            if (self.n is not None and i >= self.n) or \
                    (self.deadline is not None and now >= self.deadline):
                return
            yield self.pool[(self.start + i) % len(self.pool)]
            i += 1


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_stages(tr, batch) -> dict:
    """One training step, forward + loss, backward and optimizer each
    between device fences; times in ms.  (side_tpu_torch/stage_profile.py's
    `step_stages` at commit ca59ff401c87.)"""
    def fenced(fn):
        _sync(tr.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(tr.device)
        return out, (time.perf_counter() - t0) * 1e3
    tr.model.train()
    for p in tr.params.values():
        p.grad = None
    b, t_up = fenced(lambda: tr.to_device(batch))
    (total, _), t_fwd = fenced(lambda: tr.loss(b))
    _, t_bwd = fenced(total.backward)
    _, t_opt = fenced(tr.optimizer.step)
    return {"upload": t_up, "forward": t_fwd, "backward": t_bwd,
            "optimizer": t_opt}


def run(run) -> None:
    from side_tpu_torch.config import Config as PortConfig
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.trainer import Trainer

    mix, device = run.mix, run.device
    keys = dict(run.config_keys, batch_size=int(mix["pairs_per_step"]))
    cfg = run.ref_config(keys)
    run.mark("imports")
    pool = generator.train_pool(cfg, mix, run.seed)
    run.mark(f"{len(pool)} batches rendered")
    w = weights.draw(ref_model.build(cfg), run.seed, device)
    run.mark("weights drawn")
    model = create_model(PortConfig(**keys)).to(device)
    model.load_state_dict(w, strict=True)
    tr = Trainer(PortConfig(**keys), model, steps_per_epoch=len(pool),
                 device=device)
    run.mark("trainer built")

    n_first = int(mix["warmup_steps"])
    p0 = _clone(tr.params)
    losses, mu1 = [], None
    kept, unhook = layers.capture(model, whole_stem=True)
    for i in range(n_first):
        losses.append(tr.run_epoch("train", 0, _Batches(pool, i, n=1))["loss"])
        if i == 0:
            mu1 = _clone(tr.optimizer.mu)
            unhook()
    pn = _clone(tr.params)
    _sync(device)
    run.mark(f"{n_first} first steps")

    # ---------------------------------------------------------- the window
    run.window_opened()
    loader = _Batches(pool, n_first, deadline=time.perf_counter() + run.seconds)
    t0 = time.perf_counter()
    tr.run_epoch("train", 0, loader)
    _sync(device)
    t1 = time.perf_counter()
    steps = len(loader.marks) - 1
    step_ms = np.diff(loader.marks) * 1e3
    pairs = int(mix["pairs_per_step"])
    run.attempted, run.failed = steps, 0
    run.end_to_end = {
        "train_pairs_per_s": steps * pairs / (t1 - t0),
        "train_step_p95_ms": float(np.percentile(step_ms, 95)),
    }
    run.data.update(kind="train_loop", window={"steps": steps,
                                                "seconds": t1 - t0})
    if run.trace:
        n = int(mix["trace_steps"])
        start = n_first + steps
        run.data["trace"] = profile_call(
            lambda: tr.run_epoch("train", 0, _Batches(pool, start, n=n)),
            device)
        run.data["trace_steps"] = n
        run.data["trace_host"] = profile_call(
            lambda: tr.run_epoch("train", 0, _Batches(pool, start + n, n=2)),
            device, host=True)
        run.data["stages"] = [
            step_stages(tr, pool[(start + n + 2 + i) % len(pool)])
            for i in range(int(mix["stage_steps"]))]
        f, dcn = flop_count.count(cfg, pairs, train=True)
        run.data.update(flops=f, dcn_layers=dcn)
    run.read_memory()
    run.mark("traced" if run.trace else "window closed")

    # ------------------------------------------- the check, after the window
    del tr, model, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with float32():
        ref = run_steps(cfg, ref_model.loaded(cfg, w, device),
                        pool[:n_first], steps_per_epoch=len(pool))
        first = ref_model.loaded(cfg, w, device)
        layer = layers.gaps(first, kept, device, layers.stem_input(
            cfg, stereo_images(pool[0]), device))
        del first
    prog = {"losses": losses, "mu1": mu1, "p0": p0, "pn": pn,
            "layers": layer}
    run.compared = (prog, ref)
    run.numbers = check.train_numbers(prog, ref)
    run.mark("reference compared")
