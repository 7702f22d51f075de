"""Rank-side jobs of tests/test_torch_parallel.py (and the card test in
tests/test_torch_cuda.py): torch only, no JAX, so that each spawned rank
starts quickly.

`spawn(job, world, out_dir, *args)` starts `world` processes, each of which
joins a gloo group through a file store in `out_dir`, runs `job(mesh,
*args)` and saves what it returns to `out_dir/rank<r>.pt`; the caller gets
the list of the ranks' results.
"""

from __future__ import annotations

import hashlib
import os
import statistics
from typing import Dict, List

import numpy as np
import torch

from side_tpu_torch.parallel import mesh as pm

THREADS = 2


def start(job, world: int, out_dir: str, *args):
    """Start the ranks; `finish` waits for them and returns their
    results."""
    url = "file://" + os.path.join(out_dir, "store")
    ctx = torch.multiprocessing.spawn(
        _entry, args=(world, url, out_dir, job, args), nprocs=world,
        join=False)
    return ctx, world, out_dir


def finish(handle) -> List[dict]:
    ctx, world, out_dir = handle
    while not ctx.join():
        pass
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def spawn(job, world: int, out_dir: str, *args) -> List[dict]:
    return finish(start(job, world, out_dir, *args))


def _entry(rank, world, url, out_dir, job, args):
    torch.set_num_threads(THREADS)
    pm.init_distributed(url, world, rank, backend="gloo")
    try:
        out = job(pm.make_mesh(world), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pm.shutdown()


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def halves(a, mesh):
    """The rank's slice of a numpy array's leading axis, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        pm.shard_batch({"a": a}, mesh)["a"]))


# --------------------------------------------------------------- BatchNorm
BN_CASES = (("folded", 1), ("batchnorm", 1), ("batchnorm", -1))


def bn_case(kind: str, channel_dim: int, seed: int = 11):
    """A training-mode BatchNorm with seeded parameters and statistics, a
    (4, ...) input with per-channel means N(0, 1) and unit spread, and a
    cotangent.  (The variance max(E[x^2] - mean^2, 0), both packages'
    formula, loses (mean / std)^2 float ulps to cancellation: at unit
    spread the split batch's other sum order stays within 1e-6.)"""
    from side_tpu_torch.models.dla import BatchNorm, FoldedBatchNorm
    rng = np.random.RandomState(seed)
    C = 6
    shape = (4, C, 5, 7) if channel_dim == 1 else (4, 5, 7, C)
    cshape = [1] * 4
    cshape[channel_dim] = C
    x = (rng.randn(*shape) + rng.randn(*cshape)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    bn = (FoldedBatchNorm(C) if kind == "folded"
          else BatchNorm(C, channel_dim=channel_dim)).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.bias.copy_(torch.from_numpy(rng.randn(C)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, C)))
    return bn, x, g


def bn_run(bn, x: torch.Tensor, g: torch.Tensor, mesh=None) -> dict:
    """Forward and backward of `bn` (within `data_parallel(mesh)`)."""
    x = x.clone().requires_grad_(True)
    with pm.data_parallel(mesh):
        y = bn(x)
        y.backward(g.to(y.dtype))
    return {"y": y.detach().float().cpu(), "dx": x.grad.float().cpu(),
            "dweight": bn.weight.grad.cpu(), "dbias": bn.bias.grad.cpu(),
            "running_mean": bn.running_mean.cpu().clone(),
            "running_var": bn.running_var.cpu().clone()}


def bn_job(mesh, cases=BN_CASES, device="cpu") -> Dict[str, dict]:
    out = {}
    for kind, cdim in cases:
        bn, x, g = bn_case(kind, cdim)
        out[f"{kind}{cdim}"] = bn_run(bn.to(device),
                                      halves(x, mesh).to(device),
                                      halves(g, mesh).to(device), mesh)
    return out


# ------------------------------------------------------------ PointNetDepth
PN_N = 4


def pointnet_case(seed: int = 12):
    """The voxel variant's PointNetDepth in training mode (torch's seeded
    default init) and PN_N objects' point features, each object at its own
    scale (after the max-pool the BatchNorms take statistics over the
    objects alone; objects of one scale would make them ill-conditioned)."""
    from side_tpu_torch.models.voxel_net import VOXEL_RES, PointNetDepth
    torch.manual_seed(seed)
    pn = PointNetDepth(torch.float32).train()
    rng = np.random.RandomState(seed)
    x = (rng.randn(PN_N, VOXEL_RES ** 3, 192) *
         np.linspace(0.3, 3.0, PN_N)[:, None, None]).astype(np.float32)
    return pn, x


def pointnet_run(pn, x: torch.Tensor, mesh=None) -> dict:
    """A training-mode forward (dropout from a seeded generator) within
    `data_parallel(mesh)`: the output and the running statistics."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad(), pm.data_parallel(mesh):
        y = pn(x, generator=gen)
    return {"y": y, "running": _stats(pn)}


def pointnet_job(mesh) -> dict:
    pn, x = pointnet_case()
    return pointnet_run(pn, halves(x, mesh), mesh)


# -------------------------------------------------------------------- loss
LB, LH, LW, LK, GRID = 4, 12, 16, 5, 4
HEADS = {"hm": 3, "wh": 3, "reg": 3, "dim": 3, "orien": 2,
         "kept_type": 6 * GRID}
# name -> (uncert, depth_aux_weight, mse_loss, rows whose heatmaps hold no
# positive)
LOSS_CASES = {"uncert": (True, 0.5, False, ()),
              "fixed_weights": (False, 0.0, False, ()),
              "rank_without_positives": (True, 0.5, False, (2, 3)),
              "no_positives": (True, 0.0, False, (0, 1, 2, 3)),
              "mse": (False, 0.0, True, ())}


def loss_inputs(seed: int, empty_rows=()):
    """Seeded head outputs and targets of a batch of LB images; the second
    half has no valid slot, so one rank's L1 and depth-bin counts are
    zero."""
    rng = np.random.RandomState(seed)
    out = {k: (rng.randn(LB, LH, LW, c) * 2).astype(np.float32)
           for k, c in HEADS.items()}
    out["depth"] = (rng.rand(LB, LK, 1) * 40).astype(np.float32)
    out["depth_logits"] = rng.randn(LB, LK, 16).astype(np.float32)
    bins = np.sort(rng.uniform(2, 87, (LB, LK, 16)), axis=-1)[..., ::-1]
    out["depth_bin"] = np.ascontiguousarray(bins).astype(np.float32)
    hm = (rng.rand(LB, 3, LH, LW) ** 4 * 0.9).astype(np.float32)
    ind = rng.randint(0, LH * LW, (LB, LK)).astype(np.int64)
    mask = np.zeros((LB, LK), np.uint8)
    mask[:2, :3] = 1
    for b in range(LB):
        if b in empty_rows:
            continue
        for k in range(3):
            hm[b, k, ind[b, k] // LW, ind[b, k] % LW] = 1.0
    depth = (rng.rand(LB, LK, 1) * 40 + 5).astype(np.float32) * \
        mask[..., None]
    batch = {"hm": hm, "ind": ind, "rot_mask": mask,
             "wh": rng.uniform(2, 12, (LB, LK, 3)).astype(np.float32),
             "reg": rng.rand(LB, LK, 3).astype(np.float32),
             "dim": rng.rand(LB, LK, 3).astype(np.float32),
             "orien": rng.randn(LB, LK, 2).astype(np.float32),
             "kept": rng.uniform(-2, 14, (LB, LK, 6)).astype(np.float32),
             "depth": depth.astype(np.float32)}
    lw = rng.uniform(-1.5, 0.5, 7).astype(np.float32)
    return out, batch, lw


def loss_run(name: str, mesh=None) -> dict:
    """stereo_loss of case `name` on the rank's slice (the whole batch
    without a mesh): the loss parts and the gradients of the backed-
    propagated total with respect to every output and to loss_weight."""
    from side_tpu_torch.ops.losses import stereo_loss
    uncert, aux, mse, empty = LOSS_CASES[name]
    out, batch, lw = loss_inputs(5, empty)
    if mesh is not None:
        out = {k: halves(v, mesh) for k, v in out.items()}
        batch = {k: halves(v, mesh) for k, v in batch.items()}
    else:
        out = {k: torch.from_numpy(v) for k, v in out.items()}
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for v in out.values():
        v.requires_grad_(True)
    lw_t = torch.from_numpy(lw).requires_grad_(True)
    with pm.data_parallel(mesh):
        total, stats = stereo_loss(out, batch, lw_t, GRID, uncert, True,
                                   depth_aux_weight=aux, mse_loss=mse)
        total.backward()
    grads = {k: v.grad.clone() for k, v in out.items() if v.grad is not None}
    return {"stats": {k: float(v.detach()) for k, v in stats.items()},
            "grads": grads, "lw_grad": lw_t.grad.clone()}


def loss_job(mesh) -> Dict[str, dict]:
    return {name: loss_run(name, mesh) for name in LOSS_CASES}


# --------------------------------------------------------------- train step
SH, SW, SK, SB = 64, 128, 4, 2
STEP_KW = dict(input_h=SH, input_w=SW, compute_dtype="float32", max_objs=SK,
               roi_size=4, K=SK, uncert=True, lr=1e-3, lr_step=(3,),
               batch_size=SB)
STEP_CASES = {"flagship": {}, "remat": {"remat": True},
              "voxel": {"depth_variant": "voxel"}}
NOISE = 1e-7


def step_config(case: str):
    from side_tpu_torch.config import Config
    return Config(**STEP_KW, **STEP_CASES[case])


def step_model(cfg):
    """The model at the well-conditioned point of test_torch_train.py
    (runtime/synthetic.py:interior_init)."""
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.runtime.synthetic import interior_init
    model = create_model(cfg, seed=1)
    interior_init(model, seed=2)
    return model


def step_batch(cfg) -> Dict[str, np.ndarray]:
    from side_tpu_torch.data.synthetic import scene_batch
    return scene_batch(cfg, np.random.RandomState(3), SB, SK)


def _grads(tr) -> Dict[str, torch.Tensor]:
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).clone()
            for k, p in tr.params.items()}


def _stats(model) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def digest(tensors: Dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def grad_errors(want, got) -> Dict[str, float]:
    """Per tensor max |got - want| over max |want|, floored at 1e-4 of the
    largest gradient (a bias feeding a batch-statistics BatchNorm has a
    gradient of 0 up to float residue)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {k: float((got[k] - g).abs().max()) /
            max(float(g.abs().max()), 1e-4 * top) for k, g in want.items()}


def summary(errs: Dict[str, float]) -> Dict[str, float]:
    return {"max": max(errs.values()),
            "median": statistics.median(errs.values())}


def one_process_step(cfg, batch, mode: str, noise=None):
    """Loss parts, gradients and (train mode) running statistics of one
    step of the port on the whole batch, without a mesh; the normalised
    left input moved by `noise` if given."""
    from side_tpu_torch.runtime.trainer import Trainer, normalize_images
    tr = Trainer(cfg, step_model(cfg), steps_per_epoch=10, device="cpu")
    tr.model.train(mode == "train")
    b = tr.to_device(batch)
    if noise is not None:
        b["input"] = normalize_images(b, tr.mean, tr.std)["input"] + noise
    stats = tr.gradients(b)
    return ({k: float(v) for k, v in stats.items()}, _grads(tr),
            _stats(tr.model))


def step_job(mesh, cases=tuple(STEP_CASES),
             reference: bool = True) -> Dict[str, dict]:
    """Per case: the data-parallel eval-mode gradients and train step on
    the rank's slice; then (with `reference`) rank 0 holds them against
    the one-process run on the whole batch and rank 1 measures that run's
    distance from itself under a NOISE input change (their metrics are
    returned)."""
    from side_tpu_torch.runtime.trainer import Trainer
    out = {}
    for case in cases:
        cfg = step_config(case)
        batch = step_batch(cfg)
        tr = Trainer(cfg, step_model(cfg), steps_per_epoch=10, device="cpu",
                     mesh=mesh)
        b = tr.to_device(pm.shard_batch(batch, mesh))
        res = {}
        for mode in ("eval", "train"):
            tr.model.train(mode == "train")
            res[mode] = {"stats": {k: float(v)
                                   for k, v in tr.gradients(b).items()},
                         "grads": _grads(tr)}
        res["train"]["running"] = _stats(tr.model)
        tr.optimizer.step()
        res["param_digest"] = digest(tr.params)
        res["running_digest"] = digest(res["train"]["running"])
        res["grad_digest"] = digest(res["train"]["grads"])
        if reference and mesh.rank == 0:
            ev = one_process_step(cfg, batch, "eval")
            res["eval"]["errors"] = grad_errors(ev[1], res["eval"]["grads"])
            res["eval"]["want_stats"] = ev[0]
            ref = one_process_step(cfg, batch, "train")
            res["train"]["errors"] = grad_errors(ref[1],
                                                 res["train"]["grads"])
            res["train"]["want_stats"] = ref[0]
            res["train"]["want_running"] = ref[2]
        elif reference:
            ref = one_process_step(cfg, batch, "train")
            noise = torch.randn(batch["input"].shape,
                                generator=torch.Generator().manual_seed(7))
            moved = one_process_step(cfg, batch, "train", noise * NOISE)
            res["train"]["noise_errors"] = grad_errors(ref[1], moved[1])
            res["train"]["noise_stats"] = {
                k: abs(moved[0][k] - v) / max(abs(v), 1e-3)
                for k, v in ref[0].items()}
            res["train"]["noise_running"] = {
                k: rel_err(moved[2][k], v) for k, v in ref[2].items()}
        for mode in ("eval", "train"):
            del res[mode]["grads"]
        out[case] = res
    return out


def one_step(cfg, batch, mesh) -> dict:
    """One train step of the port on the rank's slice of `batch`: loss
    parts and the digests of the parameters, gradients and running
    statistics."""
    from side_tpu_torch.runtime.trainer import Trainer
    tr = Trainer(cfg, step_model(cfg), steps_per_epoch=10, device="cpu",
                 mesh=mesh)
    stats = tr.train_step(tr.to_device(pm.shard_batch(batch, mesh)))
    return {"stats": {k: float(v) for k, v in stats.items()},
            "param_digest": digest(tr.params),
            "grad_digest": digest(_grads(tr)),
            "running_digest": digest(_stats(tr.model))}


def world1_job(mesh) -> dict:
    """The flagship step on a world-1 group (every collective runs) and
    without a mesh, in one process (the same CPU threads)."""
    assert mesh.active and mesh.world == 1
    cfg = step_config("flagship")
    return {"group": one_step(cfg, step_batch(cfg), mesh),
            "no_mesh": one_step(cfg, step_batch(cfg), pm.Mesh())}


def all_jobs(mesh) -> dict:
    return {"bn": bn_job(mesh), "loss": loss_job(mesh),
            "pointnet": pointnet_job(mesh), "step": step_job(mesh)}
