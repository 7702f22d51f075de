"""Train the JAX package and the port side by side on the acceptance
protocol, on the CPU, from the same weights and the same batches, and say
where they part.

    python tests/torch_trajectory.py --steps 160 --out /tmp/traj [--dcn exact]

Three trainers take every step on the same uint8 batch of the protocol's
loader (`side_tpu_torch.tools.acceptance_16`: fixture scenes, val = train,
128x384, f32):

  jax   side_tpu's Trainer, from the port's `create_model(cfg, seed=0)`
        weights carried over through `weights.to_flax`;
  port  side_tpu_torch's Trainer from those weights;
  ctl   the port again, from those weights times (1 + 1e-7 * N(0, 1)): a
        control that differs from `port` by float rounding alone.

Both packages run the same DCN function: `--dcn exact` (default; the
gather form, whose derivative at integer offsets is the right one on both
sides) or `--dcn windowed` (R = 1; the JAX side's XLA shift form takes the
derivative of |d - s| at integer offsets differently, so the two parts at
the first step on the zero-initialised offsets).

Every step prints the three loss vectors; every `--every` steps the
norm-relative distance of all parameters, port vs jax and port vs ctl.
When the port follows the JAX package as closely as it follows itself
under a rounding-level change, the two distances grow together.  At the
end each trainer's checkpoint is scored by the port's protocol
(`run_overfit_variants(ckpt=...)`): the per-object errors and the failed
floors of each, one JSON line per trainer, and `trajectory.json` under
`--out`.  Needs JAX and torch (this repo's CPU test environment).

    python tests/torch_trajectory.py --check_ckpt DIR/jax/model_last.npz

instead holds one training step at a trained point: the loss parts and
the gradients of both packages on the checkpoint's weights and the
protocol's first batch (the DCN mode the checkpoint was trained in),
beside the port's own with its weights times (1 + s * N(0, 1)), s = 1e-7
and 1e-6; then the cost-volume head alone on the input it had there, in
both packages in f32 against the port in float64 (`_head_check`).  Per parameter tensor
the error is max |difference| / max |reference|; prints the median and
the worst over tensors.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from side_tpu.config import Config as JConfig  # noqa: E402
from side_tpu.models import create_model as jcreate_model  # noqa: E402
from side_tpu.ops import deform_conv as jdc  # noqa: E402
from side_tpu.runtime.trainer import Trainer as JTrainer  # noqa: E402
from side_tpu_torch import weights  # noqa: E402
from side_tpu_torch.data.loader import Loader  # noqa: E402
from side_tpu_torch.data.synthetic import (FixtureKitti,  # noqa: E402
                                           fixture_scenes)
from side_tpu_torch.models.factory import create_model  # noqa: E402
from side_tpu_torch.ops import deform_conv as tdc  # noqa: E402
from side_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from side_tpu_torch.tools import acceptance_16 as acc  # noqa: E402


def _flat_port(model) -> dict:
    params, _ = weights.to_flax(model.state_dict())
    return weights._flatten(params)


def _flat_jax(jt) -> dict:
    return weights._flatten(jax.tree.map(
        np.asarray, jax.device_get(jt.state.params["model"])))


def rel_distance(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every parameter (float64)."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in b)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got - want)


def _errors(got: dict, want: dict) -> dict:
    errs = [float(np.abs(got[k] - want[k]).max() /
                  max(np.abs(want[k]).max(), 1e-30)) for k in want]
    return {"median": float(np.median(errs)), "worst": float(max(errs)),
            "tensors": len(errs)}


def check_trained_point(path: str, hw, batch_size: int) -> dict:
    """One training step's loss parts and gradients, JAX package against
    port, at the weights of the checkpoint `path`."""
    from side_tpu.runtime.checkpoint import load_checkpoint
    cfg = acc.protocol_config("data", "exp", hw, batch_size)
    loaded = load_checkpoint(path)
    exact = loaded.get("dcn_radius", 1) < 0
    scenes = fixture_scenes(2, 2, seed=0)[:2]
    batch = next(iter(Loader(FixtureKitti(cfg, scenes), cfg.batch_size,
                             shuffle=True, num_workers=1, drop_last=True,
                             seed=0)))
    batch = {k: np.array(v) for k, v in batch.items() if k != "meta"}

    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "input_h", "input_w", "batch_size", "lr", "lr_step", "max_objs",
        "K", "compute_dtype", "num_devices", "uncert", "peak_thresh")})
    jt = JTrainer(jcfg, jcreate_model(jcfg), {
        "params": jax.tree.map(jax.numpy.asarray, loaded["params"]),
        "batch_stats": jax.tree.map(jax.numpy.asarray,
                                    loaded["batch_stats"])},
        steps_per_epoch=1)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    with jdc.dcn_mode("exact" if exact else "windowed"):
        (_, (jstats, _)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jt._loss_fn(p, jt.state.batch_stats, jbatch, True,
                                  step=jax.numpy.zeros((), "int32")),
            has_aux=True))(jt.state.params)
    want = weights._flatten(jax.tree.map(np.asarray, jgrads["model"]))
    jstats = {k: float(v) for k, v in jstats.items()}

    head_in = {}

    def port_step(scale):
        model = create_model(cfg, seed=0)
        weights.load_npz(model, path, log=lambda msg: None)
        if not scale:    # the cost-volume head's input, for `_head_check`
            model.depth_estimator.register_forward_pre_hook(
                lambda m, args: head_in.update(cost=args[0].detach(),
                                               bins=args[1].detach()))
        if scale:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + scale * torch.randn(p.shape, generator=gen))
        tr = Trainer(cfg, model, 1, device="cpu")
        model.train()
        total, stats = tr.loss(tr.to_device(batch))
        total.backward()
        grads = {weights.flax_param_path(k, p.dim()): weights.param_to_flax(
            k, np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy()) for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in stats.items()}, grads

    with tdc.dcn_mode("exact" if exact else "windowed",
                      None if exact else 1):
        pstats, pgrads = port_step(0.0)
        ctl = {scale: port_step(scale) for scale in (1e-7, 1e-6)}
    out = {"checkpoint": path, "dcn": "exact" if exact else "windowed",
           "loss_rel_diff": {k: _rel(pstats[k], jstats[k]) for k in jstats},
           "grad_err_port_vs_jax": _errors(pgrads, want)}
    for scale, (cstats, cgrads) in ctl.items():
        out[f"loss_rel_diff_ctl_{scale:g}"] = {
            k: _rel(cstats[k], pstats[k]) for k in pstats}
        out[f"grad_err_ctl_{scale:g}_vs_port"] = _errors(cgrads, pgrads)
    with tdc.dcn_mode("exact" if exact else "windowed",
                      None if exact else 1):
        out["cost_volume_head"] = _head_check(cfg, path, loaded, head_in)
    return out


def _head_check(cfg, path, loaded, head_in) -> dict:
    """The cost-volume head alone (CostVolumeNet, training-mode BatchNorm)
    on the input it had in the port's step, in both packages in f32 and in
    the port in float64: the output of its first BatchNorm and the
    gradients of a fixed random projection of (depth, logits), each
    against float64 (max |difference| / max |float64|)."""
    from side_tpu.models.cost_volume import CostVolumeNet as JCostVolumeNet
    cost, bins = head_in["cost"], head_in["bins"]
    rng = np.random.RandomState(0)
    w_depth = rng.randn(bins.shape[0])
    w_logits = rng.randn(*bins.shape)

    def port(dtype):
        model = create_model(cfg, seed=0)
        weights.load_npz(model, path, log=lambda msg: None)
        head = model.depth_estimator.to(dtype).train()
        seen = {}
        head.ConvBN3D_0.BatchNorm_0.register_forward_hook(
            lambda m, a, o: seen.update(bn=o.detach()))
        depth, logits = head(cost.to(dtype), bins.to(dtype))
        ((depth * torch.from_numpy(w_depth).to(dtype)).sum() +
         (logits * torch.from_numpy(w_logits).to(dtype)).sum()).backward()
        grads = {weights.flax_param_path("depth_estimator." + k, p.dim())
                 .split("/", 1)[1]: weights.param_to_flax(
                     "depth_estimator." + k, p.grad.double().numpy())
                 for k, p in head.named_parameters()}
        return np.moveaxis(seen["bn"].double().numpy(), 1, -1), grads

    bn64, g64 = port(torch.float64)
    bn32, g32 = port(torch.float32)
    variables = {"params": loaded["params"]["depth_estimator"],
                 "batch_stats": loaded["batch_stats"]["depth_estimator"]}

    def jloss(params):
        (depth, logits), state = JCostVolumeNet().apply(
            dict(variables, params=params), jax.numpy.asarray(cost.numpy()),
            jax.numpy.asarray(bins.numpy()), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        bn = state["intermediates"]["ConvBN3D_0"]["BatchNorm_0"]["__call__"]
        return ((depth * w_depth.astype(np.float32)).sum() +
                (logits * w_logits.astype(np.float32)).sum(), bn[0])

    jgrads, jbn = jax.grad(jloss, has_aux=True)(
        jax.tree.map(jax.numpy.asarray, variables["params"]))
    jgrads = weights._flatten(jax.tree.map(np.asarray, jgrads))

    # a gradient at rounding level in float64 (the bias of the conv that
    # feeds a training-mode BatchNorm, which removes it) is left out
    g_top = max(np.abs(g).max() for g in g64.values())
    kept = [k for k in g64 if np.abs(g64[k]).max() > 1e-6 * g_top]

    def vs64(got: dict) -> dict:
        errs = {k: float(np.abs(got[k] - g64[k]).max() /
                         np.abs(g64[k]).max()) for k in kept}
        worst = max(errs, key=errs.get)
        return {"median": float(np.median(list(errs.values()))),
                "worst": errs[worst], "worst_tensor": worst,
                "left_out": sorted(set(g64) - set(kept))}

    top = np.abs(bn64).max()
    return {"first_bn_err": {"jax": float(np.abs(np.asarray(jbn) - bn64)
                                          .max() / top),
                             "port": float(np.abs(bn32 - bn64).max() / top)},
            "grad_err": {"jax": vs64(jgrads), "port": vs64(g32)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tests/torch_trajectory.py")
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dcn", default="exact", choices=("exact", "windowed"))
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--input_h", type=int, default=128)
    ap.add_argument("--input_w", type=int, default=384)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check_ckpt", default=None)
    args = ap.parse_args(argv)
    hw = (args.input_h, args.input_w)
    if args.check_ckpt:
        print(json.dumps(check_trained_point(args.check_ckpt, hw,
                                             args.batch)), flush=True)
        return 0
    os.makedirs(args.out, exist_ok=True)

    cfg = acc.protocol_config(args.out, args.out, hw, args.batch)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "data_dir", "exp_dir", "input_h", "input_w", "batch_size", "lr",
        "lr_step", "num_epochs", "max_objs", "K", "aug_ddd", "no_color_aug",
        "flip_train", "compute_dtype", "num_devices", "uncert",
        "peak_thresh")})
    scenes = fixture_scenes(args.scenes, 2, seed=0)[:args.scenes]
    loader = Loader(FixtureKitti(cfg, scenes), cfg.batch_size, shuffle=True,
                    num_workers=2, drop_last=True, seed=0)
    spe = len(loader)

    model = create_model(cfg, seed=0)
    params, stats = weights.to_flax(model.state_dict())
    ctl_model = create_model(cfg, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in ctl_model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    trainers = {
        "jax": JTrainer(jcfg, jcreate_model(jcfg),
                        {"params": jax.tree.map(jax.numpy.asarray, params),
                         "batch_stats": jax.tree.map(jax.numpy.asarray,
                                                     stats)},
                        steps_per_epoch=spe),
        "port": Trainer(cfg, model, spe, device="cpu"),
        "ctl": Trainer(cfg, ctl_model, spe, device="cpu"),
    }
    log = {"args": vars(args), "steps": [], "distance": []}
    t0 = time.perf_counter()
    step, epoch = 0, 0
    with jdc.dcn_mode(args.dcn), tdc.dcn_mode(
            args.dcn, 1 if args.dcn == "windowed" else None):
        while step < args.steps:
            epoch += 1
            for batch in loader:
                if step >= args.steps:
                    break
                row = {"step": step + 1}
                for name, tr in trainers.items():
                    row[name] = {k: float(v) for k, v in
                                 tr.train(epoch, [batch]).items()
                                 if k != "time"}
                step += 1
                log["steps"].append(row)
                print(json.dumps(row), flush=True)
                if step % args.every == 0 or step == 1:
                    ref = _flat_port(trainers["port"].model)
                    d = {"step": step,
                         "port_vs_jax": rel_distance(
                             ref, _flat_jax(trainers["jax"])),
                         "port_vs_ctl": rel_distance(
                             ref, _flat_port(trainers["ctl"].model)),
                         "s": time.perf_counter() - t0}
                    log["distance"].append(d)
                    print("distance:", json.dumps(d), flush=True)

        # score each trainer's checkpoint by the port's protocol
        log["scores"] = {}
        for name, tr in trainers.items():
            path = os.path.join(args.out, name, "model_last.npz")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tr.save(path, epoch)
            out = acc.run_overfit_variants(
                os.path.join(args.out, name, "eval"), n_scenes=args.scenes,
                batch_size=args.batch, input_hw=hw, ckpt=path,
                device="cpu")
            errors = out["clean"][1]
            floors = acc.FLOORS[16 if args.scenes == 16 else 2](out)
            log["scores"][name] = {
                "floors_failed": floors,
                "errors": [{k: (v if isinstance(v, (bool, str))
                                else round(float(v), 3))
                            for k, v in e.items()} for e in errors],
                "aps": {k: list(v) for k, v in out["clean"][0].items()}}
            print("score:", json.dumps(acc._jsonable(
                {name: log["scores"][name]})), flush=True)
    with open(os.path.join(args.out, "trajectory.json"), "w") as f:
        json.dump(acc._jsonable(log), f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
