"""The share of seeds that meet the 2-scene floors, for the JAX package and
for the port, on the CPU at the same settings (windowed DCN at R = 1, f32).

    python tests/torch_acceptance_share.py --seeds 0-5
    python tests/torch_acceptance_share.py --side port --device cpu --seeds 0-5

Each run writes its fixture and checkpoint under `--out` (default
exp/share, inside the checkout), one directory per side and seed.

`--side jax` (the default) runs the protocol of tests/test_overfit_ap.py
(`run_overfit_ap`: 2 scenes of `build_fixture(..., seed=0)`, val = train,
batch 2, 160 epochs, 128x384) once per seed, with the seed drawing the
initial weights (`jax.random.PRNGKey(seed)`) and the batch order
(`Loader(..., seed=seed)`); that test cannot take a seed, so `jax_setup`
and `run_jax_protocol` hold a copy of its body, and
tests/test_torch_acceptance.py holds the copy against it at seed 0.  The
whole run, detection included, is under `dcn_mode("windowed")`.  The
predictions are scored by the JAX test's own `_save_and_eval`, and the
floors by the port's `acceptance_16.floors_2`, the function that judges
the port's runs.  Prints `acceptance_rate`'s JSON line for each seed (with
`side: "jax"`) and its `tally` line.

`--side port` runs `side_tpu_torch.tools.acceptance_rate` (2 scenes,
windowed, float32) at the same seeds on `--device` (default the GPU), so
that both packages' CPU rows come from one command.

    python tests/torch_acceptance_share.py --judge JAX_LOG PORT_LOG

applies the decision rule (`decide`) to the windowed float32 lines of two
such logs (or `acceptance_rate`'s) and prints its verdict, with the port's
runs that met every floor and its runs for each seed (`by_seed`).  Needs
JAX and torch (this repo's CPU test environment).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import test_overfit_ap as jtest  # noqa: E402
from side_tpu.ops import deform_conv as jdc  # noqa: E402
from side_tpu_torch.tools import acceptance_16 as acc  # noqa: E402
from side_tpu_torch.tools import acceptance_rate as rate  # noqa: E402


def jax_setup(tmp, seed=0, epochs=160, lr=1e-3, input_hw=(128, 384),
              n_scenes=2, batch_size=2):
    """tests/test_overfit_ap.py `run_overfit_ap` up to the Trainer, with
    `seed` in place of its 0 for the weights and the batch order: the
    fixture, the val = train split, the Config, the Loader and the initial
    variables.  Returns a dict of them and the paths."""
    from side_tpu.config import Config
    from side_tpu.data.dataset import StereoKitti
    from side_tpu.data.kitti import convert_split
    from side_tpu.data.loader import Loader
    from side_tpu.data.synthetic import build_fixture
    from side_tpu.models import create_model
    from side_tpu.models.stereo_net import init_stereo_net

    data_dir = os.path.join(tmp, "data")
    save_dir = os.path.join(tmp, "exp")
    os.makedirs(save_dir, exist_ok=True)
    build_fixture(data_dir, n_train=n_scenes, n_val=2, seed=0)
    base = os.path.join(data_dir, "kitti")
    with open(os.path.join(base, "ImageSets_3dop", "train.txt")) as f:
        train_ids = f.read()
    with open(os.path.join(base, "ImageSets_3dop", "val.txt"), "w") as f:
        f.write(train_ids)
    convert_split(base, "3dop", "val",
                  os.path.join(base, "annotations_3d", "kitti_3dop_val.json"))

    cfg = Config(data_dir=data_dir, exp_dir=save_dir,
                 input_h=input_hw[0], input_w=input_hw[1],
                 batch_size=batch_size, lr=lr, lr_step=(10 ** 9,),
                 num_epochs=epochs, max_objs=16, K=16,
                 aug_ddd=0.0, no_color_aug=True, flip_train=False,
                 compute_dtype="float32", num_devices=1, uncert=False,
                 peak_thresh=0.25)
    train_ds = StereoKitti(cfg, "train")
    loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                    num_workers=2, drop_last=True, seed=seed)
    model = create_model(cfg)
    variables = jax.jit(
        lambda r: init_stereo_net(model, r, cfg.input_h, cfg.input_w,
                                  cfg.max_objs))(jax.random.PRNGKey(seed))
    return dict(cfg=cfg, loader=loader, model=model, variables=variables,
                base=base, save_dir=save_dir)


def run_jax_protocol(tmp, seed=0, epochs=160, verbose=False, **kw):
    """The rest of `run_overfit_ap`: train, detect the val = train split
    with and without the dense alignment, score.  Under
    `dcn_mode("windowed")` (R = 1).  Returns {"clean": (aps, errors)}."""
    from side_tpu.data.dataset import StereoKitti
    from side_tpu.runtime.detector import Detector
    from side_tpu.runtime.trainer import Trainer

    with jdc.dcn_mode("windowed"):
        s = jax_setup(tmp, seed=seed, epochs=epochs, **kw)
        cfg, loader = s["cfg"], s["loader"]
        trainer = Trainer(cfg, s["model"], s["variables"],
                          steps_per_epoch=len(loader))
        for epoch in range(1, epochs + 1):
            stats = trainer.train(epoch, loader)
            if verbose and (epoch % 10 == 0 or epoch == 1):
                print(f"[share] seed {seed} epoch {epoch}: " +
                      " ".join(f"{k}={v:.3f}" for k, v in stats.items()),
                      flush=True)
        assert np.isfinite(stats["loss"]), stats
        trainer.save(os.path.join(s["save_dir"], "model_last.npz"), epochs)

        val_ds = StereoKitti(cfg, "val")
        detector = Detector(cfg, variables=trainer.eval_variables)
        results, results_raw = {}, {}
        for img_id in val_ds.images:
            info = val_ds.coco.images[img_id]
            lp = os.path.join(val_ds.img_dir, info["file_name"])
            rp = os.path.join(val_ds.img_right_dir, info["file_name"])
            for store, align in ((results, True), (results_raw, False)):
                store[img_id] = detector.run(
                    [lp, rp], image_id=img_id, calib=info["calib"],
                    run_align=align)["results"]
    return {"clean": jtest._save_and_eval(results, results_raw, s["base"],
                                          s["save_dir"], verbose=verbose)}


def decide(jax_lines, port_lines) -> dict:
    """The decision rule of PERF.md ("Acceptance over seeds"): the port
    has a fault if (a) a one-sided Fisher exact test for "the port's share
    of runs meeting every floor is lower" gives p < 0.05, or (b) one floor
    fails in half or more of the port's runs (8 of 16) and in none of the
    JAX package's."""
    from scipy.stats import fisher_exact

    def met(lines):
        return [sum(not ln["floors_failed"] for ln in lines), len(lines)]

    (kj, nj), (kp, n_p) = met(jax_lines), met(port_lines)
    p = float(fisher_exact([[kj, nj - kj], [kp, n_p - kp]],
                           alternative="greater").pvalue)
    misses = {}
    for ln in port_lines:
        for name in ln["floors_failed"]:
            misses[name] = misses.get(name, 0) + 1
    jax_missed = {name for ln in jax_lines for name in ln["floors_failed"]}
    only_port = sorted(name for name, n in misses.items()
                       if 2 * n >= n_p and name not in jax_missed)
    return {"jax": [kj, nj], "port": [kp, n_p], "p": p,
            "floors_only_port": only_port,
            "fault": p < 0.05 or bool(only_port)}


def by_seed(lines) -> dict:
    """For each seed of `lines`, in order: [runs that met every floor,
    runs] (a seed run more than once on the card is several draws)."""
    out = {}
    for ln in lines:
        row = out.setdefault(str(ln["seed"]), [0, 0])
        row[0] += not ln["floors_failed"]
        row[1] += 1
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def read_lines(path, **match) -> list:
    """The run lines of a log (JSON objects, one a line) whose keys equal
    `match`."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    return [ln for ln in lines
            if all(ln.get(k) == v for k, v in match.items())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tests/torch_acceptance_share.py")
    ap.add_argument("--side", default="jax", choices=("jax", "port"))
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--out", default=os.path.join("exp", "share"))
    ap.add_argument("--device", default=None, help="the port's device")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--judge", nargs=2, metavar=("JAX_LOG", "PORT_LOG"),
                    help="apply the decision rule to two logs of run lines "
                         "(the windowed float32 2-scene runs of each)")
    args = ap.parse_args(argv)

    if args.judge:
        jax_log, port_log = args.judge
        sel = dict(mode="windowed", dtype="float32")
        jax_lines = read_lines(jax_log, side="jax", **sel)
        port_lines = read_lines(port_log, **sel)
        print(json.dumps(dict(decide(jax_lines, port_lines),
                              port_by_seed=by_seed(port_lines))), flush=True)
        return 0

    if args.side == "port":
        return rate.main(["--scenes", "2", "--seeds", args.seeds,
                          "--dcn", "windowed", "--dtypes", "float32",
                          "--out", os.path.join(args.out, "port")]
                         + (["--device", args.device] if args.device
                            else []))
    lines = []
    for seed in rate.parse_seeds(args.seeds):
        t0 = time.perf_counter()
        out = run_jax_protocol(os.path.join(args.out, "jax", str(seed)),
                               seed=seed, verbose=args.verbose)
        lines.append(rate.run_line(out, 2, side="jax", mode="windowed",
                                   dtype="float32", seed=seed, rep=0))
        print(json.dumps(acc._jsonable(dict(
            lines[-1], s=round(time.perf_counter() - t0, 1)))), flush=True)
    print("tally:", json.dumps(rate.tally(lines, 2)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
