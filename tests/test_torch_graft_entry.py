"""The port's top-level entry points (side_tpu_torch/graft_entry.py) against
__graft_entry__.py.

- `entry()`: both packages' own `entry()` with `_build` patched to
  128x256 f32, on the JAX example batch (which the port draws the same).
  The JAX init gives every heatmap score within 1e-7 of 0.1007, so the
  decode order of either package would be a tie-break: the weights carried
  over by `weights.from_flax` are the Detector test's random draw
  (torch_parity.stereo_variables, seed 1) with its heatmap head spread
  (kernel x 50, bias -4; tests/test_torch_detector.py).  dets, dets_r and
  info to atol 1e-3 / rtol 1e-4, the Detector test's tolerance.  The
  decode order follows the scores, so the test fails loudly unless the
  scores at rank cv_topk lie more than 1e-3 apart (the Detector test's
  guard) and adjacent scores in the top K more than 1e-5 apart (every row
  is compared in order here; the packages' scores differ by 3.4e-6 at
  most at this draw).
- `dryrun_multichip(2, device="cpu")` over 2 gloo ranks: passes and prints
  the JAX line.
- The dry run's one-rank step (`dryrun_model`, `dryrun_step`) against the
  JAX 1-device Trainer built as __graft_entry__.py:110-117 builds it
  (make_mesh(1)), from the port's init carried over by `weights.to_flax`
  on `dryrun_batch(2)`: the step-1 loss (the Trainer's training-mode
  `_loss_fn`, which its step differentiates; the whole step takes ~4 min
  to trace here) to 1e-3 relative, train mode's bound in
  tests/test_torch_train.py.  The offset/mask convs start at zero in both
  packages (asserted), so every offset is 0 and the JAX side's exact DCN
  (traced in 9 s, windowed in 26 s) is the port's windowed function.
- Without a CUDA device `entry()` raises.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.ops.deform_conv import dcn_mode
from side_tpu_torch import graft_entry, weights

from torch_parity import stereo_variables

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(input_h=128, input_w=256)
SEED = 1
MARGIN = 1e-3           # at rank cv_topk
ORDER_MARGIN = 1e-5     # between adjacent rows


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_flax(model, params, batch_stats, capsys):
    capsys.readouterr()
    weights.merge_state(model, weights.from_flax(params, batch_stats))
    out = capsys.readouterr().out
    assert "Skip" not in out and "No param" not in out and "Drop" not in out


def test_entry_matches_jax(monkeypatch, capsys):
    jge = _jax_graft_entry()
    jbuild, tbuild = jge._build, graft_entry._build
    built = {}

    def jax_build(kw, dtype):
        cfg, built["model"], init = jbuild(dict(kw, **SMALL), jnp.float32)
        return cfg, built["model"], init
    monkeypatch.setattr(jge, "_build", jax_build)
    monkeypatch.setattr(graft_entry, "_build", lambda kw, dtype, device:
                        tbuild(dict(kw, **SMALL), torch.float32, device))
    jfn, (_, jbatch) = jge.entry()
    variables = stereo_variables(built["model"], SEED, *SMALL.values())
    hm = variables["params"]["hm"]["Conv_1"]           # spread the scores
    hm["kernel"] = hm["kernel"] * 50.0
    hm["bias"] = np.full_like(hm["bias"], -4.0)
    with dcn_mode("windowed"):
        want = [np.asarray(a) for a in jax.jit(jfn)(variables, jbatch)]

    fn, (model, batch) = graft_entry.entry(device="cpu")
    assert not model.training
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), k)
    _load_flax(model, variables["params"], variables["batch_stats"], capsys)
    got = [a.numpy() for a in fn(model, batch)]

    scores = want[0][0, :, 4]
    kcv = model.cv_topk
    margins = {"adjacent": float(-np.diff(scores).max()),
               "cv_topk": float(scores[kcv - 1] - scores[kcv])}
    assert margins["adjacent"] > ORDER_MARGIN and \
        margins["cv_topk"] > MARGIN, (
            f"seed {SEED}: decode order ambiguous ({margins}); pick another "
            "seed")
    assert [a.shape for a in got] == [a.shape for a in want] == [
        (1, 100, 6), (1, 100, 6), (1, 100, 10)]
    for name, g, w in zip(("dets", "dets_r", "info"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4, err_msg=name)


def test_dryrun_multichip_two_cpu_ranks(capsys):
    out = graft_entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"dryrun_multichip(2): loss={out['loss']:.4f} "
                    f"(1-dev {out['loss_one']:.4f}, rel diff "
                    f"{out['rel']:.2e}) OK")
    assert np.isfinite(out["loss"]) and out["rel"] < 1e-4
    assert [r["backend"] for r in out["ranks"]] == ["gloo", "gloo"]


def test_dryrun_one_rank_step_matches_jax():
    from side_tpu.config import Config as JConfig
    from side_tpu.models.stereo_net import StereoNet as JStereoNet
    from side_tpu.parallel.mesh import make_mesh, shard_batch
    from side_tpu.runtime.trainer import BATCH_KEYS, Trainer as JTrainer
    (H, W), K, n = graft_entry.DRYRUN_HW, graft_entry.DRYRUN_K, 2
    model = graft_entry.dryrun_model(n, "cpu")
    offset_convs = [p for k, p in model.state_dict().items()
                    if "offset_mask" in k]
    assert len(offset_convs) == 32 and not any(p.any() for p in offset_convs)
    params, stats = weights.to_flax(model.state_dict())
    cfg1 = JConfig(input_h=H, input_w=W, compute_dtype="float32", max_objs=K,
                   batch_size=n, uncert=True, num_devices=1)
    jm = JStereoNet(heads=dict(cfg1.heads), roi_size=4, max_objs=K, topk=4,
                    down_ratio=4, input_w=W, dtype=jnp.float32)
    trainer1 = JTrainer(cfg1, jm, {"params": params, "batch_stats": stats},
                        steps_per_epoch=1, mesh=make_mesh(1))
    batch = graft_entry.dryrun_batch(n)
    batch = shard_batch({k: batch[k] for k in BATCH_KEYS if k in batch},
                        trainer1.mesh)
    with dcn_mode("exact"):      # = windowed here: every offset is 0
        _, (jstats, _) = jax.jit(lambda p, bs, b: trainer1._loss_fn(
            p, bs, b, True, step=jnp.zeros((), jnp.int32)))(
                trainer1.state.params, trainer1.state.batch_stats, batch)
    want = float(jstats["loss"])
    got = graft_entry.dryrun_step(graft_entry.dryrun_config(n, 1), model,
                                  graft_entry.dryrun_batch(n), "cpu")
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
