"""The port's clamp-finetune recipe (side_tpu_torch/tools/finetune_clamp.py)
on the CPU: the DCN mode in force in each phase (A trains exact, B detects
A's exact-tagged checkpoint under the clamp, C finetunes and detects under
the clamp), the two checkpoints' `meta::dcn_radius`, and `_summary` against
tools/finetune_clamp.py's on the same error lists.

The recipe runs at 1 + 1 epochs, 64x128 and roi_size 4 (the cost volume's
3D CNN at the protocol's roi_size 16 takes ~15 s a CPU step): what is held
here is which DCN function each phase runs, read from every call of the
plain DCN (the CPU route) with its radius and whether autograd records it.
"""

import json
import math
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from side_tpu_torch import weights
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as dc
from side_tpu_torch.runtime import checkpoint
from side_tpu_torch.tools import acceptance_16 as acc
from side_tpu_torch.tools import finetune_clamp as fc

import torch_parity  # noqa: F401  (thread count)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_protocol(monkeypatch):
    """The protocol's config at 64x128 and roi_size 4, and a record of
    every plain DCN call: (phase, radius, training) with the phase set per
    `run_overfit_ap` call."""
    config = acc.protocol_config
    monkeypatch.setattr(acc, "protocol_config",
                        lambda *a, **k: replace(config(*a, **k), roi_size=4,
                                                input_h=64, input_w=128))
    calls, phase = [], [None]
    run = acc.run_overfit_ap

    def run_spy(tmp, **kw):
        phase[0] = os.path.basename(tmp)
        return run(tmp, **kw)
    monkeypatch.setattr(acc, "run_overfit_ap", run_spy)
    plain = dc.deform_conv_plain

    def dcn_spy(x, offset, mask, weight, bias=None, radius=1):
        calls.append((phase[0], radius, torch.is_grad_enabled()))
        return plain(x, offset, mask, weight, bias, radius)
    monkeypatch.setattr(dc, "deform_conv_plain", dcn_spy)
    return calls


def _radii(calls, phase, training):
    return {r for p, r, t in calls if p == phase and t == training}


def test_recipe_modes_and_checkpoint_tags(small_protocol, tmp_path, capsys):
    calls = small_protocol
    cap = {}
    with dc.dcn_mode("windowed", 1):
        out = fc.run_recipe(str(tmp_path), epochs=1, epochs_ft=1,
                            device="cpu", _capture=cap)
        assert dc.dcn_radius_tag() == 1
    assert list(out) == ["exact", "naive", "finetuned"]
    # A trains and detects exact; B and C detect, and C trains, at R = 1
    assert _radii(calls, "exact", True) == {-1}
    assert _radii(calls, "exact", False) == {-1}
    assert _radii(calls, "naive", True) == set()
    assert _radii(calls, "naive", False) == {1}
    assert _radii(calls, "finetuned", True) == {1}
    assert _radii(calls, "finetuned", False) == {1}
    # 16 DeformBlocks a forward
    assert sum(1 for p, _, t in calls if p == "naive") % 16 == 0
    tags = {k: int(np.load(cap[k]["checkpoint"])["meta::dcn_radius"])
            for k in ("exact", "finetuned")}
    assert tags == {"exact": -1, "finetuned": 1}
    assert cap["naive"]["checkpoint"] == cap["exact"]["checkpoint"]
    assert cap["exact"]["timing"]["steps"] == 1
    assert cap["finetuned"]["timing"]["steps"] == 1
    for summary in out.values():
        assert sorted(summary) == sorted(
            ["n_objects", "detected", "iou_min", "z_med", "z_max", "ry_max"])
        assert summary["n_objects"] == 2
    for v in cap.values():
        loss = v.get("timing", {}).get("final_loss", {})
        assert all(math.isfinite(x) for x in loss.values())
    printed = capsys.readouterr().out
    assert '{"naive": {' in printed and '{"finetuned": {' in printed


def _exact_checkpoint(path):
    cfg = acc.protocol_config("", "")
    params, stats = weights.to_flax(create_model(cfg, seed=0).state_dict())
    with dc.dcn_mode("exact"):
        checkpoint.save_checkpoint(path, 1, params, stats)
    assert int(np.load(path)["meta::dcn_radius"]) == -1
    return path


def test_naive_eval_keeps_the_clamp(small_protocol, tmp_path):
    """B on an exact-tagged checkpoint detects at R = 1.  Without the keep
    rule the Detector switches to the checkpoint's exact mode (shown
    second), so removing it from the recipe fails this test."""
    calls = small_protocol
    ckpt = _exact_checkpoint(str(tmp_path / "exact.npz"))
    with dc.dcn_mode("windowed", 1):
        fc.eval_naive(str(tmp_path), ckpt, device="cpu")
        assert dc.dcn_radius_tag() == 1
    assert calls and {r for _, r, _ in calls} == {1}
    calls.clear()
    with dc.dcn_mode("windowed", 1):
        acc.run_overfit_ap(str(tmp_path / "switching"), ckpt=ckpt,
                           n_scenes=2, batch_size=2, device="cpu",
                           run_align=False)
    assert {r for _, r, _ in calls} == {-1}


def _jax_summary():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import finetune_clamp as jfc
    finally:
        sys.path.pop(0)
    return jfc._summary


@pytest.mark.parametrize("case", ["mixed", "all_missed", "empty", "clean"])
def test_summary_equals_the_jax_tools(case):
    rng = np.random.RandomState(7)
    n = 0 if case == "empty" else 6
    errors = [{"iou": float(rng.uniform(0.3, 0.9)),
               "z": float(rng.uniform(0, 4)), "ry": float(rng.uniform(0, 1)),
               "z_cv": 0.0, "gt_type": "Car", "cls_ok": True}
              for _ in range(n)]
    if case == "mixed":
        errors[2].update(iou=0.0, z=np.inf, ry=np.inf)
    if case == "all_missed":
        for e in errors:
            e.update(iou=0.0, z=np.inf, ry=np.inf)
    assert fc._summary(errors) == _jax_summary()(errors)


def test_cli_writes_summary_json(monkeypatch, tmp_path):
    """main: the flags reach run_recipe and summary.json holds its
    result."""
    seen = {}

    def fake(out_dir, epochs, epochs_ft, device=None, verbose=False):
        seen.update(out_dir=out_dir, epochs=epochs, epochs_ft=epochs_ft,
                    device=device, verbose=verbose)
        return {"naive": {"n_objects": 2}, "finetuned": {"n_objects": 2}}
    monkeypatch.setattr(fc, "run_recipe", fake)
    out = tmp_path / "out"
    assert fc.main(["--epochs", "3", "--epochs_ft", "2", "--out", str(out),
                    "--device", "cpu", "--verbose"]) == 0
    assert seen == {"out_dir": str(out), "epochs": 3, "epochs_ft": 2,
                    "device": "cpu", "verbose": True}
    assert json.loads((out / "summary.json").read_text())["naive"] == {
        "n_objects": 2}
