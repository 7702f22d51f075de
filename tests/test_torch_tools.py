"""The port's data and weight tools against the JAX package's on the CPU:
vis_dataset (PNGs byte-equal, the stereo-flip path included),
convert_kitti_to_coco (JSON equal), calc_anchor_overlap (statistics and
printed lines equal), loader_bench (its line), and the two weight
converters (the same flat trees from one synthetic torch state_dict; the
port's `.npz` loads into the port's model with every mapped key, and the
DLA-34 trunk on it equals the JAX trunk on the JAX-converted tree to 1e-4).
"""

import importlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from side_tpu.data.dataset import StereoKitti as JStereoKitti
from side_tpu.models import create_model as jcreate
from side_tpu.models.dla import DLA as JDLA
from side_tpu.runtime.checkpoint import _flatten
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.data.dataset import StereoKitti
from side_tpu_torch.data.synthetic import build_fixture
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.tools import (calc_anchor_overlap, convert_dla34_weights,
                                  convert_kitti_to_coco,
                                  convert_reference_weights, loader_bench,
                                  vis_dataset)

from torch_parity import stereo_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """tools/<name>.py of the JAX package, imported as a module."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return build_fixture(str(tmp_path_factory.mktemp("fx")), n_train=3,
                         n_val=2, seed=4)


# ----------------------------------------------------------- vis_dataset
@pytest.mark.parametrize("split", ["val", "train_flipped"])
def test_vis_dataset_pngs_equal_the_jax_tools(split, fixture_root, tmp_path,
                                              monkeypatch, capsys):
    """Both tools on the same fixture: the val split, as the tools read it,
    and the training split with --flip_train (its second half runs the
    stereo-flip path)."""
    jvis = _jax_tool("vis_dataset")
    args = ["stereo", "--data_dir", fixture_root, "--no_color_aug"]
    if split == "train_flipped":
        args.append("--flip_train")
        monkeypatch.setattr(jvis, "StereoKitti",
                            lambda cfg, _: JStereoKitti(cfg, "train"))
        monkeypatch.setattr(vis_dataset, "StereoKitti",
                            lambda cfg, _: StereoKitti(cfg, "train"))
    monkeypatch.setenv("VIS_N", "6")
    monkeypatch.setattr(sys, "argv", ["vis_dataset.py", *args, "--exp_dir",
                                      str(tmp_path / "jax")])
    jvis.main()
    jax_lines = capsys.readouterr().out.splitlines()
    assert vis_dataset.main([*args, "--exp_dir", str(tmp_path / "port")]) \
        == 0
    port_lines = capsys.readouterr().out.splitlines()
    jdir = tmp_path / "jax" / "stereo" / "default" / "debug"
    pdir = tmp_path / "port" / "stereo" / "default" / "debug"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    assert len(names) == (2 if split == "val" else 6)
    for name in names:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert [ln.replace(str(pdir), "") for ln in port_lines] == \
        [ln.replace(str(jdir), "") for ln in jax_lines]
    if split == "train_flipped":
        assert any("flipped=True" in ln for ln in port_lines)


# ------------------------------------------------- convert_kitti_to_coco
def test_convert_kitti_to_coco_equals_the_jax_tools(fixture_root, tmp_path,
                                                    monkeypatch, capsys):
    jtool = _jax_tool("convert_kitti_to_coco")
    trees = {}
    for who in ("jax", "port"):
        kitti = tmp_path / who / "kitti"
        shutil.copytree(os.path.join(fixture_root, "kitti"), kitti)
        shutil.rmtree(kitti / "annotations_3d")
        # a second split from the same scenes: the tool converts each named
        shutil.copytree(kitti / "ImageSets_3dop", kitti / "ImageSets_subcnn")
        trees[who] = kitti
    monkeypatch.setattr(sys, "argv", ["convert_kitti_to_coco.py",
                                      "--data_dir", str(trees["jax"])])
    jtool.main()
    jax_out = capsys.readouterr().out
    assert convert_kitti_to_coco.main(["--data_dir", str(trees["port"])]) \
        == 0
    assert capsys.readouterr().out.replace(str(trees["port"]), "") == \
        jax_out.replace(str(trees["jax"]), "")
    names = sorted(os.listdir(trees["jax"] / "annotations_3d"))
    assert names == ["kitti_3dop_train.json", "kitti_3dop_val.json",
                     "kitti_subcnn_train.json", "kitti_subcnn_val.json"]
    for name in names:
        want = json.loads((trees["jax"] / "annotations_3d" / name)
                          .read_text())
        got = json.loads((trees["port"] / "annotations_3d" / name)
                         .read_text())
        assert got == want, name
        assert want["annotations"], name


# --------------------------------------------------- calc_anchor_overlap
def test_calc_anchor_overlap_equals_the_jax_tools(fixture_root, capsys):
    jtool = _jax_tool("calc_anchor_overlap")
    path = os.path.join(fixture_root, "kitti", "annotations_3d",
                        "kitti_3dop_train.json")
    jtool.main(path)
    want = capsys.readouterr().out
    assert calc_anchor_overlap.main([path]) == 0
    assert capsys.readouterr().out == want
    assert "center collisions" in want and "anchor misses" in want
    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.uniform(0, 1000, (20, 2)),
                            rng.uniform(4, 300, (20, 2))], axis=1)
    by_img = {i: [(int(rng.randint(1, 4)), list(b)) for b in boxes[i::3]]
              for i in range(3)}
    for fn, args in (("recall_at", (boxes, 0.5)), ("recall_at", (boxes, 0.7)),
                     ("collision_stats", (by_img,)),
                     ("anchor_misses", (by_img,))):
        assert getattr(calc_anchor_overlap, fn)(*args) == \
            getattr(jtool, fn)(*args), fn


# ---------------------------------------------------------- loader_bench
def test_loader_bench_prints_its_line(capsys):
    assert loader_bench.main(["--scenes", "4", "--batch_size", "2",
                              "--workers", "2", "--epochs", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[loader-bench] building 4-scene fixture at ")
    assert not os.path.exists(out[0].rsplit(" ", 1)[-1])    # removed
    line = out[-1]
    assert line.startswith("[loader-bench] batch=2 workers=2 aug=True: ")
    assert line.endswith("ms/batch, 2 batches)")
    assert float(line.split(": ")[1].split(" pairs/s")[0]) > 0


# ------------------------------------------------------------ converters
def _torch_like(rng, shape):
    return (0.05 * rng.randn(*shape)).astype(np.float32)


def _bn_state(rng, state, prefix, n):
    state[prefix + ".weight"] = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    state[prefix + ".bias"] = (0.1 * rng.randn(n)).astype(np.float32)
    state[prefix + ".running_mean"] = (0.1 * rng.randn(n)).astype(np.float32)
    state[prefix + ".running_var"] = (
        1 + 0.1 * np.abs(rng.randn(n))).astype(np.float32)


def _trunk_state(rng, params, prefix=""):
    """A torch-style DLA-34 state_dict with tools/convert_dla34_weights.py's
    names (tests/test_weight_convert.py:_fake_torch_state), shapes from the
    JAX tree (kernels back to OIHW)."""
    jcw = _jax_tool("convert_dla34_weights")
    state = {}
    for flax_prefix, torch_conv, kind in jcw.tree_mapping():
        k = params[f"{flax_prefix}/Conv_0/kernel"]
        state[prefix + torch_conv + ".weight"] = _torch_like(
            rng, np.transpose(k, (3, 2, 0, 1)).shape)
        _bn_state(rng, state, prefix + jcw._bn_name(torch_conv, kind),
                  k.shape[-1])
    return state


def _full_state(rng, params):
    """A reference stereo_network state_dict holding every key that
    `convert_full` reads, named by its own mapping, shapes from the JAX
    StereoNet tree."""
    state = _trunk_state(
        rng, {k[len("feature_extraction/base/"):]: v for k, v in params.items()
              if k.startswith("feature_extraction/base/")},
        "feature_extraction.base.")
    oihw = lambda k: np.transpose(k, (3, 2, 0, 1)).shape      # noqa: E731
    for key, v in params.items():
        parts = key.split("/")
        if parts[0] != "feature_extraction" or parts[1] == "base":
            continue
        tmod = ".".join(parts[1:-2]) if parts[-2] == "offset_mask" \
            else ".".join(parts[1:-1])
        if parts[-2].startswith("up_"):
            state[f"feature_extraction.{tmod}.weight"] = _torch_like(
                rng, np.transpose(v, (3, 2, 0, 1)).shape)
        elif parts[-1] == "kernel" and parts[-2] != "offset_mask":
            t = f"feature_extraction.{tmod}"
            state[t + ".conv.weight"] = _torch_like(rng, oihw(v))
            state[t + ".conv.bias"] = _torch_like(rng, v.shape[-1:])
            state[t + ".conv.conv_offset_mask.weight"] = _torch_like(
                rng, (27, v.shape[2], 3, 3))
            state[t + ".conv.conv_offset_mask.bias"] = _torch_like(rng, (27,))
            _bn_state(rng, state, t + ".actf.0", v.shape[-1])
    state["feaRuduce.0.weight"] = _torch_like(
        rng, oihw(params["feaReduce/kernel"]))
    _bn_state(rng, state, "feaRuduce.1", params["feaReduce/kernel"].shape[-1])
    for head in ("hm", "wh", "reg", "dim", "orien"):
        state[f"{head}.0.weight"] = _torch_like(
            rng, oihw(params[f"{head}/Conv_0/kernel"]))
        state[f"{head}.2.weight"] = _torch_like(
            rng, oihw(params[f"{head}/Conv_1/kernel"]))
        state[f"{head}.2.bias"] = _torch_like(
            rng, params[f"{head}/Conv_1/bias"].shape)
    for i, t in enumerate((0, 2, 4, 6, 8, 10)):
        state[f"kept_type.{t}.weight"] = _torch_like(
            rng, oihw(params[f"kept_type/Conv_{i}/kernel"]))
        if f"kept_type/Conv_{i}/bias" in params:
            state[f"kept_type.{t}.bias"] = _torch_like(
                rng, params[f"kept_type/Conv_{i}/bias"].shape)
    dhwio = lambda k: np.transpose(k, (4, 3, 0, 1, 2)).shape  # noqa: E731
    for i, t in enumerate(("dres0.0", "dres0.3", "dres1.0", "dres1.3",
                           "dres2.0", "dres2.3", "classify.0")):
        k = params[f"depth_estimator/ConvBN3D_{i}/Conv_0/kernel"]
        state[f"depth_estimator.{t}.weight"] = _torch_like(rng, dhwio(k))
        _bn_state(rng, state, f"depth_estimator.{t[:-1]}{int(t[-1]) + 1}",
                  k.shape[-1])
    state["depth_estimator.classify.3.weight"] = _torch_like(
        rng, dhwio(params["depth_estimator/classify/kernel"]))
    k = params["depth_estimator/strAM_conv/kernel"]
    state["depth_estimator.strAM_2D.0.weight"] = _torch_like(rng, oihw(k))
    state["depth_estimator.strAM_2D.0.bias"] = _torch_like(rng, k.shape[-1:])
    _bn_state(rng, state, "depth_estimator.strAM_2D.1", k.shape[-1])
    return {f"module.{k}": v for k, v in state.items()}


@pytest.fixture(scope="module")
def trunk_tree():
    """{flat path: zeros} of the JAX DLA-34's parameters."""
    shapes = jax.eval_shape(JDLA(dtype=jnp.float32).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 64, 3)))["params"]
    return _flatten(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))


def _same_trees(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dla34_converter_equals_the_jax_converter(trunk_tree):
    jcw = _jax_tool("convert_dla34_weights")
    state = _trunk_state(np.random.RandomState(0), trunk_tree)
    for got, want in zip(convert_dla34_weights.convert(state),
                         jcw.convert(state)):
        _same_trees(got, want)
    assert convert_dla34_weights.tree_mapping() == jcw.tree_mapping()
    for _, conv, kind in jcw.tree_mapping():
        assert convert_dla34_weights._bn_name(conv, kind) == \
            jcw._bn_name(conv, kind)


def _save_pth(state, path, **extra):
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in state.items()}, **extra}, path)
    return str(path)


def _load_messages(model, path):
    msgs = []
    weights.load_npz(model, path, log=msgs.append, keep_dcn_mode=True)
    return msgs


def test_dla34_npz_loads_and_runs_as_the_jax_trunk(trunk_tree, tmp_path):
    """The port converter's `.npz` into the port's flagship: every trunk key
    loaded; its DLA-34 trunk equals the JAX DLA on the JAX-converted tree
    (every level) to 1e-4 of each level's largest value."""
    jcw = _jax_tool("convert_dla34_weights")
    state = _trunk_state(np.random.RandomState(1), trunk_tree)
    out = str(tmp_path / "dla34.npz")
    assert convert_dla34_weights.main([_save_pth(state, tmp_path / "d.pth"),
                                       out]) == 0
    model = create_model(Config(input_h=128, input_w=256,
                                compute_dtype="float32"))
    msgs = _load_messages(model, out)
    base = [k for k in model.state_dict()
            if k.startswith("feature_extraction.base.")
            and "num_batches" not in k]
    assert base and not [m for m in msgs if any(
        f" {k} " in m or m.endswith(f" {k}") for k in base)], msgs[:3]
    jp, js = jcw.convert(state)
    x = np.random.RandomState(2).randn(1, 64, 128, 3).astype(np.float32)
    want = JDLA(dtype=jnp.float32).apply({"params": jp, "batch_stats": js},
                                         jnp.asarray(x))
    with torch.no_grad():
        got = model.eval().feature_extraction.base(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.permute(0, 2, 3, 1).numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


@pytest.fixture(scope="module")
def stereo_tree():
    from side_tpu.config import Config as JConfig
    jm = jcreate(JConfig(input_h=128, input_w=256, compute_dtype="float32"))
    variables = stereo_variables(jm, seed=0)
    return _flatten(variables["params"]), _flatten(variables["batch_stats"])


def test_reference_converter_equals_the_jax_converter(stereo_tree, tmp_path):
    """One synthetic reference state_dict through both `convert_full`s: the
    same trees; their keys are the JAX StereoNet's own.  The port's `.npz`
    loads into the port's flagship with every converted key, tagged exact
    (the reference's DCNv2 is unbounded)."""
    jref = _jax_tool("convert_reference_weights")
    params, stats = stereo_tree
    state = _full_state(np.random.RandomState(3), params)
    got = convert_reference_weights.convert_full(state)
    want = jref.convert_full(state)
    for g, w in zip(got, want):
        _same_trees(g, w)
    converted = _flatten(want[0])
    assert set(converted) <= set(params)
    assert len(converted) > 0.9 * len(params)
    out = str(tmp_path / "ref.npz")
    assert convert_reference_weights.main(
        [_save_pth(state, tmp_path / "r.pth", epoch=7), out]) == 0
    ck = np.load(out)
    assert int(ck["meta::dcn_radius"]) == -1 and int(ck["meta::epoch"]) == 7
    model = create_model(Config(input_h=128, input_w=256,
                                compute_dtype="float32"))
    msgs = _load_messages(model, out)
    mapped = set(weights.from_flax(*got))
    assert mapped <= set(model.state_dict())
    assert not [m for m in msgs if any(
        m.startswith(("No param", "Skip loading")) and f" {k} " in m + " "
        for k in mapped)], msgs[:3]
    sd = model.state_dict()
    ref = weights.from_flax(*got)
    for k in mapped:
        torch.testing.assert_close(sd[k], ref[k].to(sd[k].dtype),
                                   rtol=0, atol=0)
