"""The port's model zoo against side_tpu's: the factory's routing, the
resdcn family's forward (its training step is
tests/test_torch_resdcn_train.py), dlaseg_34, the monocular legacy nets,
and checkpoints that cross between the packages.

64x128 input (resdcn_18's 1/32 map is 2x4), f32, DCN windowed R = 1 on
both sides, weights and inputs from numpy seeds.

Tolerances:
- parameter trees: the same paths and shapes, exactly;
- eval forwards: every head map 1e-4 of its largest value (sum order);
- resdcn_18's training step (--not_cost_volume; offsets inside the window
  and away from integer kinks, as in tests/test_torch_train.py): with
  running statistics, against the JAX network built in float64, loss
  parts 1e-5 relative and every gradient 1e-4 of its tensor's largest
  value; with
  batch statistics loss parts 1e-3
  relative, updated running statistics 1e-4 of their largest value,
  gradients 0.3 of their tensor's largest value and 3e-2 in the median
  (batch statistics over few samples amplify f32 sum-order noise);
- checkpoints: every array equal;
- `lecun_init_` against flax's `lecun_normal`, 100,000 draws each: the
  same std within 1 %, and no |w| beyond 2.28 target stds (the draw is
  truncated at 2 / 0.8796 = 2.274).
"""

import unittest.mock as um

import numpy as np
import pytest
import torch

import jax

import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models.stereo_net import init_stereo_net
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.parallel.mesh import make_mesh
from side_tpu.runtime import checkpoint as jckpt
from side_tpu.runtime.trainer import Trainer as JTrainer
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.models.resnet_dcn import deform_shapes
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.detector import Detector
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import random_variables, rel_err, to_jax

H, W = 64, 128
BASE = dict(input_h=H, input_w=W, compute_dtype="float32")
# arch -> the Config fields that select it (head_conv as Config.cli sets
# it: 256 for dla*, 64 otherwise)
ARCHS = {
    "dla_34": dict(arch="dla_34"),
    "dla_34 voxel": dict(arch="dla_34", depth_variant="voxel"),
    "resdcn_18": dict(arch="resdcn_18", head_conv=64),
    "resdcn_34": dict(arch="resdcn_34", head_conv=64),
    "resdcn_50": dict(arch="resdcn_50", head_conv=64),
    "resdcn_101": dict(arch="resdcn_101", head_conv=64),
    "resdcn_152": dict(arch="resdcn_152", head_conv=64),
    "dlaseg_34": dict(arch="dlaseg_34"),
    "res_18": dict(arch="res_18", head_conv=64),
    "res_50": dict(arch="res_50", head_conv=64),
    "dlav0_34": dict(arch="dlav0_34"),
}
MONO = ("res_18", "res_50", "dlav0_34")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_shapes(name):
    jm = jcreate(JConfig(**BASE, **ARCHS[name]))
    if name in MONO:
        return jm, jax.eval_shape(lambda k: jm.init(k, jnp.zeros(
            (1, H, W, 3))), jax.random.PRNGKey(0))
    return jm, jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, 4),
                              jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(ARCHS))
def test_factory_builds_the_jax_family_with_its_parameter_tree(name):
    """Every arch the JAX factory builds: the port's model is the class of
    the same name and its state_dict, in the JAX layout, has exactly the
    JAX model's parameter and batch-statistic paths and shapes."""
    jm, shapes = _jax_shapes(name)
    port = create_model(Config(**BASE, **ARCHS[name]))
    assert type(port).__name__ == type(jm).__name__
    params, stats = weights.to_flax(port.state_dict())
    assert {k: v.shape for k, v in weights._flatten(params).items()} == \
        _shape_map(shapes["params"])
    assert {k: v.shape for k, v in weights._flatten(stats).items()} == \
        _shape_map(shapes.get("batch_stats", {}))


def _shape_map(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_factory_raises_value_error_on_an_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        create_model(Config(**BASE, arch="hourglass_104"))
    with pytest.raises(ValueError):
        jcreate(JConfig(**BASE, arch="hourglass_104"))


@pytest.mark.parametrize("name,cost_volume,match", [
    ("resdcn_18", True, "no depth output"),
    ("dlaseg_34", True, "no depth output"),
    ("res_18", False, "single-image"),
    ("dlav0_34", False, "single-image")])
def test_stereo_runtime_refuses_what_jax_cannot_run(name, cost_volume,
                                                    match):
    """resdcn / dlaseg with the depth path on have no `depth` to decode or
    train (a KeyError in the JAX package); the monocular nets take an
    image, not the stereo batch.  Trainer and Detector say so."""
    cfg = Config(**BASE, **ARCHS[name], cost_volume=cost_volume)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, create_model(cfg), steps_per_epoch=1, device="cpu")
    with pytest.raises(ValueError, match=match):
        Detector(cfg, device="cpu")


def _load(model, variables):
    model.load_state_dict(weights.from_flax(variables["params"],
                                            variables.get("batch_stats", {})))
    return model


def _compare(got, want):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        assert tuple(got[name].shape) == w.shape, name
        assert rel_err(got[name].detach().numpy(), w) <= 1e-4, name


@pytest.mark.parametrize("name", ["resdcn_18", "dlaseg_34"])
def test_stereo_family_eval_forward_matches_jax(name):
    jm, shapes = _jax_shapes(name)
    variables = random_variables(shapes, 3)
    rng = np.random.RandomState(4)
    batch = {"input": rng.randn(2, H, W, 3).astype(np.float32),
             "input_right": rng.randn(2, H, W, 3).astype(np.float32)}
    with dcn_mode("windowed"):
        want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            to_jax(variables), to_jax(batch))
    port = _load(create_model(Config(**BASE, **ARCHS[name])), variables)
    with torch.no_grad(), tdc.dcn_mode("windowed", 1):
        got = port.eval()({k: _t(v) for k, v in batch.items()},
                          use_cost_volume=False)
    assert "depth" not in got
    _compare(got, want)


@pytest.mark.parametrize("name", MONO)
def test_monocular_forward_matches_jax(name):
    jm, shapes = _jax_shapes(name)
    variables = random_variables(shapes, 5)
    x = np.random.RandomState(6).randn(2, H, W, 3).astype(np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a))(to_jax(variables),
                                                jnp.asarray(x))
    port = _load(create_model(Config(**BASE, **ARCHS[name])), variables)
    with torch.no_grad():
        got = port.eval()(_t(x))
    assert got["hm"].shape == (2, H // 4, W // 4, 3)
    _compare(got, want)


# ----------------------------------------------------------- checkpoints
CKPT = {"resdcn_18": dict(BASE, arch="resdcn_18", head_conv=64,
                          cost_volume=False, max_objs=3, K=3),
        "dla_34 voxel": dict(BASE, depth_variant="voxel", max_objs=3, K=3)}


@pytest.mark.parametrize("name", list(CKPT))
def test_checkpoint_crosses_to_jax_and_back(name, tmp_path, capsys):
    """A port Trainer.save checkpoint loads in the JAX package with no
    skipped or missing parameter and resumes its Adam state there; the JAX
    Trainer's save of it resumes in the port with every array equal."""
    kw = CKPT[name]
    jm = jcreate(JConfig(**kw))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, 3),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, 9)
    tr = Trainer(Config(**kw), _load(create_model(Config(**kw)), variables),
                 steps_per_epoch=3, device="cpu")
    rng = np.random.RandomState(2)
    for table in (tr.optimizer.mu, tr.optimizer.nu):
        for t in table.values():
            t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
    tr.optimizer.count, tr.optimizer.sched_count = 7, 5
    port_path = str(tmp_path / "port.npz")
    tr.save(port_path, epoch=4)

    loaded = jckpt.load_checkpoint(port_path)
    capsys.readouterr()
    merged = jckpt.merge_restore(variables["params"], loaded["params"])
    merged_bs = jckpt.merge_restore(variables["batch_stats"],
                                    loaded["batch_stats"])
    out = capsys.readouterr().out
    assert "Skip" not in out and "No param" not in out and "Drop" not in out
    for a, b in zip(jax.tree.leaves(merged) + jax.tree.leaves(merged_bs),
                    jax.tree.leaves(variables["params"]) +
                    jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jt = JTrainer(JConfig(**kw), jm, to_jax(variables), steps_per_epoch=3,
                  mesh=make_mesh(1))
    assert jt.load(port_path, resume=True) == 4
    adam, sched = jt.state.opt_state
    assert (int(adam.count), int(sched.count)) == (7, 5)
    jax_path = str(tmp_path / "jax.npz")
    jt.save(jax_path, epoch=5)

    back = Trainer(Config(**kw), create_model(Config(**kw), seed=3),
                   steps_per_epoch=3, device="cpu")
    log = []
    with um.patch("builtins.print", lambda *a, **k: log.append(a)):
        assert back.load(jax_path, resume=True) == 5
    assert not [m for m in log if "Skip" in str(m) or "No param" in str(m)]
    want_sd = tr.model.state_dict()
    for key, v in back.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_sd[key].numpy(), key)
    assert (back.optimizer.count, back.optimizer.sched_count) == (7, 5)
    for table in ("mu", "nu"):
        for key, v in getattr(back.optimizer, table).items():
            np.testing.assert_array_equal(
                v.numpy(), getattr(tr.optimizer, table)[key].numpy(), key)


# ------------------------------------------- launch plans at resdcn shapes
RES_SHAPES = [(shape, batch) for shape in deform_shapes(18)
              for batch in (2, 8)]


@pytest.mark.parametrize("shape,batch", RES_SHAPES, ids=[
    "x".join(map(str, s)) + f"_B{b}" for s, b in RES_SHAPES])
def test_resdcn_shapes_take_the_tensor_core_plans(shape, batch):
    """resdcn_18's DeformBlocks at 384x1280 (Cin 512 -> 256 at 12x40, 256
    -> 128 at 24x80, 128 -> 64 at 48x160) take the tensor-core route in
    bf16.  At 12x40 the forward's pixel tiles (18 at B = 2) leave SMs idle,
    so it splits the reduction; K2 takes the tile body at Cout 256 and 128
    and the patch body at Cout 64; every plan fits one block's shared
    memory."""
    from side_tpu_torch.ops.dcn_cuda import (SM_COUNT, SMEM_PER_BLOCK,
                                             dcn_route, dcoord_plan,
                                             dx_plan, fwd_plan)
    cin, h, w, cout = shape
    assert dcn_route(torch.bfloat16, cin, cout) == "tensor"
    assert dcn_route(torch.float32, cin, cout) == "cuda_core"
    fp = fwd_plan(batch, h, w, cin, cout)
    if (h, batch) == (12, 2):
        assert fp["tiles"] == 18 and fp["splits"] > 1
    if fp["tiles"] < SM_COUNT:
        assert fp["blocks"] >= min(SM_COUNT, fp["tiles"] * 9 * cin // 64)
    dp = dx_plan(batch, h, w, cin, cout, 1)
    assert dp["scatter"] == ("patch" if cout == 64 else "tile")
    cp = dcoord_plan(batch * h * w, cin, cout)
    for plan in (fp, dp, cp):
        assert 0 < plan["smem_bytes"] <= SMEM_PER_BLOCK
        assert plan["blocks"] > 0


def test_lecun_init_draws_flax_lecun_normal():
    """`lecun_init_` (ConvTranspose3d of HourglassVolume, the voxel net's
    strAM_2D, every Dense) draws flax's `lecun_normal`: a normal truncated
    at +-2 standard units with its variance corrected to 1/fan_in."""
    import flax.linen as fnn
    from side_tpu_torch.models.dla import lecun_init_
    fan_in, fan_out = 1000, 100
    sigma = fan_in ** -0.5
    flax_w = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, fan_out), jnp.float32))
    port_w = torch.empty(fan_out, fan_in)
    lecun_init_(port_w, torch.Generator().manual_seed(0))
    port_w = port_w.numpy()
    assert flax_w.size == port_w.size == 100_000
    assert abs(port_w.std() / flax_w.std() - 1) < 1e-2
    assert abs(port_w.std() / sigma - 1) < 1e-2
    for w in (flax_w, port_w):
        assert np.abs(w).max() / sigma <= 2.28
