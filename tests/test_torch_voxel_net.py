"""The port's voxel + PointNet depth variant against side_tpu's.

64x128 stereo input, K = 3 object slots, f32, DCN windowed R = 1 on both
sides, weights and inputs from numpy seeds (the geometry of
tests/test_voxel_net.py: f = 200 px, baseline 0.5 m, feature stride 4).
One training step of the whole network is tests/test_torch_voxel_train.py.

Tolerances, each stated at its assertion:
- voxel geometry (disparity depth, voxel coordinates): 1e-5 relative (f32
  projections), the in-map flags equal;
- the bilinear sampling and its gradient: 1e-6 of the largest value (f32
  sums of four terms in another order);
- PointNetDepth, eval and train mode (the JAX run's dropout mask
  substituted): output, running statistics and every gradient 1e-4 of
  their largest value (1000-point sums and max-pool in f32); the biases
  that feed a batch-statistics BatchNorm have a gradient of 0 up to float
  residue in both packages (below 1e-5 of the largest gradient);
- the whole network, eval mode on decoded boxes: head maps and depths 1e-4
  of their largest value.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models import voxel_net as jvn
from side_tpu.models.stereo_net import init_stereo_net
from side_tpu.ops import decode as jdec
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models import voxel_net as tvn
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops import gather_cuda as tg
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import (VOXEL_H as H, VOXEL_K as K, VOXEL_W as W,
                          dropout_interceptor, gradient_errors,
                          random_variables, rel_err, to_jax, voxel_boxes,
                          voxel_geometry, voxel_train_batch,
                          window_interior_offsets)

B = 2
V = tvn.VOXEL_RES ** 3
KW = dict(input_h=H, input_w=W, compute_dtype="float32", K=K, max_objs=K,
          depth_variant="voxel", lr=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _geom_args(g, bbox, bbox_r, lib):
    conv = jnp.asarray if lib == "jax" else _t
    return [conv(a) for a in (bbox, bbox_r, g["fb"], g["p2"], g["p3"],
                              g["trans"], g["trans_inv"])]


def test_disparity_depth_and_voxel_coords_match_jax():
    g = voxel_geometry(B)
    bbox, bbox_r = voxel_boxes(np.random.RandomState(0), B)
    want = jvn.voxel_coords(*_geom_args(g, bbox, bbox_r, "jax"), W // 4,
                            H // 4)
    got = tvn.voxel_coords(*_geom_args(g, bbox, bbox_r, "torch"), W // 4,
                           H // 4)
    for name, w, t in zip(("cl", "cr", "vl", "vr", "depth_ori"), want, got):
        w, t = np.asarray(w), t.numpy()
        assert t.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(t, w, err_msg=name)
        else:
            assert rel_err(t, w) <= 1e-5, name      # f32 projections
    vl = np.asarray(want[2])
    assert 0.2 < vl.mean() < 1.0                    # many voxels in the map
    d = jvn.disparity_depth(*_geom_args(g, bbox, bbox_r, "jax")[:2],
                            jnp.asarray(g["fb"]), jnp.asarray(g["trans_inv"]))
    dt = tvn.disparity_depth(_t(bbox), _t(bbox_r), _t(g["fb"]),
                             _t(g["trans_inv"]))
    assert rel_err(dt.numpy(), d) <= 1e-6


def _sampling_case(seed):
    """A 64-channel map and JAX's voxel coordinates of random boxes, with
    some coordinates pushed off the map."""
    rng = np.random.RandomState(seed)
    g = voxel_geometry(B)
    bbox, bbox_r = voxel_boxes(rng, B)
    cl, _, vl, _, _ = jvn.voxel_coords(*_geom_args(g, bbox, bbox_r, "jax"),
                                       W // 4, H // 4)
    feat = rng.randn(B, H // 4, W // 4, 64).astype(np.float32)
    return feat, np.asarray(cl), np.asarray(vl)


def test_grid_sample_feats_matches_jax_through_the_plain_gather(monkeypatch):
    """On CPU tensors grid_sample_feats hands the clipped corners to
    gather_bilinear_plain (once, f32 out); the result equals JAX's
    four-corner gather to 1e-6 of its largest value."""
    feat, coords, valid = _sampling_case(1)
    calls = []

    def spy(x, y0, x0, fy, fx, out_dtype=None):
        calls.append((y0.clone(), x0.clone(), out_dtype))
        return tg.gather_bilinear_plain(x, y0, x0, fy, fx, out_dtype)

    monkeypatch.setattr(tvn, "gather_bilinear_plain", spy)
    got = tvn.grid_sample_feats(_t(feat), _t(coords), _t(valid)).numpy()
    want = np.asarray(jvn.grid_sample_feats(
        jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(valid)))
    assert got.shape == want.shape == (B, K, V, 64)
    assert rel_err(got, want) <= 1e-6
    assert len(calls) == 1
    y0, x0, out_dtype = calls[0]
    assert out_dtype == torch.float32 and y0.dtype == torch.int32
    u = np.clip(np.where(valid, coords[..., 0], 0.0), 0, W // 4 - 1)
    np.testing.assert_array_equal(x0.numpy(), np.floor(u).astype(np.int32))


def test_gather_backward_matches_jax_and_autograd():
    """GatherBilinearFunction's gradient with respect to the map (the
    scatter-add the card runs after K5) against autograd of the plain
    gather and against jax.grad of side_tpu's grid_sample_feats: 1e-6 of
    the largest value."""
    feat, coords, valid = _sampling_case(2)
    rng = np.random.RandomState(3)
    cot = rng.randn(B, K, V, 64).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jvn.grid_sample_feats(
        f, jnp.asarray(coords), jnp.asarray(valid)) * cot))(
            jnp.asarray(feat))
    x = _t(feat).requires_grad_(True)
    (tvn.grid_sample_feats(x, _t(coords), _t(valid)) * _t(cot)).sum() \
        .backward()
    assert rel_err(x.grad.numpy(), want) <= 1e-6
    # the custom Function (what the card takes) against plain autograd
    u = np.clip(np.where(valid, coords[..., 0], 0.0), 0, W // 4 - 1)
    v = np.clip(np.where(valid, coords[..., 1], 0.0), 0, H // 4 - 1)
    y0 = _t(np.floor(v).astype(np.int32)).reshape(-1)
    x0 = _t(np.floor(u).astype(np.int32)).reshape(-1)
    fy = _t((v - np.floor(v)).astype(np.float32)).reshape(-1)
    fx = _t((u - np.floor(u)).astype(np.float32)).reshape(-1)
    g = _t(cot).reshape(-1, 64)
    xf = _t(feat).requires_grad_(True)
    (tg.GatherBilinearFunction.apply(xf, y0, x0, fy, fx) * g).sum() \
        .backward()
    xp = _t(feat).requires_grad_(True)
    (tg.gather_bilinear_plain(xp, y0, x0, fy, fx) * g).sum().backward()
    assert rel_err(xf.grad.numpy(), xp.grad.numpy()) <= 1e-6


# ------------------------------------------------------------ PointNetDepth
def _pointnet_case(seed, n=4):
    """Random PointNetDepth weights and n objects' point features, each
    object at its own scale: after the max-pool the BatchNorms take
    statistics over the n objects alone, and objects of one scale would
    make them ill-conditioned (mean >> spread, E[x^2] - mean^2 cancels)."""
    pn = jvn.PointNetDepth(dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, V, 192) * np.linspace(0.3, 3.0, n)[:, None, None]
         ).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: pn.init({"params": k, "dropout": k}, jnp.asarray(x),
                          train=False), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed + 1)
    port = tvn.PointNetDepth(torch.float32)
    port.load_state_dict(weights.from_flax(variables["params"],
                                           variables["batch_stats"]))
    return pn, variables, x, port


def test_pointnet_eval_matches_jax():
    pn, variables, x, port = _pointnet_case(4, n=3)
    want = np.asarray(pn.apply(to_jax(variables), jnp.asarray(x),
                               train=False))
    with torch.no_grad():
        got = port.eval()(_t(x)).numpy()
    assert got.shape == want.shape == (3,)
    assert rel_err(got, want) <= 1e-4


# biases of PointNetDepth that feed a batch-statistics BatchNorm
DEAD_BIASES = ("conv1.bias", "conv2.bias", "conv3.bias", "conv4.bias",
               "fc1.bias")


def test_pointnet_train_mode_matches_jax_with_its_dropout_mask(monkeypatch):
    pn, variables, x, port = _pointnet_case(5)
    cot = np.random.RandomState(6).randn(4).astype(np.float32)
    masks = []

    def loss(params, xin):
        out, mut = pn.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xin, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    with nn.intercept_methods(dropout_interceptor(masks)):
        (_, (want, new_bs)), (g_params, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                to_jax(variables["params"]), jnp.asarray(x))
        jax.effects_barrier()
    assert len(masks) == 1 and masks[0].shape == (4, 256)
    assert 0.5 < masks[0].mean() < 0.9              # keep probability 0.7

    monkeypatch.setattr(tvn, "dropout_keep_mask",
                        lambda shape, rate, gen, dev: _t(masks[0]))
    xt = _t(x).requires_grad_(True)
    port.train()
    got = port(xt)
    (got * _t(cot)).sum().backward()
    assert rel_err(got.detach().numpy(), want) <= 1e-4
    assert rel_err(xt.grad.numpy(), g_x) <= 1e-4
    errs = gradient_errors(port, jax.tree.map(np.asarray, g_params),
                           DEAD_BIASES)
    assert len(errs) == 28 - len(DEAD_BIASES)
    assert max(errs.values()) <= 1e-4, errs
    stats = weights._flatten(jax.tree.map(np.asarray, new_bs))
    for key, buf in port.named_buffers():
        module, _, leaf = key.rpartition(".")
        ref = stats.pop(f"{module}/{leaf[len('running_'):]}")
        assert rel_err(buf.numpy(), ref) <= 1e-4, key
    assert not stats


# ------------------------------------------------------------ whole network
def test_voxel_net_eval_matches_jax():
    """Eval forward on decoded boxes (the serving path), the heatmap's
    scores spread so that the decode order lies well apart from float
    noise."""
    jm = jcreate(JConfig(**KW))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, K),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, 8)
    window_interior_offsets(variables["params"], np.random.RandomState(108))
    hm = variables["params"]["hm"]["Conv_1"]
    hm["kernel"] = hm["kernel"] * 50.0
    hm["bias"] = np.full_like(hm["bias"], -9.0)
    rng = np.random.RandomState(9)
    batch = {"input": rng.randn(B, H, W, 3).astype(np.float32),
             "input_right": rng.randn(B, H, W, 3).astype(np.float32),
             **voxel_geometry(B)}
    with dcn_mode("windowed"):
        want = jax.jit(lambda v, b: jm.apply(v, b, use_cost_volume=True,
                                             train=False))(
            to_jax(variables), to_jax(batch))
    scores = jdec.topk(jdec.nms_peaks(jax.nn.sigmoid(want["hm"])), K=K + 1)[0]
    assert (-np.diff(np.asarray(scores), axis=1)).min() > 1e-3
    port = create_model(Config(**KW))
    port.load_state_dict(weights.from_flax(variables["params"],
                                           variables["batch_stats"]))
    with torch.no_grad(), tdc.dcn_mode("windowed", 1):
        got = port.eval()({k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape, name
        assert rel_err(got[name].numpy(), w) <= 1e-4, name


def test_voxel_trainer_step_runs_and_moves_weights():
    """Trainer.train_step end to end (dropout from the step's generator,
    Adam): finite loss parts with the depth part, the PointNet moves."""
    tr = Trainer(Config(**KW), create_model(Config(**KW), seed=1),
                 steps_per_epoch=2, device="cpu")
    before = tr.model.pointNet.conv1.weight.detach().clone()
    stats = tr.train_step(tr.to_device(voxel_train_batch(12, B)))
    assert set(stats) == set(tr.loss_states)
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert not torch.equal(before, tr.model.pointNet.conv1.weight)
    assert tr.step == 1
