"""The port's RoIAlign (gather and contraction forms), the gather
cost-volume builder, HourglassVolume and psroi_pool against side_tpu's, on
the CPU, f32.

Same seeded numpy inputs through both packages; values to 1e-5 of the
reference's largest value (max |diff| / max |ref|): only the order of the
sums differs.  Boxes include ones partly off the map on every side (the
-1 / size rule of torchvision's legacy RoIAlign), a zero-size box and, for
psroi_pool, boxes off the image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.models import cost_volume as jcv
from side_tpu.ops.psroi_pool import psroi_pool as jpsroi
from side_tpu.ops.roi_align import roi_align as jroi, roi_align_mm as jroi_mm
from side_tpu_torch import weights
from side_tpu_torch.models import cost_volume as tcv
from side_tpu_torch.ops.psroi_pool import psroi_pool
from side_tpu_torch.ops.roi_align import roi_align, roi_align_mm

from torch_parity import rel_err

TOL = 1e-5


def _rois(seed, n, h, w):
    rng = np.random.RandomState(seed)
    boxes = np.array([[5.0, 3.0, 20.0, 18.0],
                      [0.0, 0.0, w - 1.0, h - 1.0],
                      [10.2, 7.7, 13.9, 12.3],
                      [-3.0, -2.0, 10.0, 8.0],        # off the near edges
                      [w - 5.0, h - 4.0, w + 5.0, h + 6.0],   # far edges
                      [-1.4, 4.0, 6.0, h + 0.6],      # around -1 and h
                      [8.0, 8.0, 8.0, 8.0]],          # zero size
                     np.float32)
    extra = (rng.rand(n - len(boxes), 4) * [w, h, w, h]).astype(np.float32)
    extra[:, 2:] = extra[:, :2] + np.abs(extra[:, 2:] - extra[:, :2])
    return np.concatenate([boxes, extra])


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("form", ["gather", "mm"])
def test_roi_align_matches_jax(form, scale):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 24, 40, 8).astype(np.float32)
    boxes = _rois(1, 20, 24, 40) / scale
    idx = rng.randint(0, 2, len(boxes)).astype(np.int32)
    ours = (roi_align if form == "gather" else roi_align_mm)(
        torch.from_numpy(feat), torch.from_numpy(boxes),
        torch.from_numpy(idx), 7, scale, 2)
    want = (jroi if form == "gather" else jroi_mm)(
        jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(idx), 7, scale, 2)
    assert ours.shape == (20, 7, 7, 8) and ours.dtype == torch.float32
    assert rel_err(ours.numpy(), np.asarray(want)) <= TOL


def test_roi_align_forms_agree():
    rng = np.random.RandomState(3)
    feat = torch.from_numpy(rng.randn(2, 24, 40, 8).astype(np.float32))
    boxes = torch.from_numpy(_rois(4, 32, 24, 40))
    idx = torch.from_numpy(rng.randint(0, 2, 32))
    a = roi_align(feat, boxes, idx, 5, 1.0, 3)
    b = roi_align_mm(feat, boxes, idx, 5, 1.0, 3)
    assert rel_err(a.numpy(), b.numpy()) <= TOL


def _cost_inputs(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    B, K, D, H, W, C = 2, 5, 4, 24, 80, 8
    feat_l = rng.randn(B, H, W, C).astype(dtype)
    feat_r = rng.randn(B, H, W, C).astype(dtype)
    xy = rng.rand(B, K, 2) * [W * 0.8, H * 0.8]
    wh = rng.uniform(2, 12, (B, K, 2))
    bbox = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    bbox[0, 0] = [-2.0, -1.5, 6.0, 9.0]            # partly off the map
    bbox_r = bbox - np.array([3.0, 0, 3.0, 0], np.float32)
    fb = np.array([380.0, 410.0], np.float32)
    return feat_l, feat_r, bbox, bbox_r, fb, D, W


def test_cost_volume_gather_matches_contraction_and_jax():
    feat_l, feat_r, bbox, bbox_r, fb, D, W = _cost_inputs(4)
    t = [torch.from_numpy(a) for a in (bbox, bbox_r, fb)]
    rl, rr, _ = tcv.proposal_shift(*t, D, W)
    fl, fr = torch.from_numpy(feat_l), torch.from_numpy(feat_r)
    gathered = tcv.build_cost_volume_gather(fl, fr, rl, rr, 4)
    assert gathered.shape == (10, D, 4, 4, 24)
    contracted = tcv.build_cost_volume(fl, fr, rl, rr, 4)
    assert rel_err(gathered.numpy(), contracted.numpy()) <= TOL
    jrl, jrr, _ = jcv.proposal_shift(*(jnp.asarray(a)
                                       for a in (bbox, bbox_r, fb)), D, W)
    want = jcv.build_cost_volume_gather(jnp.asarray(feat_l),
                                        jnp.asarray(feat_r), jrl, jrr, 4)
    assert rel_err(gathered.numpy(), np.asarray(want)) <= TOL


def _hourglass_variables(shape, seed):
    """HourglassVolume's parameters and statistics, seeded, in the flax
    tree (kernels N(0, 1/fan_in), BatchNorm scale, bias, mean and var
    spread)."""
    jm = jcv.HourglassVolume(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(shape)),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.6, 1.4, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)
    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dhw", [(4, 8, 8), (3, 7, 4), (8, 3, 7)],
                         ids=["even", "odd_dh", "odd_hw"])
def test_hourglass_matches_jax(dhw, train):
    """Forward through weights.from_flax, with running (eval) or batch
    (train) statistics; the transpose convs' padding and kernel order are
    flax's (SAME, no flip), which a wrong choice breaks at every size."""
    shape = (2,) + dhw + (24,)
    jm, variables = _hourglass_variables(shape, seed=sum(dhw))
    x = np.random.RandomState(9).randn(*shape).astype(np.float32)
    if train:
        want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x))
    port = tcv.HourglassVolume(24)
    port.load_state_dict(weights.from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    port.train(train)
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2,) + tuple(2 * ((n + 1) // 2)
                                                   for n in dhw) + (64,)
    assert rel_err(got.detach().numpy(), np.asarray(want)) <= TOL
    if train:
        _, stats = weights.to_flax(port.state_dict())
        flat = weights._flatten(jax.tree.map(np.asarray,
                                             mut["batch_stats"]))
        for k, v in weights._flatten(stats).items():
            assert rel_err(v, flat[k]) <= TOL, k


def test_hourglass_weights_round_trip():
    """to_flax gives the JAX module's tree, key for key and shape for
    shape (enc0..enc3, dec0, dec1 and their _bn)."""
    shape = (1, 4, 4, 4, 16)
    jm = jcv.HourglassVolume(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(shape)),
                            jax.random.PRNGKey(0))
    params, stats = weights.to_flax(tcv.HourglassVolume(16).state_dict())
    for got, want in ((params, shapes["params"]),
                      (stats, shapes["batch_stats"])):
        want = jax.tree.map(lambda s: np.empty(s.shape, s.dtype), want)
        got, want = weights._flatten(got), weights._flatten(want)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    assert {k.split("/")[0] for k in weights._flatten(params)} == {
        "enc0", "enc1", "enc2", "enc3", "dec0", "dec1", "enc0_bn", "enc1_bn",
        "enc2_bn", "enc3_bn", "dec0_bn", "dec1_bn"}


@pytest.mark.parametrize("group_size", [1, 3])
@pytest.mark.parametrize("trans", [False, True], ids=["no_trans", "trans"])
def test_psroi_pool_matches_jax(group_size, trans):
    rng = np.random.RandomState(group_size)
    D, P = 2, 3 if group_size == 3 else 4
    feat = rng.randn(2, 16, 20, D * group_size ** 2).astype(np.float32)
    rois = np.array([[2.0, 2.0, 13.0, 11.0], [-5.0, -5.0, 2.0, 2.0],
                     [6.0, 6.0, 25.0, 20.0], [3.3, 4.6, 9.5, 14.4]],
                    np.float32)
    idx = np.array([0, 1, 1, 0], np.int32)
    kw = dict(group_size=group_size, spatial_scale=0.8, sample_per_part=3)
    if trans:
        kw.update(trans_std=0.1)
        t = rng.randn(4, P, P, 2).astype(np.float32)
    ours = psroi_pool(torch.from_numpy(feat), torch.from_numpy(rois),
                      torch.from_numpy(idx), P, D,
                      trans=torch.from_numpy(t) if trans else None, **kw)
    want = jpsroi(jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(idx), P,
                  D, trans=jnp.asarray(t) if trans else None, **kw)
    assert ours.shape == (4, P, P, D)
    assert rel_err(ours.numpy(), np.asarray(want)) <= TOL


def test_psroi_pool_no_trans_ignores_offsets():
    rng = np.random.RandomState(5)
    feat = torch.from_numpy(rng.randn(1, 12, 12, 4).astype(np.float32))
    rois = torch.tensor([[1.0, 2.0, 9.0, 10.0]])
    idx = torch.zeros(1, dtype=torch.int64)
    t = torch.from_numpy(rng.randn(1, 2, 2, 2).astype(np.float32))
    a = psroi_pool(feat, rois, idx, 2, 1, 2, trans=t, trans_std=0.2,
                   no_trans=True)
    b = psroi_pool(feat, rois, idx, 2, 1, 2)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        psroi_pool(feat, rois, idx, 2, 3, 2)
