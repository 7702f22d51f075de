"""The port's StereoNet, cost volume and decode against side_tpu's.

128x256 stereo input, batch 2, f32, DCN windowed R=1, random weights.
Tolerances: 1e-4 of a tensor's max for network outputs (sum order), 1e-5
absolute for the cost-volume pieces alone; decode indices must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.models import cost_volume as jcv
from side_tpu.models import create_model as jcreate
from side_tpu.ops import decode as jdec
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu_torch.config import Config
from side_tpu_torch.models import cost_volume as tcv
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import decode as tdec

from torch_parity import (H_IN, W_IN, load_port, random_variables, rel_err,
                          stereo_variables, to_jax)

K, CV_TOPK = 20, 8
SEED = 1      # its top-K scores are separated by > 1e-4 (asserted below)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"input": rng.randn(2, H_IN, W_IN, 3).astype(np.float32),
            "input_right": rng.randn(2, H_IN, W_IN, 3).astype(np.float32),
            "fb": np.array([380.0, 410.0], np.float32)}


def _ranked_scores(hm: np.ndarray) -> np.ndarray:
    """Scores of the reference's bbox_decode order, (B, K)."""
    peaks = jdec.nms_peaks(jax.nn.sigmoid(jnp.asarray(hm)))
    return np.asarray(jdec.topk(peaks, K=K + 1)[0])


def test_stereo_net_outputs_match():
    kw = dict(input_h=H_IN, input_w=W_IN, compute_dtype="float32", K=K,
              cv_topk=CV_TOPK)
    jm = jcreate(JConfig(**kw))
    variables = stereo_variables(jm, seed=SEED)
    # spread the heatmap logits (random weights leave them within ~0.1 of
    # each other), so that the decode order is far from float noise
    hm = variables["params"]["hm"]["Conv_1"]
    hm["kernel"] = hm["kernel"] * 50.0
    hm["bias"] = np.full_like(hm["bias"], -6.0)
    batch = _batch(SEED + 100)
    with dcn_mode("windowed"):
        want = jax.jit(lambda v, b: jm.apply(v, b, use_cost_volume=True,
                                             target=None, train=False))(
            to_jax(variables), to_jax(batch))
    want = {k: np.asarray(v) for k, v in want.items()}

    # the depth rows follow the decode order: the reference's ranked scores
    # must be separated well beyond the two packages' float noise
    gaps = -np.diff(_ranked_scores(want["hm"]), axis=1)
    assert gaps.min() > 1e-4, (
        f"seed {SEED}: top-{K} scores within {gaps.min():.2e}; pick a seed "
        "whose decode order is unambiguous")

    port = load_port(create_model(Config(**kw)), variables)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        err = rel_err(got[name], want[name])
        assert err <= 1e-4, (name, err)
    # the cost-volume depths alone (the disparity fallback of the tail can
    # be orders of magnitude larger)
    assert rel_err(got["depth"][:, :CV_TOPK], want["depth"][:, :CV_TOPK]) \
        <= 1e-4
    assert np.abs(want["depth"][:, :CV_TOPK]).max() > 1.0
    assert (want["depth"][:, CV_TOPK:] != 0).any()    # disparity fallback


def test_proposal_shift_matches():
    rng = np.random.RandomState(1)
    bbox = rng.uniform(0, 60, (2, 6, 4)).astype(np.float32)
    bbox[..., 2:] += bbox[..., :2]
    bbox_r = bbox - rng.uniform(0, 5, (2, 6, 1)).astype(np.float32)
    fb = np.array([380.0, 400.0], np.float32)
    want = jcv.proposal_shift(jnp.asarray(bbox), jnp.asarray(bbox_r),
                              jnp.asarray(fb), 16, 64)
    got = tcv.proposal_shift(torch.from_numpy(bbox), torch.from_numpy(bbox_r),
                             torch.from_numpy(fb), 16, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


def test_build_cost_volume_matches():
    rng = np.random.RandomState(2)
    fl = rng.randn(2, 16, 24, 32).astype(np.float32)
    fr = rng.randn(2, 16, 24, 32).astype(np.float32)
    bbox = rng.uniform(-2, 18, (2, 3, 4)).astype(np.float32)
    bbox[..., 2:] = bbox[..., :2] + rng.uniform(1, 8, (2, 3, 2))
    rl, rr, _ = jcv.proposal_shift(jnp.asarray(bbox), jnp.asarray(bbox - 1.0),
                                   jnp.asarray([380.0, 400.0]), 16, 24)
    want = np.asarray(jcv.build_cost_volume(jnp.asarray(fl), jnp.asarray(fr),
                                            rl, rr, 16))
    got = tcv.build_cost_volume(torch.from_numpy(fl), torch.from_numpy(fr),
                                torch.from_numpy(np.asarray(rl)),
                                torch.from_numpy(np.asarray(rr)), 16)
    assert got.shape == want.shape == (6, 16, 16, 16, 96)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_cost_volume_net_matches():
    rng = np.random.RandomState(3)
    net = jcv.CostVolumeNet(32, dtype=jnp.float32)
    cost = rng.randn(3, 16, 16, 16, 96).astype(np.float32)
    depth_bin = np.sort(rng.uniform(2, 80, (3, 16)), axis=1)[:, ::-1].astype(
        np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.asarray(cost), jnp.asarray(depth_bin))
    variables = random_variables(shapes, seed=4)
    want = net.apply(to_jax(variables), jnp.asarray(cost),
                     jnp.asarray(depth_bin))
    port = load_port(tcv.CostVolumeNet(32), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(cost), torch.from_numpy(depth_bin))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w)) <= 1e-4


def _heads(seed, tie=False):
    rng = np.random.RandomState(seed)
    B, H, W = 2, 16, 24
    heat = rng.rand(B, H, W, 3).astype(np.float32)
    if tie:
        # coarse levels: many exactly equal peaks, including equal
        # neighbours that both survive the 3x3 NMS
        heat = np.round(heat * 4) / 4
    return dict(
        heat=heat,
        kept=rng.randn(B, H, W, 6 * 4).astype(np.float32),
        dim=rng.randn(B, H, W, 3).astype(np.float32),
        orien=rng.randn(B, H, W, 2).astype(np.float32),
        wh=rng.uniform(1, 9, (B, H, W, 3)).astype(np.float32),
        reg=rng.randn(B, H, W, 3).astype(np.float32))


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "ties"])
def test_ddd_decode_indices_equal(tie):
    h = _heads(5, tie)
    want = jdec.ddd_decode(*(jnp.asarray(h[k]) for k in
                             ("heat", "kept", "dim", "orien", "wh", "reg")),
                           grid_size=4, K=30)
    got = tdec.ddd_decode(*(torch.from_numpy(h[k]) for k in
                            ("heat", "kept", "dim", "orien", "wh", "reg")),
                          grid_size=4, K=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    j_inds = np.asarray(jdec.topk(jdec.nms_peaks(jnp.asarray(h["heat"])),
                                  30)[1])
    t_inds = tdec.topk(tdec.nms_peaks(torch.from_numpy(h["heat"])), 30)[1]
    np.testing.assert_array_equal(t_inds.numpy(), j_inds)
    if tie:
        scores = np.asarray(jdec.topk(jdec.nms_peaks(
            jnp.asarray(h["heat"])), 30)[0])
        assert (np.diff(scores, axis=1) == 0).any()   # ties were exercised


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "ties"])
def test_bbox_decode_matches(tie):
    h = _heads(6, tie)
    logit = np.log(np.clip(h["heat"], 1e-3, 1 - 1e-3) /
                   (1 - np.clip(h["heat"], 1e-3, 1 - 1e-3))).astype(np.float32)
    want = jdec.bbox_decode(jnp.asarray(logit), jnp.asarray(h["wh"]),
                            jnp.asarray(h["reg"]), K=30)
    got = tdec.bbox_decode(torch.from_numpy(logit), torch.from_numpy(h["wh"]),
                           torch.from_numpy(h["reg"]), K=30)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
