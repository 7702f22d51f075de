"""The port's DLA-34 trunk and weight bridge against side_tpu's.

FeatureExtractor (DLA-34 + DLAUp + IDAUp, 16 DeformBlocks) at 128x256,
batch 2, f32, eval BN, DCN windowed R=1 on both sides, random weights with
offsets beyond +-1 and non-trivial BN statistics.  Tolerance 1e-4 of the
output's max: the convs sum in another order than XLA's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.models import dla as jdla
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu_torch.models import dla as tdla
from side_tpu_torch.weights import from_flax

from torch_parity import (H_IN, W_IN, load_port, nhwc, random_variables,
                          rel_err)


def test_feature_extractor_parity():
    model = jdla.FeatureExtractor(dtype=jnp.float32)
    x = np.random.RandomState(0).randn(2, H_IN, W_IN, 3).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, H_IN, W_IN, 3)))
    variables = random_variables(shapes, seed=1)
    with dcn_mode("windowed"):
        want = np.asarray(jax.jit(lambda v, a: model.apply(v, a))(
            jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    port = load_port(tdla.FeatureExtractor(), variables)
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, H_IN // 4, W_IN // 4, 64)
    assert np.abs(want).max() > 0.1       # the weights keep activations alive
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("factor", [2, 4])
def test_bilinear_up_parity(factor):
    """JAX: flipped lhs-dilated depthwise conv; port: ConvTranspose2d with
    weight[c, 0] = w[:, :, 0, c] unflipped."""
    rng = np.random.RandomState(factor)
    C = 5
    x = rng.randn(2, 6, 7, C).astype(np.float32)
    w = rng.randn(2 * factor, 2 * factor, 1, C).astype(np.float32)
    want = np.asarray(jdla.BilinearUp(factor).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x)))
    up = tdla.BilinearUp(C, factor)
    up.load_state_dict({"weight": torch.from_numpy(
        w.transpose(3, 2, 0, 1).copy())})
    with torch.no_grad():
        got = nhwc(up(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == (2, 6 * factor, 7 * factor, C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the bridge maps the same kernel the same way
    sd = from_flax({"up_1": {"kernel": w}}, {})
    np.testing.assert_array_equal(sd["up_1.weight"].numpy(),
                                  up.weight.detach().numpy())


def test_bilinear_up_init_equals_jax_init():
    up = tdla.BilinearUp(3, 2)
    k = jdla._bilinear_kernel(2)
    for c in range(3):
        np.testing.assert_array_equal(up.weight[c, 0].detach().numpy(), k)


def test_from_flax_mapping():
    """Every JAX leaf of the flagship StereoNet maps onto exactly one
    state_dict entry of the port with its shape, and the layouts move."""
    from side_tpu.config import Config as JConfig
    from side_tpu.models import create_model as jcreate
    from side_tpu.models.stereo_net import init_stereo_net
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model

    jm = jcreate(JConfig(input_h=H_IN, input_w=W_IN, compute_dtype="float32"))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H_IN, W_IN),
                            jax.random.PRNGKey(0))
    v = random_variables(shapes, seed=2)
    sd = from_flax(v["params"], v["batch_stats"])
    own = create_model(Config(input_h=H_IN, input_w=W_IN)).state_dict()
    assert set(sd) == set(own)
    for k in sd:
        assert tuple(sd[k].shape) == tuple(own[k].shape), k
    assert len(sd) == 400

    p = v["params"]["feature_extraction"]
    conv = p["base"]["ConvBN_0"]["Conv_0"]["kernel"]            # HWIO
    np.testing.assert_array_equal(
        sd["feature_extraction.base.ConvBN_0.Conv_0.weight"].numpy(),
        conv.transpose(3, 2, 0, 1))
    node = p["dla_up"]["ida_0"]["node_1"]
    np.testing.assert_array_equal(
        sd["feature_extraction.dla_up.ida_0.node_1.kernel"].numpy(),
        node["kernel"])                                          # DCN: kept
    np.testing.assert_array_equal(
        sd["feature_extraction.dla_up.ida_0.node_1.offset_mask.weight"]
        .numpy()[5], node["offset_mask"]["kernel"][..., 5].transpose(2, 0, 1))
    c3 = v["params"]["depth_estimator"]["ConvBN3D_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["depth_estimator.ConvBN3D_0.Conv_0.weight"].numpy(),
        c3.transpose(4, 3, 0, 1, 2))
    bs = v["batch_stats"]["feature_extraction"]["base"]["ConvBN_0"]
    np.testing.assert_array_equal(
        sd["feature_extraction.base.ConvBN_0.BatchNorm_0.running_var"]
        .numpy(), bs["BatchNorm_0"]["var"])


def test_folded_bn_bf16_single_rounding():
    """Under bf16 the BN apply is one f32 multiply-add rounded once, as in
    the JAX FoldedBatchNorm; large |mean| / small var stresses it."""
    rng = np.random.RandomState(7)
    C = 16
    x = (rng.randn(2, 4, 5, C) * 0.05 + 30.0).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 2.0, C).astype(np.float32),
              "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": np.full(C, 30.0, np.float32),
             "var": np.full(C, 0.0025, np.float32)}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jdla.FoldedBatchNorm(
        use_running_average=True, dtype=jnp.bfloat16).apply(
            {"params": params, "batch_stats": stats}, xb).astype(jnp.float32))
    bn = tdla.FoldedBatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = bn(xt)
    assert got.dtype == torch.bfloat16
    got = nhwc(got.float())
    # at most one bf16 ulp apart (f32 FMA vs mul+add before the rounding)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    assert np.abs(got - want).max() < 0.05


def test_load_npz_merge_and_radius(tmp_path):
    """A JAX `.npz` checkpoint (saved under exact DCN, tag -1) into a port
    model: matching leaves load, a missing block keeps its init, a leaf of
    another shape is skipped, an unknown one dropped, each with a message;
    the port switches to exact DCN with a warning."""
    from side_tpu.runtime.checkpoint import save_checkpoint
    from side_tpu_torch.ops import deform_conv as tdc
    from side_tpu_torch.weights import load_npz

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj_1 = tdla.DeformBlock(8, 16)
            self.node_1 = tdla.DeformBlock(16, 16)
            tdla.init_weights(self, torch.Generator().manual_seed(0))

    rng = np.random.RandomState(0)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    params = {"proj_1": {"kernel": r(3, 3, 8, 16), "bias": r(16),
                         "offset_mask": {"kernel": r(3, 3, 8, 27),
                                         "bias": r(27)},
                         "BatchNorm_0": {"scale": r(16), "bias": r(5)}},
              "extra": {"kernel": r(1, 1, 2, 2)}}
    stats = {"proj_1": {"BatchNorm_0": {"mean": r(16), "var": r(16) ** 2}}}
    path = str(tmp_path / "ck.npz")
    with dcn_mode("exact"):
        save_checkpoint(path, 3, params, stats)

    model = Two()
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    logs = []
    prev = tdc.set_dcn_mode("windowed", 1)
    try:
        load_npz(model, path, log=logs.append)
        assert tdc.dcn_radius_tag() == -1
    finally:
        tdc.set_dcn_mode(*prev)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["proj_1.kernel"].numpy(),
                                  params["proj_1"]["kernel"])
    np.testing.assert_array_equal(
        sd["proj_1.offset_mask.weight"].numpy(),
        params["proj_1"]["offset_mask"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["proj_1.BatchNorm_0.running_var"]
                                  .numpy(), stats["proj_1"]["BatchNorm_0"]
                                  ["var"])
    for k in ("proj_1.BatchNorm_0.bias", "node_1.kernel"):
        assert torch.equal(sd[k], fresh[k]), k
    text = "\n".join(logs)
    assert "Skip loading parameter proj_1.BatchNorm_0.bias" in text
    assert "No param node_1.kernel in checkpoint" in text
    assert "Drop parameter extra.weight" in text
    assert "WARNING: checkpoint trained with DCN exact" in text
