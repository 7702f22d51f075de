"""What of the tensor-core DCN route (csrc/dcn_fwd_body.cuh, K3 in
csrc/dcn_bwd.cu) can be tested without a card.

(a) Its arithmetic.  `deform_conv_mma_model` is the plain version with the
    weight rounded to bf16 before the f32 contraction, as the kernels round
    it while staging.  It is held against `deform_conv_plain` and its
    autograd at the reduction lengths of the model's 7 DeformBlock shapes
    (9*Cin from 576 to 4608, He-scaled weights, bf16 activations, numpy
    seeds), within chip_smoke.py's bf16 tolerances: 8e-3 of the output's
    largest value forward, 2e-2 of each cotangent's largest value backward.
    This decided single-vs-split weight: with a single bf16 weight the f32
    sums move by about 2e-3 of the output's largest value (1.6e-3 .. 1.9e-3
    at these sizes), under one bf16 ulp there, so the rounded outputs differ
    by one ulp at most (<= 2^-7 = 7.8e-3); a high + low pair would move them
    by 3e-6 at twice the tensor-core work and shared memory, and is not
    taken.  One case also holds the model against the JAX package's windowed
    function on the same bf16 inputs.
(b) The route rule `dcn_route`: the 7 shapes at B = 2 and 8 take the
    tensor-core body, f32 and other widths the CUDA-core body.
(c) The launch plans `fwd_plan` and `dcoord_plan`: every model shape fills
    the card's 132 SMs and stays inside a block's 232,448 bytes of shared
    memory; splits and slices leave no block without work.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from side_tpu.ops import deform_conv as jdc
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops.dcn_cuda import (SM_COUNT, SMEM_PER_BLOCK,
                                         SMEM_PER_SM, dcn_route, dcoord_plan,
                                         fwd_plan)
from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES

import torch_parity  # noqa: F401  (thread count)

# (Cin, H, W, Cout) of the model's DeformBlocks at 384x1280 (chip_smoke.py)
MODEL_SHAPES = [(512, 12, 40, 256), (256, 24, 80, 256), (256, 24, 80, 128),
                (256, 24, 80, 64), (128, 48, 160, 128), (128, 48, 160, 64),
                (64, 96, 320, 64)]
IDS = ["x".join(map(str, s)) for s in MODEL_SHAPES]
FWD_TOL = 8e-3      # chip_smoke.py TOLERANCE[bfloat16]
BWD_TOL = 2e-2      # chip_smoke.py BWD_TOLERANCE[bfloat16]


def _case(cin, cout, seed, B=2, H=10, W=24):
    """The widths of a model shape on a small image: the reduction length
    is the model's, the pixel count is not."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H, W, cin).astype(np.float32))
    off = torch.from_numpy(
        rng.uniform(-1.5, 1.5, (B, H, W, 9, 2)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(B, H, W, 9).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, cin, cout) /
                          np.sqrt(9 * cin)).astype(np.float32))
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H, W, cout).astype(np.float32))
    return x.bfloat16(), off, mask, w, b, g.bfloat16()


def _rel(a, ref):
    return float((a.float() - ref.float()).abs().max() /
                 ref.float().abs().max())


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_single_bf16_weight_holds_the_forward_tolerance(shape):
    cin, _, _, cout = shape
    x, off, mask, w, b, _ = _case(cin, cout, seed=cin + cout)
    with torch.no_grad():
        want = tdc.deform_conv_plain(x, off, mask, w, b, 1)
        got = tdc.deform_conv_mma_model(x, off, mask, w, b, 1)
        # the sums before the output's rounding
        cols = tdc._sample_columns(x, off, mask, 1).float()
        w2 = w.reshape(9 * cin, cout)
        f32_move = _rel(cols @ w2.bfloat16().float(), cols @ w2)
    assert got.dtype == torch.bfloat16
    assert f32_move <= 3e-3, f32_move          # under one bf16 ulp (3.9e-3)
    assert _rel(got, want) <= 2.0 ** -7, _rel(got, want)   # one ulp at most
    assert _rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_single_bf16_weight_holds_the_backward_tolerance(shape):
    cin, _, _, cout = shape
    x, off, mask, w, b, g = _case(cin, cout, seed=100 + cin + cout)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, off, mask, w)]
        fn(*leaves, b, 1).backward(g)
        return [t.grad for t in leaves]

    want = grads(tdc.deform_conv_plain)
    got = grads(tdc.deform_conv_mma_model)
    for name, a, ref in zip(("x", "offset", "mask", "weight"), got, want):
        assert a.dtype == ref.dtype
        assert _rel(a, ref) <= BWD_TOL, (name, _rel(a, ref))
    # d_W is taken from the bf16 column and g, which the weight's rounding
    # does not touch
    assert torch.equal(got[3], want[3])


def test_split_weight_would_buy_three_more_digits():
    cin, cout = 256, 128
    x, off, mask, w, b, _ = _case(cin, cout, seed=7)
    with torch.no_grad():
        cols = tdc._sample_columns(x, off, mask, 1).float()
        w2 = w.reshape(9 * cin, cout)
        hi = w2.bfloat16().float()
        lo = (w2 - hi).bfloat16().float()
        single = _rel(cols @ hi, cols @ w2)
        split = _rel(cols @ hi + cols @ lo, cols @ w2)
        model = tdc.deform_conv_mma_model(x, off, mask, w, b, 1,
                                          split_weight=True)
        want = tdc.deform_conv_plain(x, off, mask, w, b, 1)
    assert split <= 1e-5 < 1e-3 <= single
    assert _rel(model, want) <= 2.0 ** -7


def test_model_matches_jax_windowed_in_bf16():
    """The model against the JAX package's windowed DCN on the same bf16
    input: they differ by the weight's rounding (the JAX function contracts
    at default precision on the CPU, i.e. with the f32 weight), the order of
    the sums and where each rounds to bf16: 2 bf16 ulps of the largest
    value."""
    cin, cout = 64, 64
    x, off, mask, w, b, _ = _case(cin, cout, seed=11, H=8, W=16)
    want = np.asarray(jdc.deform_conv2d_windowed(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        *map(jnp.asarray, (off.numpy(), mask.numpy(), w.numpy(), b.numpy())),
        radius=1).astype(jnp.float32))
    with torch.no_grad():
        got = tdc.deform_conv_mma_model(x, off, mask, w, b, 1).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()


# ------------------------------------------------------------ (b) the routes
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_model_shapes_take_the_tensor_core_route(shape, batch):
    cin, h, w, cout = shape
    assert dcn_route(torch.bfloat16, cin, cout) == "tensor"
    # dtype and widths alone: the pixel count never changes the route
    assert fwd_plan(batch, h, w, cin, cout)["bn"] == cout


@pytest.mark.parametrize("dtype,cin,cout", [
    (torch.float32, 64, 64), (torch.float32, 512, 256),
    (torch.bfloat16, 24, 64), (torch.bfloat16, 40, 72),
    (torch.bfloat16, 64, 72), (torch.bfloat16, 96, 64),
    (torch.bfloat16, 64, 512), (torch.bfloat16, 64, 32),
    (torch.float16, 64, 64)])
def test_other_operands_take_the_cuda_core_route(dtype, cin, cout):
    assert dcn_route(dtype, cin, cout) == "cuda_core"


def test_ragged_pixel_count_stays_on_the_tensor_core_route():
    assert dcn_route(torch.bfloat16, 64, 64) == "tensor"
    plan = fwd_plan(3, 13, 37, 64, 64)
    # patches of 8 x 16 pixels: 2 x 3 an image, the edge ones part empty
    assert (plan["tile_h"], plan["tile_w"], plan["tiles"]) == (8, 16, 18)


# ------------------------------------------------------------- (c) the plans
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_forward_plan_fills_the_card_within_shared_memory(shape, batch):
    cin, h, w, cout = shape
    P = batch * h * w
    plan = fwd_plan(batch, h, w, cin, cout)
    assert plan["blocks"] >= SM_COUNT, plan
    assert plan["tile_h"] * plan["tile_w"] == plan["bm"]
    assert plan["tiles"] * plan["bm"] >= P
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    # two blocks an SM, so that one samples while the other multiplies
    assert plan["blocks_per_sm"] == 2
    assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    assert plan["bm"] * plan["bn"] == 64 * 256 or plan["bn"] == 64
    # every split has turns of the (chunk, tap) list to run
    n_iter = 9 * cin // 64
    per = -(-n_iter // plan["splits"])
    assert 1 <= plan["splits"] <= n_iter
    assert per * (plan["splits"] - 1) < n_iter
    assert (plan["scratch_floats"] ==
            (plan["splits"] * P * cout if plan["splits"] > 1 else 0))
    # the large layers need no split and no scratch
    if plan["tiles"] >= SM_COUNT:
        assert plan["splits"] == 1


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_dcoord_plan_fills_the_card_within_shared_memory(shape, batch):
    cin, h, w, cout = shape
    P = batch * h * w
    plan = dcoord_plan(P, cin, cout)
    resident = SM_COUNT * plan["blocks_per_sm"]
    assert SM_COUNT <= plan["blocks"] <= 2 * resident, plan
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] == 2
    per = -(-plan["pixel_tiles"] // plan["slices"])
    assert 1 <= plan["slices"] <= plan["pixel_tiles"]
    assert per * (plan["slices"] - 1) < plan["pixel_tiles"]   # no empty slice


PROTOCOL_IDS = ["x".join(map(str, s)) for s in PROTOCOL_SHAPES]


@pytest.mark.parametrize("shape", PROTOCOL_SHAPES, ids=PROTOCOL_IDS)
def test_plans_at_the_protocol_shapes(shape):
    """At 128x384, B = 8: the tensor-core route; the forward's patches
    cover every pixel with no patch row or column empty, and the reduction
    is split (no split empty) where the tiles alone leave SMs idle; K3's
    slices cover every pixel tile, none empty; both within shared
    memory."""
    cin, h, w, cout = shape
    batch, P = 8, 8 * h * w
    assert dcn_route(torch.bfloat16, cin, cout) == "tensor"
    plan = fwd_plan(batch, h, w, cin, cout)
    th, tw = plan["tile_h"], plan["tile_w"]
    assert plan["tiles"] == batch * -(-h // th) * -(-w // tw)
    assert (-(-h // th) - 1) * th < h and (-(-w // tw) - 1) * tw < w
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    n_iter = 9 * cin // 64
    per = -(-n_iter // plan["splits"])
    assert per * (plan["splits"] - 1) < n_iter <= per * plan["splits"]
    if plan["tiles"] < SM_COUNT:
        assert plan["splits"] > 1 and plan["scratch_floats"] == \
            plan["splits"] * P * cout
        # one more split would leave a split empty or not add blocks
        assert plan["blocks"] > SM_COUNT - plan["tiles"] * per
    plan = dcoord_plan(P, cin, cout)
    assert plan["pixel_tiles"] == -(-P // 64)
    per = -(-plan["pixel_tiles"] // plan["slices"])
    assert per * (plan["slices"] - 1) < plan["pixel_tiles"]
    assert plan["blocks"] == plan["combos"] * plan["slices"] >= SM_COUNT
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK


def test_plans_of_a_tiny_input():
    """One pixel tile: the forward splits the reduction as far as it goes,
    K3 has one slice."""
    plan = fwd_plan(1, 5, 8, 64, 64)
    assert (plan["tiles"], plan["splits"], plan["blocks"]) == (1, 9, 9)
    plan = dcoord_plan(40, 64, 64)
    assert (plan["slices"], plan["blocks"]) == (1, 9)
