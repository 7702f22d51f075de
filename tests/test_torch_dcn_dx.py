"""What of the tensor-core K2 (d_x of the DCN; csrc/dcn_bwd.cu
`dcn_bwd_dx_mma_kernel` and `dcn_bwd_dx_patch_kernel`) can be tested without
a card.

(a) The launch plan `dx_plan` at the model's 7 DeformBlock shapes, B = 2 and
    8, R = 1, 2 and -1 (exact): every one of the card's 132 SMs gets a
    block, a block's shared memory stays within 232,448 bytes, no block is
    without work, the patch route is the windowed function's only (R = 1 at
    Cout 64, where it measured faster), and the bytes equal the formula of
    the C launcher.
(b) The halo rule the patch route rests on: with offsets clamped to [-R, R]
    an input pixel receives nothing from an output pixel more than R + 1
    rows or columns away.  Autograd of the plain version: a cotangent that
    is zero on a patch grown by R + 1 gives d_x exactly 0 on the patch
    (exact: every dropped term is a product with a weight of 0.0 or is
    never formed), and a cotangent that lives only at distance R + 1
    reaches the patch, so the halo cannot be narrower.  Offsets drawn in
    [-R - 0.5, R + 0.5] (part of them clamped) and at exactly +-R.
(c) `dcn_dx_patch_model`, plain PyTorch for the route's formulation (patch +
    halo, what leaves the patch dropped), against autograd d_x on images
    whose sides are no multiples of the patch: 1e-6 of d_x's largest value
    (f32; the two add the same terms in another order).
(d) The same d_x against the JAX package: the VJP of
    `deform_conv2d_windowed` in `dcn_mode("windowed")` at non-integer
    offsets, 1e-5 (two f32 implementations, sums in other orders), and the
    Pallas d_x of `dcn_packed_backward` in interpret mode, 1e-4 (the
    tolerance tests/test_torch_dcn_backward.py holds that kernel to).
"""

import functools
import unittest.mock as um

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.ops import deform_conv as jdc
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.ops.dcn_cuda import (SM_COUNT, SMEM_PER_BLOCK,
                                         SMEM_PER_SM, dx_plan)
from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES

from torch_parity import rel_err

MODEL_SHAPES = [(512, 12, 40, 256), (256, 24, 80, 256), (256, 24, 80, 128),
                (256, 24, 80, 64), (128, 48, 160, 128), (128, 48, 160, 64),
                (64, 96, 320, 64)]
IDS = ["x".join(map(str, s)) for s in MODEL_SHAPES]


# ------------------------------------------------------------- (a) the plan
@pytest.mark.parametrize("radius", [1, 2, -1])
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=IDS)
def test_dx_plan_fills_the_card_within_shared_memory(shape, batch, radius):
    cin, h, w, cout = shape
    plan = dx_plan(batch, h, w, cin, cout, radius)
    assert plan["blocks"] >= SM_COUNT, plan
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    assert plan["blocks"] == plan["tiles"] * (cin // 64) * plan["tap_splits"]
    if radius != 1 or cout != 64:
        # exact mode: unbounded offsets, no patch can hold the scatter; at
        # Cout 128 and 256 the product over the halo, and at R = 2 the 25
        # slots, cost more than the device-memory scatter they save
        # (PERF.md)
        assert (plan["scatter"], plan["patch_h"]) == ("tile", 0)
        assert plan["tiles"] == -(-batch * h * w // 64)
        per = -(-9 // plan["tap_splits"])
        assert per * (plan["tap_splits"] - 1) < 9        # no block tapless
        assert plan["smem_bytes"] == (2 * 64 * cout * 2 + 64 * 72 * 4
                                      + 64 * 9 * 32)
        return
    assert plan["scatter"] == "patch" and plan["patch_h"] in (4, 8)
    assert plan["halo"] == radius + 1 and plan["tap_splits"] == 1
    ph = plan["patch_h"]
    # every patch holds pixels of the image: no empty block
    assert plan["tiles"] == batch * -(-h // ph) * -(-w // 16)
    assert (-(-h // ph) - 1) * ph < h and (-(-w // 16) - 1) * 16 < w
    halo = plan["halo"]
    assert plan["region"] == (ph + 2 * halo) * (16 + 2 * halo)
    assert plan["region"] <= 512                 # two samples a thread
    assert plan["region"] <= plan["g_rows"] < plan["region"] + 32
    assert plan["smem_bytes"] == (
        plan["g_rows"] * cout * 2 + 64 * cout * 2 + plan["region"] * 72 * 4
        + (2 * radius + 1) ** 2 * ph * 16 * 4)


@pytest.mark.parametrize("shape", PROTOCOL_SHAPES,
                         ids=["x".join(map(str, s)) for s in PROTOCOL_SHAPES])
def test_dx_plan_at_the_protocol_shapes(shape):
    """At 128x384, B = 8 and R = 1: Cout 64 takes the patch body, its
    patches cover every pixel with no patch row or column empty (4 x 12
    and 8 x 24 are ragged in width); the others take the tile body with
    every pixel tile and no tap split empty; all within shared memory."""
    cin, h, w, cout = shape
    batch = 8
    plan = dx_plan(batch, h, w, cin, cout, 1)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    assert plan["blocks"] == plan["tiles"] * (cin // 64) * plan["tap_splits"]
    if cout != 64:
        assert plan["scatter"] == "tile"
        assert plan["tiles"] == -(-batch * h * w // 64)
        per = -(-9 // plan["tap_splits"])
        assert per * (plan["tap_splits"] - 1) < 9
        return
    assert plan["scatter"] == "patch" and plan["halo"] == 2
    ph = plan["patch_h"]
    assert plan["tiles"] == batch * -(-h // ph) * -(-w // 16)
    assert (-(-h // ph) - 1) * ph < h and (-(-w // 16) - 1) * 16 < w
    assert plan["region"] == (ph + 4) * (16 + 4) <= plan["g_rows"]


def test_dx_plan_of_wide_windows_and_tiny_inputs():
    """Only R = 1 takes the patch route; a tiny exact-mode input splits its
    taps over blocks as far as they go."""
    for radius in (0, 2, 3):
        assert dx_plan(8, 96, 320, 64, 64, radius)["scatter"] == "tile"
    assert dx_plan(8, 96, 320, 64, 64, 1)["halo"] == 2
    plan = dx_plan(1, 5, 8, 64, 64, -1)
    assert (plan["tiles"], plan["tap_splits"], plan["blocks"]) == (1, 9, 9)
    plan = dx_plan(1, 5, 8, 64, 64, 1)
    assert (plan["scatter"], plan["tiles"]) == ("patch", 1)


# ------------------------------------------------------- (b) the halo rule
def _case(seed, B, H, W, C, Cout, radius, offsets="random"):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    if offsets == "at_radius":
        off = rng.choice([-float(radius), float(radius)],
                         (B, H, W, 9, 2)).astype(np.float32)
    else:
        off = rng.uniform(-radius - 0.5, radius + 0.5,
                          (B, H, W, 9, 2)).astype(np.float32)
    mask = (0.25 + 0.75 * rng.rand(B, H, W, 9)).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32)
    g = rng.randn(B, H, W, Cout).astype(np.float32)
    return x, off, mask, w, g


def _autograd_dx(x, off, mask, w, g, radius):
    leaf = torch.tensor(x, requires_grad=True)
    out = tdc.deform_conv_plain(leaf, torch.tensor(off), torch.tensor(mask),
                                torch.tensor(w), None, radius)
    out.backward(torch.tensor(g))
    return leaf.grad


@pytest.mark.parametrize("offsets", ["random", "at_radius"])
@pytest.mark.parametrize("radius", [1, 2])
def test_nothing_reaches_a_patch_from_beyond_its_halo(radius, offsets):
    B, H, W = 2, 20, 30
    x, off, mask, w, g = _case(40 + radius, B, H, W, 4, 5, radius, offsets)
    halo = radius + 1
    py0, px0, ph, pw = 8, 9, 4, 8            # a patch inside the image
    region = np.zeros((H, W), bool)
    region[py0 - halo:py0 + ph + halo, px0 - halo:px0 + pw + halo] = True
    g_out = g * ~region[None, :, :, None]
    d_x = _autograd_dx(x, off, mask, w, g_out, radius)
    assert float(d_x.abs().max()) > 0.1
    assert float(d_x[:, py0:py0 + ph, px0:px0 + pw].abs().max()) == 0.0


@pytest.mark.parametrize("offsets", ["random", "at_radius"])
@pytest.mark.parametrize("radius", [1, 2])
def test_the_halo_cannot_be_narrower(radius, offsets):
    """A cotangent on the ring at distance exactly R + 1 from the patch
    reaches it."""
    B, H, W = 2, 20, 30
    x, off, mask, w, g = _case(50 + radius, B, H, W, 4, 5, radius, offsets)
    halo = radius + 1
    py0, px0, ph, pw = 8, 9, 4, 8
    ring = np.zeros((H, W), bool)
    ring[py0 - halo:py0 + ph + halo, px0 - halo:px0 + pw + halo] = True
    ring[py0 - halo + 1:py0 + ph + halo - 1,
         px0 - halo + 1:px0 + pw + halo - 1] = False
    d_x = _autograd_dx(x, off, mask, w, g * ring[None, :, :, None], radius)
    assert float(d_x[:, py0:py0 + ph, px0:px0 + pw].abs().max()) > 1e-3


# ------------------------------------------- (c) the patch route's formulation
@pytest.mark.parametrize("offsets", ["random", "at_radius"])
@pytest.mark.parametrize("radius,patch_h", [(1, 8), (1, 4), (2, 8), (2, 4),
                                            (0, 8)])
def test_patch_model_equals_autograd_dx(radius, patch_h, offsets):
    """13 x 37: neither side a multiple of the patch (4 or 8 x 16)."""
    x, off, mask, w, g = _case(60 + radius + patch_h, 2, 13, 37, 6, 5,
                               max(radius, 1), offsets)
    want = _autograd_dx(x, off, mask, w, g, radius)
    got = tdc.dcn_dx_patch_model(torch.tensor(g), torch.tensor(off),
                                 torch.tensor(mask), torch.tensor(w), radius,
                                 patch_h)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want.numpy()) <= 1e-6


def test_patch_model_refuses_exact_mode():
    x, off, mask, w, g = _case(70, 1, 5, 8, 4, 4, 1)
    with pytest.raises(ValueError):
        tdc.dcn_dx_patch_model(torch.tensor(g), torch.tensor(off),
                               torch.tensor(mask), torch.tensor(w), -1, 8)


def test_patch_model_with_the_bf16_weight_holds_the_backward_tolerance():
    """The route's one new rounding, W to bf16 inside g·W_k^T, at the model's
    longest reduction (Cout 256), against autograd of the plain version in
    bf16: inside chip_smoke.py's 2e-2."""
    rng = np.random.RandomState(71)
    B, H, W, C, Cout = 1, 9, 18, 64, 256
    x, off, mask, _, g = _case(72, B, H, W, C, Cout, 1)
    w = (rng.randn(3, 3, C, Cout) / np.sqrt(9 * C)).astype(np.float32)
    g16 = torch.tensor(g).bfloat16()
    leaf = torch.tensor(x).bfloat16().requires_grad_(True)
    tdc.deform_conv_plain(leaf, torch.tensor(off), torch.tensor(mask),
                          torch.tensor(w), None, 1).backward(g16)
    got = tdc.dcn_dx_patch_model(g16, torch.tensor(off), torch.tensor(mask),
                                 torch.tensor(w).bfloat16(), 1, 8).bfloat16()
    assert rel_err(got.float().numpy(), leaf.grad.float().numpy()) <= 2e-2


# ------------------------------------------------ (d) against the JAX package
@pytest.mark.parametrize("radius,patch_h", [(1, 8), (2, 4)])
def test_patch_model_matches_jax_windowed_vjp(radius, patch_h):
    x, off, mask, w, g = _case(80 + radius, 2, 13, 21, 8, 8, radius)
    with jdc.dcn_mode("windowed"):
        _, vjp = jax.vjp(
            lambda xx: jdc.deform_conv2d_windowed(
                xx, jnp.asarray(off), jnp.asarray(mask), jnp.asarray(w),
                radius=radius), jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tdc.dcn_dx_patch_model(torch.tensor(g), torch.tensor(off),
                                 torch.tensor(mask), torch.tensor(w), radius,
                                 patch_h).numpy()
    assert rel_err(got, want) <= 1e-5


def test_patch_model_matches_pallas_dx_in_interpret_mode():
    from side_tpu.ops import dcn_pallas as DP
    from side_tpu.ops.dcn_pallas_bwd import dcn_packed_backward
    B, H, W, C = 2, 8, 16, 8
    x, off, mask, w, g = _case(90, B, H, W, C, 8, 1)
    with um.patch("side_tpu.ops.dcn_pallas_bwd.pl.pallas_call",
                  functools.partial(DP.pl.pallas_call, interpret=True)):
        want = np.asarray(dcn_packed_backward(
            jnp.asarray(x), jnp.asarray(off.reshape(B, H, W, 18)),
            jnp.asarray(mask), jnp.asarray(w), jnp.asarray(g), 1)[0])
    got = tdc.dcn_dx_patch_model(torch.tensor(g), torch.tensor(off),
                                 torch.tensor(mask), torch.tensor(w), 1,
                                 4).numpy()
    assert rel_err(got, want) <= 1e-4
