"""The port's DCN gradient against side_tpu's.

On the CPU the port's DCN backward is autograd through the plain version
(ops/deform_conv.py:deform_conv_plain), the function the Hopper kernels K2
and K3 are held against on the card.  Same numpy inputs and cotangent
through both packages, f32; tolerance 1e-5 of each cotangent's largest
value (the two sum in other orders).

At integer offsets the JAX package's two backward forms differ: the VJP of
the windowed XLA form (a sum of triangles) takes whatever subgradients
JAX picks for max and abs at their kinks there, which is neither the left,
the right nor the central derivative, while the Pallas backward (its lerp
body), the reference DCNv2 and the port give the right-derivative.  The
port is held against the Pallas backward, run in interpret mode as
tests/test_deform_conv.py runs it.
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

from torch_parity import rel_err

TOL = 1e-5
NAMES = ("x", "offset", "mask", "weight", "bias")


def _case(seed, B=2, H=8, W=16, C=8, Cout=8, off_range=2.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, W, C) * 0.5).astype(np.float32),
            rng.uniform(-off_range, off_range, (B, H, W, 9, 2)).astype(
                np.float32),
            rng.rand(B, H, W, 9).astype(np.float32),
            (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32),
            rng.randn(Cout).astype(np.float32),
            rng.randn(B, H, W, Cout).astype(np.float32)]


def _port_grads(fn, arrays, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*leaves).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in leaves]


def _jax_grads(fn, arrays, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("off_range", [0.9, 2.5], ids=["inside", "beyond"])
@pytest.mark.parametrize("radius", [1, 2])
def test_windowed_grad_matches_jax_vjp(radius, off_range):
    """Offsets inside +-R and beyond it (clamped: zero offset gradient)."""
    *arrays, g = _case(0, off_range=off_range)
    want = _jax_grads(functools.partial(jdc.deform_conv2d_windowed,
                                        radius=radius), arrays, g)
    got = _port_grads(functools.partial(tdc.deform_conv2d_windowed,
                                        radius=radius), arrays, g)
    for name, a, b in zip(NAMES, got, want):
        assert rel_err(a, b) <= TOL, (name, rel_err(a, b))
    if off_range > radius:
        clamped = np.abs(arrays[1]) > radius
        assert clamped.any() and np.all(got[1][clamped] == 0)


def test_exact_grad_matches_jax_gather_vjp():
    *arrays, g = _case(1, off_range=3.0)
    want = _jax_grads(jdc._deform_conv2d_gather, arrays, g)
    got = _port_grads(tdc.deform_conv2d_exact, arrays, g)
    for name, a, b in zip(NAMES, got, want):
        assert rel_err(a, b) <= TOL, (name, rel_err(a, b))


def test_zero_offset_grad_matches_pallas_backward():
    """At offset 0 (the init value) the port's offset gradient is the
    right-derivative, nonzero, and equals the Pallas backward's (K2 + K3 of
    the JAX package, interpret mode) for every cotangent."""
    from side_tpu.ops import dcn_pallas as DP
    from side_tpu.ops.dcn_pallas_bwd import dcn_packed_backward
    x, off, mask, w, b, g = _case(2)
    off[:] = 0.0
    with um.patch("side_tpu.ops.dcn_pallas_bwd.pl.pallas_call",
                  functools.partial(DP.pl.pallas_call, interpret=True)):
        want = dcn_packed_backward(
            jnp.asarray(x), jnp.asarray(off.reshape(2, 8, 16, 18)),
            jnp.asarray(mask), jnp.asarray(w), jnp.asarray(g), 1)
    want = [np.asarray(a) for a in want]
    want[1] = want[1].reshape(off.shape)
    got = _port_grads(functools.partial(tdc.deform_conv2d_windowed,
                                        radius=1), (x, off, mask, w, b), g)
    assert np.abs(got[1]).sum() > 1.0
    for name, a, ref in zip(NAMES, got, want):
        assert rel_err(a, ref) <= 1e-4, (name, rel_err(a, ref))


def test_zero_offset_grad_differs_from_jax_windowed_vjp():
    """The divergence recorded in ROADMAP Queue 3: at zero offsets the JAX
    windowed VJP (which side_tpu's 5 DeformBlocks with C > 128 take in
    training) gives another offset gradient than the port's right-derivative
    (all 16 DeformBlocks); every other cotangent agrees."""
    *arrays, g = _case(3)
    arrays[1][:] = 0.0
    want = _jax_grads(functools.partial(jdc.deform_conv2d_windowed,
                                        radius=1), arrays, g)
    got = _port_grads(functools.partial(tdc.deform_conv2d_windowed,
                                        radius=1), arrays, g)
    assert np.abs(got[1]).max() > 0.1
    assert rel_err(got[1], want[1]) > 0.1
    for name, a, b in zip(NAMES, got, want):
        if name != "offset":
            assert rel_err(a, b) <= TOL, (name, rel_err(a, b))


def test_om_block_grad_matches_jax():
    """offset/mask conv + DCN (the DeformBlock's compute), windowed R=1,
    gradients of its five inputs."""
    rng = np.random.RandomState(4)
    B, H, W, C, Cout = 2, 8, 16, 8, 8
    arrays = [(rng.randn(B, H, W, C) * 0.5).astype(np.float32),
              (rng.randn(3, 3, C, 27) * 0.4).astype(np.float32),
              (rng.randn(27) * 0.5).astype(np.float32),
              (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32),
              rng.randn(Cout).astype(np.float32)]
    g = rng.randn(B, H, W, Cout).astype(np.float32)
    with jdc.dcn_mode("windowed"):
        want = _jax_grads(jdc.deform_conv2d_om, arrays, g)
    with tdc.dcn_mode("windowed", 1):
        got = _port_grads(tdc.deform_conv2d_om, arrays, g)
    for name, a, b in zip(("x", "w_om", "b_om", "weight", "bias"), got,
                          want):
        assert rel_err(a, b) <= 1e-4, (name, rel_err(a, b))


def test_cpu_dispatch_is_plain_autograd():
    """deform_conv2d on CPU tensors: the plain version with autograd (the
    card's path, DcnFunction, is tested in test_torch_cuda.py)."""
    *arrays, g = _case(5)
    got = _port_grads(tdc.deform_conv2d, arrays, g)
    want = _port_grads(functools.partial(tdc.deform_conv_plain, radius=1),
                       arrays, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
