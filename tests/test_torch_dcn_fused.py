"""The port's fused offset/mask DCN route (K4's plain version and the
switch) against side_tpu's fused op.

The JAX fused op `deform_conv2d_pallas_fused` runs its Pallas kernel
(`_dcn_kernel_packed_om`) in interpret mode, patched as
tests/test_deform_conv.py does; tolerance 2e-3, that test's (the packed
kernel's block-diagonal conv sums in another order).  Against the JAX
unfused composition `_fused_reference` the port agrees to 1e-5 in f32.
"""

import functools
import unittest.mock as um

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from side_tpu.ops import dcn_pallas as DP
from side_tpu_torch.ops import deform_conv as tdc

import torch_parity  # noqa: F401  (thread count)


def _case(seed, B=2, H=8, W=16, C=8, Cout=8, om_scale=0.2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    w_om = (rng.randn(3, 3, C, 27) * om_scale).astype(np.float32)
    b_om = (rng.randn(27) * 0.3).astype(np.float32)
    return x, w_om, b_om, w, b


def _port_block(x, w_om, b_om, w, b):
    t = [torch.from_numpy(a) for a in (x, w_om, b_om, w, b)]
    return tdc.deform_block_om(t[0], t[1].permute(3, 2, 0, 1), *t[2:])


def _jax_fused(x, w_om, b_om, w, b, radius=1):
    with um.patch("side_tpu.ops.dcn_pallas.pl.pallas_call",
                  functools.partial(DP.pl.pallas_call, interpret=True)), \
            um.patch.object(DP, "_PACK", True):
        return np.asarray(DP.deform_conv2d_pallas_fused(
            *map(jnp.asarray, (x, w_om, b_om, w, b)), radius=radius))


@pytest.mark.parametrize("C,Cout", [(8, 8), (16, 24)])
def test_fused_block_matches_jax_fused_interpret(C, Cout):
    args = _case(3, C=C, Cout=Cout)
    want = _jax_fused(*args)
    with tdc.dcn_mode("windowed", 1), tdc.dcn_fused(), torch.no_grad():
        got = _port_block(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("om_scale", [0.2, 1.5],
                         ids=["inside_window", "beyond_window"])
def test_fused_block_matches_jax_reference(om_scale):
    """om_scale 1.5 drives most offsets beyond +-1: the clamp is compared."""
    args = _case(4, om_scale=om_scale)
    want = np.asarray(DP._fused_reference(*map(jnp.asarray, args), radius=1))
    with tdc.dcn_mode("windowed", 1), tdc.dcn_fused(), torch.no_grad():
        got = _port_block(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2])
def test_om_plain_offsets_beyond_window_and_on_integers(radius):
    """`deform_conv_om_plain` on a hand-made om: dy, dx beyond +-R and
    exactly on integers (the bilinear kinks), against the JAX windowed op
    fed the split operands."""
    from side_tpu.ops.deform_conv import deform_conv2d_windowed
    rng = np.random.RandomState(5)
    B, H, W, C, Cout = 2, 6, 9, 8, 5
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.3).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    om = rng.uniform(-3.0, 3.0, (B, H, W, 9, 3)).astype(np.float32)
    om[0, :3, :, :, :2] = rng.randint(-3, 4, (3, W, 9, 2))
    off = jnp.asarray(om[..., :2])
    mask = 1.0 / (1.0 + jnp.exp(-jnp.asarray(om[..., 2])))
    want = np.asarray(deform_conv2d_windowed(
        jnp.asarray(x), off, mask, jnp.asarray(w), jnp.asarray(b),
        radius=radius))
    got = tdc.deform_conv_om_plain(
        torch.from_numpy(x), torch.from_numpy(om.reshape(B, H, W, 27)),
        torch.from_numpy(w), torch.from_numpy(b), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nan_logit_poisons_its_pixel_only():
    x, w_om, b_om, w, b = _case(6)
    B, H, W, _ = x.shape
    om = np.random.RandomState(7).randn(B, H, W, 27).astype(np.float32)
    om[1, 2, 3, 3 * 4 + 2] = np.nan
    got = tdc.deform_conv_om_plain(torch.from_numpy(x), torch.from_numpy(om),
                                   torch.from_numpy(w), torch.from_numpy(b),
                                   1).numpy()
    bad = np.isnan(got)
    assert bad[1, 2, 3].all() and bad.sum() == got.shape[-1]


def test_switch_is_ignored_when_a_gradient_is_wanted():
    """K4 has no backward: with the switch on, a call under autograd takes
    the unfused route, and its gradients equal the unfused ones."""
    args = _case(8)

    def grads(fused):
        t = [torch.from_numpy(a).requires_grad_(True) for a in args]
        with tdc.dcn_mode("windowed", 1), tdc.dcn_fused(fused), \
                um.patch.object(tdc, "_deform_conv2d_fused",
                                side_effect=AssertionError("fused route")):
            out = tdc.deform_block_om(t[0], t[1].permute(3, 2, 0, 1), *t[2:])
        (out ** 2).sum().backward()
        return [out.detach()] + [a.grad for a in t]

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_switch_routes_only_windowed_inference():
    """Fused route taken: switch on, windowed mode, no gradient wanted.
    In exact mode and with the switch off the unfused route runs."""
    args = _case(9)
    calls = []
    real = tdc._deform_conv2d_fused

    def spy(*a):
        calls.append(1)
        return real(*a)

    with um.patch.object(tdc, "_deform_conv2d_fused", spy), torch.no_grad():
        with tdc.dcn_mode("windowed", 1):
            off = _port_block(*args)
            assert calls == []
            with tdc.dcn_fused():
                on = _port_block(*args)
            assert calls == [1]
            assert not tdc.get_dcn_fused()
        with tdc.dcn_mode("exact"), tdc.dcn_fused():
            exact = _port_block(*args)
        assert calls == [1]
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=1e-6)
    want = np.asarray(DP._fused_reference(*map(jnp.asarray, args), radius=1))
    assert np.abs(exact.numpy() - want).max() > 1e-3    # unbounded offsets
    # tensors that require grad, but under no_grad: still the fused route
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    with um.patch.object(tdc, "_deform_conv2d_fused", spy), \
            tdc.dcn_mode("windowed", 1), tdc.dcn_fused(), torch.no_grad():
        tdc.deform_block_om(t[0], t[1].permute(3, 2, 0, 1), *t[2:])
    assert calls == [1, 1]


def test_env_switch(monkeypatch):
    import subprocess
    import sys
    code = ("from side_tpu_torch.ops import deform_conv as d; "
            "print(d.get_dcn_fused())")
    for value, want in (("1", "True"), ("0", "False")):
        monkeypatch.setenv("SIDE_TPU_TORCH_DCN_FUSED", value)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want
