"""The port's bilinear gather (K5's plain version, the probe's variants)
against the JAX probe tools/gather_microbench.py.

The probe's module globals are set to a small shape (B, H, W, C = 2, 32, 80,
8; H*W*9 must be a multiple of its tile of 7680 samples).  Its Pallas
variant E does lower in interpret mode on the CPU, so the port is held
against the kernel it replaces: f32 to 1e-6 relative, bf16 to one ulp (both
accumulate in f32 in the same corner order).  Variant A, the probe's
take_along_axis formulation, multiplies and sums in x's dtype: in f32 it
agrees to 1e-6 too; in bf16 it rounds at every step and is only held to 4
ulps of the largest value.  The JAX variants return the sum of their
result; the test reads the full array as it enters that `jnp.sum`.
"""

import functools
import importlib.util
import os
import unittest.mock as um

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from side_tpu_torch.ops.gather_cuda import (GATHER_BILINEAR,
                                            gather_bilinear_plain)
from side_tpu_torch.tools import gather_microbench as TG

import torch_parity  # noqa: F401  (thread count)

_SPEC = importlib.util.spec_from_file_location(
    "jax_gather_microbench", os.path.join(
        os.path.dirname(__file__), "..", "tools", "gather_microbench.py"))
JG = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JG)

SHAPE = (2, 32, 80, 8)


@pytest.fixture
def small_probe(monkeypatch):
    for name, v in zip("BHWC", SHAPE):
        monkeypatch.setattr(JG, name, v)
    return JG


def _full_result(fn, *args):
    """The (…, C) array a JAX variant hands to its final jnp.sum."""
    seen = []
    real = jnp.sum

    def spy(a, *rest, **kw):
        seen.append(a)
        return real(a, *rest, **kw)

    with um.patch.object(jnp, "sum", spy), \
            um.patch.object(pl, "pallas_call", functools.partial(
                pl.pallas_call, interpret=True)):
        fn(*args)
    return np.asarray(seen[-1], np.float32).reshape(-1, SHAPE[3])


def _inputs(probe, dtype):
    x, sy, sx = probe.make_inputs()          # bf16 x, f32 positions
    x = np.asarray(x, np.float32)
    if dtype == torch.float32:
        x = x + np.random.RandomState(1).randn(*x.shape).astype(
            np.float32) * 1e-3               # use f32's extra bits
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jnp.asarray(x, jdt), sy, sx), (
        torch.from_numpy(x).to(dtype), torch.from_numpy(np.asarray(sy)),
        torch.from_numpy(np.asarray(sx)))


def test_make_inputs_draws_the_probes_numbers(small_probe):
    jx, jsy, jsx = small_probe.make_inputs()
    tx, tsy, tsx = TG.make_inputs("cpu", shape=SHAPE)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    np.testing.assert_array_equal(tsy.numpy(), np.asarray(jsy))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_pallas_variant_E_interpret(small_probe, dtype):
    jargs, (x, sy, sx) = _inputs(small_probe, dtype)
    want = _full_result(small_probe.variant_E, *jargs)
    y0, x0, fy, fx = TG.corners(sy, sx)
    got = gather_bilinear_plain(x, y0, x0, fy, fx)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
        assert (np.abs(got - want) <= ulp).all()
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = GATHER_BILINEAR.launches
    again = TG.variant_E(x, sy, sx)
    assert GATHER_BILINEAR.launches == before
    np.testing.assert_array_equal(again.float().numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["A", "B", "E"])
def test_variants_match_jax_variant_A(small_probe, dtype, variant):
    jargs, targs = _inputs(small_probe, dtype)
    want = _full_result(small_probe.variant_A, *jargs)
    got = getattr(TG, f"variant_{variant}")(*targs).float().numpy()
    tol = 1e-6 if dtype == torch.float32 else 4 * 2.0 ** -8
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_last_row_and_column_clamp():
    """Samples on the last row / column read the edge twice (min(.., H-1))
    and so return the edge value for any fraction."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 5, 7, 8).astype(np.float32))
    y0 = torch.tensor([4, 4, 2], dtype=torch.int32)
    x0 = torch.tensor([6, 3, 6], dtype=torch.int32)
    fy = torch.tensor([0.7, 0.3, 0.0])
    fx = torch.tensor([0.4, 0.0, 0.9])
    got = gather_bilinear_plain(x, y0, x0, fy, fx)
    np.testing.assert_allclose(got[0], x[0, 4, 6], atol=1e-6)
    np.testing.assert_allclose(got[1], x[0, 4, 3], atol=1e-6)
    np.testing.assert_allclose(got[2], x[0, 2, 6], atol=1e-6)


def test_grid_sample_is_the_same_function_in_bounds():
    x, sy, sx = TG.make_inputs("cpu", torch.float32, shape=SHAPE)
    want = TG.variant_E(x, sy, sx)
    got = TG.grid_sample_call(x.permute(0, 3, 1, 2).contiguous(), sy, sx)
    got = got[:, :, 0].permute(0, 2, 1).reshape(-1, SHAPE[3])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


def test_probe_cli_on_cpu_and_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(TG, "make_inputs", functools.partial(
        TG.make_inputs, shape=SHAPE))
    assert TG.main(["--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    for name in ("A torch.gather", "B index_select", "E gather_bilinear",
                 "grid_sample"):
        assert name in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.main([])
