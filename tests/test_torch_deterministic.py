"""What of the port's deterministic mode can be tested without a card.

(a) `dx_plan(..., deterministic=True)`: at the window R = 1 every width of
    the tensor-core route takes K2's patch body (no atomics; 4 rows at
    Cout 256, where 8 exceed a block's shared memory), at the model's 7
    DeformBlock shapes and the acceptance protocol's 7 (B = 2 and 8), with
    the patches covering every pixel, no patch empty and the bytes of the
    C launcher's formula; off the window the tile body stays (the wrapper
    then refuses, as PyTorch does).  Without the flag the plan is the
    default one.
(b) `deterministic_mode()`: sets PyTorch's deterministic algorithms (warn
    only), cuDNN's deterministic switch without autotuning and cuBLAS's
    workspace setting where none is set, and restores the previous
    settings, also after an error.
(c) `_not_deterministic`: raises under `torch.use_deterministic_algorithms
    (True)`, warns where PyTorch is set to warn only.
(d) `acceptance_16.weights_digest`: equal for the same arrays whatever the
    order they were saved in, different for one changed bit.
"""

import os

import numpy as np
import pytest
import torch

from side_tpu_torch.ops import dcn_cuda
from side_tpu_torch.ops.dcn_cuda import (SMEM_PER_BLOCK, SMEM_PER_SM,
                                         deterministic_mode, dx_plan)
from side_tpu_torch.tools.acceptance_16 import PROTOCOL_SHAPES, weights_digest

MODEL_SHAPES = [(512, 12, 40, 256), (256, 24, 80, 256), (256, 24, 80, 128),
                (256, 24, 80, 64), (128, 48, 160, 128), (128, 48, 160, 64),
                (64, 96, 320, 64)]
SHAPES = MODEL_SHAPES + PROTOCOL_SHAPES
IDS = ["x".join(map(str, s)) for s in SHAPES]


# ------------------------------------------------------------- (a) the plan
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_deterministic_plan_takes_the_patch_at_every_width(shape, batch):
    cin, h, w, cout = shape
    plan = dx_plan(batch, h, w, cin, cout, 1, deterministic=True)
    assert plan["scatter"] == "patch" and plan["halo"] == 2
    assert plan["tap_splits"] == 1
    ph = plan["patch_h"]
    assert ph in (4, 8) and (cout != 256 or ph == 4)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    # every pixel in a patch, no patch without pixels of the image
    assert plan["tiles"] == batch * -(-h // ph) * -(-w // 16)
    assert (-(-h // ph) - 1) * ph < h and (-(-w // 16) - 1) * 16 < w
    assert plan["blocks"] == plan["tiles"] * (cin // 64)
    assert plan["region"] == (ph + 4) * (16 + 4) <= 256     # a sample a thread
    assert plan["region"] <= plan["g_rows"] < plan["region"] + 32
    assert plan["smem_bytes"] == (
        plan["g_rows"] * cout * 2 + 64 * cout * 2 + plan["region"] * 72 * 4
        + 9 * ph * 16 * 4)
    if cout == 64:
        # the default plan of Cout 64 is the same patch
        assert plan == dx_plan(batch, h, w, cin, cout, 1)
    else:
        assert dx_plan(batch, h, w, cin, cout, 1)["scatter"] == "tile"


@pytest.mark.parametrize("radius", [0, 2, -1])
@pytest.mark.parametrize("cout", [64, 128, 256])
def test_deterministic_plan_off_the_window_keeps_the_tile(radius, cout):
    plan = dx_plan(8, 24, 80, 256, cout, radius, deterministic=True)
    assert plan == dx_plan(8, 24, 80, 256, cout, radius)
    assert (plan["scatter"], plan["patch_h"]) == ("tile", 0)


# ---------------------------------------------------------- (b) the switch
def _settings():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def test_deterministic_mode_sets_and_restores(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = _settings()
    assert before[0] is False
    with deterministic_mode():
        assert _settings() == (True, True, True, False)
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == \
            dcn_cuda.CUBLAS_WORKSPACE
    assert _settings() == before
    with pytest.raises(ValueError):
        with deterministic_mode():
            raise ValueError("inside")
    assert _settings() == before


def test_deterministic_mode_keeps_a_cublas_setting(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with deterministic_mode():
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_deterministic_mode_nests():
    before = _settings()
    with deterministic_mode():
        with deterministic_mode():
            assert _settings() == (True, True, True, False)
        assert _settings() == (True, True, True, False)
    assert _settings() == before


# -------------------------------------------------------- (c) the refusal
def test_not_deterministic_raises_or_warns():
    prev = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match="deterministic"):
            dcn_cuda._not_deterministic("dcn_bwd_dx on its tile route")
        torch.use_deterministic_algorithms(True, warn_only=True)
        with pytest.warns(UserWarning, match="dcn_bwd_dx"):
            dcn_cuda._not_deterministic("dcn_bwd_dx on its tile route")
    finally:
        torch.use_deterministic_algorithms(prev)


# ---------------------------------------------------------- (d) the digest
def test_weights_digest_names_the_arrays(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(3, 4).astype(np.float32),
              "b/c": rng.randint(0, 9, (5,)).astype(np.int64)}
    np.savez(tmp_path / "one.npz", **arrays)
    np.savez(tmp_path / "two.npz", **dict(reversed(list(arrays.items()))))
    d1 = weights_digest(tmp_path / "one.npz")
    assert d1 == weights_digest(tmp_path / "two.npz") and len(d1) == 64
    flipped = arrays["a"].copy()
    flipped.view(np.uint32)[1, 2] ^= 1
    np.savez(tmp_path / "three.npz", a=flipped, **{"b/c": arrays["b/c"]})
    assert weights_digest(tmp_path / "three.npz") != d1
    # the same bytes under another shape are other weights
    np.savez(tmp_path / "four.npz", a=arrays["a"].reshape(4, 3),
             **{"b/c": arrays["b/c"]})
    assert weights_digest(tmp_path / "four.npz") != d1
