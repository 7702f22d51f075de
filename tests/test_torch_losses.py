"""The port's training losses and GT RoI boxes against side_tpu's.

Seeded numpy head maps and targets (batch 2, 16x24 maps, K=6 slots with 3
valid, grid 4), f32.  Values must agree to 1e-5 relative and their
gradients with respect to every head map (and to `loss_weight`) to 1e-5 of
each gradient's largest value: both packages compute the same sums in
other orders.  Integer targets must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.ops import decode as jdec
from side_tpu.ops import losses as jl
from side_tpu_torch.ops import decode as tdec
from side_tpu_torch.ops import losses as tl

from torch_parity import rel_err

B, H, W, K, GRID = 2, 16, 24, 6, 4
HEADS = {"hm": 3, "wh": 3, "reg": 3, "dim": 3, "orien": 2,
         "kept_type": 6 * GRID}


def _outputs(seed):
    rng = np.random.RandomState(seed)
    out = {k: (rng.randn(B, H, W, c) * 2).astype(np.float32)
           for k, c in HEADS.items()}
    out["hm"][0, 3, 4, 0] = -30.0          # a saturated positive
    out["depth"] = (rng.rand(B, K, 1) * 40).astype(np.float32)
    out["depth_logits"] = rng.randn(B, K, 16).astype(np.float32)
    bins = np.sort(rng.uniform(2, 87, (B, K, 16)), axis=-1)[..., ::-1]
    out["depth_bin"] = np.ascontiguousarray(bins).astype(np.float32)
    return out


def _targets(seed):
    rng = np.random.RandomState(seed)
    hm = (rng.rand(B, 3, H, W) ** 4).astype(np.float32)
    ind = rng.randint(0, H * W, (B, K)).astype(np.int64)
    mask = np.zeros((B, K), np.uint8)
    mask[:, :3] = 1
    for b in range(B):
        for k in range(3):
            hm[b, k, ind[b, k] // W, ind[b, k] % W] = 1.0
    depth = (rng.rand(B, K, 1) * 40 + 5).astype(np.float32) * mask[..., None]
    return {"hm": hm, "ind": ind, "ind_float": ind.astype(np.float32),
            "rot_mask": mask,
            "wh": rng.uniform(2, 12, (B, K, 3)).astype(np.float32),
            "reg": rng.rand(B, K, 3).astype(np.float32),
            "dim": rng.rand(B, K, 3).astype(np.float32),
            "orien": rng.randn(B, K, 2).astype(np.float32),
            "kept": rng.uniform(-2, 14, (B, K, 6)).astype(np.float32),
            "depth": depth.astype(np.float32)}


def _both(jfn, tfn, args, grad_idx=()):
    """Value of both, and the gradients of each w.r.t. args[i], i in
    grad_idx."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=i in grad_idx)
             for i, a in enumerate(args)]
    jv = jfn(*jargs)
    tv = tfn(*targs)
    jg = tg = ()
    if grad_idx:
        jg = jax.grad(lambda *a: jfn(*a), argnums=tuple(grad_idx))(*jargs)
        tv.backward()
        tg = [targs[i].grad.numpy() for i in grad_idx]
    return (np.asarray(jv), tv.detach().numpy(), [np.asarray(g) for g in jg],
            tg)


def _check(jv, tv, jg, tg, tol=1e-5):
    assert rel_err(tv, jv) <= tol, (tv, jv)
    for a, b in zip(tg, jg):
        assert rel_err(a, b) <= tol


def test_clamped_sigmoid_matches():
    x = np.linspace(-15, 15, 61).astype(np.float32)
    np.testing.assert_allclose(
        tl.clamped_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jl.clamped_sigmoid(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("which", ["focal_loss", "focal_loss_logits"])
def test_focal_losses_match(which):
    out, tgt = _outputs(0), _targets(1)
    gt = tgt["hm"].transpose(0, 2, 3, 1).copy()
    logits = out["hm"]
    if which == "focal_loss":
        pred = np.clip(1 / (1 + np.exp(-logits)), 1e-4, 1 - 1e-4).astype(
            np.float32)
        args = (pred, gt)
    else:
        args = (logits, gt)
    _check(*_both(getattr(jl, which), getattr(tl, which), args, (0,)))


def test_focal_loss_without_positives_matches():
    out = _outputs(2)
    gt = np.full((B, H, W, 3), 0.5, np.float32)
    _check(*_both(jl.focal_loss_logits, tl.focal_loss_logits,
                  (out["hm"], gt), (0,)))


@pytest.mark.parametrize("head", ["wh", "reg", "dim", "orien"])
def test_masked_l1_loss_matches(head):
    out, tgt = _outputs(3), _targets(4)
    _check(*_both(jl.masked_l1_loss, tl.masked_l1_loss,
                  (out[head], tgt["rot_mask"], tgt["ind"], tgt[head]), (0,)))


def test_kept_label_and_cross_loss_match():
    out, tgt = _outputs(5), _targets(6)
    want = np.asarray(jl.compute_kept_label(jnp.asarray(tgt["kept"]),
                                            jnp.asarray(tgt["wh"]), GRID))
    got = tl.compute_kept_label(torch.from_numpy(tgt["kept"]),
                                torch.from_numpy(tgt["wh"]), GRID)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[..., 0])) > 2        # several classes hit
    kt = out["kept_type"][..., :4 * GRID].copy()
    _check(*_both(jl.cross_loss, tl.cross_loss,
                  (kt, tgt["ind"], want[..., 0]), (0,)))


def test_depth_bin_ce_matches():
    out, tgt = _outputs(7), _targets(8)
    _check(*_both(jl.depth_bin_ce, tl.depth_bin_ce,
                  (out["depth_logits"], out["depth_bin"],
                   tgt["depth"][..., 0]), (0,)))


def test_boxes_from_targets_match():
    tgt = _targets(9)
    want = jdec.boxes_from_targets(jnp.asarray(tgt["ind_float"]),
                                   jnp.asarray(tgt["wh"]),
                                   jnp.asarray(tgt["reg"]), W, 1.5)
    got = tdec.boxes_from_targets(torch.from_numpy(tgt["ind_float"]),
                                  torch.from_numpy(tgt["wh"]),
                                  torch.from_numpy(tgt["reg"]), W, 1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("uncert,mse,aux", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 0.0),
    (True, True, 1.0)], ids=["plain", "uncert", "mse_no_aux", "uncert_mse"])
def test_stereo_loss_matches(uncert, mse, aux):
    """Total and parts, and the gradients w.r.t. every head map and the
    loss weights; hm targets arrive (B, C, H, W) as the dataset gives them."""
    out, tgt = _outputs(10), _targets(11)
    names = list(HEADS) + ["depth", "depth_logits"]
    lw = (np.full(7, -1.0, np.float32) if uncert
          else np.linspace(0.5, 2.0, 7).astype(np.float32))

    def run(mod, arrays, lw_, xp):
        o = dict(zip(names, arrays))
        o["depth_bin"] = xp(out["depth_bin"])
        batch = {k: xp(v) for k, v in tgt.items()}
        return mod.stereo_loss(o, batch, lw_, GRID, uncert, True,
                               depth_aux_weight=aux, mse_loss=mse)

    jargs = [jnp.asarray(out[k]) for k in names]
    (jt, jstats), jg = jax.value_and_grad(
        lambda a, w: run(jl, a, w, jnp.asarray), argnums=(0, 1),
        has_aux=True)(jargs, jnp.asarray(lw))
    targs = [torch.tensor(out[k], requires_grad=True) for k in names]
    tlw = torch.tensor(lw, requires_grad=True)
    tt, tstats = run(tl, targs, tlw, torch.from_numpy)
    tt.backward()
    assert set(tstats) == set(jstats)
    for k in jstats:
        assert rel_err(tstats[k].item(), float(jstats[k])) <= 1e-5, k
    for name, a, g in zip(names, targs, jg[0]):
        got = (np.zeros(a.shape, np.float32) if a.grad is None
               else a.grad.numpy())
        if np.abs(np.asarray(g)).max() == 0:
            assert np.abs(got).max() == 0, name     # an unused head
        else:
            assert rel_err(got, np.asarray(g)) <= 1e-5, name
    assert rel_err(tlw.grad.numpy(), np.asarray(jg[1])) <= 1e-5
