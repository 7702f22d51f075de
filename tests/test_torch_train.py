"""The port's training step, optimizer, checkpoints and train CLI against
side_tpu's.

One train step from identical random weights and one uint8 batch: 64x128
input, batch 2, max_objs 4 (two valid GT slots per image, so the cost
volume's BatchNorms also see invalid zero-box slots), roi_size 4, f32,
`--uncert`.

The weights are random, except that every offset/mask conv gets a tiny
kernel and dy/dx biases in (0.3, 0.7): every DCN samples at offsets inside
the window and away from integers.  There the windowed (port, R=1) and the
exact (JAX side, whose VJP traces ~6x faster than the windowed one) DCN are
the same smooth function, and no offset sits on a kink of the bilinear
derivative.  With offsets spread over kinks, the train-mode gradient of
this random network is chaotic in f32: a 1e-7 change of the input moves
the port's own gradients by 3.6 % (median over tensors, norm-relative).

Tolerances:
- eval-mode BatchNorm (running statistics): every gradient within 1e-3 of
  its tensor's largest value; the network is well conditioned there (a
  1e-6 input change moves the port's gradients by 3e-6 at most);
- train mode (batch statistics): loss parts 1e-3 relative and updated
  batch statistics 1e-4 of their largest value; gradients within 0.3 of
  their tensor's largest value, 3e-2 in the median over tensors.  Batch
  statistics over 2-32 samples per channel make this deep BN network at
  random init amplify float noise: a 1e-6 change of the normalised input
  moves the port's own gradients by 1.0 % in the median and 14 % at worst
  (of a tensor's max), in the same deep Tree layers that differ most
  between the packages (1.2 % median, 19 % worst).  The BatchNorm backward
  alone is held tightly in `test_folded_bn_train_matches_flax`, and every
  other backward in eval mode.

The optimizer is compared alone, on identical gradients (after one Adam
step the parameters differ by 2*lr wherever a gradient is at float noise,
so comparing updated parameters of the whole network says nothing).
"""

import unittest.mock as um

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from side_tpu.config import Config as JConfig
from side_tpu.models.stereo_net import StereoNet as JStereoNet
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.parallel.mesh import make_mesh
from side_tpu.runtime import checkpoint as jckpt
from side_tpu.runtime.trainer import Trainer as JTrainer
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.trainer import Adam, PiecewiseLR, Trainer

from torch_parity import load_port, random_variables, rel_err, to_jax

H, W, K, B = 64, 128, 4, 2
KW = dict(input_h=H, input_w=W, compute_dtype="float32", max_objs=K,
          roi_size=4, K=K, uncert=True, lr=1e-3, lr_step=(3,))


def _jmodel():
    return JStereoNet(heads=dict(JConfig(**KW).heads), roi_size=4,
                      max_objs=K, topk=K, down_ratio=4, input_w=W,
                      dtype=jnp.float32)


def _window_interior_offsets(tree, rng):
    """Offset/mask convs: tiny kernel, dy/dx biases in (0.3, 0.7) (channel
    order per tap [dy, dx, mask-logit])."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if name == "offset_mask":
            sub["kernel"] = sub["kernel"] * 0.02
            bias = sub["bias"].copy()
            bias[0::3] = rng.uniform(0.3, 0.7, 9)
            bias[1::3] = rng.uniform(0.3, 0.7, 9)
            sub["bias"] = bias
        else:
            _window_interior_offsets(sub, rng)


def _variables(jm, seed):
    from side_tpu.models.stereo_net import init_stereo_net
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, K),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed)
    _window_interior_offsets(variables["params"],
                             np.random.RandomState(seed + 100))
    return variables


def _batch(seed):
    rng = np.random.RandomState(seed)
    Ho, Wo = H // 4, W // 4
    hm = np.zeros((B, 3, Ho, Wo), np.float32)
    ind = np.zeros((B, K), np.int64)
    mask = np.zeros((B, K), np.uint8)
    wh = np.zeros((B, K, 3), np.float32)
    for b in range(B):
        for k in range(2):
            y, x = rng.randint(2, Ho - 2), rng.randint(4, Wo - 4)
            hm[b, k, y, x] = 1.0
            ind[b, k] = y * Wo + x
            mask[b, k] = 1
            wh[b, k] = rng.uniform(3.0, 8.0, 3)
    hm = np.maximum(hm, rng.rand(*hm.shape).astype(np.float32) * 0.5)
    return {
        "input": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "input_right": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "hm": hm, "ind": ind, "ind_float": ind.astype(np.float32),
        "rot_mask": mask, "wh": wh,
        "reg": rng.rand(B, K, 3).astype(np.float32),
        "dim": rng.rand(B, K, 3).astype(np.float32) + 1.0,
        "orien": rng.rand(B, K, 2).astype(np.float32),
        "depth": ((rng.rand(B, K, 1) * 30 + 5) * mask[..., None]).astype(
            np.float32),
        "kept": (rng.rand(B, K, 6) * 5).astype(np.float32),
        "fb": np.array([380.0, 410.0], np.float32),
    }


def _jax_step(jt, batch, train: bool):
    """Loss, stats, gradients and new batch statistics of the JAX
    trainer's loss function (exact DCN: see the module docstring)."""
    state = jt.state

    def loss_fn(p, bs, b):
        return jt._loss_fn(p, bs, b, train, step=jnp.zeros((), jnp.int32))
    with dcn_mode("exact"):
        (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(state.params, state.batch_stats,
                                    to_jax(batch))
    return {"stats": {k: float(v) for k, v in stats.items()},
            "grads": jax.tree.map(np.asarray, grads),
            "batch_stats": jax.tree.map(np.asarray, new_bs)}


def _port_step(variables, batch, train: bool):
    model = load_port(create_model(Config(**KW)), variables)
    tr = Trainer(Config(**KW), model, steps_per_epoch=2, device="cpu")
    model.train(train)
    with tdc.dcn_mode("windowed", 1):
        total, stats = tr.loss(tr.to_device(batch))
        total.backward()
    return tr, {k: float(v.detach()) for k, v in stats.items()}


@pytest.fixture(scope="module")
def steps():
    """{"train" | "eval": (JAX result, port trainer after one forward +
    backward, port stats)} from the same weights and batch."""
    jm = _jmodel()
    variables = _variables(jm, seed=3)
    batch = _batch(4)
    jt = JTrainer(JConfig(**KW), jm, to_jax(variables), steps_per_epoch=2,
                  mesh=make_mesh(1))
    out = {}
    for mode in ("train", "eval"):
        tr, stats = _port_step(variables, batch, mode == "train")
        out[mode] = (_jax_step(jt, batch, mode == "train"), tr, stats)
    return out


def _gradient_errors(want, tr, floor: float = 0.0):
    """max |port - JAX| / max(max |JAX|, floor * largest gradient of the
    model) per parameter tensor, and the number of tensors whose JAX
    gradient is exactly zero (then so must the port's be)."""
    flat = weights._flatten(want["grads"]["model"])
    top = max(np.abs(v).max() for v in flat.values())
    errs, n_zero = {}, 0
    for key, p in tr.model.named_parameters():
        ref = flat.pop(weights.flax_param_path(key, p.dim()))
        got = (np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy())
        got = weights.param_to_flax(key, got)
        if np.abs(ref).max() == 0:
            assert np.abs(got).max() == 0, key
            n_zero += 1
        else:
            errs[key] = float(np.abs(got - ref).max() /
                              max(np.abs(ref).max(), floor * top))
    assert not flat, f"JAX gradients the port lacks: {sorted(flat)[:5]}"
    lw = tr.loss_weight.grad.numpy()
    errs["loss_weight"] = rel_err(lw, want["grads"]["loss_weight"])
    return errs, n_zero


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_train_step_loss_parts_match(steps, mode):
    want, _, got = steps[mode]
    assert set(got) == set(want["stats"])
    tol = 1e-3 if mode == "train" else 1e-4
    for k, v in want["stats"].items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (k, got[k], v)


def test_train_step_gradients_match(steps):
    """Batch statistics (the train step itself): loose, see the module
    docstring.  The 6 zero gradients are the conv and BatchNorm parameters
    of the two Tree projections whose output nothing reads; JAX computes them for their BatchNorm statistics.  A
    bias that feeds a BatchNorm has a gradient of exactly 0 in exact
    arithmetic (the batch mean removes it): its float residue is held
    against 1e-4 of the model's largest gradient instead."""
    want, tr, _ = steps["train"]
    errs, n_zero = _gradient_errors(want, tr, floor=1e-4)
    assert n_zero == 6, n_zero
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.3, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 3e-2
    assert errs["loss_weight"] <= 1e-3


def test_eval_mode_gradients_match(steps):
    """Running statistics: every backward of the step (losses, heads, cost
    volume, DCN, convs, upsampling) at a well-conditioned point."""
    want, tr, _ = steps["eval"]
    errs, n_zero = _gradient_errors(want, tr)
    assert n_zero == 6, n_zero
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_train_step_batch_stats_match(steps):
    want, tr, _ = steps["train"]
    _, got = weights.to_flax(tr.model.state_dict())
    ref = weights._flatten(want["batch_stats"])
    got = weights._flatten(got)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert rel_err(got[k], v) <= 1e-4, k


def test_interior_init_draws_this_point():
    """side_tpu_torch.runtime.synthetic.interior_init, the point of the
    card-vs-CPU train step in chip_smoke.py, rewrites every parameter and
    BatchNorm statistic with this module's distributions (torch_parity
    `_fill` plus `_window_interior_offsets`): kernel std within 10 % of
    1/sqrt(fan_in) where a tensor has >= 4096 entries, statistics and dy/dx
    biases in their ranges."""
    from side_tpu_torch.runtime.synthetic import interior_init
    cfg = Config(**KW)
    fresh = create_model(cfg, seed=0).state_dict()
    model = create_model(cfg, seed=0)
    interior_init(model, seed=1)
    sd = model.state_dict()
    assert all(not torch.equal(sd[k], v) for k, v in fresh.items()
               if v.numel() > 1), "a tensor kept its initial value"
    n_kernels = 0
    for key, v in sd.items():
        leaf = key.rsplit(".", 1)[-1]
        if "offset_mask" in key:
            if leaf == "bias":
                for part in (v[0::3], v[1::3]):
                    assert ((part > 0.3) & (part < 0.7)).all(), key
            else:
                assert v.abs().max() <= 0.2 / v[0].numel() ** 0.5, key
        elif leaf == "running_var":
            assert ((v >= 0.5) & (v <= 1.5)).all(), key
        elif leaf in ("weight", "kernel") and v.dim() >= 4 and \
                v.numel() >= 4096 and "up_" not in key:
            fan_in = (v[..., 0].numel() if leaf == "kernel"
                      else v[0].numel())
            assert abs(float(v.std()) * fan_in ** 0.5 - 1) <= 0.1, key
            n_kernels += 1
    assert n_kernels > 50


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_bn_train_matches_flax(dtype):
    """FoldedBatchNorm in training mode against the JAX module: output,
    updated running statistics (biased variance, momentum 0.9) and the
    gradients through the batch mean and variance, for a (B, C, H, W)
    input with |mean| well above its spread.  f32: 1e-5 of each tensor's
    max; bf16 input and output: 1e-2 (the output's rounding)."""
    from side_tpu.models.dla import FoldedBatchNorm as JBN
    from side_tpu_torch.models.dla import FoldedBatchNorm
    rng = np.random.RandomState(11)
    x = (rng.randn(4, 6, 5, 7) * 0.5 + rng.randn(1, 6, 1, 1) * 3).astype(
        np.float32)
    g = rng.randn(4, 6, 5, 7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = 1e-5 if dtype == "float32" else 1e-2

    jbn = JBN(use_running_average=False, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)

    def f(params, xin):
        return jbn.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, xin,
                         mutable=["batch_stats"])
    y, mut = f(variables["params"], x_nhwc)
    _, vjp = jax.vjp(lambda p, xin: f(p, xin)[0], variables["params"],
                     x_nhwc)
    dparams, dx = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)).astype(jdt))

    bn = FoldedBatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    yt = bn(xt)
    yt.backward(torch.from_numpy(g).to(tdt))

    def nchw(a):
        return np.asarray(a, np.float32).transpose(0, 3, 1, 2)
    assert yt.dtype == tdt
    assert rel_err(yt.float().detach().numpy(), nchw(y)) <= tol
    assert rel_err(xt.grad.float().numpy(), nchw(dx)) <= tol
    assert rel_err(bn.weight.grad.numpy(), dparams["scale"]) <= tol
    assert rel_err(bn.bias.grad.numpy(), dparams["bias"]) <= tol
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        assert rel_err(getattr(bn, ours).numpy(),
                       mut["batch_stats"][theirs]) <= 1e-6, ours


@pytest.mark.parametrize("lr_step,spe", [((2,), 2), ((10 ** 9, 3), 4)],
                         ids=["boundary_at_4", "clamped_boundary"])
def test_adam_and_schedule_match_optax(lr_step, spe):
    """Identical gradients into optax.adam(piecewise_constant_schedule) and
    the port's Adam, 6 steps: the lr drops at step b = lr_step*spe (steps
    b-1, b, b+1 are inside the run when b = 4); tolerance 1e-6 relative."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    boundaries = {min(e * spe, 2 ** 31 - 1): 0.1 for e in lr_step}
    tx = optax.adam(optax.piecewise_constant_schedule(1e-2, boundaries))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sched = PiecewiseLR(1e-2, lr_step, spe)
    opt = Adam(tp, sched)
    lrs = []
    for step in range(6):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        if step == 2:
            g["b"][:] = 0.0       # a zero gradient still decays the moments
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        lrs.append(opt.step())
        for k in params:
            assert rel_err(tp[k].detach().numpy(), jp[k]) <= 1e-6, (step, k)
    b = min(lr_step[0] * spe, 2 ** 31 - 1)
    want = [1e-2 * (0.1 if s >= b else 1.0) for s in range(6)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    assert sched(2 ** 31 - 1) == pytest.approx(1e-2 * 0.1 ** len(
        {min(e * spe, 2 ** 31 - 1) for e in lr_step}))


def _filled_opt_state(jt, seed):
    """The JAX trainer's optimizer state with random moments and counts."""
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(jt.state.opt_state)
    new = [jnp.asarray(rng.randint(1, 50), l.dtype) if l.ndim == 0 else
           jnp.asarray(rng.randn(*l.shape).astype(np.float32))
           for l in leaves]
    return jax.tree.unflatten(treedef, new)


@pytest.fixture(scope="module")
def ckpt_pair():
    jm = _jmodel()
    variables = _variables(jm, seed=5)
    jt = JTrainer(JConfig(**KW), jm, to_jax(variables), steps_per_epoch=3,
                  mesh=make_mesh(1))
    return jm, variables, jt


def test_checkpoint_from_jax_resumes_in_port(ckpt_pair, tmp_path):
    """A JAX Trainer.save checkpoint resumes in the port with its weights,
    batch statistics, Adam moments and counts, loss_weight and epoch."""
    jm, variables, jt = ckpt_pair
    jt.state = jt.state._replace(opt_state=_filled_opt_state(jt, 1),
                                 params=dict(jt.state.params, loss_weight=(
                                     jnp.arange(7, dtype=jnp.float32))))
    path = str(tmp_path / "jax.npz")
    jt.save(path, epoch=2)

    log = []
    tr = Trainer(Config(**KW), create_model(Config(**KW), seed=9),
                 steps_per_epoch=3, device="cpu")
    with um.patch("builtins.print", lambda *a, **k: log.append(a)):
        start = tr.load(path, resume=True)
    assert start == 2 and tr.step == 6
    assert not [m for m in log if "Skip" in str(m) or "No param" in str(m)]
    np.testing.assert_array_equal(tr.loss_weight.detach().numpy(),
                                  np.arange(7))
    sd = tr.model.state_dict()
    for key, v in weights.from_flax(variables["params"],
                                    variables["batch_stats"]).items():
        np.testing.assert_array_equal(sd[key].numpy(), v.numpy(), key)
    adam, sched = jt.state.opt_state
    assert tr.optimizer.count == int(adam.count)
    assert tr.optimizer.sched_count == int(sched.count)
    assert tr.optimizer.sched_count != tr.optimizer.count
    for table, tree in (("mu", adam.mu), ("nu", adam.nu)):
        flat = weights._flatten(jax.tree.map(np.asarray, tree["model"]))
        got = getattr(tr.optimizer, table)
        for key, p in tr.model.named_parameters():
            ref = flat[weights.flax_param_path(key, p.dim())]
            np.testing.assert_array_equal(
                weights.param_to_flax(key, got[key].numpy()), ref, key)
        np.testing.assert_array_equal(got["loss_weight"].numpy(),
                                      np.asarray(tree["loss_weight"]))


def test_checkpoint_from_port_loads_in_jax(ckpt_pair, tmp_path, capsys):
    """A port Trainer.save checkpoint loads in the JAX package with no
    skipped or missing parameter, and resumes its optimizer there."""
    jm, variables, jt = ckpt_pair
    model = load_port(create_model(Config(**KW)), variables)
    tr = Trainer(Config(**KW), model, steps_per_epoch=3, device="cpu")
    rng = np.random.RandomState(2)
    for table in (tr.optimizer.mu, tr.optimizer.nu):
        for t in table.values():
            t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
    tr.optimizer.count, tr.optimizer.sched_count = 7, 5
    with torch.no_grad():
        tr.loss_weight.copy_(torch.linspace(-1, 1, 7))
    path = str(tmp_path / "port.npz")
    tr.save(path, epoch=4)

    loaded = jckpt.load_checkpoint(path)
    assert loaded["epoch"] == 4 and loaded["dcn_radius"] == 1
    capsys.readouterr()
    merged = jckpt.merge_restore(variables["params"], loaded["params"])
    merged_bs = jckpt.merge_restore(variables["batch_stats"],
                                    loaded["batch_stats"])
    out = capsys.readouterr().out
    assert "Skip" not in out and "No param" not in out and "Drop" not in out
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(
            variables["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(merged_bs), jax.tree.leaves(
            variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jt2 = JTrainer(JConfig(**KW), jm, to_jax(variables), steps_per_epoch=3,
                   mesh=make_mesh(1))
    assert jt2.load(path, resume=True) == 4
    adam, sched = jt2.state.opt_state
    assert (int(adam.count), int(sched.count)) == (7, 5)
    np.testing.assert_array_equal(
        np.asarray(jt2.state.params["loss_weight"]),
        tr.loss_weight.detach().numpy())
    flat = weights._flatten(jax.tree.map(np.asarray, adam.nu["model"]))
    for key, p in tr.model.named_parameters():
        np.testing.assert_array_equal(
            flat[weights.flax_param_path(key, p.dim())],
            weights.param_to_flax(key, tr.optimizer.nu[key].numpy()), key)


def test_train_cli_one_iteration(fixture_root, tmp_path, monkeypatch,
                                 capsys):
    """python -m side_tpu_torch.train on the synthetic fixture, on the CPU:
    one iteration, a validation pass, checkpoints written; max_objs and
    roi_size cut to 4 to keep the CPU run short."""
    import sys
    from side_tpu_torch import train
    from side_tpu_torch.data import dataset
    monkeypatch.setattr(dataset.StereoKitti, "max_objs", 4)
    cli = train.Config.cli
    monkeypatch.setattr(train.Config, "cli", staticmethod(
        lambda argv=None: cli(argv).replace(roi_size=4)))
    # the optional TensorBoard writer imports TensorFlow here (~20 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rc = train.main(["stereo", "--data_dir", fixture_root, "--exp_dir",
                     str(tmp_path), "--input_h", "64", "--input_w", "128",
                     "--batch_size", "2", "--num_epochs", "1",
                     "--num_iters", "1", "--val_intervals", "1",
                     "--num_workers", "1", "--compute_dtype", "float32",
                     "--uncert", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Starting training..." in out and "epoch: 1 |" in out
    exp = tmp_path / "stereo" / "default"
    assert (exp / "model_last.npz").exists()
    assert (exp / "model_best.npz").exists()
    loaded = jckpt.load_checkpoint(str(exp / "model_last.npz"))
    assert loaded["epoch"] == 1 and len(loaded["opt"]) > 2
    assert np.isfinite(loaded["loss_weight"]).all()
