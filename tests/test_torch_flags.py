"""The port's `--not_cost_volume` and `--remat` against side_tpu's.

`--not_cost_volume` on the flagship dla_34: the forward stops after the
heads, the trainer drops the depth part, the detector's rows take the
disparity depth.  64x128 input, f32, weights from numpy seeds; the forward
with DCN windowed R = 1 on both sides.  The training step, as in
tests/test_torch_train.py, samples every DCN inside its window and away
from integer kinks, where the windowed (port, R = 1) and the exact (JAX
side, whose VJP traces ~6x faster on the CPU) function are the same.

`--remat` has no JAX counterpart to differ from (nn.remat recomputes the
same function): the port's step with and without it must agree.

Tolerances:
- forward head maps: 1e-4 of their largest value;
- one step with running statistics, against the JAX network built in
  float64: loss parts 1e-5 relative, every gradient 1e-3 of its tensor's
  largest value (the bound of tests/test_torch_train.py) but the stem
  conv's, 2e-3: its weight gradient, a sum of cancelling terms over
  32,768 pixels, shows the port's f32 sum order most (1.6e-3); with batch
  statistics, against the f32 JAX step:
  loss parts 1e-3 relative, updated running statistics 1e-4 of their
  largest value, gradients 0.3 of their tensor's largest value and 3e-2 in
  the median (the bounds of tests/test_torch_train.py);
- --remat against the plain step: loss parts, gradients and running
  statistics equal to 1e-6 of their largest value (the recompute runs the
  same kernels on the same values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models.stereo_net import StereoNet as JStereoNet
from side_tpu.models.stereo_net import init_stereo_net
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.parallel.mesh import make_mesh
from side_tpu.runtime.trainer import Trainer as JTrainer
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models import dla
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.detector import Detector
from side_tpu_torch.runtime.synthetic import kitti_calib, random_frame
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import (gradient_errors, random_variables, rel_err,
                          to_jax, voxel_train_batch, window_interior_offsets)

H, W, K = 64, 128, 3
NCV = dict(input_h=H, input_w=W, compute_dtype="float32", K=K, max_objs=K,
           roi_size=4, cost_volume=False, lr=1e-3)


def _variables(seed, interior: bool):
    jm = jcreate(JConfig(**NCV))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, K),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed)
    if interior:
        window_interior_offsets(variables["params"],
                                np.random.RandomState(seed + 100))
    return jm, variables


def _port(variables, **kw):
    model = create_model(Config(**NCV, **kw))
    model.load_state_dict(weights.from_flax(variables["params"],
                                            variables["batch_stats"]))
    return model


def test_not_cost_volume_forward_matches_jax():
    jm, variables = _variables(1, interior=False)
    rng = np.random.RandomState(2)
    batch = {"input": rng.randn(2, H, W, 3).astype(np.float32),
             "input_right": rng.randn(2, H, W, 3).astype(np.float32),
             "fb": np.array([380.0, 410.0], np.float32)}
    with dcn_mode("windowed"):
        want = jax.jit(lambda v, b: jm.apply(v, b, use_cost_volume=False,
                                             train=False))(
            to_jax(variables), to_jax(batch))
    port = _port(variables).eval()
    with torch.no_grad(), tdc.dcn_mode("windowed", 1):
        got = port({k: torch.from_numpy(v) for k, v in batch.items()},
                   use_cost_volume=False)
    assert set(got) == set(want) == set(JConfig(**NCV).heads)
    for name in want:
        assert rel_err(got[name].numpy(), np.asarray(want[name])) <= 1e-4, \
            name


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else jnp.asarray(a), tree)


@pytest.fixture(scope="module")
def steps():
    """{"train" | "eval": (JAX loss parts, gradients, batch statistics, the
    port trainer after loss + backward, its loss parts)}.  With running
    statistics the JAX network is built in float64, the reference for
    gradients that are sums of cancelling terms."""
    jm, variables = _variables(3, interior=True)
    batch = voxel_train_batch(4, 2)
    out = {}
    for mode in ("train", "eval"):
        train = mode == "train"
        with jax.enable_x64(not train), dcn_mode("exact"):
            jv, jb = to_jax(variables), to_jax(batch)
            if not train:
                jm = JStereoNet(heads=dict(JConfig(**NCV).heads), roi_size=4,
                                max_objs=K, topk=K, input_w=W,
                                dtype=jnp.float64)
                jv, jb = _f64(jv), _f64(jb)
            jt = JTrainer(JConfig(**NCV), jm, jv, steps_per_epoch=2,
                          mesh=make_mesh(1))

            def loss_fn(p, bs, b):
                return jt._loss_fn(p, bs, b, train,
                                   step=jnp.zeros((), jnp.int32))
            (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(jt.state.params,
                                        jt.state.batch_stats, jb)
        tr = Trainer(Config(**NCV), _port(variables), steps_per_epoch=2,
                     device="cpu")
        tr.model.train(train)
        with tdc.dcn_mode("windowed", 1):
            total, got = tr.loss(tr.to_device(batch))
            total.backward()
        out[mode] = ({k: float(v) for k, v in stats.items()},
                     jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  grads["model"]),
                     jax.tree.map(np.asarray, new_bs), tr,
                     {k: float(v.detach()) for k, v in got.items()})
    return out


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_not_cost_volume_loss_parts_match_jax(steps, mode):
    want, _, _, tr, got = steps[mode]
    assert set(got) == set(want) == set(tr.loss_states)
    assert "depth_loss" not in tr.loss_states
    tol = 1e-3 if mode == "train" else 1e-5
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-6), (k, got[k], v)


def test_not_cost_volume_gradients_match_jax(steps):
    _, grads, _, tr, _ = steps["eval"]
    errs = gradient_errors(tr.model, grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 2e-3, worst
    stem = "feature_extraction.base.ConvBN_0.Conv_0.weight"
    assert max(v for k, v in errs.items() if k != stem) <= 1e-3
    _, grads, new_bs, tr, _ = steps["train"]
    errs = gradient_errors(tr.model, grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 0.3, worst
    assert np.median(list(errs.values())) <= 3e-2
    # the depth path's parameters take no part: no gradient in either
    for key, p in tr.model.named_parameters():
        if key.startswith(("feaReduce", "depth_estimator")):
            assert p.grad is None, key
    sd = tr.model.state_dict()
    for path, ref in weights._flatten(new_bs).items():
        module, _, leaf = path.rpartition("/")
        got = sd[f"{module.replace('/', '.')}.running_{leaf}"].numpy()
        assert rel_err(got, ref) <= 1e-4, path


def test_not_cost_volume_detector_takes_the_disparity_depth():
    """Without the depth path the info rows have 9 columns (no network
    depth), and the tail still gives K finite rows of 13."""
    cfg = Config(**dict(NCV, input_h=128, input_w=256))
    det = Detector(cfg, device="cpu", seed=1)
    pre = det.load_and_pre(random_frame(np.random.RandomState(0)),
                           kitti_calib())
    for key in ("p2", "p3", "trans", "trans_inv"):
        assert key in pre["batch"]
    dets, dets_r, info = det.process(pre["batch"])
    assert info.shape == (1, K, 9)
    out = det.network(pre["batch"])
    assert "depth" not in out
    pending = det.dispatch(pre)
    rows = pending["handles"][0]
    assert tuple(rows.shape) == (K, 13) and bool(torch.isfinite(rows).all())
    det.finish(pending)


# ------------------------------------------------------------------ remat
def _remat_step(remat: bool):
    cfg = Config(input_h=H, input_w=W, compute_dtype="float32", K=K,
                 max_objs=K, roi_size=4, lr=1e-3, remat=remat)
    from side_tpu_torch.runtime.synthetic import interior_init
    model = create_model(cfg, seed=5)
    interior_init(model, seed=6)
    assert model.remat is remat
    tr = Trainer(cfg, model, steps_per_epoch=2, device="cpu")
    calls = []
    orig = dla.FeatureExtractor.forward

    def counted(self, x):
        calls.append(dla._frozen_statistics)
        return orig(self, x)
    mp = pytest.MonkeyPatch()
    mp.setattr(dla.FeatureExtractor, "forward", counted)
    try:
        tr.model.train()
        total, stats = tr.loss(tr.to_device(voxel_train_batch(7, 2)))
        total.backward()
    finally:
        mp.undo()
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()
             if p.grad is not None}
    running = {k: v.clone() for k, v in tr.model.state_dict().items()
               if "running_" in k}
    return ({k: float(v.detach()) for k, v in stats.items()}, grads,
            running, calls)


def test_remat_step_equals_the_plain_step():
    """With --remat the feature extractor runs twice (the forward and the
    backward's recompute, the second with frozen statistics); loss parts,
    gradients and running statistics equal the plain step's, so the
    statistics blend once."""
    want_s, want_g, want_r, plain_calls = _remat_step(False)
    got_s, got_g, got_r, remat_calls = _remat_step(True)
    assert plain_calls == [False] and remat_calls == [False, True]
    for k, v in want_s.items():
        assert abs(got_s[k] - v) <= 1e-6 * max(abs(v), 1e-6), k
    assert set(got_g) == set(want_g)
    for k, v in want_g.items():
        assert rel_err(got_g[k].numpy(), v.numpy()) <= 1e-6, k
    fresh = create_model(Config(input_h=H, input_w=W), seed=5).state_dict()
    moved = 0
    for k, v in want_r.items():
        assert rel_err(got_r[k].numpy(), v.numpy()) <= 1e-6, k
        moved += not torch.equal(v, fresh[k])
    assert moved == len(want_r)


def test_remat_is_off_outside_training_with_gradients():
    """In eval mode or under no_grad the --remat model runs the feature
    extractor once, as the plain one."""
    cfg = Config(input_h=H, input_w=W, compute_dtype="float32", K=K,
                 roi_size=4, remat=True)
    model = create_model(cfg, seed=5)
    calls = []
    model.feature_extraction.register_forward_hook(
        lambda m, i, o: calls.append(None))
    batch = {"input": torch.randn(1, H, W, 3),
             "input_right": torch.randn(1, H, W, 3),
             "fb": torch.tensor([380.0])}
    with torch.no_grad():
        model.train()(batch)
    model.eval()(batch)
    assert len(calls) == 2
