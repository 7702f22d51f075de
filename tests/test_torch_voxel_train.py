"""One training step of the port's voxel variant against side_tpu's.

The JAX trainer's loss function (value and gradient) and the port
Trainer's loss + backward from identical random weights and one uint8
batch: 64x128 input, batch 2, 3 GT slots (one invalid), f32,
`--depth_variant voxel`, in training-mode BatchNorm (PointNetDepth's
dropout on, with the mask the JAX step drew at step 0 substituted in the
port) and with running statistics.

As in tests/test_torch_train.py, every offset/mask conv samples inside the
window and away from integer kinks, where the windowed (port, R = 1) and the
exact (JAX side) DCN are the same smooth function: the JAX package's
windowed VJP traces ~6x slower on the CPU (130 s against 22 s for this
step).

PointNetDepth max-pools 1000 points per channel, and ~0.3 % of its maxima
lie within 1e-5 of the runner-up: a 1e-6 change of its input (the two
packages' sum-order difference there) moves the argmax of those channels
and with it its weight gradients by ~2 %.  So the port's step is taken
twice: as it runs, to hold its PointNet input against the JAX one's (1e-5
of the largest value with running statistics, 1e-3 with batch statistics),
and with the JAX step's PointNet input put in its
place (value substituted, gradient passed through), so that both packages
max-pool the same values and the whole backward can be compared tightly.

Tolerances:
- running statistics (eval mode): loss parts 1e-4 relative, every gradient
  1e-3 of its tensor's largest value;
- batch statistics (train mode): loss parts 1e-3 relative, updated running
  statistics 1e-4 of their largest value, gradients 0.3 of their tensor's
  largest value and 3e-2 in the median over tensors, the bounds of
  tests/test_torch_train.py (batch statistics over few samples amplify
  f32 sum-order noise in the deep trunk).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models import voxel_net as jvn
from side_tpu.models.stereo_net import init_stereo_net
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.parallel.mesh import make_mesh
from side_tpu.runtime.trainer import Trainer as JTrainer
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models import voxel_net as tvn
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import (VOXEL_H as H, VOXEL_K as K, VOXEL_W as W,
                          dropout_interceptor, gradient_errors,
                          random_variables, to_jax, voxel_train_batch,
                          window_interior_offsets)

B = 2
KW = dict(input_h=H, input_w=W, compute_dtype="float32", K=K, max_objs=K,
          depth_variant="voxel", lr=1e-3)


def _jax_step(jt, batch, train: bool):
    """Loss parts, gradients, new batch statistics, the dropout masks and
    PointNetDepth's input of the JAX trainer's loss function at step 0."""
    masks, inputs = [], []
    record = dropout_interceptor(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jvn.PointNetDepth):
            jax.debug.callback(lambda a: inputs.append(np.asarray(a)),
                               args[0])
        return record(next_fun, args, kwargs, context)

    def loss_fn(p, bs, b):
        return jt._loss_fn(p, bs, b, train, step=jnp.zeros((), jnp.int32))
    with dcn_mode("exact"), nn.intercept_methods(interceptor):
        (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jt.state.params, jt.state.batch_stats,
                                    to_jax(batch))
        jax.effects_barrier()
    return {"stats": {k: float(v) for k, v in stats.items()},
            "grads": jax.tree.map(np.asarray, grads["model"]),
            "batch_stats": jax.tree.map(np.asarray, new_bs),
            "masks": masks, "pointnet_input": inputs[0]}


def _port_step(variables, batch, train: bool, mask, pointnet_input=None):
    """The port Trainer's loss + backward (no optimizer step) with the
    dropout mask `mask`.  Returns the trainer, the loss parts, the seeds of
    the dropout generators drawn from, and PointNetDepth's input; with
    `pointnet_input` that input's value is replaced by it (its gradient
    passes through to the port's own)."""
    model = create_model(Config(**KW))
    model.load_state_dict(weights.from_flax(variables["params"],
                                            variables["batch_stats"]))
    tr = Trainer(Config(**KW), model, steps_per_epoch=2, device="cpu")
    seeds, seen = [], []

    def keep(shape, rate, gen, dev):
        seeds.append(gen.initial_seed())
        return torch.from_numpy(mask)

    def substitute(module, args):
        seen.append(args[0].detach().numpy().copy())
        if pointnet_input is None:
            return None
        x = args[0]
        return (x + (torch.from_numpy(pointnet_input) - x).detach(),) + \
            tuple(args[1:])
    hook = model.pointNet.register_forward_pre_hook(substitute)
    mp = pytest.MonkeyPatch()
    mp.setattr(tvn, "dropout_keep_mask", keep)
    try:
        model.train(train)
        with tdc.dcn_mode("windowed", 1):
            total, stats = tr.loss(tr.to_device(batch))
            total.backward()
    finally:
        mp.undo()
        hook.remove()
    return tr, {k: float(v.detach()) for k, v in stats.items()}, seeds, \
        seen[0]


@pytest.fixture(scope="module")
def steps():
    jm = jcreate(JConfig(**KW))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, K),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, 10)
    window_interior_offsets(variables["params"], np.random.RandomState(110))
    batch = voxel_train_batch(11, B)
    jt = JTrainer(JConfig(**KW), jm, to_jax(variables), steps_per_epoch=2,
                  mesh=make_mesh(1))
    out = {}
    for mode in ("train", "eval"):
        want = _jax_step(jt, batch, mode == "train")
        mask = want["masks"][0]                  # all kept in eval mode
        _, _, _, own = _port_step(variables, batch, mode == "train", mask)
        tr, stats, seeds, _ = _port_step(variables, batch, mode == "train",
                                         mask, want["pointnet_input"])
        out[mode] = (want, tr, stats, seeds, own)
    return out


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_voxel_step_pointnet_input_matches_jax(steps, mode):
    """What the port feeds PointNetDepth (the K5 samples of both views and
    their difference) against the JAX step's, relative to the largest
    value: 1e-5 with running statistics, 1e-3 with batch statistics (the
    trunk's train-mode noise, as in the loss parts)."""
    want, _, _, _, own = steps[mode]
    ref = want["pointnet_input"]
    tol = 1e-3 if mode == "train" else 1e-5
    assert own.shape == ref.shape == (B * K, 1000, 192)
    assert np.abs(own - ref).max() <= tol * np.abs(ref).max()
    assert (np.abs(ref).sum(-1) > 0).mean() > 0.3   # voxels in the map


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_voxel_step_loss_parts_match_jax(steps, mode):
    want, _, got, seeds, _ = steps[mode]
    assert set(got) == set(want["stats"]) and "depth_loss" in got
    tol = 1e-3 if mode == "train" else 1e-4
    for k, v in want["stats"].items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-6), (k, got[k], v)
    if mode == "train":
        # one dropout draw, from the generator seeded with (seed, step 0)
        assert len(want["masks"]) == 1
        assert want["masks"][0].shape == (B * K, 256)
        assert seeds == [(Config().seed << 32) + 0]
    else:
        assert want["masks"][0].all() and seeds == []


def test_voxel_step_gradients_match_jax_with_running_statistics(steps):
    want, tr, _, _, _ = steps["eval"]
    errs = gradient_errors(tr.model, want["grads"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-3, worst
    assert sum(k.startswith("pointNet.") for k in errs) == 28


def test_voxel_step_gradients_match_jax_with_batch_statistics(steps):
    want, tr, _, _, _ = steps["train"]
    errs = gradient_errors(tr.model, want["grads"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 0.3, worst
    assert np.median(list(errs.values())) <= 3e-2


def test_voxel_step_batch_statistics_match_jax(steps):
    want, tr, _, _, _ = steps["train"]
    flat = weights._flatten(want["batch_stats"])
    sd = tr.model.state_dict()
    for path, ref in flat.items():
        module, _, leaf = path.rpartition("/")
        got = sd[f"{module.replace('/', '.')}.running_{leaf}"].numpy()
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-4, (path, err)
