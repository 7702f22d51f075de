"""One training step of the port's resdcn_18 against side_tpu's.

`--arch resdcn_18 --not_cost_volume` (the family has no depth output): the
JAX trainer's loss function (value and gradient) and the port Trainer's
loss + backward from identical random weights and one uint8 batch, 64x128
input (the 1/32 map is 2x4), batch 2, 3 GT slots, f32, DCN windowed R = 1
on both sides with every offset/mask conv sampling inside the window and
away from integer kinks (as in tests/test_torch_train.py).  The three
DeformBlocks run K1 at Cin 512/256/128 and, in the backward, K2 and K3.

Tolerances:
- running statistics, against the JAX network built in float64: loss parts
  1e-5 relative, every gradient 1e-4 of its tensor's largest value;
- batch statistics, against the JAX step in f32: loss parts 1e-3
  relative, updated running statistics 1e-4 of their largest value,
  gradients 0.3 of their tensor's largest value and 3e-2 in the median
  over tensors (batch statistics over few samples amplify f32 sum-order
  noise), the bounds of tests/test_torch_train.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models.resnet_dcn import StereoResNet
from side_tpu.models.stereo_net import init_stereo_net
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.parallel.mesh import make_mesh
from side_tpu.runtime.trainer import Trainer as JTrainer
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.trainer import Trainer

from torch_parity import (gradient_errors, random_variables, rel_err,
                          to_jax, voxel_train_batch, window_interior_offsets)

H, W = 64, 128
RES_KW = dict(input_h=H, input_w=W, compute_dtype="float32",
              arch="resdcn_18", head_conv=64, cost_volume=False,
              max_objs=3, K=3, lr=1e-3)


def _load(model, variables):
    model.load_state_dict(weights.from_flax(variables["params"],
                                            variables["batch_stats"]))
    return model


def _res_variables(seed):
    jm = jcreate(JConfig(**RES_KW))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, 3),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed)
    window_interior_offsets(variables["params"],
                            np.random.RandomState(seed + 100))
    return jm, variables


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else jnp.asarray(a), tree)


@pytest.fixture(scope="module")
def res_steps():
    """{"train" | "eval": (JAX loss parts, gradients and batch statistics,
    the port trainer after loss + backward, its loss parts)}.  With batch
    statistics the JAX step is the f32 one.  With running statistics it is
    the same network built in float64: the trunk's gradients are ~1e-4 of
    the heads' and sums of cancelling terms, where the JAX package's own
    f32 gradient lies up to 1.8 % off its float64 one and the port's f32
    gradient 1.4e-6."""
    jm, variables = _res_variables(7)
    batch = voxel_train_batch(8, 2)
    out = {}
    for mode in ("train", "eval"):
        train = mode == "train"
        with jax.enable_x64(not train), dcn_mode("windowed"):
            if train:
                jv, jb = to_jax(variables), to_jax(batch)
            else:
                jm = StereoResNet(heads=dict(JConfig(**RES_KW).heads),
                                  num_layers=18, head_conv=64,
                                  dtype=jnp.float64)
                jv, jb = _f64(to_jax(variables)), _f64(to_jax(batch))
            jt = JTrainer(JConfig(**RES_KW), jm, jv, steps_per_epoch=2,
                          mesh=make_mesh(1))

            def loss_fn(p, bs, b):
                return jt._loss_fn(p, bs, b, train,
                                   step=jnp.zeros((), jnp.int32))
            (_, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(jt.state.params,
                                        jt.state.batch_stats, jb)
        tr = Trainer(Config(**RES_KW),
                     _load(create_model(Config(**RES_KW)), variables),
                     steps_per_epoch=2, device="cpu")
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
def test_resdcn_step_loss_parts_match_jax(res_steps, mode):
    want, _, _, _, got = res_steps[mode]
    assert set(got) == set(want) and "depth_loss" not in got
    tol = 1e-3 if mode == "train" else 1e-5
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-6), (k, got[k], v)


def test_resdcn_step_gradients_match_jax(res_steps):
    _, grads, _, tr, _ = res_steps["eval"]
    errs = gradient_errors(tr.model, grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst
    _, grads, _, tr, _ = res_steps["train"]
    errs = gradient_errors(tr.model, grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 0.3, worst
    assert np.median(list(errs.values())) <= 3e-2
    # the three DeconvStages' DCN parameters get their gradients
    for i in range(3):
        assert tr.model.get_submodule(
            f"DeconvStage_{i}.DeformBlock_0").kernel.grad.abs().max() > 0


def test_resdcn_step_batch_statistics_match_jax(res_steps):
    _, _, new_bs, tr, _ = res_steps["train"]
    sd = tr.model.state_dict()
    for path, ref in weights._flatten(new_bs).items():
        module, _, leaf = path.rpartition("/")
        got = sd[f"{module.replace('/', '.')}.running_{leaf}"].numpy()
        assert rel_err(got, ref) <= 1e-4, path
