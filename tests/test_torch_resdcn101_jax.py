"""One training step of the port's resdcn_101 against side_tpu's.

The published depth and widths (`--arch resdcn_101 --not_cost_volume`,
`head_conv` 64: 33 bottleneck blocks (3, 4, 23, 3), each 1x1 -> 3x3 -> 1x1
with the stride on the 3x3 and a projection on each stage's first block,
2048 channels into the first DeformBlock) at a small image, 64x128 (the
1/32 map is 2x4), batch 2, 3 GT slots, f32, DCN windowed R = 1 on both
sides with every offset/mask conv sampling inside the window and away from
integer kinks (tests/torch_parity.py:window_interior_offsets).  Both
packages build the network from their own code, load the same random
weights and run their own trainer's loss: the JAX Trainer's `_loss_fn`
(value and gradient) and the port Trainer's loss + backward.  Compared:
every head's output, every loss part, every parameter's gradient, and
with batch statistics the updated running statistics.

Tolerances, each from the f32 noise the JAX package itself shows at this
depth (its f32 step against its float64 one, same weights and batch):
- running statistics, against the JAX network built in float64: heads
  1e-5 of their largest value and loss parts 1e-5 relative (the port reads
  <= 1e-6); the gradients of every leaf outside the trunk (heads, the three
  up-stages, the DeformBlocks at Cin 2048 / 256 / 128 and their offset
  convs) 1e-4 of the tensor's largest value (it reads <= 3e-6); the
  trunk's, sums of cancelling terms ~1e-4 of the heads', 0.1 in the worst
  tensor and 5e-3 in the median (it reads 0.019 and 7e-4: on a CPU whose
  oneDNN convolutions round the weight gradient below f32, 5e-4 in the
  median leaf against 2e-6 with oneDNN off; the JAX package's own f32
  reads 1.5e-3 and 1e-6);
- batch statistics, against the JAX step in f32: 33 blocks of
  batch-statistics BatchNorm amplify f32's rounding ~1e4-fold at this
  depth, so that the JAX package's own f32 step lies 3.6e-3 off its
  float64 one in the heads, 7e-4 in the loss parts and 0.09 in the median
  gradient (0.39 in the worst).  Heads 3e-2 of their largest value, loss
  parts 1e-2 relative, the median gradient 0.3 (the port reads 6e-3,
  1.6e-3 and 0.15); no bound on the worst gradient, which is noise; the
  updated running statistics, a tenth of the batch's blended in, 1e-3 of
  their largest value (the port reads ~1e-4 in the deepest blocks).
A bottleneck built otherwise (the stride on the first 1x1, a projection
missing or misplaced) or BatchNorm on the wrong statistics moves the heads
by O(1).
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
              arch="resdcn_101", head_conv=64, cost_volume=False,
              max_objs=3, K=3, lr=1e-3)
# mode: (heads, loss parts, gradient outside the trunk, worst trunk
# gradient, median gradient)
TOL = {"eval": (1e-5, 1e-5, 1e-4, 0.1, 5e-3),
       "train": (3e-2, 1e-2, None, None, 0.3)}


class _KeepOutput:
    """The model the JAX Trainer applies, keeping the heads of its last
    apply (traced values of the enclosing jit)."""

    def __init__(self, model):
        self.model, self.out = model, None

    def apply(self, *args, **kw):
        res = self.model.apply(*args, **kw)
        self.out = res[0] if isinstance(res, tuple) else res
        return res


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else jnp.asarray(a), tree)


def _jax_step(jm, variables, batch, train):
    """(heads, loss parts, gradients, updated batch statistics) of the JAX
    Trainer's loss function."""
    jt = JTrainer(JConfig(**RES_KW), jm, variables, steps_per_epoch=2,
                  mesh=make_mesh(1))
    keep = _KeepOutput(jt.model)
    jt.model = keep

    def loss_fn(p, bs, b):
        total, aux = jt._loss_fn(p, bs, b, train,
                                 step=jnp.zeros((), jnp.int32))
        return total, (aux, keep.out)
    (_, ((stats, new_bs), heads)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jt.state.params, jt.state.batch_stats, batch)
    return ({k: np.asarray(v, np.float64) for k, v in heads.items()},
            {k: float(v) for k, v in stats.items()},
            jax.tree.map(lambda a: np.asarray(a, np.float32),
                         grads["model"]),
            jax.tree.map(np.asarray, new_bs))


def _steps():
    """{"train" | "eval": (JAX heads, loss parts, gradients, batch
    statistics; the port trainer after loss + backward, its heads, its loss
    parts)}."""
    jm = jcreate(JConfig(**RES_KW))
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, H, W, 3),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, 11)
    window_interior_offsets(variables["params"], np.random.RandomState(111))
    batch = voxel_train_batch(8, 2)
    out = {}
    for mode in ("train", "eval"):
        train = mode == "train"
        with jax.enable_x64(not train), dcn_mode("windowed"):
            if train:
                want = _jax_step(jm, to_jax(variables), to_jax(batch), True)
            else:
                jm64 = StereoResNet(heads=dict(JConfig(**RES_KW).heads),
                                    num_layers=101, head_conv=64,
                                    dtype=jnp.float64)
                want = _jax_step(jm64, _f64(to_jax(variables)),
                                 _f64(to_jax(batch)), False)
        model = create_model(Config(**RES_KW))
        model.load_state_dict(weights.from_flax(variables["params"],
                                                variables["batch_stats"]))
        tr = Trainer(Config(**RES_KW), model, steps_per_epoch=2,
                     device="cpu")
        tr.model.train(train)
        heads = {}
        hook = tr.model.register_forward_hook(
            lambda m, args, y: heads.update(y))
        with tdc.dcn_mode("windowed", 1):
            total, got = tr.loss(tr.to_device(batch))
            total.backward()
        hook.remove()
        out[mode] = want + (tr, {k: v.detach().double().numpy()
                                 for k, v in heads.items()},
                            {k: float(v.detach()) for k, v in got.items()})
    return out


@pytest.fixture(scope="module")
def steps():
    return _steps()


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resdcn101_heads_match_jax(steps, mode):
    want, got = steps[mode][0], steps[mode][5]
    assert sorted(got) == sorted(want) == sorted(Config(**RES_KW).heads)
    for name, y in want.items():
        g = got[name]
        if g.ndim == 4 and g.shape != y.shape:     # NCHW against NHWC
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == y.shape, name
        assert rel_err(g, y) <= TOL[mode][0], (name, rel_err(g, y))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resdcn101_loss_parts_match_jax(steps, mode):
    want, got = steps[mode][1], steps[mode][6]
    assert set(got) == set(want) and "depth_loss" not in got
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL[mode][1] * max(abs(v), 1e-6), \
            (k, got[k], v)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resdcn101_gradients_match_jax(steps, mode):
    grads, tr = steps[mode][2], steps[mode][4]
    _, _, near, trunk, median = TOL[mode]
    errs = gradient_errors(tr.model, grads)
    assert np.median(list(errs.values())) <= median
    if near is not None:
        worst = max(((k, v) for k, v in errs.items()
                     if not k.startswith("trunk.")), key=lambda kv: kv[1])
        assert worst[1] <= near, worst
        worst = max(((k, v) for k, v in errs.items()
                     if k.startswith("trunk.")), key=lambda kv: kv[1])
        assert worst[1] <= trunk, worst
    # the first DeformBlock (Cin 2048) and every bottleneck's 3x3 get
    # their gradients
    for name in ["DeconvStage_0.DeformBlock_0"] + [
            f"trunk.{n}.ConvBN_1.Conv_0" for n in tr.model.trunk.names]:
        sub = tr.model.get_submodule(name)
        w = sub.kernel if hasattr(sub, "kernel") else sub.weight
        assert w.grad.abs().max() > 0, name


def test_resdcn101_batch_statistics_match_jax(steps):
    new_bs, tr = steps["train"][3], steps["train"][4]
    sd = tr.model.state_dict()
    errs = {}
    for path, ref in weights._flatten(new_bs).items():
        module, _, leaf = path.rpartition("/")
        got = sd[f"{module.replace('/', '.')}.running_{leaf}"].numpy()
        errs[path] = rel_err(got, ref)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-3, worst
