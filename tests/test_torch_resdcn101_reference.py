"""The benchmark's plain reference of the resdcn family
(portbench/reference/arch_resdcn.py, float32, plain torch) against the
port's resdcn_101, on the benchmark's seeded random weights
(portbench/weights.py): a check that the reference the benchmark judges
the port by computes what the port computes.  The reference is a frozen
copy of the port's plain path, so this is not the port's parity test:
tests/test_torch_resdcn101_jax.py holds the port's resdcn_101 against the
JAX package, which builds the network from its own code.

At the published depth and widths (33 bottleneck blocks, 2048 channels
into the first DeformBlock, `head_conv` 64) and a small image, 64x128,
batch 2 pairs, float32, DCN windowed R = 1 on both sides (the weights put
every offset inside the window and off the integer kinks): one training
forward (batch statistics) and its loss and backward, the port through
`Trainer.gradients`, the reference through its own normalisation, target
boxes, model and loss.  Compared: every head's output, every loss part and
the first gradient of one leaf per kind (the stem conv, a bottleneck's
1x1 conv, the first DeformBlock's kernel and its offset/mask conv, the
heatmap head's last conv).

Tolerances.  Both sides run the same float32 operations of one PyTorch on
the CPU in the same order, and every compared number is equal bit for
bit.  The bounds, 1e-5 for the heads (norm of the difference over the
reference's norm) and the loss parts (relative) and 1e-4 for a gradient
(of the reference gradient's norm), hold them to that: a step computed
in another order reads far above them, since 33 blocks of
batch-statistics BatchNorm amplify f32's rounding (~1e-7) to ~5e-3 in the
heads (the JAX package's own f32 step against its float64 one,
test_torch_resdcn101_jax.py).  The same step with the port computing in
bfloat16 misses each of them by orders of magnitude (heads 0.04-1.0, loss
parts 2e-3-0.14, gradients 0.1-1.6): the last test."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import weights as bench_weights
from portbench.reference import float32, model as ref_model
from portbench.reference.decode import boxes_from_targets
from portbench.reference.losses import stereo_loss
from portbench.reference.train import normalize_images, to_device
from portbench.traffic.config import Config as RefConfig
from side_tpu_torch.config import Config
from side_tpu_torch.data.synthetic import scene_batch
from side_tpu_torch.models.factory import create_model
from side_tpu_torch.ops.deform_conv import dcn_mode
from side_tpu_torch.runtime.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 17
SMALL = dict(input_h=64, input_w=128, compute_dtype="float32", max_objs=4,
             K=8)
LEAVES = ("trunk.ConvBN_0.Conv_0.weight",
          "trunk.ResBottleneck_10.ConvBN_0.Conv_0.weight",
          "DeconvStage_0.DeformBlock_0.kernel",
          "DeconvStage_0.DeformBlock_0.offset_mask.weight",
          "hm_out.weight", "hm_out.bias")
HEAD_TOL = 1e-5      # heads' outputs: f32 sum order through 33 blocks
LOSS_TOL = 1e-5      # loss parts, relative
GRAD_TOL = 1e-4      # a leaf's gradient, of the reference gradient's norm
PARTS = ("loss", "hm_loss", "wh_loss", "off_loss", "dim_loss", "orien_loss",
         "kept_loss")


def _keys() -> dict:
    """The configuration's keys as the benchmark runs it, at the small
    size."""
    conf = json.load(open(os.path.join(
        ROOT, "portbench", "configs", "side_resdcn101.json")))
    return dict(conf["config"], **SMALL, batch_size=2)


def _loss_gap(a, b) -> float:
    a, b = float(a.detach()), float(b.detach())
    return abs(a - b) / abs(b)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _keep_output(model, store):
    return model.register_forward_hook(
        lambda m, args, out: store.update(out))


def one_step(**over):
    """(the port's model, (its heads, loss parts, grads), the reference's
    (heads, loss parts, grads)) of one training step; `over` changes the
    port's configuration keys, not the reference's."""
    keys = _keys()
    cfg, rcfg = Config(**dict(keys, **over)), RefConfig(**keys)
    batch = scene_batch(cfg, np.random.RandomState(5), 2, cfg.max_objs)
    w = bench_weights.draw(ref_model.build(rcfg), SEED, "cpu")
    torch.manual_seed(0)
    with dcn_mode("windowed", 1), float32():
        model = create_model(cfg)
        model.load_state_dict(w, strict=True)
        tr = Trainer(cfg, model, steps_per_epoch=1, device="cpu")
        heads = {}
        hook = _keep_output(model, heads)
        tr.model.train()
        stats = tr.gradients(tr.to_device(batch))
        hook.remove()
        port = (heads, stats, {k: tr.params[k].grad for k in LEAVES})

        ref = ref_model.loaded(rcfg, w, "cpu").train()
        b = normalize_images(to_device(batch, "cpu"),
                             torch.tensor(rcfg.mean), torch.tensor(rcfg.std))
        target = boxes_from_targets(b["ind_float"], b["wh"], b["reg"],
                                    rcfg.output_w, rcfg.wh_scale)
        lw = torch.full((7,), -1.0, requires_grad=True)
        out = ref(b, target=target, use_cost_volume=rcfg.cost_volume)
        total, rstats = stereo_loss(out, b, lw, rcfg.grid, rcfg.uncert,
                                    rcfg.cost_volume,
                                    depth_aux_weight=rcfg.depth_aux_weight,
                                    mse_loss=rcfg.mse_loss)
        total.backward()
        params = dict(ref.named_parameters())
        refs = (out, rstats, {k: params[k].grad for k in LEAVES})
    return model, port, refs


@pytest.fixture(scope="module")
def both():
    return one_step()


def test_published_depth_and_widths(both):
    model = both[0]
    blocks = [n for n in model.trunk.names if n.startswith("ResBottleneck")]
    assert len(blocks) == len(model.trunk.names) == 33
    assert model.trunk.out_channels == 2048
    assert model.DeconvStage_0.DeformBlock_0.kernel.shape[-2:] == (2048, 256)
    assert model.hm_conv.weight.shape[0] == 64
    assert sum(p.numel() for p in model.parameters()) == 48_605_575


def test_heads_match_the_reference(both):
    _, (heads, _, _), (ref_heads, _, _) = both
    assert sorted(heads) == sorted(ref_heads) == \
        sorted(Config(**_keys()).heads)
    for name, y in heads.items():
        assert y.shape == ref_heads[name].shape, name
        assert _gap(y, ref_heads[name]) <= HEAD_TOL, name


def test_loss_parts_match_the_reference(both):
    _, (_, stats, _), (_, ref_stats, _) = both
    assert "depth_loss" not in stats
    for k in PARTS:
        assert _loss_gap(stats[k], ref_stats[k]) <= LOSS_TOL, k


@pytest.mark.parametrize("leaf", LEAVES)
def test_first_gradient_matches_the_reference(both, leaf):
    _, (_, _, grads), (_, _, ref_grads) = both
    assert ref_grads[leaf].norm() > 0, leaf
    assert _gap(grads[leaf], ref_grads[leaf]) <= GRAD_TOL, leaf


def test_bfloat16_port_misses_every_tolerance():
    """The control: the port computing in bfloat16 (the benchmark's
    precision) against the float32 reference misses each bound."""
    _, (heads, stats, grads), (ref_heads, ref_stats, ref_grads) = \
        one_step(compute_dtype="bfloat16")
    for name in heads:
        assert _gap(heads[name], ref_heads[name]) > 100 * HEAD_TOL, name
    for k in PARTS:
        assert _loss_gap(stats[k], ref_stats[k]) > 10 * LOSS_TOL, k
    for leaf in LEAVES:
        assert _gap(grads[leaf], ref_grads[leaf]) > 100 * GRAD_TOL, leaf
