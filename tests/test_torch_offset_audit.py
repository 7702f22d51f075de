"""The port's offset audit (side_tpu_torch/tools/offset_audit.py) against
side_tpu on the CPU: a small flagship (128x256, f32, K 12), random weights
whose offset convs reach beyond +-1, one rendered frame; DCN mode named on
both sides.

The reference is the JAX package's own DeformBlock computation, not
tools/offset_audit.py (which captures `_OffsetMaskParams`' parameters and
slices channels 0:18 of the per-tap interleaved [dy, dx, mask logit]
layout): each JAX DeformBlock's input is captured with
`flax.linen.intercept_methods`, put through its `offset_mask` parameters,
split (9, 3) and the [..., 0:2] kept.  Statistics to 1e-5 relative (the
shares beyond 1 and 2 to one value of the layer), the clamped-vs-exact
deltas to 1e-4.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from side_tpu.config import Config as JConfig
from side_tpu.models import create_model as jcreate
from side_tpu.models.dla import DeformBlock as JDeformBlock
from side_tpu.ops.deform_conv import dcn_mode as jdcn_mode
from side_tpu_torch import weights
from side_tpu_torch.config import Config
from side_tpu_torch.data.synthetic import val_scenes
from side_tpu_torch.ops import deform_conv as dc
from side_tpu_torch.runtime import checkpoint
from side_tpu_torch.runtime.detector import Detector
from side_tpu_torch.tools import offset_audit

from torch_parity import load_port, stereo_variables, to_jax

KW = dict(input_h=128, input_w=256, compute_dtype="float32", K=12,
          cv_topk=6)
SEED = 1


def _spread(variables):
    """Heatmap logits spread apart, so that both packages decode the same
    top-K order in both passes (tests/test_torch_stereo_net.py)."""
    hm = variables["params"]["hm"]["Conv_1"]
    hm["kernel"] = hm["kernel"] * 50.0
    hm["bias"] = np.full_like(hm["bias"], -6.0)
    return variables


@pytest.fixture(scope="module")
def setup():
    jm = jcreate(JConfig(**KW))
    variables = _spread(stereo_variables(jm, seed=SEED))
    det = Detector(Config(**KW), device="cpu")
    load_port(det.model, variables)
    frames = val_scenes(1, seed=3)
    return jm, variables, det, frames


def _jax_forward(jm, variables, batch, mode):
    """The JAX network in `mode`; returns (outputs, [(module path, the
    DeformBlock's input)]) in call order."""
    paths = []

    def run(v, b):
        xs = []

        def spy(next_fun, args, kwargs, context):
            if (isinstance(context.module, JDeformBlock)
                    and context.method_name == "__call__"):
                paths.append(".".join(context.module.path))
                xs.append(args[0])
            return next_fun(*args, **kwargs)
        with nn.intercept_methods(spy):
            out = jm.apply(v, b, use_cost_volume=True, target=None,
                           train=False)
        return out, xs
    with jdcn_mode(mode):
        out, xs = jax.jit(run)(to_jax(variables), to_jax(batch))
    return ({k: np.asarray(v) for k, v in out.items()},
            list(zip(paths, [np.asarray(x) for x in xs])))


def _jax_offsets(variables, path, x):
    """The block's offsets from its input, through its offset_mask
    parameters, split per tap (9, 3), [..., 0:2]."""
    node = variables["params"]
    for p in path.split("."):
        node = node[p]
    w, b = node["offset_mask"]["kernel"], node["offset_mask"]["bias"]
    om = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b)
    B, H, W, _ = om.shape
    return np.asarray(om).reshape(B, H, W, 9, 3)[..., 0:2]


def _normalised_batch(det, frame):
    _, images, calib = frame
    batch = det.load_and_pre(images, calib)["batch"]
    return {"input": det._normalise(batch["input"]).numpy(),
            "input_right": det._normalise(batch["input_right"]).numpy(),
            "fb": batch["fb"].numpy()}


@pytest.fixture(scope="module")
def audited(setup):
    jm, variables, det, frames = setup
    with dc.dcn_mode("windowed", 1):
        out = offset_audit.audit(det, frames)
    assert dc.get_dcn_mode() == "windowed"
    batch = _normalised_batch(det, frames[0])
    ref = {mode: _jax_forward(jm, variables, batch, mode)
           for mode in ("windowed", "exact")}
    return out, ref, variables


def test_layer_statistics_match_jax_deformblocks(audited):
    out, ref, variables = audited
    _, blocks = ref["windowed"]
    assert out["stats_pass"] == "windowed" and out["frames"] == 1
    assert list(out["layers"]) == [p for p, _ in blocks]
    assert len(blocks) == 16
    for path, x in blocks:
        off = np.abs(_jax_offsets(variables, path, x)).reshape(-1)
        got = out["layers"][path]
        for key, want in (("max", off.max()),
                          ("p99", np.percentile(off, 99))):
            assert abs(got[key] - want) <= 1e-5 * abs(want), (path, key)
        for key, bound in (("pct_gt1", 1.0), ("pct_gt2", 2.0)):
            want = 100.0 * (off > bound).sum() / off.size
            assert abs(got[key] - want) <= max(1e-5 * want,
                                               100.0 / off.size), (path, key)
    assert out["global_max"] == max(st["max"] for st in out["layers"].values())
    assert out["global_max"] > 2.0        # the weights reach past the clamp


def test_clamped_vs_exact_deltas_match_jax(audited):
    out, ref, _ = audited
    (row,) = out["deltas"]
    want_w, want_e = ref["windowed"][0], ref["exact"][0]
    sig = lambda a: 1 / (1 + np.exp(-a.astype(np.float64)))  # noqa: E731
    hm = np.abs(sig(want_e["hm"]) - sig(want_w["hm"])).max()
    depth = np.abs(want_e["depth"] - want_w["depth"]).max()
    assert abs(row["hm"] - hm) <= 1e-4, (row, hm)
    assert abs(row["depth"] - depth) <= 1e-4 * max(1.0, depth), (row, depth)
    assert row["hm"] > 1e-3        # the clamp changes this network's output


def test_mask_logits_are_not_offsets(setup):
    """Large mask logits, small offsets: the reported max stays the
    offsets' (channel layout per tap [dy, dx, logit]; a 0:18 slice would
    report the logits)."""
    _, _, det, frames = setup
    saved = {k: v.clone() for k, v in det.model.state_dict().items()}
    try:
        with torch.no_grad():
            for name, m in det.model.named_modules():
                if name.endswith("offset_mask"):
                    m.weight.zero_()
                    bias = torch.zeros(27)
                    bias[0::3], bias[1::3], bias[2::3] = 0.25, -0.125, 12.0
                    m.bias.copy_(bias)
        out = offset_audit.audit(det, frames)
    finally:
        det.model.load_state_dict(saved)
    for st in out["layers"].values():
        assert st["max"] == pytest.approx(0.25)
        assert st["pct_gt1"] == st["pct_gt2"] == 0.0
    assert out["global_max"] == pytest.approx(0.25)


def test_exact_tagged_checkpoint_keeps_the_clamped_pass_windowed(
        setup, tmp_path, monkeypatch, capsys):
    """An exact-trained checkpoint (meta::dcn_radius = -1) through the CLI:
    the clamped pass still runs at R = 1, the exact pass at R = -1, and the
    mode in force is the caller's afterwards.  Without the keep rule the
    Detector would switch to exact (shown at the end)."""
    _, _, det, _ = setup
    ckpt = str(tmp_path / "exact.npz")
    params, stats = weights.to_flax(det.model.state_dict())
    with dc.dcn_mode("exact"):
        checkpoint.save_checkpoint(ckpt, 1, params, stats)
    radii = []
    plain = dc.deform_conv_plain

    def spy(x, offset, mask, weight, bias=None, radius=1):
        radii.append(radius)
        return plain(x, offset, mask, weight, bias, radius)
    monkeypatch.setattr(dc, "deform_conv_plain", spy)
    with dc.dcn_mode("windowed", 1):
        rc = offset_audit.main(
            ["stereo", "--load_model", ckpt, "--device", "cpu",
             "--num_images", "1", "--input_h", "128", "--input_w", "256",
             "--K", "12", "--cv_topk", "6", "--compute_dtype", "float32"])
        assert rc == 0
        assert dc.dcn_radius_tag() == 1
    printed = capsys.readouterr().out
    assert "trained with DCN exact" in printed and "as the caller set" \
        in printed
    assert radii == [1] * 16 + [-1] * 16
    assert "windowed pass; radius clamp = 1" in printed
    # the default rule switches: the audit's keep is what holds the mode
    with dc.dcn_mode("windowed", 1):
        Detector(Config(**KW, load_model=ckpt), device="cpu")
        assert dc.dcn_radius_tag() == -1


def test_capture_matches_the_block_conv(setup):
    """The pre-hook's offsets are the block's own offset/mask conv of its
    input, and the capture leaves the model's output as it was."""
    _, _, det, frames = setup
    _, images, calib = frames[0]
    batch = det.load_and_pre(images, calib)["batch"]
    inputs, got = {}, {}
    handles = [m.register_forward_pre_hook(
        functools.partial(lambda n, mod, args: inputs.setdefault(
            n, args[0].clone()), name))
        for name, m in det.model.named_modules()
        if isinstance(m, offset_audit.DeformBlock)]
    try:
        with offset_audit.capture_offsets(det.model,
                                          lambda n, o: got.setdefault(n, o)):
            out = det.network(batch)
    finally:
        for h in handles:
            h.remove()
    assert list(got) == list(inputs) and len(got) == 16
    name = next(iter(got))
    block = det.model.get_submodule(name)
    with torch.no_grad():
        om = torch.nn.functional.conv2d(inputs[name],
                                        block.offset_mask.weight,
                                        block.offset_mask.bias, padding=1)
    want = om.permute(0, 2, 3, 1).reshape(*om.shape[:1], *om.shape[2:],
                                          9, 3)[..., 0:2]
    torch.testing.assert_close(got[name], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(det.network(batch)["hm"], out["hm"],
                               rtol=0, atol=0)
