"""The port's Detector against side_tpu's, end to end on one frame.

Random JAX weights are saved with the JAX package's `save_checkpoint` and
read by the port's `load_npz` (Config.load_model), so the test also covers
the checkpoint format and its DCN radius tag (windowed R=1 on both sides).
One rendered 375x1242 stereo frame, 128x256 input, f32, K=20.  The rows of
both packages must agree to 1e-3 (the box solve and the alignment amplify
the networks' float noise).

Which rows are compared, and whether a row gets cost-volume or disparity
depth, follows the decode order.  So the seed and the heatmap scale are
chosen such that the reference's scores are well apart (> 1e-3) at the two
places where rank matters, rank `cv_topk` and `peak_thresh`, and the test
fails loudly if they are not; the 11 rows above the threshold are then 8
with cost-volume depth and 3 with the disparity fallback.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from side_tpu.config import Config as JConfig
from side_tpu.data.synthetic import _render, default_calib, make_scene
from side_tpu.models import create_model as jcreate
from side_tpu.ops.deform_conv import dcn_mode
from side_tpu.runtime.checkpoint import save_checkpoint
from side_tpu.runtime.detector import Detector as JDetector
from side_tpu_torch.config import Config
from side_tpu_torch.ops import deform_conv as tdc
from side_tpu_torch.runtime.detector import Detector

from torch_parity import H_IN, W_IN, stereo_variables, to_jax

SEED = 1
KW = dict(input_h=H_IN, input_w=W_IN, compute_dtype="float32", K=20,
          cv_topk=8, peak_thresh=0.85)


def _frame():
    p2, p3 = default_calib()
    p0 = p2.copy()
    p0[0, 3] = 0.0
    calib = [p0.tolist(), p3.tolist(), p2.tolist(), p3.tolist()]
    objs = make_scene(np.random.RandomState(0), 3)
    img_l = _render(objs, p2, np.random.RandomState(5))
    img_r = _render(objs, p3, np.random.RandomState(5))
    return img_l, img_r, calib


def test_detector_run_matches_jax(tmp_path):
    jm = jcreate(JConfig(**KW))
    variables = stereo_variables(jm, seed=SEED)
    hm = variables["params"]["hm"]["Conv_1"]          # spread the scores
    hm["kernel"] = hm["kernel"] * 50.0
    hm["bias"] = np.full_like(hm["bias"], -4.0)
    img_l, img_r, calib = _frame()
    ckpt = str(tmp_path / "model.npz")
    with dcn_mode("windowed"):
        save_checkpoint(ckpt, 0, variables["params"],
                        variables["batch_stats"])
        jdet = JDetector(JConfig(**KW), variables=to_jax(variables))
        pre = jdet.load_and_pre((img_l, img_r), calib)
        dets = np.asarray(jdet._process(jdet.variables, pre["batch"])[0])
        want = jdet.run((img_l, img_r), calib=calib)
    scores = dets[0, :, 4]
    kcv = KW["cv_topk"]
    margins = {"cv_topk": scores[kcv - 1] - scores[kcv],
               "peak_thresh": np.abs(scores - KW["peak_thresh"]).min()}
    assert min(margins.values()) > 1e-3, (
        f"seed {SEED}: decode order ambiguous where rank matters "
        f"({margins}); pick another seed")

    prev = tdc.set_dcn_mode("exact")       # the checkpoint must switch it
    try:
        det = Detector(Config(load_model=ckpt, **KW), device="cpu")
        assert tdc.dcn_radius_tag() == 1
        got = det.run((img_l, img_r), calib=calib)
    finally:
        tdc.set_dcn_mode(*prev)
    assert set(got["results"]) == set(want["results"]) == {1, 2, 3}
    n = 0
    for cls in want["results"]:
        w, g = want["results"][cls], got["results"][cls]
        assert g.shape == w.shape, cls
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4)
        n += len(w)
    assert n > kcv          # cost-volume and fallback rows both compared
    for k in ("tot", "load", "pre", "net", "dec", "post", "merge"):
        assert got[k] >= 0


def test_detector_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(Config(**KW))
