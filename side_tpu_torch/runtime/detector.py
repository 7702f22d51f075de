"""Inference engine with per-stage timing (port of
side_tpu/runtime/detector.py).

`load_and_pre` runs the host stages (image load, affine warp to the input
size, uint8); `dispatch` enqueues the device work — normalisation, the
network, sigmoid + `ddd_decode`, and the fused tail — without waiting;
`finish` waits (`torch.cuda.synchronize()` fences), fetches one (K, 13)
array and applies the score filter.  `run` does the three.
`dispatch_batch` / `finish_batch` do the same for a group of frames: one
pass of the network and one tail over the frame axis.  With
SIDE_TPU_TORCH_HOST_TAIL=1 `dispatch` stops after the decode and `finish`
runs the host tail (`postprocess/post_process.py:process_frame`).

Every arch of the factory that takes the stereo batch runs here; with
`--not_cost_volume` the network stops after the heads and the info rows
carry no depth column, so the tail takes the disparity depth.

The Detector runs on `cuda` unless the caller passes `device="cpu"`; with
no CUDA device and no explicit device it raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data import geometry as G
from ..data.dataset import warp_affine
from ..models.factory import check_stereo_model, create_model
from ..ops import decode as dec
from ..ops import deform_conv as dc
from ..postprocess.device_tail import (bucket_results, run_tail,
                                       run_tail_batch)
from ..postprocess.post_process import process_frame
from .. import weights


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: side_tpu_torch runs on the GPU; pass "
                "device='cpu' to run the plain CPU path explicitly")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def ieee_f32():
    """TF32 off in matmuls and cuDNN convolutions (PyTorch's default has
    it on in cuDNN), restored on exit: f32 as the JAX package runs it on
    the CPU."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, prev):
            f.allow_tf32 = v


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _imread(path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("reading image files needs OpenCV (cv2); pass "
                           "the frames as arrays instead") from e
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


class Detector:
    def __init__(self, cfg: Config, device=None, seed: int = 0,
                 keep_dcn_mode: bool = False):
        """`keep_dcn_mode`: load `cfg.load_model` keeping the DCN mode in
        force, with a warning where the checkpoint's radius differs (the
        JAX package's rule), instead of switching to the checkpoint's.
        `cfg.reference_exact` sets exact mode (unless SIDE_TPU_TORCH_DCN
        pins one) and keeps the mode in force on load, as the JAX package
        does."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.reference_exact:
            dc.apply_reference_exact()
        model = create_model(cfg, seed=seed)
        check_stereo_model(model, cfg)
        if cfg.load_model:
            weights.load_npz(model, cfg.load_model,
                             keep_dcn_mode=keep_dcn_mode
                             or cfg.reference_exact)
        self.model = model.to(self.device).eval()
        self.mean = torch.tensor(cfg.mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(cfg.std, dtype=torch.float32,
                                device=self.device)

    # -------------------------------------------------------------- stages
    def pre_process(self, image, image_right, calib):
        cfg = self.cfg
        height, width = image.shape[:2]
        c = np.array([width / 2.0, height / 2.0], np.float32)
        if cfg.keep_res:
            s = np.array([cfg.input_w, cfg.input_h], np.int32)
        else:
            s = np.array([width, height], np.int32)
        trans = G.get_affine_transform(c, s, 0, [cfg.input_w, cfg.input_h])

        def prep(im):
            return warp_affine(im, trans, cfg.input_w, cfg.input_h)[None]

        trans_out = G.get_affine_transform(
            c, s, 0, [cfg.output_w, cfg.output_h])
        trans_inv = G.get_affine_transform(
            c, s, 0, [cfg.output_w, cfg.output_h], inv=True)
        meta = {"c": c, "s": s, "calib": calib, "trans": trans_out,
                "trans_inv": trans_inv}
        return prep(image), prep(image_right), meta

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> normalised float32, on the device."""
        if x.dtype == torch.uint8:
            return (x.float() / 255.0 - self.mean) / self.std
        return x

    @torch.inference_mode()
    def network(self, batch: Dict[str, torch.Tensor]):
        """Normalisation + the network on the device: its output dict."""
        batch = dict(batch)
        batch["input"] = self._normalise(batch["input"])
        batch["input_right"] = self._normalise(batch["input_right"])
        return self.model(batch, use_cost_volume=self.cfg.cost_volume)

    @torch.inference_mode()
    def decode(self, out: Dict[str, torch.Tensor]):
        """Sigmoid + ddd_decode of the network's output: (dets, dets_r,
        info (B, K, 10)), or info (B, K, 9) without the depth path."""
        hm = torch.sigmoid(out["hm"])
        dets, dets_r, info = dec.ddd_decode(
            hm, out["kept_type"], out["dim"], out["orien"], out["wh"],
            out["reg"], grid_size=self.cfg.grid, K=self.cfg.K)
        if self.cfg.cost_volume:
            info = torch.cat([info, out["depth"]], dim=2)
        return dets, dets_r, info

    def process(self, batch: Dict[str, torch.Tensor]):
        """Network + decode on the device: (dets, dets_r, info)."""
        return self.decode(self.network(batch))

    def merge_outputs(self, results: Dict[int, np.ndarray]):
        """Per-class peak_thresh filter."""
        out = {}
        for cls, rows in results.items():
            rows = np.asarray(rows)
            out[cls] = rows[rows[:, -1] > self.cfg.peak_thresh] \
                if len(rows) else rows
        return out

    # --------------------------------------------------- pipelined stages
    def load_and_pre(self, images_or_paths, calib):
        """Host stages: image load + affine pre-process.  The batch carries
        the images, fb, the projections P2 / P3 and the output-resolution
        affines (what the voxel variant projects its voxels with)."""
        t0 = time.time()
        if isinstance(images_or_paths, (list, tuple)) and \
                isinstance(images_or_paths[0], str):
            image = _imread(images_or_paths[0])
            image_right = _imread(images_or_paths[1])
        else:
            image, image_right = images_or_paths
        t_load = time.time()
        inp, inp_right, meta = self.pre_process(image, image_right, calib)
        dev = self.device
        p2 = np.asarray(calib[2], np.float64).reshape(3, 4)
        p3 = np.asarray(calib[3], np.float64).reshape(3, 4)
        batch = {
            "input": torch.from_numpy(inp).to(dev),
            "input_right": torch.from_numpy(inp_right).to(dev),
            "fb": torch.tensor([p2[0, 3] - p3[0, 3]], dtype=torch.float32,
                               device=dev),
        }
        for key, a in (("p2", p2), ("p3", p3), ("trans", meta["trans"]),
                       ("trans_inv", meta["trans_inv"])):
            batch[key] = torch.tensor(np.asarray(a, np.float32)[None],
                                      device=dev)
        t_pre = time.time()
        return {"batch": batch, "meta": meta, "image": image,
                "image_right": image_right, "t0": t0,
                "load": t_load - t0, "pre": t_pre - t_load}

    @torch.inference_mode()
    def dispatch(self, pre, run_align: bool = True) -> Dict:
        """Enqueue the network, decode and fused tail without waiting.
        With SIDE_TPU_TORCH_HOST_TAIL=1 the tail is left to `finish`, which
        then runs it on the host."""
        t = time.time()
        dets, dets_r, info = self.process(pre["batch"])
        if os.environ.get("SIDE_TPU_TORCH_HOST_TAIL", "0") == "1":
            pre.update(handles=(dets, dets_r, info), fused=False,
                       run_align=run_align, t_dispatch=time.time() - t)
            return pre
        rows, classes = run_tail(dets[0], dets_r[0], info[0], pre["image"],
                                 pre["image_right"], pre["meta"], self.cfg,
                                 run_align=run_align)
        pre.update(handles=(rows, classes), fused=True, run_align=run_align,
                   t_dispatch=time.time() - t)
        return pre

    def _bucket(self, rows: np.ndarray, classes: np.ndarray):
        return bucket_results(rows, classes,
                              rows[:, 12] > self.cfg.peak_thresh,
                              self.cfg.num_classes)

    def finish(self, pending, run_align=None) -> Dict:
        """Wait for the device, fetch the rows, filter by score.  A
        `run_align` that differs from the dispatch's re-dispatches the frame.

        `net` is the host time from dispatch to the device's end (enqueue +
        wait): eager PyTorch may block while enqueueing, so the wait alone
        would under-count the device program."""
        if run_align is not None and run_align != pending["run_align"] \
                and pending["fused"]:
            pending = self.dispatch(pending, run_align=run_align)
        t_net0 = time.time()
        _sync(self.device)
        t_net = time.time()
        if pending["fused"]:
            rows, classes = (h.cpu().numpy() for h in pending["handles"])
            t_dec = time.time()
            results = self._bucket(rows, classes)
        else:
            dets, dets_r, info = (h[0].float().cpu().numpy()
                                  for h in pending["handles"])
            t_dec = time.time()
            results = process_frame(
                dets, dets_r, info, pending["meta"], self.cfg,
                img_left=pending["image"], img_right=pending["image_right"],
                run_align=pending["run_align"])
        t_post = time.time()
        results = self.merge_outputs(results)
        t_end = time.time()
        return {
            "results": results,
            "tot": t_end - pending["t0"], "load": pending["load"],
            "pre": pending["pre"],
            "net": pending["t_dispatch"] + (t_net - t_net0),
            "dec": t_dec - t_net, "post": t_post - t_dec,
            "merge": t_end - t_post,
        }

    # --------------------------------------------------- batched pipeline
    @torch.inference_mode()
    def dispatch_batch(self, pres, run_align: bool = True) -> Dict:
        """Batched dispatch: one pass of the network + decode over B frames
        (2B images through the trunk) and one tail over the frame axis.
        `pres` is a list of `load_and_pre` outputs."""
        t = time.time()
        batch = {k: torch.cat([p["batch"][k] for p in pres], dim=0)
                 for k in pres[0]["batch"]}
        dets, dets_r, info = self.process(batch)
        rows, classes = run_tail_batch(
            dets, dets_r, info,
            [p["image"] for p in pres], [p["image_right"] for p in pres],
            [p["meta"] for p in pres], self.cfg, run_align=run_align)
        return {"handles": (rows, classes), "pres": pres,
                "t_dispatch": time.time() - t}

    def finish_batch(self, pending) -> list:
        """Fetch the batched rows; returns one result dict per frame, the
        group's net and dec times shared out evenly."""
        pres = pending["pres"]
        t_net0 = time.time()
        _sync(self.device)
        t_net = time.time()
        rows_b, classes_b = (h.cpu().numpy() for h in pending["handles"])
        t_dec = time.time()
        net = pending["t_dispatch"] + (t_net - t_net0)
        outs = []
        for pre, rows, classes in zip(pres, rows_b, classes_b):
            results = self._bucket(rows, classes)
            t_post = time.time()
            results = self.merge_outputs(results)
            t_end = time.time()
            outs.append({
                "results": results,
                "tot": t_end - pre["t0"], "load": pre["load"],
                "pre": pre["pre"], "net": net / len(pres),
                "dec": (t_dec - t_net) / len(pres),
                "post": t_post - t_dec, "merge": t_end - t_post,
            })
        return outs

    def run(self, images_or_paths, image_id=None, calib=None,
            run_align: bool = True) -> Dict:
        pre = self.load_and_pre(images_or_paths, calib)
        return self.finish(self.dispatch(pre, run_align=run_align))
