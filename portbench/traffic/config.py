# Frozen copy of side_tpu_torch/config.py at commit ca59ff401c87, kept with the benchmark
# so that later changes to the program do not move the yardstick.
"""Experiment configuration of the PyTorch port.

A copy of side_tpu/config.py (the port imports nothing of the JAX package):
the same dataclass, constants, defaults and command-line flags, so one run
command configures either package.  One difference: `--reference_exact`
sets the `reference_exact` field, and the training entry point and the
Detector switch the DCN to its exact (unbounded) mode from it; parsing the
flags imports no DCN module.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


# KITTI stereo dataset constants (reference stereoDataset.py:21-36)
NUM_CLASSES = 3
CLASS_NAMES = ["__background__", "Car", "Van", "Truck"]
DEFAULT_RESOLUTION = (384, 1280)  # (h, w)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
DIM_EXP = (3.88, 1.63, 1.53)
MAX_OBJS = 50


@dataclass
class Config:
    # basic experiment setting (opts.py:13-34)
    task: str = "stereo"
    dataset: str = "kitti"
    exp_id: str = "default"
    test: bool = False
    debug: int = 0
    demo: str = ""
    load_model: str = ""
    resume: bool = False

    # system (opts.py:37-44)
    num_workers: int = 4
    seed: int = 317

    # log
    print_iter: int = 0
    hide_data_time: bool = False
    save_all: bool = False
    metric: str = "loss"
    vis_thresh: float = 0.3

    # model (opts.py:61-71)
    arch: str = "dla_34"
    head_conv: int = 256
    down_ratio: int = 4

    # input (opts.py:74-80); defaults from the dataset (384 x 1280)
    input_h: int = DEFAULT_RESOLUTION[0]
    input_w: int = DEFAULT_RESOLUTION[1]

    # train (opts.py:83-101)
    lr: float = 2.5e-4
    lr_step: Tuple[int, ...] = (45, 60)
    num_epochs: int = 70
    batch_size: int = 16
    num_iters: int = -1
    val_intervals: int = 10
    trainval: bool = False
    flip_train: bool = False

    # test (opts.py:104-119)
    flip_test: bool = False
    K: int = 100
    fix_res: bool = True
    keep_res: bool = False

    # dataset augmentation (opts.py:122-147)
    shift: float = 0.1
    scale: float = 0.4
    flip: float = 0.5
    no_color_aug: bool = False
    aug_ddd: float = 0.35
    kitti_split: str = "3dop"

    # loss (opts.py:150-176)
    mse_loss: bool = False
    hm_weight: float = 1.0
    off_weight: float = 1.0
    wh_weight: float = 1.0
    dim_weight: float = 1.0
    orien_weight: float = 1.0
    kept_weight: float = 1.0
    depth_weight: float = 1.0
    # auxiliary soft-target CE on the cost-volume depth-bin logits
    # (TPU-native addition; 0 = exact reference semantics — see
    # ops/losses.depth_bin_ce for why expectation-only L1 collapses)
    depth_aux_weight: float = 1.0
    peak_thresh: float = 0.2
    uncert: bool = False
    cost_volume: bool = True
    # ship training images to the device as warped uint8 and normalise on
    # device (TPU-native: 4x smaller H2D + host collate, normalisation
    # fuses into the first conv — same trick the Detector uses at
    # inference).  Bit-equivalent to host normalisation for un-augmented
    # samples (the reference also warps in uint8, stereoDataset.py:109-128);
    # color-augmented samples re-quantise to uint8 (<=0.5/255 noise on an
    # already-random augmentation).  False = reference-style host float32.
    uint8_images: bool = True
    wh_scale: float = 1.0

    # heads
    reg_bbox: bool = True
    reg_offset: bool = True
    grid: int = 28  # keypoint grid cells (opts.py:290)

    # detection
    center_thresh: float = 0.1

    # dirs (opts.py:272-277)
    data_dir: str = "data"
    exp_dir: str = "exp"

    # TPU-native additions -------------------------------------------------
    # number of data-parallel devices; 0 = all visible
    num_devices: int = 0
    # multi-host SPMD: join a jax.distributed cluster before building the
    # mesh (empty address = auto-detect from the TPU pod environment)
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1
    # compute dtype for the conv trunk ("bfloat16" | "float32")
    compute_dtype: str = "bfloat16"
    # per-image cost-volume proposal count at inference (train uses MAX_OBJS)
    roi_size: int = 16  # depth bins == RoIAlign resolution (stereo_network_old.py:270)
    # inference 3D-CNN runs on the top cv_topk score-ordered slots only,
    # disparity fallback beyond (0 = all K slots; see StereoNet.cv_topk)
    cv_topk: int = 32
    # fused inference tail runs dense alignment on the top align_topk
    # score-ordered slots only (0 = all K slots); slots beyond keep their
    # solved (un-aligned) depth — in practice they sit below peak_thresh
    # and are filtered out downstream (see postprocess/device_tail.py)
    align_topk: int = 32
    max_objs: int = MAX_OBJS
    # use gradient checkpointing on the backbone
    remat: bool = False
    # instance-depth estimator: "cost_volume" (stereo_network_old) or
    # "voxel" (stereo_network_new voxel+PointNet variant)
    depth_variant: str = "cost_volume"

    # one switch back to exact reference semantics (see `cli`): also selects
    # the exact DCN mode unless SIDE_TPU_TORCH_DCN pins one
    reference_exact: bool = False

    # ground-truth oracle ablations (opts.py:211-225 — parsed for CLI parity;
    # like the reference's stereo path, currently not consumed downstream)
    eval_oracle_hm: bool = False
    eval_oracle_wh: bool = False
    eval_oracle_offset: bool = False
    eval_oracle_dep: bool = False

    # derived ---------------------------------------------------------------
    @property
    def output_h(self) -> int:
        return self.input_h // self.down_ratio

    @property
    def output_w(self) -> int:
        return self.input_w // self.down_ratio

    @property
    def num_classes(self) -> int:
        return NUM_CLASSES

    @property
    def mean(self):
        return MEAN

    @property
    def std(self):
        return STD

    @property
    def dim_exp(self):
        return DIM_EXP

    @property
    def heads(self) -> Dict[str, int]:
        """Head spec for the stereo task (opts.py:304-311)."""
        heads = {
            "hm": NUM_CLASSES,
            "dim": 3,
            "orien": 2,
            "kept_type": 6 * self.grid,
        }
        if self.reg_bbox:
            heads["wh"] = 3
        if self.reg_offset:
            heads["reg"] = 3
        return heads

    @property
    def loss_weight(self) -> Tuple[float, ...]:
        """Fixed 7-vector of loss weights (opts.py:291-292):
        [hm, wh, off, depth, dim, orien, kept]."""
        return (
            self.hm_weight,
            self.wh_weight,
            self.off_weight,
            self.depth_weight,
            self.dim_weight,
            self.orien_weight,
            self.kept_weight,
        )

    @property
    def save_dir(self) -> str:
        return os.path.join(self.exp_dir, self.task, self.exp_id)

    @property
    def debug_dir(self) -> str:
        return os.path.join(self.save_dir, "debug")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ CLI
    @staticmethod
    def cli(argv=None) -> "Config":
        p = argparse.ArgumentParser(description="side_tpu_torch")
        p.add_argument("task", nargs="?", default="stereo")
        p.add_argument("--dataset", default="kitti")
        p.add_argument("--exp_id", default="default")
        p.add_argument("--test", action="store_true")
        p.add_argument("--debug", type=int, default=0)
        p.add_argument("--demo", default="")
        p.add_argument("--load_model", default="")
        p.add_argument("--resume", action="store_true")
        p.add_argument("--num_workers", type=int, default=4)
        p.add_argument("--seed", type=int, default=317)
        p.add_argument("--print_iter", type=int, default=0)
        p.add_argument("--save_all", action="store_true")
        p.add_argument("--vis_thresh", type=float, default=0.3)
        p.add_argument("--arch", default="dla_34")
        p.add_argument("--head_conv", type=int, default=-1)
        p.add_argument("--down_ratio", type=int, default=4)
        p.add_argument("--input_h", type=int, default=-1)
        p.add_argument("--input_w", type=int, default=-1)
        p.add_argument("--input_res", type=int, default=-1)
        p.add_argument("--lr", type=float, default=2.5e-4)
        p.add_argument("--lr_step", type=str, default="45,60")
        p.add_argument("--num_epochs", type=int, default=70)
        p.add_argument("--batch_size", type=int, default=16)
        p.add_argument("--num_iters", type=int, default=-1)
        p.add_argument("--val_intervals", type=int, default=10)
        p.add_argument("--trainval", action="store_true")
        p.add_argument("--flip_train", action="store_true")
        p.add_argument("--K", type=int, default=100)
        p.add_argument("--keep_res", action="store_true")
        p.add_argument("--shift", type=float, default=0.1)
        p.add_argument("--scale", type=float, default=0.4)
        p.add_argument("--flip", type=float, default=0.5)
        p.add_argument("--no_color_aug", action="store_true")
        p.add_argument("--aug_ddd", type=float, default=0.35)
        p.add_argument("--kitti_split", default="3dop")
        p.add_argument("--mse_loss", action="store_true")
        p.add_argument("--hm_weight", type=float, default=1.0)
        p.add_argument("--off_weight", type=float, default=1.0)
        p.add_argument("--wh_weight", type=float, default=1.0)
        p.add_argument("--dim_weight", type=float, default=1.0)
        p.add_argument("--orien_weight", type=float, default=1.0)
        p.add_argument("--kept_weight", type=float, default=1.0)
        p.add_argument("--depth_weight", type=float, default=1.0)
        p.add_argument("--depth_aux_weight", type=float, default=1.0)
        p.add_argument("--peak_thresh", type=float, default=0.2)
        p.add_argument("--uncert", action="store_true")
        p.add_argument("--not_cost_volume", action="store_true")
        p.add_argument("--wh_scale", type=float, default=1.0)
        p.add_argument("--not_reg_offset", action="store_true")
        p.add_argument("--not_reg_bbox", action="store_true")
        p.add_argument("--center_thresh", type=float, default=0.1)
        p.add_argument("--data_dir", default="data")
        p.add_argument("--exp_dir", default="exp")
        p.add_argument("--num_devices", type=int, default=0)
        p.add_argument("--distributed", action="store_true")
        p.add_argument("--coordinator_address", default="")
        p.add_argument("--num_processes", type=int, default=-1)
        p.add_argument("--process_id", type=int, default=-1)
        p.add_argument("--compute_dtype", default="bfloat16")
        p.add_argument("--remat", action="store_true")
        p.add_argument("--cv_topk", type=int, default=32)
        p.add_argument("--align_topk", type=int, default=32)
        p.add_argument("--depth_variant", default="cost_volume",
                       choices=["cost_volume", "voxel"])
        p.add_argument("--eval_oracle_hm", action="store_true")
        p.add_argument("--eval_oracle_wh", action="store_true")
        p.add_argument("--eval_oracle_offset", action="store_true")
        p.add_argument("--eval_oracle_dep", action="store_true")
        p.add_argument("--reference_exact", action="store_true",
                       help="one switch back to exact reference semantics: "
                            "no depth-bin aux CE, 3D-CNN and dense "
                            "alignment on ALL top-K slots, host-float "
                            "images (disables every individually-flagged "
                            "TPU-first default deviation at once)")
        a = p.parse_args(argv)
        if a.reference_exact:
            a.depth_aux_weight = 0.0
            a.cv_topk = 0
            a.align_topk = 0

        input_h = a.input_h if a.input_h > 0 else (
            a.input_res if a.input_res > 0 else DEFAULT_RESOLUTION[0])
        input_w = a.input_w if a.input_w > 0 else (
            a.input_res if a.input_res > 0 else DEFAULT_RESOLUTION[1])
        head_conv = a.head_conv if a.head_conv >= 0 else (
            256 if "dla" in a.arch else 64)
        val_intervals = 10 ** 9 if a.trainval else a.val_intervals

        return Config(
            task=a.task, dataset=a.dataset, exp_id=a.exp_id, test=a.test,
            debug=a.debug, demo=a.demo, load_model=a.load_model,
            resume=a.resume, num_workers=a.num_workers, seed=a.seed,
            print_iter=a.print_iter, save_all=a.save_all,
            vis_thresh=a.vis_thresh, arch=a.arch, head_conv=head_conv,
            down_ratio=a.down_ratio, input_h=input_h, input_w=input_w,
            lr=a.lr, lr_step=tuple(int(s) for s in a.lr_step.split(",")),
            num_epochs=a.num_epochs, batch_size=a.batch_size,
            num_iters=a.num_iters, val_intervals=val_intervals,
            trainval=a.trainval, flip_train=a.flip_train, K=a.K,
            keep_res=a.keep_res, fix_res=not a.keep_res, shift=a.shift,
            scale=a.scale, flip=a.flip, no_color_aug=a.no_color_aug,
            aug_ddd=a.aug_ddd, kitti_split=a.kitti_split,
            mse_loss=a.mse_loss, hm_weight=a.hm_weight,
            off_weight=a.off_weight, wh_weight=a.wh_weight,
            dim_weight=a.dim_weight, orien_weight=a.orien_weight,
            kept_weight=a.kept_weight, depth_weight=a.depth_weight,
            depth_aux_weight=a.depth_aux_weight,
            peak_thresh=a.peak_thresh, uncert=a.uncert,
            cost_volume=not a.not_cost_volume, wh_scale=a.wh_scale,
            reg_offset=not a.not_reg_offset, reg_bbox=not a.not_reg_bbox,
            center_thresh=a.center_thresh, data_dir=a.data_dir,
            exp_dir=a.exp_dir, num_devices=a.num_devices,
            distributed=a.distributed,
            coordinator_address=a.coordinator_address,
            num_processes=a.num_processes, process_id=a.process_id,
            compute_dtype=a.compute_dtype, remat=a.remat,
            cv_topk=a.cv_topk, align_topk=a.align_topk,
            depth_variant=a.depth_variant,
            eval_oracle_hm=a.eval_oracle_hm, eval_oracle_wh=a.eval_oracle_wh,
            eval_oracle_offset=a.eval_oracle_offset,
            eval_oracle_dep=a.eval_oracle_dep,
            uint8_images=not a.reference_exact,
            reference_exact=a.reference_exact,
        )
