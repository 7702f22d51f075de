"""Top-level entry points of the port (port of __graft_entry__.py): the
flagship's served function, and a data-parallel training dry run.

    python -m side_tpu_torch.graft_entry      # dryrun_multichip(N_DEVICES or 8)

prints the dry run's line and then its seconds (spawn, the n ranks'
step, the one-process step).

`entry(device=None)` returns `(fn, (model, batch))`: `fn(model, batch)` is
one inference step of the flagship at `Config()` (384x1280, K=100, bf16,
eval mode): the stereo network with its heads and cost-volume depth,
sigmoid and `ddd_decode`, as `(dets, dets_r, info)` with the depth as the
last column of `info`.  `batch` is one pair of N(0, 1) images (numpy
RandomState(0), drawn as the JAX file draws them) and fb 380.

`dryrun_multichip(n, device=None)` takes one training step of the
flagship at 64x128 (f32, K 4, roi_size 4, `--uncert`) over n ranks on the
fixed batch of n pairs, then one step of a single process from the same
initial weights on the same global batch; it raises unless the loss is
finite and the two agree to 1e-4 relative (the JAX file's assert).  The
ranks are processes joined through `parallel/mesh.py`: on the card rank r
runs on cuda:(r mod the visible cards), over nccl where every rank has a
card of its own and over gloo where ranks share one; with `device="cpu"`
they are gloo CPU ranks.  f32 runs with TF32 off on the card, as the JAX
file's f32 runs on the CPU.

Both run on `cuda` unless the caller passes `device="cpu"`, and raise
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import Config
from .models.stereo_net import StereoNet
from .ops import decode as dec
from .parallel.mesh import ShardedLoader, init_distributed, make_mesh, shutdown
from .runtime.detector import ieee_f32, resolve_device
from .runtime.trainer import Trainer

DRYRUN_HW = (64, 128)
DRYRUN_K = 4
DRYRUN_TOL = 1e-4


def _build(cfg_kw: dict, dtype: torch.dtype, device) -> tuple:
    """(cfg, model) as __graft_entry__._build builds them: StereoNet from
    `Config(**cfg_kw)` with the model's default cv_topk, seeded init (seed
    0), on `device`."""
    cfg = Config(**cfg_kw)
    model = StereoNet(heads=dict(cfg.heads), roi_size=cfg.roi_size,
                      topk=cfg.K, down_ratio=cfg.down_ratio,
                      input_w=cfg.input_w, dtype=dtype, seed=0)
    return cfg, model.to(device)


def example_batch(cfg: Config, device) -> Dict[str, torch.Tensor]:
    """One stereo pair of N(0, 1) images, drawn in the JAX file's order,
    and fb 380."""
    rng = np.random.RandomState(0)
    shape = (1, cfg.input_h, cfg.input_w, 3)
    batch = {"input": rng.randn(*shape), "input_right": rng.randn(*shape),
             "fb": np.full((1,), 380.0)}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items()}


def served(cfg_kw: dict, dtype: torch.dtype, device=None):
    """(fn, (model, batch)) of the inference step at `Config(**cfg_kw)`;
    `entry` at the flagship's defaults."""
    device = resolve_device(device)
    cfg, model = _build(cfg_kw, dtype, device)
    model.eval()

    @torch.inference_mode()
    def fn(model, batch):
        out = model(batch, target=None, use_cost_volume=True)
        hm = torch.sigmoid(out["hm"])
        dets, dets_r, info = dec.ddd_decode(
            hm, out["kept_type"], out["dim"], out["orien"], out["wh"],
            out["reg"], grid_size=cfg.grid, K=cfg.K)
        info = torch.cat([info, out["depth"]], dim=2)
        return dets, dets_r, info

    return fn, (model, example_batch(cfg, device))


def entry(device=None):
    """(fn, example_args): the flagship's inference step, bf16."""
    return served(dict(), torch.bfloat16, device)


# ------------------------------------------------------------------ dryrun
def _dryrun_kw(n: int, num_devices: int) -> dict:
    h, w = DRYRUN_HW
    return dict(input_h=h, input_w=w, compute_dtype="float32",
                max_objs=DRYRUN_K, K=DRYRUN_K, roi_size=4, batch_size=n,
                uncert=True, num_devices=num_devices)


def dryrun_config(n: int, num_devices: Optional[int] = None) -> Config:
    """The dry run's Config: a global batch of n pairs over `num_devices`
    ranks (default n); K and roi_size as the JAX dry run builds its
    model."""
    return Config(**_dryrun_kw(n, n if num_devices is None else num_devices))


def dryrun_model(n: int, device) -> torch.nn.Module:
    """The dry run's f32 model, seeded init, on `device`."""
    return _build(_dryrun_kw(n, n), torch.float32, device)[1]


def fixed_batch(n: int, in_hw, out_hw, K: int, centre, wh: float,
                image_dtype=np.float32) -> Dict[str, np.ndarray]:
    """The fixed training batch of the JAX dry run and bench.py (the same
    draws from RandomState(0)): n pairs of uint8 images or N(0, 1) f32
    ones, and one GT slot repeated K times at `centre` (row, col) of the
    `out_hw` map, `wh` wide and high."""
    rng = np.random.RandomState(0)
    shape = (n, *in_hw, 3)

    def images():
        if image_dtype == np.uint8:
            return rng.randint(0, 256, shape).astype(np.uint8)
        return rng.randn(*shape).astype(image_dtype)

    (ho, wo), (r, c) = out_hw, centre
    hm = np.zeros((n, 3, ho, wo), np.float32)
    hm[:, 0, r, c] = 1.0
    ind = np.full((n, K), r * wo + c, np.int64)
    return {
        "input": images(), "input_right": images(),
        "hm": hm, "ind": ind, "ind_float": ind.astype(np.float32),
        "rot_mask": np.ones((n, K), np.uint8),
        "wh": np.full((n, K, 3), wh, np.float32),
        "reg": rng.rand(n, K, 3).astype(np.float32),
        "dim": np.full((n, K, 3), 1.5, np.float32),
        "orien": np.tile([0.0, 1.0], (n, K, 1)).astype(np.float32),
        "depth": np.full((n, K, 1), 15.0, np.float32),
        "kept": (rng.rand(n, K, 6) * 4).astype(np.float32),
        "fb": np.full((n,), 380.0, np.float32),
    }


def dryrun_batch(n: int) -> Dict[str, np.ndarray]:
    """The JAX dry run's fixed global batch of n pairs
    (__graft_entry__.py:83-101)."""
    h, w = DRYRUN_HW
    return fixed_batch(n, DRYRUN_HW, (h // 4, w // 4), DRYRUN_K, (5, 7), 5.0)


def dryrun_step(cfg: Config, model: torch.nn.Module, batch, device,
                mesh=None) -> float:
    """The loss of one training step (Trainer.train over a one-batch
    loader; the rank's slice of `batch` under a mesh of several ranks)."""
    device = torch.device(device)
    trainer = Trainer(cfg, model, steps_per_epoch=1, device=device,
                      mesh=mesh)
    loader = [batch]
    if mesh is not None and mesh.world > 1:
        loader = ShardedLoader(loader, mesh)
    with ieee_f32():
        return float(trainer.train(1, loader)["loss"])


def _launches() -> dict:
    from .ops.dcn_cuda import KERNELS
    return {name: k.launches for name, k in KERNELS.items() if k.launches}


def _rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _dryrun_rank(rank: int, n: int, device_type: str, store: str) -> None:
    """One rank of the dry run: its step's loss and kernel launches into
    `store`/rank<r>.json."""
    device = _rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        own_card = n <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
        backend = "gloo"
    init_distributed("file://" + os.path.join(store, "rendezvous"), n, rank,
                     backend=backend)
    try:
        loss = dryrun_step(dryrun_config(n), dryrun_model(n, device),
                           dryrun_batch(n), device, make_mesh(n, device))
        with open(os.path.join(store, f"rank{rank}.json"), "w") as f:
            json.dump({"loss": loss, "device": str(device),
                       "backend": backend, "launches": _launches()}, f)
    finally:
        shutdown()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One data-parallel training step over `n_devices` ranks against one
    process on the same global batch; raises on a non-finite loss or a
    relative difference of 1e-4 or more.  Returns the losses, the relative
    difference, each rank's device, backend and kernel launches, and the
    seconds taken."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    if device.type == "cuda":
        # one build before the ranks start, not n racing ones
        from .ops.dcn_cuda import LIBRARIES, build_all
        build_all(LIBRARIES)
    store = tempfile.mkdtemp(prefix="side_tpu_torch_dryrun_")
    try:
        torch.multiprocessing.spawn(
            _dryrun_rank, args=(n_devices, device.type, store),
            nprocs=n_devices, join=True)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(store, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    loss = ranks[0]["loss"]
    if not all(np.isfinite(r["loss"]) for r in ranks):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite loss "
                           f"{[r['loss'] for r in ranks]}")

    # the same global batch through the same init in one process
    device1 = _rank_device(0, device.type)
    loss1 = dryrun_step(dryrun_config(n_devices, 1),
                        dryrun_model(n_devices, device1),
                        dryrun_batch(n_devices), device1)
    rel = abs(loss - loss1) / max(abs(loss1), 1e-6)
    if not rel < DRYRUN_TOL:
        raise RuntimeError(
            f"DP loss mismatch: {n_devices}-dev {loss:.6f} vs 1-dev "
            f"{loss1:.6f} (rel {rel:.2e})")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} "
          f"(1-dev {loss1:.4f}, rel diff {rel:.2e}) OK", flush=True)
    return {"loss": loss, "loss_one": loss1, "rel": rel, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    n = int(os.environ.get("N_DEVICES") or 8)
    seconds = dryrun_multichip(n)["seconds"]
    print(f"dryrun_multichip({n}): {seconds:.3f} s", flush=True)
