"""Validation entry point of the port (mirrors tools/val.py): run the
detector over the val split, write KITTI result files, run the evaluator.

    python -m side_tpu_torch.val stereo --data_dir data \\
        --load_model exp/stereo/default/model_last.npz [--eval_batch 4]

Flags beside Config's: `--eval_batch B` frames per device pass (one network
pass over 2B images and one tail over the frame axis; the last group is
padded by repeating its final frame and the padded results are dropped),
`--eval_batches 1,4` one full pass per size in one process, `--serial` (no
pipelining: `Detector.run` frame by frame), `--no_align`, `--num_images N`,
`--no_eval`, `--profile` (a torch.profiler trace, `val_trace.json` under
`<save_dir>/profile`; see below), `--dcn_fused` (the fused offset/mask DCN
kernel, ops/deform_conv.py), `--device cpu` (the plain CPU path; without
it the run needs a CUDA device), and `--synthetic_scenes N`: N rendered
scenes held in memory with their labels written under
`<save_dir>/synthetic_gt`, for machines without OpenCV or a dataset.
Pipelined (the default), a producer thread runs load + pre-process ahead,
and the main thread dispatches group i before it finishes group i-1.

In the `--profile` trace the pass's stages show beside the kernels as host
ranges named `side::<stage>` (runtime/spans.py): per group `val.wait_frames`
(the main thread waiting for the producer's frames), `val.dispatch` (holding
the Detector's `net`, `decode` and `tail`, which holds `tail.prep`,
`tail.solve`, `tail.align`, `tail.resolve`) and `val.finish` (holding
`val.wait_device`, `val.fetch`, `val.report`), and one `side::anchor` a
pass.  The producer's `val.pre` spans (load + pre-process, one a frame) are
only in the in-memory buffer (`spans.recorded()`): the profiler records no
operation of a thread it did not start.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
import time
from typing import Iterable, Iterator, Tuple

from .config import CLASS_NAMES, Config
from .demo import _pop_option
from .ops import deform_conv as dc
from .postprocess.post_process import save_kitti_results
from .runtime.logger import AverageMeter
from .runtime.spans import begin, span

STAGES = ("tot", "load", "pre", "net", "dec", "post", "merge")
Frame = Tuple[int, tuple, list]     # image id, (left, right), calib


def kitti_source(ds) -> Iterator[Frame]:
    """The frames of a StereoKitti split as (image id, (left path, right
    path), calib)."""
    for img_id in ds.images:
        info = ds.coco.images[img_id]
        yield (img_id,
               (os.path.join(ds.img_dir, info["file_name"]),
                os.path.join(ds.img_right_dir, info["file_name"])),
               info["calib"])


def run_pass(cfg: Config, source: Iterable[Frame], detector, *, n: int,
             eval_batch: int = 1, serial: bool = False,
             no_align: bool = False):
    """One inference pass over the first `n` frames of `source`, which
    yields (image id, (left, right) arrays or paths, calib).  Returns
    (results {image id: {class: rows}}, meters, steady_ms): steady_ms is
    the wall time per image over the second half of the pass (the first
    half absorbs kernel builds and warm-up), None under 4 frames.  It runs
    from the dispatch of the group that holds frame n // 2 to the last
    report.  (The JAX package takes it between reports; here the host's
    kernel launches make a dispatch last about as long as the device work,
    so the reports of two groups arrive back to back and their spacing
    says nothing.)  Under torch.profiler the pass records the spans that
    the module's docstring lists."""
    call = begin()
    meters = {k: AverageMeter() for k in STAGES}
    results = {}
    report_t = []
    starts = {}         # index of a group's first frame -> its dispatch time
    frames = itertools.islice(iter(source), n)

    def report(ind, img_id, ret):
        results[img_id] = ret["results"]
        report_t.append(time.time())
        msg = f"[{ind + 1}/{n}] {img_id:06d} "
        for k in meters:
            meters[k].update(ret[k])
            msg += f"|{k} {ret[k]:.3f}s ({meters[k].avg:.3f}s) "
        print(msg, flush=True)

    if serial:
        eval_batch = 1
        for ind, (img_id, pair, calib) in enumerate(frames):
            starts[ind] = time.time()
            report(ind, img_id, detector.run(
                pair, image_id=img_id, calib=calib, run_align=not no_align))
    else:
        q = queue.Queue(maxsize=4 * eval_batch)
        failure = []

        def producer():
            try:
                for ind, (img_id, pair, calib) in enumerate(frames):
                    with span("val.pre", ind, call=call):
                        pre = detector.load_and_pre(pair, calib)
                    q.put((ind, img_id, pre))
            except Exception as e:          # re-raised by the consumer
                failure.append(e)
            q.put(None)

        threading.Thread(target=producer, daemon=True).start()

        def next_group():
            group = []
            while len(group) < eval_batch:
                item = q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return group, True
                group.append(item)
            return group, False

        def finish(pending):
            group, n_real, handle = pending
            with span("val.finish", group[0][0]):
                rets = ([detector.finish(handle)] if eval_batch == 1
                        else detector.finish_batch(handle))
                for (ind, img_id, _), ret in list(zip(group, rets))[:n_real]:
                    report(ind, img_id, ret)

        pending = None
        done = False
        taken = 0
        while not done:
            with span("val.wait_frames", taken):
                group, done = next_group()
            if not group:
                break
            n_real = len(group)
            taken += n_real
            group += [group[-1]] * (eval_batch - n_real)
            with span("val.dispatch", group[0][0]):
                starts[group[0][0]] = time.time()
                if eval_batch == 1:
                    handle = detector.dispatch(group[0][2],
                                               run_align=not no_align)
                else:
                    handle = detector.dispatch_batch(
                        [g[2] for g in group], run_align=not no_align)
            if pending is not None:
                finish(pending)
            pending = (group, n_real, handle)
        if pending is not None:
            finish(pending)

    steady_ms = None
    if len(report_t) >= 4:
        first = len(report_t) // 2 // eval_batch * eval_batch
        steady_ms = (report_t[-1] - starts[first]) / \
            (len(report_t) - first) * 1e3
    return results, meters, steady_ms


def _pop_flag(argv, name):
    return [a for a in argv if a != name], name in argv


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _pop_option(argv, "--device")
    argv, num_images = _pop_option(argv, "--num_images")
    argv, eval_batch = _pop_option(argv, "--eval_batch")
    argv, eval_batches = _pop_option(argv, "--eval_batches")
    argv, n_scenes = _pop_option(argv, "--synthetic_scenes")
    argv, no_align = _pop_flag(argv, "--no_align")
    argv, profile = _pop_flag(argv, "--profile")
    argv, serial = _pop_flag(argv, "--serial")
    argv, no_eval = _pop_flag(argv, "--no_eval")
    argv, fused = _pop_flag(argv, "--dcn_fused")
    num_images = -1 if num_images is None else int(num_images)
    batches = ([int(v) for v in eval_batches.split(",")] if eval_batches
               else [int(eval_batch or 1)])
    cfg = Config.cli(argv)

    from .runtime.detector import Detector
    detector = Detector(cfg, device=device)
    if fused:       # after the Detector: a run that cannot start leaves it
        dc.set_dcn_fused(True)
    os.makedirs(cfg.save_dir, exist_ok=True)
    if n_scenes is not None:
        from .data.synthetic import val_scenes
        gt_dir = os.path.join(cfg.save_dir, "synthetic_gt", "label_2")
        source = val_scenes(int(n_scenes), seed=cfg.seed, label_dir=gt_dir)
        total = int(n_scenes)
    else:
        from .data.dataset import StereoKitti
        ds = StereoKitti(cfg, "val")
        gt_dir = os.path.join(cfg.data_dir, "kitti", "training", "label_2")
        source = list(kitti_source(ds))
        total = len(source)
    n = total if num_images < 0 else min(num_images, total)

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        acts = [ProfilerActivity.CPU]
        if detector.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = tprofile(activities=acts)
        prof.start()

    results = None
    for eb in batches:
        t0 = time.time()
        results, meters, steady_ms = run_pass(
            cfg, source, detector, n=n, eval_batch=eb, serial=serial,
            no_align=no_align)
        wall = time.time() - t0
        if n > 1:
            # pipelined, `net` is the enqueue plus the wait left after the
            # overlap with host work; quote --serial runs for device time
            net_label = ("pure net avg" if serial
                         else "net enqueue + wait (overlapped) avg")
            steady = (f"; steady {steady_ms:.0f} ms/image "
                      f"({1e3 / steady_ms:.1f} pairs/s)" if steady_ms else "")
            print(f"[val] batch {eb}: wall {wall:.1f}s for {n} images = "
                  f"{wall / n * 1e3:.0f} ms/image "
                  f"({'serial' if serial else 'pipelined'}); {net_label} "
                  f"{meters['net'].avg * 1e3:.0f} ms{steady}", flush=True)

    if prof is not None:
        prof.stop()
        prof_dir = os.path.join(cfg.save_dir, "profile")
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "val_trace.json"))
        print(f"[val] profile trace in {prof_dir}")

    save_kitti_results(results, cfg.save_dir, CLASS_NAMES)
    print(f"[val] wrote results to {cfg.save_dir}/results")
    if not no_eval and (num_images < 0 or n_scenes is not None):
        from .runtime.evaluator import run_eval
        run_eval(os.path.join(cfg.save_dir, "results"), gt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
