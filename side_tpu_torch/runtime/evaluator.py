"""The KITTI object evaluator: build, run, parse.

`tools/kitti_eval/evaluate_object_3d_offline.cpp` (standard C++17, no
dependency) is compiled at first use into `side_tpu_torch/_build/` with g++
or, where there is none, nvcc's host compiler: a binary built elsewhere may
not run on this machine.  `run_eval(result_dir, gt_dir)` runs it as
tools/val.py does and returns its `<class>_<metric> AP: easy moderate hard`
lines as a dict.  A failing build or run raises.

The evaluator writes its precision/recall tables to `<result_dir>/../plot`.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from ..ops.dcn_cuda import BUILD_DIR

SOURCE = (Path(__file__).resolve().parents[2] / "tools" / "kitti_eval" /
          "evaluate_object_3d_offline.cpp")
_AP_LINE = re.compile(r"^(\S+) AP: ([-\d.naif]+) ([-\d.naif]+) ([-\d.naif]+)$")


def _compile_command(out: Path) -> List[str]:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx:
        return [cxx, "-O2", "-std=c++17", "-o", str(out), str(SOURCE)]
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return [str(Path(cand) / "bin" / "nvcc"), "-O2", "-std=c++17",
                    "-x", "c++", "-o", str(out), str(SOURCE)]
    raise RuntimeError("no C++ compiler found (g++, c++ or nvcc) to build "
                       f"{SOURCE}")


def build_evaluator() -> Path:
    """The evaluator binary, compiled unless one of this source exists."""
    if not SOURCE.exists():
        raise FileNotFoundError(SOURCE)
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"evaluate_object_3d_offline_{digest}"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = _compile_command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the evaluator failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def parse_ap(stdout: str) -> Dict[str, Tuple[float, float, float]]:
    """`car_detection AP: 90.1 80.2 70.3` lines -> {"car_detection":
    (easy, moderate, hard)}."""
    aps = {}
    for line in stdout.splitlines():
        m = _AP_LINE.match(line.strip())
        if m:
            aps[m.group(1)] = tuple(float(m.group(i)) for i in (2, 3, 4))
    return aps


def run_eval(result_dir: str, gt_dir: str, timeout: float = 600.0
             ) -> Dict[str, Tuple[float, float, float]]:
    """Evaluate the KITTI txt files of `result_dir` against the labels in
    `gt_dir`; returns the parsed AP lines."""
    binary = build_evaluator()
    cmd = [str(binary), str(gt_dir), str(result_dir)]
    print("[val] running:", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the evaluator failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    aps = parse_ap(proc.stdout)
    for name, vals in aps.items():
        print(f"{name} AP: " + " ".join(f"{v:.4f}" for v in vals), flush=True)
    return aps
