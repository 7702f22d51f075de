"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (side_tpu_torch).  The cell's entry in BENCHMARK.json names its
configuration file and its traffic mix (portbench/traffic/<mix>.json); the
mix's `kind` names the driver (portbench/drivers/<kind>.py).  With
`--trace 0` the result holds the cell's end-to-end metrics, with `--trace 1`
its per-layer ones (portbench/metrics/<metric>.py).  The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, [breakdown,] checks; the numbers compared for `correct` and their
limits are also the last lines of standard error.  Without a CUDA device
with enough cards the run prints no result and exits with 2."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "side_tpu")


def _fixed_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Run:
    """One run of one cell: what the driver reads and what it leaves."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device, root: str = ROOT,
                 config_overrides=None, mix_overrides=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.bench, self.cell = bench, cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = _load(os.path.join(root, conf["file"]))
        self.config_keys = dict(self.config["config"],
                                **(config_overrides or {}))
        self.mix = dict(_load(os.path.join(
            HERE, "traffic", f"{self.cell['traffic']}.json")),
            **(mix_overrides or {}))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.data = {"device": device.type,
                     "dtype": self.config_keys["compute_dtype"]}
        self.end_to_end, self.numbers = {}, {}
        self.compared = None
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.t_window = None

    @staticmethod
    def ref_config(keys: dict):
        from .traffic.config import Config
        return Config(**keys)

    def mark(self, what: str) -> None:
        """A set-up phase's end, on standard error: seconds since start."""
        print(f"portbench: {time.perf_counter() - T_START:8.3f} s {what}",
              file=sys.stderr, flush=True)

    def window_opened(self) -> None:
        self.t_window = time.perf_counter()
        self.mark("window opens")

    def read_memory(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def execute(self) -> None:
        kind = self.mix["kind"]
        importlib.import_module(f"portbench.drivers.{kind}").run(self)

    def metric_names(self, section: str) -> list:
        return [m["name"] for m in self.bench[section]
                if self.cell["name"] in m.get("workloads",
                                              [self.cell["name"]])]

    def result(self) -> dict:
        from .check import judge
        from .metrics import reader
        units = {m["name"]: m["unit"]
                 for s in ("end_to_end", "per_layer") for m in self.bench[s]}
        metrics = {}
        if not self.trace:
            values = dict(self.end_to_end,
                          setup_s=self.t_window - T_START)
            names = self.metric_names("end_to_end")
        else:
            values = {n: reader(n)(self.data)
                      for n in self.metric_names("per_layer")}
            names = list(values)
        for n in names:
            if values.get(n) is not None:
                metrics[n] = {"value": float(values[n]), "unit": units[n]}
        limits = _load(os.path.join(
            HERE, "limits", f"{self.cell['name']}.json"))["limits"]
        correct, checks = judge(self.numbers, limits)
        for c in checks.values():
            if not math.isfinite(c["value"]):
                c["value"] = str(c["value"])
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": _device_name(self.device), "count": 1,
                  "memory_peak_bytes": self.memory_peak}
        if self.device.type == "cuda":
            device["power_limit"] = _power_limit()
        out = {"correct": correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": device}
        tr = self.data.get("trace")
        if self.trace and tr is not None:
            device["busy_s"] = tr.busy_us / 1e6
            device["window_s"] = tr.window_us / 1e6
            gaps = self.data.get("trace_host", tr)
            out["breakdown"] = {"device_ops": tr.top_ops(10),
                                "idle_gaps": gaps.idle_gaps(10)}
        out["checks"] = checks
        return out


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench_path: str = None, **overrides) -> dict:
    """The cell's result line as a dict (no checks of the machine)."""
    return execute(workload, seed, seconds, trace, device, bench_path,
                   **overrides).result()


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", bench_path: str = None, **overrides) -> Run:
    """One run of the cell, done: its Run holds every number it read."""
    import torch
    bench = _load(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    run = Run(bench, workload, seed, seconds, trace, torch.device(device),
              **overrides)
    dcn = run.config["dcn"]
    os.environ["SIDE_TPU_TORCH_DCN"] = dcn["mode"]
    os.environ["SIDE_TPU_TORCH_DCN_RADIUS"] = str(dcn["radius"])
    os.environ["SIDE_TPU_TORCH_DCN_FUSED"] = "0"
    os.environ["SIDE_TPU_TORCH_HOST_TAIL"] = "0"
    run.execute()
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    import torch
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
