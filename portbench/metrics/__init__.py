"""Per-layer metrics: one file per metric, `metrics/<metric name>.py`, with
one function `read(data) -> float | None`, found by the metric's name.
`data` holds what the run collected (see drivers/); a reader that finds
nothing to read returns None and the metric is left out of the line."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str, root: str = HERE):
    path = os.path.join(root, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
