"""side_tpu_torch stands alone: no JAX, nothing of side_tpu.

Every module of the port imports in a fresh interpreter where `jax` and
`side_tpu` cannot be imported; no file of the package, nor chip_smoke.py,
names them in an import; and chip_smoke.py fails on a machine without a
CUDA device instead of reporting a result.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "side_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "side_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None
import side_tpu_torch
names = [m.name for m in pkgutil.walk_packages(side_tpu_torch.__path__,
                                                "side_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _python_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "test_torch_cuda.py",
                                         ROOT / "tests" / "torch_dp.py",
                                         ROOT / "tests" / "torch_box_rows.py"]


def test_every_module_imports_without_jax_or_side_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=FORBIDDEN)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 61, proc.stdout


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_side_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


NEW_MODULES = ("val", "postprocess.post_process", "runtime.evaluator",
               "ops.gather_cuda", "tools.gather_microbench",
               "tools.acceptance_16", "tools.acceptance_rate",
               "models.voxel_net", "models.resnet_dcn", "models.dla_seg",
               "models.legacy", "parallel.mesh", "ops.psroi_pool",
               "utils.debugger", "tools.offset_audit", "tools.finetune_clamp",
               "tools.vis_dataset", "tools.loader_bench",
               "tools.convert_dla34_weights",
               "tools.convert_reference_weights",
               "tools.convert_kitti_to_coco", "tools.calc_anchor_overlap",
               "bench", "graft_entry", "ops.box_solve_cuda")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_validation_modules_are_walked(name):
    """The modules of the later slices are files of the package, so the
    two checks above cover them."""
    path = PKG / (name.replace(".", "/") + ".py")
    assert path in _python_files()
    if "." in name:
        assert (path.parent / "__init__.py").exists()


def test_chip_smoke_fails_without_a_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
