"""The harness on the CPU at a tiny size: the result line, the readers,
the counts, the isolation from JAX and the JAX package, and that a cell,
a traffic mix and a metric are added as files alone."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.metrics import reader
from portbench.metrics.roofline import bwd_bounds_s, fwd_bound_s
from portbench.tests.tiny import SEED, kind_of, overrides

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    out = run.run_cell(workload, SEED, 1.0, bool(trace), device="cpu",
                       **overrides(kind_of(workload)))
    keys = list(out)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "checks"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = run.Run(BENCH, workload, SEED, 1, bool(trace),
                    torch.device("cpu")).metric_names(
        "per_layer" if trace else "end_to_end")
    assert set(out["metrics"]) <= set(names)
    if not trace:
        assert set(out["metrics"]) == set(names)
        assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.loads(json.dumps(out, allow_nan=False))
    # float32 on the CPU: the program's plain path is the reference's
    # function, so every compared number reads (nearly) nothing
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(name):
    read = reader(name)
    assert read({}) is None
    assert read({"kind": "train_loop"}) is None or True


def test_dcn_bounds_by_hand():
    b, h, w, cin, cout = 2, 8, 16, 64, 128
    pix = b * h * w
    flops = pix * 9 * cin * (2 * cout + 8)
    nbytes = pix * cin * 2 + pix * 27 * 4 + 9 * cin * cout * 4 + cout * 4 \
        + pix * cout * 2
    assert fwd_bound_s(b, h, w, cin, cout, "bfloat16") == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    mac = pix * 9 * cin * cout
    dx = max((2 * mac + pix * 9 * cin * 9) / 989e12,
             (pix * cout * 2 + pix * 27 * 4 + 9 * cin * cout * 4
              + pix * cin * 2) / 3.35e12)
    assert bwd_bounds_s(b, h, w, cin, cout, "bfloat16")[0] == \
        pytest.approx(dx)


def test_dcn_flops_by_hand():
    """The counter on the reference's DeformBlock at one small shape: the
    offset/mask conv and the DCN's contraction, forward only."""
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference.dla import DeformBlock
    b, h, w, cin, cout = 2, 8, 16, 32, 64
    with torch.device("meta"):
        blk = DeformBlock(cin, cout).eval()
        x = torch.empty(b, cin, h, w)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        blk(x)
    hand = 2 * b * h * w * 27 * 9 * cin + 2 * b * h * w * 9 * cin * cout
    assert counter.get_total_flops() == hand


def test_train_flops_count_backward():
    from portbench.metrics import flops
    from portbench.traffic.config import Config
    from portbench.tests.tiny import CONFIG
    cfg = Config(**dict(CONFIG, uncert=True))
    fwd, layers = flops.count(cfg, 2, train=False)
    step, layers_t = flops.count(cfg, 2, train=True)
    assert len(layers) == len(layers_t) == 16
    assert layers_t[0][0] == 4          # both views of 2 pairs
    assert step > 2.5 * fwd             # backward: about twice the forward


def _isolated(code: str, cwd: str = ROOT, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_jax_after_a_run():
    code = (
        "import torch; torch.set_num_threads(4)\n"
        "from portbench import run\n"
        "from portbench.tests.tiny import SEED, overrides\n"
        "run.run_cell('train.side_dla34_cv.b4', SEED, 0.5, False, "
        "device='cpu', **overrides('train_loop'))\n"
        "print(run.forbidden_modules())\n"
        "import sys; print(sorted({m.split('.')[0] for m in sys.modules "
        "if m.split('.')[0].startswith('side')}))\n")
    p = _isolated(code)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['side_tpu_torch']"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import portbench.reference.model, portbench.reference.train, "
        "portbench.reference.detect, portbench.traffic.generator\n"
        "fams = portbench.reference.model.families()\n"
        "assert {f.__name__.rsplit('.', 1)[1] for f in fams} >= "
        "{'arch_dla', 'arch_resdcn'}, fams\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'side_tpu', 'side_tpu_torch', 'jax', 'jaxlib', 'flax'}))\n")
    p = _isolated(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[]"


def test_new_cell_metric_and_mix_are_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a metric and a cell (its
    limits file with it) as new files and new BENCHMARK.json entries, with
    no file edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*")
              if p.is_file()}
    os.symlink(os.path.join(ROOT, "side_tpu_torch"), copy / "side_tpu_torch")
    mix = json.load(open(copy / "portbench/traffic/train_b4.json"))
    mix["pairs_per_step"] = 2
    (copy / "portbench/traffic/train_b2.json").write_text(json.dumps(mix))
    shutil.copy(copy / "portbench/limits/train.side_dla34_cv.b4.json",
                copy / "portbench/limits/train.side_dla34_cv.b2.json")
    (copy / "portbench/metrics/steps_traced.train.py").write_text(
        "def read(d):\n"
        "    return d.get('trace_steps') if d.get('kind') == 'train_loop' "
        "else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "train.side_dla34_cv.b2",
                               "config": "side_dla34_cv",
                               "traffic": "train_b2", "chips": 1,
                               "why": "two pairs a step"})
    for m in bench["end_to_end"]:
        if "train.side_dla34_cv.b4" in m.get("workloads", []):
            m["workloads"].append("train.side_dla34_cv.b2")
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "train_pairs_per_s",
                               "workloads": ["train.side_dla34_cv.b2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, torch; torch.set_num_threads(4)\n"
        "from portbench import run\n"
        "from portbench.tests.tiny import SEED, overrides\n"
        "o = overrides('train_loop'); o['mix_overrides'].pop('pairs_per_step')\n"
        "out = run.run_cell('train.side_dla34_cv.b2', SEED, 0.5, True, "
        "device='cpu', **o)\n"
        "print(json.dumps(out))\n")
    p = _isolated(str(code), cwd=str(copy))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["steps_traced.train"]["value"] == 2
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"


def test_checkout_without_the_program_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no result,
    a nonzero exit."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


# sha256 of the DLA configurations' weight draws (name, shape, float32
# bytes of every leaf in order) and of their single-layer tables ([name,
# module path, a deformable block or not] of every layer the model has),
# at the tiny size on the CPU, as the harness drew them before the
# reference found its model, layers and heatmap bias by arch family.
DLA_DIGESTS = {
    "side_dla34_cv": (
        400,
        "fca47a91bb417c9425bdef14ab775325fcf9570bff1071297da132b8d0889ee6",
        "325dd67a0ca6654227425bc178edf08a2b45606b74e81f876b098a0727b62451"),
    "side_dla34_voxel": (
        399,
        "26a5e1262b878260ef98b39eff190bef781c95124ff67958a98a6962f97dda79",
        "252e2db4c914b76905eef8000e76c0df317087cf9178d0a84d6d954ed8e1499a"),
}


@pytest.mark.parametrize("config", sorted(DLA_DIGESTS))
def test_dla_draws_and_tables_unchanged(config):
    import hashlib
    import numpy as np
    from portbench import weights
    from portbench.reference import layers, model as ref_model
    from portbench.traffic.config import Config
    from portbench.tests.tiny import CONFIG
    keys = json.load(open(os.path.join(
        ROOT, "portbench", "configs", f"{config}.json")))["config"]
    meta = ref_model.build(Config(**dict(keys, **CONFIG)))
    w = weights.draw(meta, SEED, "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(repr(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().astype(np.float32).tobytes())
    table = []
    for name, path in layers.table(meta).items():
        try:
            mod = meta.get_submodule(path)
        except AttributeError:
            continue
        table.append([name, path, hasattr(mod, "offset_mask")])
    assert (len(w), h.hexdigest(),
            hashlib.sha256(json.dumps(table).encode()).hexdigest()) == \
        DLA_DIGESTS[config]


def test_arch_without_a_family_names_the_file():
    from portbench.reference import model as ref_model
    from portbench.traffic.config import Config
    with pytest.raises(ValueError, match="portbench/reference/arch_dlav0.py"):
        ref_model.build(Config(arch="dlav0_34"))


RESDCN_CELLS = {"train.side_resdcn101.b4": ("train_b4", "train_loop",
                                            "train.side_dla34_cv.b4"),
                "val.side_resdcn101.b8": ("val_b8", "val_pass",
                                          "val.side_dla34_cv.b8")}


@pytest.mark.parametrize("workload", sorted(RESDCN_CELLS))
def test_new_family_is_files(tmp_path, workload):
    """A copy of the benchmark gains a configuration of another trunk
    family, resdcn_101 without a depth path, and a cell of it with its
    limits file, as new files and new BENCHMARK.json entries, with no file
    edited: the reference builds it, judges its three single layers and
    gives its heatmap's last conv the initial bias, and the operation count
    finds its three DCN layers."""
    mix, kind, like = RESDCN_CELLS[workload]
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*")
              if p.is_file()}
    os.symlink(os.path.join(ROOT, "side_tpu_torch"), copy / "side_tpu_torch")
    conf = json.load(open(copy / "portbench/configs/side_dla34_cv.json"))
    conf.update(name="side_resdcn101", source="CenterNet, arXiv 1904.07850")
    conf["config"].update(arch="resdcn_101", head_conv=64, cost_volume=False)
    (copy / "portbench/configs/side_resdcn101.json").write_text(
        json.dumps(conf))
    shutil.copy(copy / f"portbench/limits/{like}.json",
                copy / f"portbench/limits/{workload}.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "side_resdcn101",
                             "source": "https://arxiv.org/abs/1904.07850",
                             "file": "portbench/configs/side_resdcn101.json",
                             "reduced": [], "why": "a ResNet-101 trunk"})
    bench["workloads"].append({"name": workload, "config": "side_resdcn101",
                               "traffic": mix, "chips": 1,
                               "why": "another trunk family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(workload)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, math, torch; torch.set_num_threads(4)\n"
        "from portbench import run, weights\n"
        "from portbench.metrics import reader\n"
        "from portbench.metrics.roofline import dcn_bound_s\n"
        "from portbench.reference import model as ref_model\n"
        "from portbench.tests.tiny import SEED, overrides\n"
        f"r = run.execute({workload!r}, SEED, 0.5, True, device='cpu', "
        f"**overrides({kind!r}))\n"
        "out = r.result()\n"
        "prog = r.compared[0] if isinstance(r.compared, tuple) "
        "else r.compared\n"
        "cfg = r.ref_config(r.config_keys)\n"
        "w = weights.draw(ref_model.build(cfg), SEED, 'cpu')\n"
        "mfu = reader('mfu.train' if r.data['kind'] == 'train_loop' "
        "else 'mfu.val')(dict(r.data, device='cuda'))\n"
        "print(json.dumps({'out': out, 'layers': prog['layers'], "
        "'hm_out': w['hm_out.bias'].tolist(), "
        "'hm_conv': w['hm_conv.bias'].abs().max().item(), "
        "'dcn': r.data['dcn_layers'], 'mfu': mfu, "
        "'bound': dcn_bound_s(r.data['dcn_layers'], 'bfloat16', True)}))\n")
    p = _isolated(code, cwd=str(copy))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    out = got["out"]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)
    assert sorted(got["layers"]) == ["dcn", "head", "stem"]
    assert all(math.isfinite(v) for v in got["layers"].values())
    assert got["hm_out"] == [-2.1875] * len(got["hm_out"])
    assert got["hm_conv"] == 0.0
    # the three deconvolution stages' DCN layers, the first at Cin 2048
    assert [s[3:] for s in got["dcn"]] == [[2048, 256], [256, 128],
                                           [128, 64]]
    assert math.isfinite(got["mfu"]) and got["mfu"] > 0
    assert math.isfinite(got["bound"]) and got["bound"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"
