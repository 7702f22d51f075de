"""The port's data-parallel train CLI on the CPU.

`python -m side_tpu_torch.train --device cpu --num_devices 2`: two gloo
ranks, spawned by the CLI, train one iteration on the synthetic fixture;
rank 0 alone writes the log and the checkpoint, which the JAX package's
Trainer loads and resumes.  The rank loaders: with --num_devices every
rank's batches are its slices of the one-process run's global batches;
with --distributed each rank draws a local batch of batch_size // world
from seed cfg.seed + 13 * rank (tools/train.py).
"""

import glob
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dp


def _cli_cfg(monkeypatch):
    from side_tpu_torch import train
    cli = train.Config.cli
    monkeypatch.setattr(train.Config, "cli", staticmethod(
        lambda argv=None: cli(argv).replace(roi_size=4)))
    # the optional TensorBoard writer imports TensorFlow here (~20 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    return train


def test_train_cli_two_ranks(fixture_root, tmp_path, monkeypatch, capsys):
    """--num_devices 2 --device cpu: two gloo ranks train one iteration;
    rank 0 alone writes the log and the checkpoint, which the JAX Trainer
    loads.  The ranks are new processes, which the sys.modules block on
    TensorBoard does not reach: a `tensorboard` package on sys.path (which
    spawned processes inherit) that fails to import keeps them from
    importing TensorFlow (~20 s)."""
    from side_tpu.config import Config as JConfig
    from side_tpu.models.stereo_net import StereoNet as JStereoNet
    from side_tpu.models.stereo_net import init_stereo_net
    from side_tpu.parallel.mesh import make_mesh
    from side_tpu.runtime.trainer import Trainer as JTrainer
    train = _cli_cfg(monkeypatch)
    stub = tmp_path / "no_tensorboard" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        'raise ImportError("TensorBoard is blocked in this test")\n')
    monkeypatch.syspath_prepend(str(stub.parent))
    argv = ["stereo", "--data_dir", fixture_root, "--exp_dir", str(tmp_path),
            "--input_h", "64", "--input_w", "128", "--batch_size", "2",
            "--num_epochs", "1", "--num_iters", "1", "--val_intervals", "0",
            "--num_workers", "1", "--compute_dtype", "float32", "--uncert",
            "--device", "cpu", "--num_devices", "2"]
    assert train.main(argv) == 0
    exp = tmp_path / "stereo" / "default"
    assert len(glob.glob(str(exp / "log_*.txt"))) == 1
    assert (exp / "model_last.npz").exists()
    jcfg = JConfig(input_h=64, input_w=128, compute_dtype="float32",
                   roi_size=4, uncert=True)
    jm = JStereoNet(heads=dict(jcfg.heads), roi_size=4, max_objs=4, topk=4,
                    down_ratio=4, input_w=128, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: init_stereo_net(jm, k, 64, 128, 4),
                            jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jt = JTrainer(jcfg, jm, variables, steps_per_epoch=1, mesh=make_mesh(1))
    capsys.readouterr()
    assert jt.load(str(exp / "model_last.npz"), resume=True) == 1
    out = capsys.readouterr().out
    assert "Skip" not in out and "No param" not in out and "reinit" not in out
    assert np.isfinite(np.asarray(jt.state.params["loss_weight"])).all()


def test_rank_batches_join_to_the_global_batch(fixture_root, monkeypatch):
    """--num_devices: each rank's batches are its slices of the one-process
    run's global batches (same shuffle, same augmentation draws)."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.parallel.mesh import Mesh
    from side_tpu_torch.train import rank_loaders
    cfg = Config(data_dir=fixture_root, input_h=64, input_w=128,
                 batch_size=2, num_workers=1)
    whole = [dict(b) for b in rank_loaders(cfg, Mesh())[0]]
    parts = [[dict(b) for b in rank_loaders(cfg, Mesh(world=2, rank=r))[0]]
             for r in range(2)]
    assert len(whole) == 2 and all(len(p) == 2 for p in parts)
    for i, want in enumerate(whole):
        assert set(parts[0][i]) == set(want) - {"meta"}
        for k in parts[0][i]:
            np.testing.assert_array_equal(
                np.concatenate([parts[0][i][k], parts[1][i][k]]), want[k], k)


def test_distributed_ranks_draw_their_own_loaders(fixture_root):
    """--distributed: a local batch of batch_size // world, seeded
    cfg.seed + 13 * rank (tools/train.py)."""
    from side_tpu_torch.config import Config
    from side_tpu_torch.parallel.mesh import Mesh
    from side_tpu_torch.train import rank_loaders
    cfg = Config(data_dir=fixture_root, input_h=64, input_w=128,
                 batch_size=4)
    for rank in range(2):
        loader = rank_loaders(cfg, Mesh(world=2, rank=rank), True)[0]
        assert loader.batch_size == 2
        want = np.random.RandomState(cfg.seed + 13 * rank).get_state()[1]
        np.testing.assert_array_equal(loader.rng.get_state()[1], want)


def test_only_rank_zero_saves(tmp_path):
    from side_tpu_torch.config import Config
    from side_tpu_torch.models.factory import create_model
    from side_tpu_torch.parallel.mesh import Mesh
    from side_tpu_torch.runtime.trainer import Trainer
    cfg = Config(**torch_dp.STEP_KW)
    tr = Trainer(cfg, create_model(cfg, seed=0), 1, device="cpu",
                 mesh=Mesh(world=2, rank=1))
    tr.save(str(tmp_path / "m.npz"), 1)
    assert not os.path.exists(tmp_path / "m.npz")


def test_shard_batch_rejects_an_uneven_split():
    from side_tpu_torch.parallel.mesh import Mesh, shard_batch
    batch = {"input": np.zeros((3, 2)), "meta": [1, 2, 3]}
    with pytest.raises(ValueError):
        shard_batch(batch, Mesh(world=2, rank=0))
    out = shard_batch({"input": np.arange(4)}, Mesh(world=2, rank=1))
    np.testing.assert_array_equal(out["input"], [2, 3])
