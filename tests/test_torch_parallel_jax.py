"""The port's data-parallel train step against the JAX package's Trainer
on a 2-device mesh (tests/conftest.py gives 8 virtual CPU devices).

Two gloo ranks of the port (tests/torch_dp.py:step_job, the flagship case:
64x128, f32, 1 pair a rank, max_objs 4, roi_size 4, interior_init
weights) run while the JAX Trainer's loss function, the batch sharded over
make_mesh(2) and the DCN windowed, is traced and compiled on the same
weights and batch.  Loss parts to 1e-3 relative in training mode and 1e-4
in eval mode, running statistics to 1e-4 of each tensor's largest value
(tests/test_torch_train.py's bounds).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dp
from torch_dp import rel_err


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return torch_dp.start(torch_dp.step_job, 2,
                          str(tmp_path_factory.mktemp("dp")), ("flagship",),
                          False)


@pytest.fixture(scope="module")
def jax_mesh_step(started):
    """Loss parts (eval and train) and new batch statistics of the JAX
    Trainer's loss function on make_mesh(2), the batch sharded over it, at
    the flagship case's weights and batch."""
    from side_tpu.config import Config as JConfig
    from side_tpu.models.stereo_net import StereoNet as JStereoNet
    from side_tpu.ops.deform_conv import dcn_mode
    from side_tpu.parallel.mesh import make_mesh, shard_batch
    from side_tpu.runtime.trainer import BATCH_KEYS, Trainer as JTrainer
    from side_tpu_torch import weights
    cfg = torch_dp.step_config("flagship")
    params, stats = weights.to_flax(torch_dp.step_model(cfg).state_dict())
    kw = {k: v for k, v in torch_dp.STEP_KW.items()}
    jm = JStereoNet(heads=dict(JConfig(**kw).heads), roi_size=4,
                    max_objs=torch_dp.SK, topk=torch_dp.SK, down_ratio=4,
                    input_w=torch_dp.SW, dtype=jnp.float32)
    mesh = make_mesh(2)
    jt = JTrainer(JConfig(**kw), jm, {"params": params,
                                      "batch_stats": stats},
                  steps_per_epoch=10, mesh=mesh)
    batch = torch_dp.step_batch(cfg)
    batch = shard_batch({k: batch[k] for k in BATCH_KEYS}, mesh)
    out = {}
    with dcn_mode("windowed"):
        for mode in ("eval", "train"):
            fn = jax.jit(lambda p, bs, b, train=mode == "train": jt._loss_fn(
                p, bs, b, train, step=jnp.zeros((), jnp.int32)))
            _, (st, new_bs) = fn(jt.state.params, jt.state.batch_stats,
                                 batch)
            out[mode] = ({k: float(v) for k, v in st.items()},
                         weights._flatten(jax.tree.map(np.asarray, new_bs)))
    return out


def _parts_close(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (k, got[k], v)


@pytest.fixture(scope="module")
def ranks(started, jax_mesh_step):
    return torch_dp.finish(started)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_step_matches_jax_trainer_on_two_devices(ranks, jax_mesh_step, mode):
    from side_tpu_torch import weights
    assert len(jax.devices()) >= 2
    want, want_bs = jax_mesh_step[mode]
    got = ranks[0]["flagship"][mode]["stats"]
    _parts_close(got, want, 1e-3 if mode == "train" else 1e-4)
    if mode == "train":
        _, got_bs = weights.to_flax(ranks[0]["flagship"]["train"]
                                    ["running"])
        got_bs = weights._flatten(got_bs)
        assert set(got_bs) == set(want_bs)
        for k, v in want_bs.items():
            assert rel_err(got_bs[k], v) <= 1e-4, k
