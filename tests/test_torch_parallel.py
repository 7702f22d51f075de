"""Data-parallel training of the port (side_tpu_torch/parallel/mesh.py)
against the port's one-process run on the joined batch and against the
JAX package's Trainer on a 2-device mesh.

Two gloo ranks on the CPU (spawned once for the module, a file store under
the test's temporary directory) run every rank-side job of
tests/torch_dp.py; each holds half of the global batch.

Tolerances:
- BatchNorm (FoldedBatchNorm, BatchNorm over dim 1 and over the last
  dim), synced over the ranks, against one module on the whole batch:
  output, d_x, d_weight, d_bias (summed over the ranks) and running
  statistics to 1e-6 relative (max |diff| over max |reference|).  Only the
  order of the sums differs.
- The voxel PointNet in training mode (dropout mask drawn at the global
  shape and sliced, synced BatchNorms) over the ranks' halves against one
  module on the whole: output and running statistics to 1e-5 relative
  (its BatchNorms after the max-pool take statistics over 4 objects).
- stereo_loss split over the ranks: every part and the gradient with
  respect to every output and to loss_weight to 1e-6, with and without
  --uncert, with the depth-bin term, with --mse_loss, with no positive on
  one rank and with none at all (focal's branch follows the global count).
- The train step (64x128, f32, 1 pair a rank, max_objs 4, roi_size 4, the
  well-conditioned weights of runtime/synthetic.py:interior_init), for the
  flagship, --remat and --depth_variant voxel:
  - eval-mode BatchNorm: loss parts to 1e-6, the all-reduced gradients to
    1e-5 of each tensor's largest value;
  - training mode: loss parts to 1e-4, running statistics to 1e-5 of
    each tensor's largest value.  Splitting the batch only reorders the
    sums of the batch statistics, but batch statistics make this network
    amplify float noise (tests/test_torch_train.py's docstring: its
    train-mode gradients are chaotic in f32): the gradients are held to
    twice the one-process run's own distance from itself under a 1e-7
    change of its input (its noise floor), in the worst tensor and in the
    median over tensors.  Five keys of the voxel variant, whose floor is
    above the fixed bound, are held to the larger of the bound and twice
    their floor (VOXEL_NOISY): the running statistics of its PointNet
    BatchNorms after the 1000-point max-pool (fc_bn1, fc_bn2), which take
    statistics over the 8 RoI slots of the batch, many of them the
    identical empty slots, and its depth loss, which those feed.  A 1e-7
    input change moves them by 1.2e-5 to 2.6e-5 and 2.1e-4 relative
    (measured on the CPU); every other key keeps the fixed bound;
  - parameters (after Adam), gradients and running statistics are
    identical bit for bit on both ranks.

A world-1 process group runs every collective of the flagship step and
leaves each bit of it as the step without a mesh has it.

The same step against the JAX package's Trainer on a 2-device mesh is in
tests/test_torch_parallel_jax.py, the train CLI's ranks in
tests/test_torch_parallel_cli.py.
"""

import pytest
import torch

import torch_dp
from torch_dp import (BN_CASES, LOSS_CASES, STEP_CASES, bn_case, bn_run,
                      loss_run, rel_err)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of torch_dp.all_jobs."""
    return torch_dp.spawn(torch_dp.all_jobs, 2,
                          str(tmp_path_factory.mktemp("dp")))


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("case", [f"{k}{c}" for k, c in BN_CASES])
def test_synced_batchnorm_matches_one_module(ranks, case):
    kind, cdim = next((k, c) for k, c in BN_CASES if f"{k}{c}" == case)
    bn, x, g = bn_case(kind, cdim)
    want = bn_run(bn, torch.from_numpy(x), torch.from_numpy(g))
    got = [r["bn"][case] for r in ranks]
    for key in ("y", "dx"):
        assert rel_err(torch.cat([r[key] for r in got]), want[key]) <= 1e-6
    for key in ("dweight", "dbias"):
        assert rel_err(got[0][key] + got[1][key], want[key]) <= 1e-6
    for key in ("running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key]), key
        assert rel_err(got[0][key], want[key]) <= 1e-6, key


# ------------------------------------------------------------ PointNetDepth
def test_pointnet_follows_the_global_batch(ranks):
    """The voxel PointNet in training mode over the ranks' halves: its
    dropout mask drawn at the global shape and sliced, its BatchNorms
    synced, so the ranks' output rows joined equal one module's on the
    whole batch."""
    pn, x = torch_dp.pointnet_case()
    want = torch_dp.pointnet_run(pn, torch.from_numpy(x))
    got = [r["pointnet"] for r in ranks]
    assert rel_err(torch.cat([g["y"] for g in got]), want["y"]) <= 1e-5
    for k, v in want["running"].items():
        assert torch.equal(got[0]["running"][k], got[1]["running"][k]), k
        assert rel_err(got[0]["running"][k], v) <= 1e-5, k


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_split_loss_matches_whole_batch(ranks, case):
    want = loss_run(case)
    got = [r["loss"][case] for r in ranks]
    assert got[0]["stats"] == got[1]["stats"]
    assert set(got[0]["stats"]) == set(want["stats"])
    for k, v in want["stats"].items():
        assert abs(got[0]["stats"][k] - v) <= 1e-6 * max(abs(v), 1e-6), k
    assert set(got[0]["grads"]) == set(want["grads"])
    for k, v in want["grads"].items():
        joined = torch.cat([r["grads"][k] for r in got])
        assert rel_err(joined, v) <= 1e-6, k
    assert rel_err(got[0]["lw_grad"] + got[1]["lw_grad"],
                   want["lw_grad"]) <= 1e-6


def test_focal_branch_follows_the_global_count(ranks):
    """One rank without positives takes the normalised branch with the
    other's count; with none anywhere both take -neg_loss."""
    one = [r["loss"]["rank_without_positives"]["stats"]["hm_loss"]
           for r in ranks]
    assert one[0] == one[1] > 0
    none = loss_run("no_positives")["stats"]["hm_loss"]
    assert ranks[1]["loss"]["no_positives"]["stats"]["hm_loss"] == \
        pytest.approx(none, rel=1e-6)


# --------------------------------------------------------------- train step
def _parts_close(got, want, tol):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (k, got[k], v)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_eval_mode_matches_one_process(ranks, case):
    res = ranks[0]["step"][case]["eval"]
    _parts_close(res["stats"], res["want_stats"], 1e-6)
    worst = max(res["errors"], key=res["errors"].get)
    assert res["errors"][worst] <= 1e-5, (worst, res["errors"][worst])


# the train-mode keys held to max(bound, twice their noise floor)
VOXEL_NOISY = {("voxel", "depth_loss")} | {
    ("voxel", f"pointNet.{bn}.running_{s}")
    for bn in ("fc_bn1", "fc_bn2") for s in ("mean", "var")}


def _bound(case, key, bound, floor):
    if (case, key) in VOXEL_NOISY:
        return max(bound, 2 * floor[key])
    return bound


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_train_mode_matches_one_process(ranks, case):
    res = ranks[0]["step"][case]["train"]
    noise = ranks[1]["step"][case]["train"]
    assert set(res["stats"]) == set(res["want_stats"])
    assert {k for c, k in VOXEL_NOISY if c == case} <= \
        set(res["want_stats"]) | set(res["want_running"])
    for k, v in res["want_stats"].items():
        err = abs(res["stats"][k] - v) / max(abs(v), 1e-3)
        assert err <= _bound(case, k, 1e-4, noise["noise_stats"]), (k, err)
    for k, v in res["want_running"].items():
        err = rel_err(res["running"][k], v)
        assert err <= _bound(case, k, 1e-5, noise["noise_running"]), \
            (k, err)
    dp = torch_dp.summary(res["errors"])
    floor = torch_dp.summary(noise["noise_errors"])
    assert floor["max"] > 0
    for k in ("max", "median"):
        assert dp[k] <= 2 * floor[k], (k, dp, floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ranks_hold_identical_state(ranks, case):
    a, b = (r["step"][case] for r in ranks)
    for key in ("param_digest", "running_digest", "grad_digest"):
        assert a[key] == b[key], key
    assert a["train"]["stats"] == b["train"]["stats"]


def test_world1_group_step_equals_no_mesh(tmp_path):
    """A world-1 process group runs every collective of the step and
    changes no bit of it: the sync-BN divides the summed means by 1, the
    loss shares by 1, the all-reduces of one rank return their input."""
    res = torch_dp.spawn(torch_dp.world1_job, 1, str(tmp_path))[0]
    assert res["group"] == res["no_mesh"]
