"""The port's process groups (fasttrack_tpu_torch.parallel.multihost)
against the JAX package's, on the CPU.

- `initialize_distributed` is the JAX function's no-op for one process or no
  address, reads the same environment variables, and joins a group at
  tcp://<address> with gloo for CPU shards (seen at
  `torch.distributed.init_process_group`, which the test stands in for);
- `shard_ba_problem` keeps the values: this process's slices, concatenated,
  are the window, and equal the JAX package's global arrays; the sharded
  problem solves as the whole one does (tests/test_multihost.py:39-54);
- two processes x 4 CPU shards over gloo (`tools/torch_bench_multichip.py
  --processes 2 --shards 4`, 120 s a process, one torch thread each) solve
  the seeded window to what one process with 8 shards gives: the shards'
  partial systems are added pairwise in shard order and the two processes'
  sums once, so the two runs add the same numbers in the same order
  (costs within 1e-6 relative, poses within 1e-6; they read equal).
"""

import numpy as np
import pytest
import torch

from fasttrack_tpu.parallel import make_global_mesh as jax_make_global_mesh
from fasttrack_tpu.parallel import shard_ba_problem as jax_shard_ba_problem
from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.parallel import (
    distributed_bundle_adjustment,
    initialize_distributed,
    make_global_mesh,
    make_mesh,
    multihost,
    shard_ba_problem,
)
from fasttrack_tpu_torch.parallel import dryrun
from tests.test_torch_system import one_torch_thread
from tools import bench_multichip, torch_bench_multichip

ENV = ("FASTTRACK_COORDINATOR", "FASTTRACK_NUM_PROCS", "FASTTRACK_PROC_ID")


@pytest.fixture
def window():
    arrays, cam, bf, _ = dryrun.make_problem(K=8, L=256, obs_per_point=4)
    return convert.ba_problem_from_numpy(arrays, "cpu"), make_pinhole(*cam, device="cpu"), bf


def test_single_process_is_a_no_op(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    assert initialize_distributed(num_processes=2, process_id=1) is False     # no address
    assert not torch.distributed.is_initialized()


def test_reads_the_jax_packages_environment(monkeypatch):
    joined = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setenv("FASTTRACK_COORDINATOR", "localhost:45123")
    monkeypatch.setenv("FASTTRACK_NUM_PROCS", "1")
    monkeypatch.setenv("FASTTRACK_PROC_ID", "0")
    assert initialize_distributed(device="cpu") is False and not joined
    monkeypatch.setenv("FASTTRACK_NUM_PROCS", "2")
    monkeypatch.setenv("FASTTRACK_PROC_ID", "1")
    assert initialize_distributed(device="cpu") is True
    assert joined == [("gloo", {"init_method": "tcp://localhost:45123", "world_size": 2,
                                "rank": 1})]


def test_make_global_mesh_without_a_group_is_make_mesh():
    mesh = make_global_mesh(device="cpu", n_devices=4)
    assert mesh == make_mesh(4, device="cpu") and mesh.group is None


def test_shard_ba_problem_keeps_the_values(window):
    prob, _, _ = window
    mesh = make_mesh(8, device="cpu")
    sp = shard_ba_problem(prob, mesh)
    assert len(sp.shards) == 8
    for name in ("points", "obs_uv", "obs_ur", "inv_sigma2", "mask", "point_free"):
        assert torch.equal(torch.cat([getattr(s, name) for s in sp.shards]), getattr(prob, name))
    for s in sp.shards:
        assert s.points.shape[0] == 32
        assert torch.equal(s.poses.t, prob.poses.t) and torch.equal(s.cam_free, prob.cam_free)
    jprob, _, _, _ = bench_multichip.make_problem(K=8, L=256, obs_per_point=4)
    g = jax_shard_ba_problem(jprob, jax_make_global_mesh())
    np.testing.assert_array_equal(np.asarray(g.points),
                                  torch.cat([s.points for s in sp.shards]).numpy())
    np.testing.assert_array_equal(np.asarray(g.poses.t), sp.shards[0].poses.t.numpy())
    with pytest.raises(ValueError, match="equal shards"):
        shard_ba_problem(prob, make_mesh(3, device="cpu"))


def test_dist_ba_on_a_sharded_problem(window):
    """tests/test_multihost.py:39-54 on the port: the sharded problem goes
    through the same solver, to the same result as the whole window."""
    prob, cam, bf = window
    mesh = make_global_mesh(device="cpu", n_devices=8)
    with one_torch_thread():
        _, _, costs, _, _ = distributed_bundle_adjustment(shard_ba_problem(prob, mesh), cam, bf,
                                                          mesh, iters=4)
        _, _, whole, _, _ = distributed_bundle_adjustment(prob, cam, bf, mesh, iters=4)
    assert costs[-1] < 0.05 * costs[0]
    assert costs == whole


def test_two_processes_of_four_shards_equal_one_of_eight():
    env = {"BMC_K": "8", "BMC_L": "256", "BMC_ITERS": "6"}
    out = torch_bench_multichip.run_multiprocess(2, shards_per_process=4, device="cpu",
                                                 timeout=120, env=env)
    assert out["processes"] == 2 and out["backend"] == "gloo"
    assert out["local_shards"] == 4 and out["global_shards"] == 8
    assert 0 < out["reduce_share"] < 1
    arrays, cam, bf, _ = dryrun.make_problem(K=8, L=256, obs_per_point=6)
    with one_torch_thread():
        poses, _, costs, inlier, _ = distributed_bundle_adjustment(
            convert.ba_problem_from_numpy(arrays, "cpu"), make_pinhole(*cam, device="cpu"), bf,
            make_mesh(8, device="cpu"), iters=6)
    assert len(out["costs"]) == len(costs)
    np.testing.assert_allclose(out["costs"], costs, rtol=1e-6)
    np.testing.assert_allclose(out["poses_t"], poses.t.numpy(), atol=1e-6)
    assert out["inliers"] == int(inlier.sum())


def test_a_failing_process_fails_its_caller():
    with pytest.raises(RuntimeError, match="failed, rc"):
        torch_bench_multichip.run_multiprocess(2, shards_per_process=3, device="cpu",
                                               timeout=120, env={"BMC_K": "8", "BMC_L": "256"})
