"""The port's loop closer against the JAX package's, on the CPU.

tests/test_gba_merge.py's drifted map (datasets.synthetic.drifted_loop_scene,
which chip_smoke.py's phase 18a builds too): an outbound leg of 6 keyframes
over a 300-point cloud, then a return leg of 3 keyframes over the same
places whose poses and duplicate points carry a 0.06 rad, 0.3 m drift; every
point has its viewing normal and distance band, so the loop's fusion merges
the duplicates. Both
packages' `LoopCloser` (a vocabulary of 64 words trained on the cloud's
descriptors, min_consistency 2, global BA on) take the 9 keyframes in turn
through `process_keyframe`, the JAX side with its own native build.
Compared, and why the bounds are what they are:

- per keyframe, the loop candidates, the consistency counts and whether a
  loop closed; the loop keyframe, `n_loops_closed` and `n_gba_runs`: equal;
- the rows `_search_by_sim3` adds to the Sim3 solve: equal to 1e-12
  (host NumPy on both sides, the same integer matches);
- keyframe poses and map points within 1e-4, after the essential graph and
  the fusion (`run_gba=False`) and after the global BA: the Sim3
  refinement runs in float32 in both packages, and the BA windows in
  float32 in the JAX package and in float64 in the port (ROADMAP P4); on
  this noise-free map they part by 5e-6 at most (0 before the BA); the
  fusion leaves the same points in both, fewer than before the loop;
- the loop removes the drift in both packages, to < 0.6 of the drift
  before (the JAX test's ratio), and the drifts after agree within 1e-4.

Also the branches that came with M7b run: the threads, the inertial global
BA's dispatch and the 4-DoF graph, and a candidate in another Atlas map.
"""

import numpy as np
import pytest

from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.bow.vocabulary import train_vocabulary as jax_train_vocabulary
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.loop_closing import LoopCloser as JaxLoopCloser
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.bow.vocabulary import train_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets.synthetic import (
    LOOP_FX,
    LOOP_H,
    LOOP_W,
    drifted_loop_scene,
    two_map_scene,
)
from fasttrack_tpu_torch.loop_closing import LoopCloser
from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_system import one_torch_thread

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


def _closer(torch_side, run_gba):
    mod = tmap if torch_side else jmap
    atlas, out, back, descs, drift = drifted_loop_scene(mod)
    corpus = np.concatenate([descs, descs])
    if torch_side:
        cam = make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device="cpu")
        voc = train_vocabulary(corpus, n_words=64, iters=2, device="cpu")
        K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])
        lc = LoopCloser(atlas, voc, K, camera=cam, bf=1.0, run_gba=run_gba,
                        min_consistency=2, device="cpu")
    else:
        cam = jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H)
        voc = jax_train_vocabulary(corpus, n_words=64, iters=2)
        lc = JaxLoopCloser(atlas, voc, np.asarray(cam.K()), camera=cam, bf=1.0,
                           run_gba=run_gba, min_consistency=2)
    return lc, out, back, drift


def _run(torch_side, run_gba):
    lc, out, back, drift = _closer(torch_side, run_gba)
    log = {"cands": [], "sim3_rows": []}
    detect, search = lc.db.detect_loop_candidates, lc._search_by_sim3

    def detect_loop_candidates(*a, **kw):
        log["cands"].append(detect(*a, **kw))
        return log["cands"][-1]

    def search_by_sim3(*a):
        log["sim3_rows"].append(search(*a))
        return log["sim3_rows"][-1]

    lc.db.detect_loop_candidates = detect_loop_candidates
    lc._search_by_sim3 = search_by_sim3
    drift_before = drift(back)
    n_points_before = len(lc.atlas.current.mappoints)
    log["consistency"], log["closed"] = [], []
    for kf in out + back:
        log["closed"].append(lc.process_keyframe(kf.kid))
        log["consistency"].append(dict(lc._consistency))
    m = lc.atlas.current
    log.update(
        lc=lc, drift_before=drift_before, drift_after=drift(back),
        n_points_before=n_points_before,
        poses={k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in m.keyframes.items()},
        points={k: p.position.copy() for k, p in m.mappoints.items() if not p.bad},
    )
    return log


@pytest.fixture(scope="module", params=[False, True], ids=["graph", "gba"])
def runs(request):
    with one_torch_thread():
        return _run(True, request.param), _run(False, request.param), request.param


def test_detection_equals_jax(runs):
    t, j, _ = runs
    assert t["cands"] == j["cands"] and len(t["cands"]) == 9
    assert t["consistency"] == j["consistency"]
    assert t["closed"] == j["closed"] and any(t["closed"])
    lt, lj = t["lc"], j["lc"]
    assert (lt.n_loops_closed, lt.last_loop_kf_id) == (lj.n_loops_closed, lj.last_loop_kf_id)
    assert lt.n_loops_closed >= 1


def test_search_by_sim3_rows_equal_jax(runs):
    t, j, _ = runs
    assert len(t["sim3_rows"]) == len(j["sim3_rows"]) >= 1
    for a, b in zip(t["sim3_rows"], j["sim3_rows"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert len(a[0]) >= 10
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, atol=1e-12, rtol=0)


def test_corrected_map_equals_jax(runs):
    t, j, run_gba = runs
    assert t["lc"].n_gba_runs == j["lc"].n_gba_runs == int(run_gba)
    assert sorted(t["poses"]) == sorted(j["poses"])
    for k, (R, tt) in t["poses"].items():
        np.testing.assert_allclose(R, j["poses"][k][0], atol=ATOL)
        np.testing.assert_allclose(tt, j["poses"][k][1], atol=ATOL)
    assert sorted(t["points"]) == sorted(j["points"])
    assert len(t["points"]) < t["n_points_before"] == j["n_points_before"]
    for k, p in t["points"].items():
        np.testing.assert_allclose(p, j["points"][k], atol=ATOL)


def test_the_loop_removes_the_drift(runs):
    t, j, _ = runs
    assert t["drift_before"] == j["drift_before"] > 0.15
    for r in (t, j):
        assert r["drift_after"] < 0.6 * r["drift_before"], (r["drift_before"], r["drift_after"])
    assert t["drift_after"] == pytest.approx(j["drift_after"], abs=ATOL)


# ------------------------------------------------------------ the branches of M7b
def test_branches_of_m7b_run():
    """What the synchronous closer of M7a raised for runs: a run_async
    closer builds and stops, the inertial `_run_global_ba` dispatches to the
    mapper's converged full inertial BA, and a candidate in another Atlas
    map welds the maps (tests/test_torch_map_merge.py and
    test_torch_inertial_loop.py hold these against the JAX package)."""
    lc, out, back, _ = _closer(True, run_gba=False)
    threaded = LoopCloser(lc.atlas, lc.voc, lc.K, run_async=True, device="cpu")
    assert threaded._thread.is_alive()
    threaded.stop()
    assert not threaded._thread.is_alive() and threaded.n_thread_errors == 0
    m = lc.atlas.current
    m.is_inertial = m.imu_initialized = True
    calls = []
    lc.local_mapper = type("Mapper", (), dict(
        imu_calib=object(),
        full_inertial_ba_converged=lambda self, kf, should_abort=None, lock=None:
            calls.append(kf.kid) or 1))()
    lc._run_global_ba()
    assert calls == [max(m.keyframes)] and lc.n_gba_runs == 1
    # the 4-DoF graph of an inertial map keeps the fixed vertex where it is
    poses = {k: (1.0, kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in m.keyframes.items()}
    got = lc._optimize_graph(m, poses, [], {out[0].kid})
    assert sorted(got) == sorted(poses)
    np.testing.assert_array_equal(got[out[0].kid][2], poses[out[0].kid][2])
    lc.stop()
    # the Atlas map merge: a new map over the places of an older one
    # (tests/test_gba_merge.py's two maps) welds into it
    atlas, m_old, m_new, kfs_a, kfs_b, descs = two_map_scene(tmap)
    voc = train_vocabulary(np.concatenate([descs, descs]), n_words=64, iters=2, device="cpu")
    lc = LoopCloser(atlas, voc, lc.K, camera=lc.camera, bf=1.0, run_gba=False, device="cpu")
    atlas.change_map(m_old)
    for kf in kfs_a:
        lc.process_keyframe(kf.kid)
    atlas.change_map(m_new)
    merged = [lc.process_keyframe(kf.kid) for kf in kfs_b]
    assert any(merged) and lc.n_maps_merged == 1 and lc.n_loops_closed == 0
    assert atlas.current is m_old and m_new not in atlas.maps
    assert all(kf.kid in m_old.keyframes for kf in kfs_b)
