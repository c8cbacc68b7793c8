"""The port's inertial loop closing against the JAX package's, on the CPU.

tests/test_inertial_loop.py's scene (datasets.synthetic.drifted_loop_scene
with inertial=True, which chip_smoke.py's phase 19a builds too): an
inertial, IMU-initialized map whose outbound leg of 6 keyframes moves at
(0.4, 0, 0) per second and whose return leg of 3 keyframes carries a
0.06 rad, 0.3 m drift in its poses, points and velocities. Both packages'
`LoopCloser` (a vocabulary of 64 words trained on the cloud's descriptors,
min_consistency 2, no global BA) take the 9 keyframes in turn through
`process_keyframe`, the JAX side with its own native build. Compared, and
why the bounds are what they are:

- per keyframe, the loop candidates and whether a loop closed; the loop
  keyframe and `n_loops_closed`: equal;
- the loop runs the 4-DoF essential graph (Optimizer.cc:5292) once in each
  package, and every vertex's world-side update W_k = S_new^-1 o S_old maps
  world z to world z within 1e-6 (the graph moves in yaw and translation
  only, so gravity stays put);
- keyframe poses, velocities and map points within 1e-4, the bound of
  tests/test_torch_loop_closing.py: the Sim3 refinement runs in float32 in
  both packages, the graph on the host in float64;
- the corrected velocities match the corrected trajectory's finite
  differences within 0.25 m/s and the outbound leg's move by less than 0.2
  (tests/test_inertial_loop.py's bounds), in both packages;
- the tracker's re-anchored last-keyframe state, equal.

Also the dispatch of `_run_global_ba` (tests/test_inertial_loop.py::
test_inertial_gba_branch_dispatch): an IMU-initialized map with a mapper
that has an IMU calibration goes to the mapper's converged full inertial
BA, a visual one to the visual global BA, the same in both packages.
"""

import types

import numpy as np
import pytest

from fasttrack_tpu import ba_assembly as jba
from fasttrack_tpu import loop_closing as jloop
from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.bow.vocabulary import train_vocabulary as jax_train_vocabulary
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu_torch import loop_closing as tloop
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.bow.vocabulary import train_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets.synthetic import LOOP_FX, LOOP_H, LOOP_W, drifted_loop_scene
from fasttrack_tpu_torch.optim.pose_graph import sim3_inv, sim3_mul
from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_system import one_torch_thread

ATOL = 1e-4
GRAVITY_ATOL = 1e-6
V_TRUE = np.array([0.4, 0.0, 0.0])
K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


def stub_tracker(last_kf_id):
    """What `_refresh_tracker_anchor` reads of a tracker (T_b_c = I)."""
    return types.SimpleNamespace(use_imu=True, last_kf_id=last_kf_id, last_frame=None,
                                 last_kf_state=None, v_w=None,
                                 _body_from_cam=lambda R_cw, t_cw: (R_cw.T, -R_cw.T @ t_cw))


def closer(torch_side, atlas, descs, **kw):
    corpus = np.concatenate([descs, descs])
    if torch_side:
        cam = make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device="cpu")
        voc = train_vocabulary(corpus, n_words=64, iters=2, device="cpu")
        return tloop.LoopCloser(atlas, voc, K, camera=cam, bf=1.0, device="cpu", **kw)
    cam = jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H)
    voc = jax_train_vocabulary(corpus, n_words=64, iters=2)
    return jloop.LoopCloser(atlas, voc, np.asarray(cam.K()), camera=cam, bf=1.0, **kw)


def _run(torch_side, monkeypatch):
    mod = tloop if torch_side else jloop
    atlas, out, back, descs, _ = drifted_loop_scene(tmap if torch_side else jmap,
                                                    inertial=True)
    lc = closer(torch_side, atlas, descs, run_gba=False, min_consistency=2)
    lc.tracker = stub_tracker(back[-1].kid)
    graphs = []
    inner = mod.optimize_essential_graph_4dof

    def graph_4dof(poses, edges, fixed, *a, **kw):
        res = inner(poses, edges, fixed, *a, **kw)
        graphs.append((dict(poses), res))
        return res

    monkeypatch.setattr(mod, "optimize_essential_graph_4dof", graph_4dof)
    cands, closed = [], []
    detect = lc.db.detect_loop_candidates

    def detect_loop_candidates(*a, **kw):
        cands.append(detect(*a, **kw))
        return cands[-1]

    lc.db.detect_loop_candidates = detect_loop_candidates
    for kf in out + back:
        closed.append(lc.process_keyframe(kf.kid))
    m = atlas.current
    return dict(
        lc=lc, out=out, back=back, cands=cands, closed=closed, graphs=graphs,
        poses={k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in m.keyframes.items()},
        velocities={k: np.asarray(kf.velocity, np.float64) for k, kf in m.keyframes.items()},
        points={k: p.position.copy() for k, p in m.mappoints.items() if not p.bad},
    )


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        with one_torch_thread():
            return {"torch": _run(True, mp), "jax": _run(False, mp)}
    finally:
        mp.undo()


def test_detection_equals_jax(runs):
    t, j = runs["torch"], runs["jax"]
    assert t["cands"] == j["cands"] and len(t["cands"]) == 9
    assert t["closed"] == j["closed"] and any(t["closed"])
    lt, lj = t["lc"], j["lc"]
    assert (lt.n_loops_closed, lt.last_loop_kf_id) == (lj.n_loops_closed, lj.last_loop_kf_id)
    assert lt.n_loops_closed == 1 and lt.n_gba_runs == lj.n_gba_runs == 0


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_the_4dof_graph_keeps_gravity(runs, package):
    """Every vertex update W_k = S_new^-1 o S_old of the loop's graph maps
    world z to world z (tests/test_inertial_loop.py's check, in a loop)."""
    graphs = runs[package]["graphs"]
    assert len(graphs) == 1
    poses, out = graphs[0]
    assert sorted(out) == sorted(poses) and len(out) == 9
    ez = np.array([0.0, 0.0, 1.0])
    for k in poses:
        _, Rw, _ = sim3_mul(sim3_inv(out[k]), poses[k])
        assert np.linalg.norm(Rw @ ez - ez) < GRAVITY_ATOL, k


def test_the_4dof_graph_equals_jax(runs):
    (pt, ot), (pj, oj) = runs["torch"]["graphs"][0], runs["jax"]["graphs"][0]
    assert sorted(ot) == sorted(oj)
    for k in ot:
        for a, b in zip(pt[k] + ot[k], pj[k] + oj[k]):
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"keyframe {k}")


def test_corrected_poses_velocities_and_points_equal_jax(runs):
    t, j = runs["torch"], runs["jax"]
    assert sorted(t["poses"]) == sorted(j["poses"])
    for k, (R, tt) in t["poses"].items():
        np.testing.assert_allclose(R, j["poses"][k][0], atol=ATOL)
        np.testing.assert_allclose(tt, j["poses"][k][1], atol=ATOL)
        np.testing.assert_allclose(t["velocities"][k], j["velocities"][k], atol=ATOL)
    assert sorted(t["points"]) == sorted(j["points"])
    for k, p in t["points"].items():
        np.testing.assert_allclose(p, j["points"][k], atol=ATOL)


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_velocities_follow_the_corrected_trajectory(runs, package):
    r = runs[package]
    back, out = r["back"], r["out"]
    for k in range(len(back) - 1):      # keyframes 1 s apart
        dc = back[k + 1].center - back[k].center
        v = np.asarray(back[k].velocity)
        assert np.linalg.norm(v - dc) < 0.25, (k, v, dc)
    for kf in out[:3]:
        assert np.linalg.norm(np.asarray(kf.velocity) - V_TRUE) < 0.2


def test_the_tracker_is_re_anchored_as_in_jax(runs):
    t, j = runs["torch"]["lc"].tracker, runs["jax"]["lc"].tracker
    assert t.last_kf_state is not None and j.last_kf_state is not None
    for a, b in zip(t.last_kf_state, j.last_kf_state):
        np.testing.assert_allclose(a, b, atol=ATOL)
    np.testing.assert_allclose(t.v_w, j.v_w, atol=ATOL)
    # the anchor is the corrected keyframe's body state
    kf = runs["torch"]["back"][-1]
    np.testing.assert_allclose(t.last_kf_state[1], kf.center, atol=1e-12)


# ------------------------------------------------------- the global BA's dispatch
class StubMapper:
    imu_calib = object()

    def __init__(self):
        self.calls = []

    def full_inertial_ba_converged(self, kf, should_abort=None, lock=None):
        self.calls.append((kf.kid, should_abort(), lock))
        return 1


def _dispatch(torch_side, inertial, monkeypatch):
    atlas, out, back, _, _ = drifted_loop_scene(tmap if torch_side else jmap,
                                                inertial=inertial)
    mod = tloop if torch_side else jloop
    cam = (make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device="cpu")
           if torch_side else jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2,
                                               LOOP_W, LOOP_H))
    kw = dict(device="cpu") if torch_side else {}
    lc = mod.LoopCloser(atlas, None, K, camera=cam, bf=1.0, **kw)
    visual = []

    def global_bundle_adjustment(m, *a, fixed_kf_ids=None, should_abort=None, lock=None, **kw):
        visual.append((m.n_keyframes(), fixed_kf_ids, should_abort(), lock))
        return 0

    monkeypatch.setattr(tloop if torch_side else jba, "global_bundle_adjustment",
                        global_bundle_adjustment)
    lc.local_mapper = StubMapper()
    lc.tracker = stub_tracker(back[-1].kid)
    lc.abort_gba = True
    lc._run_global_ba(fixed_kf_ids={out[0].kid})
    return lc, visual


@pytest.mark.parametrize("inertial", [True, False], ids=["inertial", "visual"])
def test_the_global_ba_dispatch_equals_jax(inertial, monkeypatch):
    (lt, vt), (lj, vj) = (_dispatch(True, inertial, monkeypatch),
                          _dispatch(False, inertial, monkeypatch))
    assert lt.n_gba_runs == lj.n_gba_runs == 1
    assert lt.local_mapper.calls == lj.local_mapper.calls
    assert vt == vj
    if inertial:
        # the latest keyframe, the abort flag cleared at the start, no lock inline
        assert lt.local_mapper.calls == [(8, False, None)] and vt == []
        assert lt.tracker.last_kf_state is not None     # re-anchored after the BA
    else:
        assert lt.local_mapper.calls == [] and vt == [(9, {0}, False, None)]
