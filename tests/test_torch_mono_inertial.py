"""The port's monocular-inertial System (`Sensor.IMU_MONOCULAR`) on the CPU.

The scene is tests/test_mono_e2e.py's sweep (`generate_sequence(h=240,
w=320, seed=3)`) with its exact 200 Hz IMU stream and T_b_c1 = I, 512
features, 4 levels, `vocabulary=False`, inline mapping, the port with
device="cpu" on one torch thread. 60 frames render the same trajectory as
50 (the sweep's period is max(T, 3 s)); the port runs all 60, through its
IMU init at frame 42.

The JAX package's own System loses track right after its IMU init on this
scene (ROADMAP F35). The port repairs the causes as recorded differences,
each acting on a monocular-inertial map only:

- F33: the second keyframe of the two-view init carries the preintegration
  from the reference frame (the JAX package hands it an empty one);
- F34: the IMU init's velocities are metric and are not scaled again;
- F35: before its IMU init a monocular-inertial map takes a keyframe every
  0.25 s and no other, as the reference's inertial branch of
  NeedNewKeyFrame returns (the JAX package falls through to the ratio test,
  a keyframe on nearly every frame, and the map's scale drifts ~2.5x across
  the 2 s chain that the init fits with one scale);
- F36 and F37: after a rescale the points' normals and distances, and the
  tracker's frames (saved, last and in flight), follow the map;
- F38: after the IMU init the reference ratio is IMU_MONOCULAR's, 0.75
  above 350 inliers.

So the port is held:
- against the JAX `System` as it is up to the first keyframe that F35
  changes: the same two-view init frame, states, keyframe frames and poses
  (2e-3);
- against the JAX `System` with F33, F34 and F35 applied from this file
  (wrapped, never switched in a package) up to its IMU init: the same
  states and keyframe frames, the IMU init at the same frame, poses within
  2e-3 before the first local bundle adjustment (after it the JAX float32
  adjustment parts from the port's float64 one, ROADMAP P4), and tracking
  on past the init, where the JAX package as it is loses track;
- after its IMU init against the renderer's ground truth: every frame OK,
  the Sim(3) scale from the init's frame on within 5% of 1.0, the SE(3)
  ATE of the frames after it below 5 mm (the port reads 2.5 mm), the
  init's own frame saved in the metric world, inertial fused frames;
- `initialize_imu` and `LocalMapper._scale_refinement` on one keyframe
  chain built from the renderer's numbers, through both packages: scale
  within 1e-6 relative, gravity within 1e-6 rad, the same apply-or-skip
  decision, on a chain that needs a scale and on one already at scale; the
  refinement's branch on every 10th keyframe in both;
- each recorded difference by a test of its own; `async_mapping=True`
  (port only) through the IMU init, no thread alive after `shutdown()`;
- the System's wiring: the mono route with an IMU, `fix_scale=True`.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import rig_reading
from fasttrack_tpu import native as jnative
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error, umeyama_alignment

H, W = 240, 320
N_FRAMES = 60
JAX_TAIL = 3               # frames the wrapped JAX run goes past its IMU init
POSE_ATOL = 2e-3
SCALE_TOL = 0.05           # Sim(3) scale after the init, and the init's scale against JAX
ATE_AFTER_INIT_M = 0.005   # the port reads 0.0025 m over the 17 frames after its init
INIT_FRAME_ERROR_M = 0.05  # the init's own frame, aligned with those: the port reads 0.023 m


def numpy_hamming_matrix_packed(a, b):
    bits_a = np.unpackbits(np.ascontiguousarray(a, np.uint8), axis=1).astype(np.int32)
    bits_b = np.unpackbits(np.ascontiguousarray(b, np.uint8), axis=1).astype(np.int32)
    return (bits_a @ (1 - bits_b).T + (1 - bits_a) @ bits_b.T).astype(np.int32)


@pytest.fixture(scope="module")
def seq():
    from fasttrack_tpu_torch.datasets.synthetic import generate_sequence

    return generate_sequence(n_frames=N_FRAMES, h=H, w=W, seed=3)


def make_settings(pkg, seq):
    if pkg == "jax":
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.settings import Settings

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H)
    else:
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.settings import Settings

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
    s = Settings()
    s.width, s.height, s.camera1 = W, H, cam
    s.bf, s.n_features, s.n_levels = 0.0, 512, 4
    s.imu_frequency, s.T_b_c1 = 200.0, np.eye(4)
    return s


def imu_between(seq, t0, t1):
    sel = (seq.imu_t > t0) & (seq.imu_t <= t1)
    return [(float(t), seq.imu_acc[i], seq.imu_gyro[i])
            for i, t in zip(np.where(sel)[0], seq.imu_t[sel])]


def drive(system, seq, stop=None):
    """Track the frames with their samples; one row per frame. `stop(rows)`
    ends the run early."""
    rows, t_prev = [], -1.0
    for f in seq.frames:
        system.track_monocular(f.left, f.timestamp, imu=imu_between(seq, t_prev, f.timestamp))
        t_prev = f.timestamp
        m, tr = system.atlas.current, system.tracker
        lf = tr.last_frame
        rows.append(dict(
            state=system.tracking_state.name, imu=bool(m.imu_initialized),
            kf_frames=sorted(k.frame_id for k in m.keyframes.values()),
            R=None if lf.R_cw is None else lf.R_cw.copy(),
            t=None if lf.t_cw is None else lf.t_cw.copy(),
        ))
        if stop is not None and stop(rows):
            break
    return rows


def imu_init_frame(rows):
    return [r["imu"] for r in rows].index(True)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ------------------------------------------------------------------ the runs
@pytest.fixture(scope="module")
def runs(seq):
    """The port over all frames; the JAX System as it is up to frame 8; the
    JAX System with the recorded differences up to JAX_TAIL frames past its
    IMU init. Each once."""
    from fasttrack_tpu.system import Sensor as JSensor
    from fasttrack_tpu.system import System as JSystem
    from fasttrack_tpu_torch.system import Sensor, System

    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    try:
        system = System(make_settings("torch", seq), Sensor.IMU_MONOCULAR, vocabulary=False,
                        device="cpu")
        out["torch"] = (system, drive(system, seq))
        system.shutdown()
        system = JSystem(make_settings("jax", seq), JSensor.IMU_MONOCULAR, vocabulary=False)
        out["jax"] = (system, drive(system, seq, stop=lambda rows: len(rows) == 8))
        system.shutdown()
        # F33, F34 and F35 applied to the JAX package from outside it, by the
        # wrappers that the committed reading switches them with
        rig_reading._mono_inertial_variant("jax", ("f33", "f34", "f35"), (),
                                           lambda owner, name, value: mp.setattr(owner, name, value))
        system = JSystem(make_settings("jax", seq), JSensor.IMU_MONOCULAR, vocabulary=False)
        out["jax_repaired"] = (system, drive(system, seq, stop=lambda rows: (
            rows[-1]["imu"] and len(rows) > imu_init_frame(rows) + JAX_TAIL)))
        system.shutdown()
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return out


def test_two_view_init_states_and_keyframes_equal_jax_until_f35_acts(runs):
    """The JAX System as it is: the same two-view init frame, and the same
    states and keyframe frames on every frame before the first keyframe the
    pre-init keyframe rule (F35) takes away."""
    jrows, trows = runs["jax"][1], runs["torch"][1]
    init = [r["state"] for r in trows].index("OK")
    assert init == [r["state"] for r in jrows].index("OK") <= 3
    first_changed = next(i for i, (a, b) in enumerate(zip(jrows, trows))
                         if a["kf_frames"] != b["kf_frames"])
    assert first_changed > init
    for a, b in zip(jrows[:first_changed], trows[:first_changed]):
        assert a["state"] == b["state"]
    for a, b in zip(jrows[init:first_changed], trows[init:first_changed]):
        np.testing.assert_allclose(b["R"], a["R"], atol=POSE_ATOL)
        np.testing.assert_allclose(b["t"], a["t"], atol=POSE_ATOL)


def test_imu_init_at_the_frame_of_jax_with_the_recorded_differences(runs):
    (jsys, jrows), (tsys, trows) = runs["jax_repaired"], runs["torch"]
    init = imu_init_frame(trows)
    assert imu_init_frame(jrows) == init >= 40
    for a, b in zip(jrows[:init + 1], trows[:init + 1]):
        assert (a["state"], a["kf_frames"]) == (b["state"], b["kf_frames"])
    assert tsys.local_mapper.imu_init_time == jsys.local_mapper.imu_init_time


def test_poses_equal_jax_with_the_recorded_differences_before_the_first_adjustment(runs):
    (_, jrows), (tsys, trows) = runs["jax_repaired"], runs["torch"]
    # the third keyframe's frame is the first tracked against an adjusted map
    first_adjusted = sorted(k.frame_id for k in tsys.atlas.current.keyframes.values())[2] + 1
    init = [r["state"] for r in trows].index("OK")
    assert first_adjusted > init + 2
    for i in range(init, first_adjusted):
        np.testing.assert_allclose(trows[i]["R"], jrows[i]["R"], atol=POSE_ATOL, err_msg=f"{i}")
        np.testing.assert_allclose(trows[i]["t"], jrows[i]["t"], atol=POSE_ATOL, err_msg=f"{i}")


def test_jax_with_the_recorded_differences_tracks_past_its_imu_init(runs):
    """The JAX System as it is loses track one or two frames after its IMU
    init on this scene (ROADMAP F35); with the three differences applied it
    tracks on, as the port does. Their init scales are not compared: before
    the init the JAX float32 visual adjustment drives its map by rounding
    noise (P4), and the two maps part by centimetres."""
    _, jrows = runs["jax_repaired"]
    init = imu_init_frame(jrows)
    assert len(jrows) == init + JAX_TAIL + 1
    assert [r["state"] for r in jrows[init:]] == ["OK"] * (JAX_TAIL + 1)


def after_init(system, rows, seq, with_the_init_frame=True):
    """The saved camera centres from the IMU init's frame on (or from the
    frame after it)."""
    init = imu_init_frame(rows)
    t_init = seq.frames[init].timestamp
    traj = [(t, R, tt) for t, R, tt in system.tracker.trajectory
            if t > t_init or (with_the_init_frame and t == t_init)]
    ts = np.asarray([t for t, _, _ in traj])
    ps = np.asarray([-R.T @ t for _, R, t in traj])
    return init, ts, ps


def test_every_frame_after_the_imu_init_is_ok(runs):
    _, rows = runs["torch"]
    init = imu_init_frame(rows)
    assert init <= N_FRAMES - 10
    assert [r["state"] for r in rows[init:]] == ["OK"] * (N_FRAMES - init)
    assert [r["state"] for r in rows[:init]].count("OK") >= init - 2


def test_the_scale_after_the_imu_init_is_metric(runs, seq):
    system, rows = runs["torch"]
    _, ts, ps = after_init(system, rows, seq)
    sim3 = absolute_trajectory_error(ts, ps, seq.gt_t, seq.gt_pos, with_scale=True)
    assert sim3["n"] >= 10 and abs(sim3["scale"] - 1.0) < SCALE_TOL, sim3


def test_the_ate_after_the_imu_init(runs, seq):
    system, rows = runs["torch"]
    _, ts, ps = after_init(system, rows, seq, with_the_init_frame=False)
    se3 = absolute_trajectory_error(ts, ps, seq.gt_t, seq.gt_pos)
    assert se3["rmse"] < ATE_AFTER_INIT_M, se3


def test_the_frame_of_the_imu_init_is_saved_in_the_metric_world(runs, seq):
    """The frame whose keyframe set off the IMU init is saved after the
    inline mapper moved the map (F37): aligned with the frames after it, its
    camera centre lies within INIT_FRAME_ERROR_M of the truth (the port
    reads 0.023 m: its pose as tracked before the init, which the init's
    inertial window then corrects in its keyframe alone). Saved in the
    visual world, at about half the scale, it lay 0.26 m off, and the
    Sim(3) scale from the init's frame on read 0.94."""
    system, rows = runs["torch"]
    init, ts, ps = after_init(system, rows, seq)
    assert ts[0] == seq.frames[init].timestamp
    idx = np.abs(seq.gt_t[None, :] - ts[:, None]).argmin(axis=1)
    s, R, t = umeyama_alignment(ps[1:], seq.gt_pos[idx[1:]])
    assert s == 1.0
    err = float(np.linalg.norm(R @ ps[0] + t - seq.gt_pos[idx[0]]))
    assert err < INIT_FRAME_ERROR_M, err


def test_inertial_fused_frames_and_windows_after_the_init(runs):
    system, _ = runs["torch"]
    series = system.stats.series
    assert sum(series["lm_imu_inits"]) == 1
    assert sum(series["fused_vi_frames"]) >= 5
    assert system.tracker.monocular and system.tracker.use_imu
    # one flip count per inertial window (the init's at least), counted on
    # the device: none here
    assert len(series["lm_inertial_steps_flipped"]) == sum(series["lm_inertial_bas"]) >= 1
    assert sum(series["lm_inertial_steps_flipped"]) == 0


def _count_branch_calls(mapper, monkeypatch, n_keyframes):
    """process_keyframe of an IMU-initialized monocular mapper with every
    step stubbed but the branch: the keyframes at which it refines."""
    calls = []
    for name in ("_track_new_points", "_cull_recent_mappoints", "_create_new_mappoints",
                 "_search_in_neighbors", "_local_inertial_ba", "_cull_keyframes",
                 "_full_inertial_ba"):
        monkeypatch.setattr(type(mapper), name, lambda self, kf, *a, **k: None)
    monkeypatch.setattr(type(mapper), "_scale_refinement",
                        lambda self, kf: calls.append(kf.kid))
    m = mapper.atlas.current
    m.imu_initialized = True
    mapper.imu_init_time = 0.0
    for kid in range(n_keyframes):
        kf = types.SimpleNamespace(kid=kid, timestamp=0.1 * kid)
        m.keyframes[kid] = kf
        mapper.process_keyframe(kf)
    return calls


def test_the_scale_refinement_runs_on_every_tenth_keyframe_as_in_jax(seq, monkeypatch):
    """The branch of process_keyframe (fasttrack_tpu/local_mapping.py:158-162):
    every 10th keyframe after the IMU init, before the first full inertial
    BA stage (5 s), in both packages."""
    tm, _ = mapper_with_the_chain(seq, "torch", 1.0)
    jm, _ = mapper_with_the_chain(seq, "jax", 1.0)
    for mapper in (tm, jm):
        mapper.atlas = type(mapper.atlas)()
    got = _count_branch_calls(tm, monkeypatch, 35)
    assert got == _count_branch_calls(jm, monkeypatch, 35) == [9, 19, 29]


# ------------------------------------------------------- the recorded differences
def test_f33_the_second_init_keyframe_spans_the_init_frames(runs):
    tsys, jsys = runs["torch"][0], runs["jax"][0]
    for system, spans in ((tsys, True), (jsys, False)):
        kfs = sorted(system.atlas.current.keyframes.values(), key=lambda k: k.kid)
        kf1, kf2 = kfs[0], kfs[1]
        assert kf1.preintegrated is None and kf2.prev_kf_id == kf1.kid
        gap = kf2.timestamp - kf1.timestamp
        assert gap > 0
        want = gap if spans else 0.0                 # the JAX package: empty (F33)
        assert kf2.preintegrated.dT == pytest.approx(want, abs=1e-9)


def chain_from_the_renderer(seq, pkg, visual_scale, n_kf=10, step=5):
    """Keyframe states every 0.25 s from the renderer's truth, the positions
    divided by `visual_scale` (a monocular map's units), and each
    preintegration from the exact IMU stream, in `pkg`'s types."""
    if pkg == "jax":
        from fasttrack_tpu.imu.preintegration import HostPreintegrated, ImuCalib

        calib = ImuCalib.default()
    else:
        from fasttrack_tpu_torch.imu.preintegration import HostPreintegrated, ImuCalib

        calib = ImuCalib.default(device="cpu")
    idx = [i * step for i in range(n_kf)]
    R_wb = [seq.gt_R[i] for i in idx]
    p_w = [seq.gt_pos[i] / visual_scale for i in idx]
    preints = []
    for a, b in zip(idx, idx[1:]):
        ta, tb = seq.gt_t[a], seq.gt_t[b]
        sel = np.where((seq.imu_t > ta) & (seq.imu_t <= tb))[0]
        dts = np.diff(np.concatenate([[ta], seq.imu_t[sel]]))
        pre = HostPreintegrated(np.zeros(3), np.zeros(3))
        pre.integrate(list(seq.imu_acc[sel]), list(seq.imu_gyro[sel]), list(dts), calib)
        preints.append(pre)
    return idx, R_wb, p_w, preints, calib


def rotation_angle(A, B):
    return float(np.arccos(np.clip((np.trace(A.T @ B) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("visual_scale", [2.5, 1.0], ids=["needs_a_scale", "at_scale"])
def test_initialize_imu_equals_jax_on_one_chain(seq, visual_scale):
    from fasttrack_tpu.imu.init import initialize_imu as jinit
    from fasttrack_tpu_torch.imu.init import initialize_imu as tinit

    for estimate_ba in (False, True):        # the init's call, and the refinement's
        _, R_wb, p_w, pj, _ = chain_from_the_renderer(seq, "jax", visual_scale)
        _, _, _, pt, _ = chain_from_the_renderer(seq, "torch", visual_scale)
        want = jinit(R_wb, p_w, pj, mono_scale=True, estimate_ba=estimate_ba)
        got = tinit(R_wb, p_w, pt, mono_scale=True, estimate_ba=estimate_ba)
        assert got.success and want.success
        assert got.scale == pytest.approx(want.scale, rel=1e-6)
        assert rotation_angle(got.R_gw, want.R_gw) < 1e-6
        np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-6)
        # the solve finds the visual map's scale
        assert got.scale == pytest.approx(visual_scale, rel=0.02)


def mapper_with_the_chain(seq, pkg, visual_scale):
    """A monocular-inertial mapper of `pkg` whose map holds the chain."""
    idx, R_wb, p_w, preints, calib = chain_from_the_renderer(seq, pkg, visual_scale)
    if pkg == "jax":
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.local_mapping import LocalMapper
        from fasttrack_tpu.slam_map import Atlas, KeyFrame

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H)
    else:
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.local_mapping import LocalMapper
        from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
    atlas = Atlas()
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mapper = LocalMapper(atlas, cam, 0.0, n_levels=4, imu_calib=calib, monocular=True, **kw)
    m = atlas.current
    kfs = []
    for j, (i, R, p) in enumerate(zip(idx, R_wb, p_w)):
        R_cw = R.T                                        # T_b_c1 = I
        kf = KeyFrame(j, i, float(seq.gt_t[i]), R_cw, -R_cw @ p, np.zeros((1, 2), np.float32),
                      np.zeros(1, np.int32), np.zeros(1, np.float32), np.zeros((1, 32), np.uint8),
                      np.zeros((1, 256), np.int8), -np.ones(1), -np.ones(1), np.ones(1, bool))
        kf.velocity = np.zeros(3) + 0.1 * j
        kf.imu_bias = (np.zeros(3), np.zeros(3))
        if j:
            kf.prev_kf_id = j - 1
            kf.preintegrated = preints[j - 1]
            kfs[-1].next_kf_id = j
        m.add_keyframe(kf)
        kfs.append(kf)
    m.imu_initialized = True
    return mapper, kfs


@pytest.mark.parametrize("visual_scale", [1.3, 1.0], ids=["needs_a_scale", "at_scale"])
def test_scale_refinement_equals_jax_on_one_chain(seq, visual_scale):
    """LocalMapper._scale_refinement of both packages on the same chain: the
    same decision, and where it applies, the same rescaled, rotated map (the
    velocities in map units take the scale)."""
    tm, tkfs = mapper_with_the_chain(seq, "torch", visual_scale)
    jm, jkfs = mapper_with_the_chain(seq, "jax", visual_scale)
    before = [k.center.copy() for k in tkfs]
    tm._scale_refinement(tkfs[-1])
    jm._scale_refinement(jkfs[-1])
    moved = any(not np.allclose(k.center, c, atol=1e-12) for k, c in zip(tkfs, before))
    moved_j = any(not np.allclose(k.center, c, atol=1e-12) for k, c in zip(jkfs, before))
    assert moved == moved_j == (visual_scale != 1.0)
    applied = tm.stats.series["lm_scale_applied"]
    assert applied == [float(moved)]
    solved = tm.stats.series["lm_scale_refinement_scale"][0]
    assert abs(solved - visual_scale) < 0.02 * visual_scale
    for kt, kj in zip(tkfs, jkfs):
        scale = max(np.linalg.norm(kj.center), 1.0)
        np.testing.assert_allclose(kt.center, kj.center, rtol=0, atol=1e-6 * scale)
        assert rotation_angle(kt.R_cw, kj.R_cw) < 1e-6
        np.testing.assert_allclose(kt.velocity, kj.velocity, rtol=0, atol=1e-6)


def test_f34_the_init_velocities_are_metric(seq, monkeypatch):
    """The port's IMU init on a chain whose visual map is 2.5x too small:
    the keyframe speeds are the renderer's, in metres per second; the JAX
    package's are the init's scale times those (F34)."""
    from fasttrack_tpu import local_mapping as jmapping
    from fasttrack_tpu_torch import local_mapping as tmapping

    for cls in (tmapping.LocalMapper, jmapping.LocalMapper):
        monkeypatch.setattr(cls, "_local_inertial_ba", lambda self, kf: None)
    dt = seq.gt_t[1] - seq.gt_t[0]
    speeds = {}
    for pkg in ("torch", "jax"):
        mapper, kfs = mapper_with_the_chain(seq, pkg, 2.5)
        mapper.atlas.current.imu_initialized = False
        mapper._try_initialize_imu(kfs[-1])
        assert mapper.atlas.current.imu_initialized
        speeds[pkg] = np.asarray([np.linalg.norm(k.velocity) for k in kfs])
    truth = np.asarray([np.linalg.norm(seq.gt_pos[k.frame_id + 1] - seq.gt_pos[k.frame_id - 1])
                        / (2 * dt) if k.frame_id else np.nan for k in kfs])[1:]
    np.testing.assert_allclose(speeds["torch"][1:], truth, rtol=0.03)
    np.testing.assert_allclose(speeds["jax"][1:] / speeds["torch"][1:], 2.5, rtol=0.02)


def test_f36_f37_a_rescale_brings_the_points_and_the_saved_frames_along(seq):
    """After an applied scale refinement of a monocular-inertial map, a
    point's normal and scale-invariance distances are those of its new
    position (F36; the JAX package keeps the old ones), and the tracker's
    frames of the map sit where the keyframes were moved (F37): the saved
    ones, the last frame, and the frame in flight, which an inline mapper
    rescales inside its keyframe insertion before the frame is saved."""
    from fasttrack_tpu_torch.slam_map import MapPoint
    from fasttrack_tpu_torch.tracking import Tracker

    mapper, kfs = mapper_with_the_chain(seq, "torch", 1.3)
    m = mapper.atlas.current
    X = kfs[0].center + np.array([0.3, -0.2, 3.0])
    mp = MapPoint(1, X, kfs[0].kid, kfs[0].kid)
    for k in kfs[:2]:
        mp.add_observation(k.kid, 0)
    m.add_mappoint(mp)
    mp.update_normal_and_depth({k.kid: k.center for k in kfs[:2]}, kfs[0].center, 0,
                               mapper.scale_factor, mapper.n_levels)
    max_before = mp.max_distance
    def frame(k):
        return types.SimpleNamespace(timestamp=k.timestamp, R_cw=k.R_cw.copy(), t_cw=k.t_cw.copy())

    tracker = types.SimpleNamespace(
        last_kf_id=None, _frame_in_flight=frame(kfs[-1]), last_frame=frame(kfs[-2]),
        trajectory=[(k.timestamp, k.R_cw.copy(), k.t_cw.copy()) for k in kfs[:-1]])
    tracker.transform_trajectory = lambda *a: Tracker.transform_trajectory(tracker, *a)
    mapper.tracker = tracker
    mapper._scale_refinement(kfs[-1])
    assert mapper.stats.series["lm_scale_applied"] == [1.0]
    scale = mapper.stats.series["lm_scale_refinement_scale"][0]
    assert mp.max_distance == pytest.approx(np.linalg.norm(mp.position - kfs[0].center),
                                            rel=1e-12)
    assert mp.max_distance == pytest.approx(scale * max_before, rel=1e-9)
    views = [(mp.position - k.center) / np.linalg.norm(mp.position - k.center) for k in kfs[:2]]
    mean = np.mean(views, axis=0)
    np.testing.assert_allclose(mp.normal, mean / np.linalg.norm(mean), atol=1e-12)
    in_flight, last = tracker._frame_in_flight, tracker.last_frame
    saved = tracker.trajectory + [(in_flight.timestamp, in_flight.R_cw, in_flight.t_cw)]
    assert len(saved) == len(kfs)
    for (ts, R_cw, t_cw), k in zip(saved, kfs):
        assert ts == k.timestamp
        np.testing.assert_allclose(-R_cw.T @ t_cw, k.center, atol=1e-9)
        np.testing.assert_allclose(R_cw, k.R_cw, atol=1e-12)
    np.testing.assert_allclose(-last.R_cw.T @ last.t_cw, kfs[-2].center, atol=1e-9)


class _StubKeyframe:
    def __init__(self, tracked, timestamp):
        self.tracked, self.timestamp = tracked, timestamp

    def tracked_map_points(self, mappoints, min_obs):
        return self.tracked


def keyframe_decisions(monocular, dt, imu_initialized=False, inliers=50, ref_points=100):
    """Tracker._need_new_keyframe of both packages, port first, for an
    inertial tracker whose reference keyframe tracks `ref_points` points
    and whose frame `dt` after it has `inliers`."""
    from fasttrack_tpu.cameras import make_pinhole as jpinhole
    from fasttrack_tpu.imu.preintegration import ImuCalib as JCalib
    from fasttrack_tpu.ops.extractor import OrbConfig as JOrb
    from fasttrack_tpu.slam_map import Atlas as JAtlas
    from fasttrack_tpu.tracking import TrackedFrame as JFrame
    from fasttrack_tpu.tracking import Tracker as JTracker
    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.imu.preintegration import ImuCalib
    from fasttrack_tpu_torch.ops.extractor import OrbConfig
    from fasttrack_tpu_torch.slam_map import Atlas
    from fasttrack_tpu_torch.tracking import TrackedFrame, Tracker

    n = 8
    fields = dict(frame_id=5, timestamp=1.0 + dt, kp_uv=np.zeros((n, 2)),
                  kp_level=np.zeros(n, np.int32), kp_angle=np.zeros(n),
                  desc_packed=np.zeros((n, 32), np.uint8), desc_signed=np.ones((n, 256), np.int8),
                  u_right=np.full(n, -1.0), depth=np.full(n, -1.0), valid=np.ones(n, bool))
    got = []
    for make, frame_cls in (
        (lambda: Tracker(make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu"),
                         OrbConfig(H, W, n_features=512, n_levels=4), 1.0, Atlas(),
                         monocular=monocular, imu_calib=ImuCalib.default(device="cpu"),
                         device="cpu"), TrackedFrame),
        (lambda: JTracker(jpinhole(256.0, 256.0, 160.0, 120.0, W, H),
                          JOrb(H, W, n_features=512, n_levels=4), 1.0, JAtlas(),
                          monocular=monocular, imu_calib=JCalib.default()), JFrame),
    ):
        tr = make()
        m = tr.atlas.current
        m.imu_initialized = imu_initialized
        for kid in range(3):
            m.keyframes[kid] = _StubKeyframe(ref_points, 1.0)
        tr.ref_kf_id, tr.last_kf_id, tr.frame_id, tr.last_kf_frame_id = 2, 2, 5, 4
        tr.n_inliers = inliers
        got.append(tr._need_new_keyframe(frame_cls(**fields)))
    return got


@pytest.mark.parametrize("monocular, dt, port_wants, jax_wants", [
    (True, 0.10, False, True),      # F35: the ratio test would fire; the reference waits
    (True, 0.30, True, True),
    (False, 0.10, True, True),      # stereo-inertial keeps the JAX rule (mirrored)
])
def test_f35_the_pre_init_keyframe_rule(monocular, dt, port_wants, jax_wants):
    """Before its IMU init a monocular-inertial tracker asks for a keyframe
    every 0.25 s and for no other reason (Tracking::NeedNewKeyFrame's
    inertial branch); the stereo-inertial one, and the JAX package's for
    either sensor, fall through to the ratio test (here 50 tracked points
    against 100 in the reference keyframe)."""
    assert keyframe_decisions(monocular, dt) == [port_wants, jax_wants]


@pytest.mark.parametrize("monocular, inliers, ref_points, port_wants, jax_wants", [
    (True, 400, 500, False, True),    # F38: 0.8 of the reference, above 350 inliers
    (True, 360, 500, True, True),     # under 0.75
    (True, 300, 350, True, True),     # at most 350 inliers: the monocular 0.9
    (False, 400, 500, False, False),  # stereo-inertial keeps the JAX rule (0.75, mirrored)
])
def test_f38_the_keyframe_rule_after_the_imu_init(monocular, inliers, ref_points, port_wants,
                                                  jax_wants):
    """After its IMU init a monocular-inertial tracker takes IMU_MONOCULAR's
    reference ratio, 0.75 above 350 inliers and 0.9 below; the JAX package
    keeps the monocular 0.9 (at 752x480 every frame after the init then
    makes a keyframe, and none is fused)."""
    got = keyframe_decisions(monocular, 0.1, True, inliers, ref_points)
    assert got == [port_wants, jax_wants]


# ------------------------------------------------------------------ async, wiring
def test_async_mapping_reaches_the_imu_init_and_stops(seq, one_torch_thread):
    from fasttrack_tpu_torch.system import Sensor, System

    before = {t.ident for t in threading.enumerate()}
    system = System(make_settings("torch", seq), Sensor.IMU_MONOCULAR, vocabulary=False,
                    async_mapping=True, device="cpu")
    rows = drive(system, seq, stop=lambda rows: rows[-1]["imu"] or len(rows) == 55)
    t0 = time.perf_counter()
    while not system.local_mapper.is_idle() and time.perf_counter() - t0 < 60.0:
        time.sleep(0.05)
    assert system.local_mapper.is_idle()
    assert system.atlas.current.imu_initialized, [r["state"] for r in rows]
    assert "OK" in rows[-1]["state"]
    system.shutdown()
    alive = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert not alive, alive


def test_the_system_takes_the_mono_route_with_an_imu(seq):
    """IMU_MONOCULAR builds the calibration from the settings, a monocular
    tracker and mapper that share it, a loop closer with the scale fixed
    (the IMU observes it; fasttrack_tpu/system.py:160-162), no
    rectification even for a distorted pair, and takes samples through
    track_monocular; IMU_RGBD (M9d) builds from the same settings with the
    same calibration, a tracker and mapper that are not monocular."""
    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.system import Sensor, System

    s = make_settings("torch", seq)
    s.camera2 = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
    s.T_c1_c2, s.dist1, s.dist2 = np.eye(4) + np.eye(4, k=3) * 0.1, np.full(4, 0.01), np.zeros(4)
    system = System(s, Sensor.IMU_MONOCULAR, device="cpu")
    cal = system.imu_calib
    assert cal is not None and system.tracker.imu_calib is cal is system.local_mapper.imu_calib
    assert system.tracker.monocular and system.local_mapper.monocular
    assert system.loop_closer.fix_scale is True and system._rect is None
    assert system.tracker.stereo_rig is None
    system.track_monocular(seq.frames[0].left, seq.frames[0].timestamp,
                           imu=imu_between(seq, -1.0, seq.frames[0].timestamp))
    assert system.tracker._init_reference is not None and system.tracker.pre_from_kf is not None
    with pytest.raises(RuntimeError, match="non-stereo"):
        system.track_stereo(seq.frames[0].left, seq.frames[0].right, 0.1)
    system.shutdown()
    rgbd = System(s, Sensor.IMU_RGBD, vocabulary=False, device="cpu")
    np.testing.assert_array_equal(rgbd.imu_calib.R_bc.numpy(), cal.R_bc.numpy())
    assert rgbd.tracker.use_imu and not rgbd.tracker.monocular and not rgbd.local_mapper.monocular
    assert rgbd._rect is None and rgbd.tracker.stereo_rig is None


def test_the_scale_refinement_needs_a_chain(seq):
    """A chain shorter than the init's 6 keyframes is left alone, as in the
    JAX package."""
    mapper, kfs = mapper_with_the_chain(seq, "torch", 1.3)
    last = kfs[4]                                 # a chain of 5 keyframes
    before = last.center.copy()
    mapper._scale_refinement(last)
    np.testing.assert_array_equal(last.center, before)
    assert mapper.stats.series.get("lm_scale_refinement_scale", []) == []
