"""The port's visual stereo Tracker against the JAX package's, on the CPU.

The same rendered stereo sequences (datasets.synthetic, seeds written here)
and the same numpy inputs go through both packages; the port runs with
device="cpu". Tolerances and why:

- match_fisheye, twm_match_packed, tlm_match_packed: indices and masks equal
  (integer Hamming distances, lax.top_k's tie order on both sides);
- the 20-frame sequence: tracking state, path taken (stepwise or fused) and
  the number of keyframes equal on every frame; mp_ids equal on the first 5
  frames and on >= 95% of keypoints after (a pose difference of 1e-4 may
  flip a borderline inlier); poses within 1e-3 per frame (rotation:
  Frobenius norm of the difference; translation: metres), which is f32
  rounding through two 40-step optimizations per frame, analytic against
  forward-mode Jacobians; ATE RMSE of the port no worse than JAX's + 5 mm;
- datasets.synthetic: images and ground truth bit-equal; evaluation.ate:
  1e-12.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu import tracking as jtracking
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.datasets import synthetic as jsynthetic
from fasttrack_tpu.evaluation import ate as jate
from fasttrack_tpu.kernels import KernelConfig as JaxKernelConfig
from fasttrack_tpu.ops import project_match as jpm
from fasttrack_tpu.ops import stereo_match as jsm
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.slam_map import Atlas as JaxAtlas
from fasttrack_tpu_torch import tracking
from fasttrack_tpu_torch.cameras import make_kannala_brandt8, make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import ate
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.ops import project_match as tpm
from fasttrack_tpu_torch.ops import stereo_match as tsm
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.slam_map import Atlas

H, W = 240, 320
N_FEATURES, N_LEVELS = 512, 4
POSE_ATOL = 1e-3          # rotation (Frobenius) and translation (m), per frame
MIN_IDS_EQUAL_LATE = 0.95  # share of keypoints with equal mp_ids after frame 5
ATE_MARGIN_M = 0.005


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- matchers
def _descriptors(rng, n):
    return (2 * rng.integers(0, 2, (n, 256)) - 1).astype(np.int8)


def _noisy_copies(rng, desc, pick, n_flip):
    """Rows `pick` of `desc` with `n_flip` random bits flipped in each."""
    out = desc[pick].copy()
    for row in out:
        row[rng.choice(256, n_flip, replace=False)] *= -1
    return out


def test_match_fisheye_equals_jax(rng):
    n_l, n_r = 300, 260
    r_desc = _descriptors(rng, n_r)
    # two of every three left rows are a noisy copy of a right one (several
    # left rows may share one), the rest are unrelated
    l_desc = _noisy_copies(rng, r_desc, rng.integers(0, n_r, n_l), 20)
    l_desc[::3] = _descriptors(rng, len(l_desc[::3]))
    l_valid = rng.random(n_l) > 0.2   # invalid rows tie at 1e9 across all columns
    r_valid = rng.random(n_r) > 0.2
    for ratio, max_dist in ((0.7, 100), (0.75, 50)):
        want = jsm.match_fisheye(J(l_desc), J(l_valid), J(r_desc), J(r_valid),
                                 ratio=ratio, max_dist=max_dist)
        got = tsm.match_fisheye(T(l_desc), T(l_valid), T(r_desc), T(r_valid),
                                ratio=ratio, max_dist=max_dist)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.idx_right.numpy(), np.asarray(want.idx_right))
        assert got.idx_right.dtype == torch.int32
        assert 50 < int(got.valid.sum()) < n_l
        assert not got.valid.numpy()[~l_valid].any()


def _packed_case(rng, m=400, n=350):
    """A frame of n keypoints and m projected queries around them."""
    kp_x = rng.uniform(0, W, n).astype(np.float32)
    kp_y = rng.uniform(0, H, n).astype(np.float32)
    kp_level = rng.integers(0, N_LEVELS, n).astype(np.int32)
    kp_angle = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    kp_desc = _descriptors(rng, n)
    kp_valid = rng.random(n) > 0.1
    pick = rng.integers(0, n, m)
    q_desc = _noisy_copies(rng, kp_desc, pick, 15)
    lvl = kp_level[pick]
    q = np.stack([
        kp_x[pick] + rng.normal(0, 3, m), kp_y[pick] + rng.normal(0, 3, m),
        7.0 * 1.2 ** lvl, np.maximum(lvl - 1, 0), np.minimum(lvl + 1, N_LEVELS - 1),
        (rng.random(m) > 0.15).astype(np.float64),
        kp_angle[pick] + 0.3 + rng.normal(0, 0.05, m),
    ]).astype(np.float32)
    return q, q_desc, (kp_x, kp_y, kp_desc, kp_level, kp_valid), kp_angle


def test_twm_match_packed_equals_jax(rng):
    q7, q_desc, kp, kp_angle = _packed_case(rng)
    idx_j, keep_j = jpm.twm_match_packed(J(q7), J(q_desc), *(J(a) for a in kp), J(kp_angle))
    idx_t, keep_t = tpm.twm_match_packed(T(q7), T(q_desc), *(T(a) for a in kp), T(kp_angle))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(keep_t.sum()) > 100


def test_tlm_match_packed_equals_jax(rng):
    q7, q_desc, kp, _ = _packed_case(rng)
    q6 = q7[:6].copy()
    q6[2] *= 0.6
    taken = (rng.random(len(kp[0])) < 0.3).astype(np.float32)
    idx_j, keep_j = jpm.tlm_match_packed(J(q6), J(q_desc), *(J(a) for a in kp), J(taken))
    idx_t, keep_t = tpm.tlm_match_packed(T(q6), T(q_desc), *(T(a) for a in kp), T(taken))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(keep_t.sum()) > 50
    assert not taken[idx_t.numpy()[keep_t.numpy()]].any()


# ---------------------------------------------------- renderer and evaluation
@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=20, h=H, w=W, seed=3)


def test_synthetic_sequence_is_bit_equal_to_jax(seq):
    want = jsynthetic.generate_sequence(n_frames=3, h=H, w=W, seed=3)
    assert (seq.fx, seq.fy, seq.cx, seq.cy, seq.baseline) == (
        want.fx, want.fy, want.cx, want.cy, want.baseline)
    for got_f, want_f in zip(seq.frames, want.frames):
        assert got_f.timestamp == want_f.timestamp
        np.testing.assert_array_equal(got_f.left, want_f.left)
        np.testing.assert_array_equal(got_f.right, want_f.right)
        np.testing.assert_array_equal(got_f.R_wc, want_f.R_wc)
        np.testing.assert_array_equal(got_f.t_wc, want_f.t_wc)
    np.testing.assert_array_equal(seq.gt_pos[:3], want.gt_pos)
    # the IMU block depends on the sequence's length: compare a whole short one
    short = synthetic.generate_sequence(n_frames=3, h=H, w=W, seed=3)
    np.testing.assert_array_equal(short.imu_acc, want.imu_acc)
    np.testing.assert_array_equal(short.imu_gyro, want.imu_gyro)
    np.testing.assert_array_equal(short.imu_t, want.imu_t)


def test_make_texture_and_loop_trajectory_equal_jax():
    got = synthetic.make_texture(np.random.default_rng(5), size=256)
    want = jsynthetic.make_texture(np.random.default_rng(5), size=256)
    np.testing.assert_array_equal(got, want)
    a = synthetic.generate_sequence(n_frames=2, h=60, w=80, seed=1, trajectory="loop")
    b = jsynthetic.generate_sequence(n_frames=2, h=60, w=80, seed=1, trajectory="loop")
    np.testing.assert_array_equal(a.frames[1].left, b.frames[1].left)
    np.testing.assert_array_equal(a.gt_R, b.gt_R)


def test_ate_equals_jax(rng):
    n = 40
    t = np.arange(n) * 0.05
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    est = 1.3 * (gt @ R.T) + np.asarray([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, (n, 3))
    for with_scale in (False, True):
        got = ate.absolute_trajectory_error(t + 0.001, est, t, gt, with_scale=with_scale)
        want = jate.absolute_trajectory_error(t + 0.001, est, t, gt, with_scale=with_scale)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
        s, Rg, tg = ate.umeyama_alignment(est, gt, with_scale)
        sw, Rw, tw = jate.umeyama_alignment(est, gt, with_scale)
        np.testing.assert_allclose(Rg, Rw, atol=1e-12)
        np.testing.assert_allclose(tg, tw, atol=1e-12)
        assert abs(s - sw) <= 1e-12
    assert ate.absolute_trajectory_error(t, est, t, gt, with_scale=True)["rmse"] < 0.03
    assert ate.absolute_trajectory_error(t[:2], est[:2], t, gt)["n"] == 2


# ------------------------------------------------------------- the trackers
def make_trackers(seq, **kwargs):
    """(JAX Tracker, port Tracker on the CPU) for `seq`'s camera."""
    bf = seq.fx * seq.baseline
    jt = jtracking.Tracker(
        jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H),
        JaxOrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS), bf, JaxAtlas(), **kwargs,
    )
    tt = tracking.Tracker(
        make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"),
        OrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS), bf, Atlas(),
        device="cpu", **kwargs,
    )
    return jt, tt


def step(tracker, left, right, timestamp) -> dict:
    """One frame through `tracker` (either package's); what the tests
    compare. A frame went stepwise if it recorded `orb_extraction` (the
    fused path records it only when it falls back)."""
    series = tracker.stats.series
    before = len(series["orb_extraction"])
    tracker.track_stereo(left, right, timestamp)
    f = tracker.last_frame
    return dict(
        state=tracker.state.name,
        path="stepwise" if len(series["orb_extraction"]) > before else "fused",
        n_keyframes=tracker.atlas.current.n_keyframes(),
        n_mappoints=tracker.atlas.current.n_mappoints(),
        n_maps=tracker.atlas.n_maps(),
        mp_ids=f.mp_ids.copy(),
        R=None if f.R_cw is None else f.R_cw.copy(),
        t=None if f.t_cw is None else f.t_cw.copy(),
        n_inliers=tracker.n_inliers,
    )


def run_both(seq, frames, **kwargs):
    jt, tt = make_trackers(seq, **kwargs)
    log_j = [step(jt, f.left, f.right, f.timestamp) for f in frames]
    log_t = [step(tt, f.left, f.right, f.timestamp) for f in frames]
    return jt, tt, log_j, log_t


@pytest.fixture(scope="module")
def run20(seq):
    return run_both(seq, seq.frames)


def test_sequence_states_and_paths_equal(run20):
    _, _, log_j, log_t = run20
    assert [r["state"] for r in log_t] == [r["state"] for r in log_j] == ["OK"] * 20
    paths = [r["path"] for r in log_t]
    assert paths == [r["path"] for r in log_j]
    # init, one stepwise frame (reference keyframe + local map), then fused
    assert paths == ["stepwise", "stepwise"] + ["fused"] * 18


def test_sequence_keyframes_equal(run20):
    jt, tt, log_j, log_t = run20
    kfs = [r["n_keyframes"] for r in log_t]
    assert kfs == [r["n_keyframes"] for r in log_j]
    assert kfs[0] == 1 and kfs[-1] >= 2           # a keyframe is inserted on the way
    assert [r["n_mappoints"] for r in log_t] == [r["n_mappoints"] for r in log_j]
    assert tt.ref_kf_id == jt.ref_kf_id
    mj, mt = jt.atlas.current, tt.atlas.current
    assert sorted(mt.keyframes) == sorted(mj.keyframes)
    for kid, kf in mt.keyframes.items():
        assert kf.frame_id == mj.keyframes[kid].frame_id
        assert kf.covisible == mj.keyframes[kid].covisible


def test_sequence_bindings_equal(run20):
    _, _, log_j, log_t = run20
    for i, (a, b) in enumerate(zip(log_t, log_j)):
        same = float((a["mp_ids"] == b["mp_ids"]).mean())
        if i < 5:
            assert same == 1.0, (i, same)
        else:
            assert same >= MIN_IDS_EQUAL_LATE, (i, same)
        assert (a["mp_ids"] >= 0).sum() >= 100


def test_sequence_poses_within_tolerance(run20):
    _, _, log_j, log_t = run20
    for i, (a, b) in enumerate(zip(log_t, log_j)):
        assert np.linalg.norm(a["R"] - b["R"]) < POSE_ATOL, i
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL, i
        np.testing.assert_allclose(a["R"] @ a["R"].T, np.eye(3), atol=1e-12)


def test_sequence_ate_no_worse_than_jax(run20, seq):
    jt, tt, _, _ = run20

    def rmse(tracker):
        t_est = np.asarray([t for t, _, _ in tracker.trajectory])
        p_est = np.asarray([-R.T @ t_ for _, R, t_ in tracker.trajectory])
        return ate.absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)["rmse"]

    assert len(tt.trajectory) == len(jt.trajectory) == 20
    assert rmse(tt) <= rmse(jt) + ATE_MARGIN_M
    assert rmse(tt) < 0.05     # the JAX system's gate on this scene


def test_sequence_store_uploads_and_fetches(run20):
    _, tt, _, log_t = run20
    series = tt.stats.series
    n_fused = sum(r["path"] == "fused" for r in log_t)
    # the device mirror is uploaded at the first fused frame and after each
    # keyframe made while fused frames run, never in between
    n_kf_while_fused = log_t[-1]["n_keyframes"] - log_t[1]["n_keyframes"]
    assert len(series["store_uploads"]) == 1 + n_kf_while_fused
    # one fetch per fused frame; stepwise: snapshot (1), frame 1 adds the
    # reference-keyframe match, its pose, the local-map match, its pose (4)
    assert len(series["device_fetches"]) == n_fused + 2 + 4
    assert len(series["fused_dispatch"]) == n_fused
    np.testing.assert_array_equal(tt._store_dev.pos.numpy(),
                                  tt.atlas.current.store.pos.astype(np.float32))


def test_stats_series_match_jax_and_save(run20, tmp_path):
    jt, tt, _, _ = run20
    own = {"store_uploads", "fused_host_pre", "fused_dispatch", "fused_host_post"}
    assert set(tt.stats.series) - own == set(jt.stats.series)
    for name in ("tracking_total", "orb_extraction", "track_ok", "trk", "tlm"):
        assert len(tt.stats.series[name]) == len(jt.stats.series[name]), name
    tt.stats.save(str(tmp_path))
    lines = (tmp_path / "data" / "track_ok.txt").read_text().splitlines()
    assert lines[0] == "0: 1.0000" and len(lines) == 19
    assert (tmp_path / "summary.json").exists()


def test_fused_fallback_then_lost_then_new_map(seq):
    """A blank frame in the OK state enters the fused path, finds no TWM
    inlier and resumes stepwise; more blank frames run the lost state
    machine; the next good frame initializes a new map."""
    jt, tt = make_trackers(seq)
    blank = np.zeros((H, W), np.float32)
    f = seq.frames
    feed = [(f[i].left, f[i].right, f[i].timestamp) for i in range(4)]
    feed += [(blank, blank, 0.20), (blank, blank, 1.0), (blank, blank, 5.5),
             (f[4].left, f[4].right, 5.55), (f[5].left, f[5].right, 5.60)]
    log = {}
    for name, tr in (("jax", jt), ("torch", tt)):
        rows = []
        for left, right, ts in feed:
            eligible = tr._fused_eligible()
            rows.append(dict(step(tr, left, right, ts), eligible=eligible))
        log[name] = rows
    for key in ("state", "path", "eligible", "n_keyframes", "n_mappoints", "n_maps"):
        assert [r[key] for r in log["torch"]] == [r[key] for r in log["jax"]], key
    rows = log["torch"]
    assert [r["state"] for r in rows] == [
        "OK", "OK", "OK", "OK", "RECENTLY_LOST", "RECENTLY_LOST", "NOT_INITIALIZED", "OK", "OK"]
    # frame 4: eligible for the fused path, which fell back to stepwise
    assert rows[4]["eligible"] and rows[4]["path"] == "stepwise"
    assert not rows[5]["eligible"]
    # LOST with a small map: the map is cleared and a new one started
    assert rows[6]["n_maps"] == 2 and rows[6]["n_keyframes"] == 0
    assert rows[7]["n_keyframes"] == 1 and rows[7]["n_mappoints"] > 100
    assert tt.atlas.maps[0].n_mappoints() == 0 and tt.atlas.maps[0].store.alive.sum() == 0
    for a, b in zip(log["torch"], log["jax"]):
        assert float((a["mp_ids"] == b["mp_ids"]).mean()) >= MIN_IDS_EQUAL_LATE
        assert np.linalg.norm(a["R"] - b["R"]) < POSE_ATOL
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL


def test_backwards_timestamp_resets_the_map(seq):
    jt, tt = make_trackers(seq)
    f = seq.frames
    for tr in (jt, tt):
        for i in range(3):
            step(tr, f[i].left, f[i].right, f[i].timestamp)
        row = step(tr, f[3].left, f[3].right, -1.0)
        assert row["state"] == "OK" and row["path"] == "stepwise"
        assert row["n_keyframes"] == 1 and row["n_maps"] == 1
        np.testing.assert_array_equal(row["R"], np.eye(3))
        assert tr.stats.series["timestamp_jump_backwards"] == [1.0]
    assert tt.atlas.current.n_mappoints() == jt.atlas.current.n_mappoints()


def test_localization_only_inserts_no_keyframe(seq):
    # max_frames_between_kf=3 makes the frame-spacing rule ask for a keyframe
    jt, tt = make_trackers(seq, max_frames_between_kf=3)
    logs = []
    for tr in (jt, tt):
        rows = [step(tr, f.left, f.right, f.timestamp) for f in seq.frames[:2]]
        tr.localization_only = True
        rows += [step(tr, f.left, f.right, f.timestamp) for f in seq.frames[2:6]]
        logs.append(rows)
        assert [r["n_keyframes"] for r in rows] == [1] * 6
        assert [r["path"] for r in rows] == ["stepwise"] * 6   # the fused path is not eligible
        assert [r["state"] for r in rows] == ["OK"] * 6
    for a, b in zip(*logs):
        assert float((a["mp_ids"] == b["mp_ids"]).mean()) >= MIN_IDS_EQUAL_LATE
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL
    # the same frames with mapping allowed do insert one
    _, tt2 = make_trackers(seq, max_frames_between_kf=3)
    rows = [step(tt2, f.left, f.right, f.timestamp) for f in seq.frames[:6]]
    assert rows[-1]["n_keyframes"] >= 2


def test_bypass_pose_optimization_equals_jax(seq):
    jt, tt = make_trackers(seq)
    jt.kcfg = JaxKernelConfig(pose_optimization=False)
    tt.kcfg = KernelConfig(pose_optimization=False)
    for f in seq.frames[:4]:
        a = step(tt, f.left, f.right, f.timestamp)
        b = step(jt, f.left, f.right, f.timestamp)
        assert (a["state"], a["path"], a["n_inliers"]) == (b["state"], "stepwise", b["n_inliers"])
        np.testing.assert_array_equal(a["mp_ids"], b["mp_ids"])
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL


# ---------------------------------------------------------- what is left out
def _cpu_tracker(seq, **kwargs):
    return make_trackers(seq, **kwargs)[1]


def _cam():
    return make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu")


CFG = OrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS)


@pytest.mark.parametrize("kwargs, item", [
    (dict(imu_calib=object()), "M8"),
    (dict(monocular=True), "M9"),
    (dict(stereo_rig=object()), "M9"),
])
def test_left_out_constructor_arguments_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        tracking.Tracker(_cam(), CFG, 28.0, Atlas(), device="cpu", **kwargs)


def test_kb8_camera_raises():
    cam = make_kannala_brandt8(190.0, 190.0, 160.0, 120.0, 0, 0, 0, 0, W, H, device="cpu")
    with pytest.raises(NotImplementedError, match="M9"):
        tracking.Tracker(cam, CFG, 28.0, Atlas(), device="cpu")


@pytest.mark.parametrize("call, item", [
    (lambda tr, img: tr.track_rgbd(img, img, 0.0), "M9"),
    (lambda tr, img: tr.track_monocular(img, 0.0), "M9"),
    (lambda tr, img: tr.grab_imu([(0.0, np.zeros(3), np.zeros(3))]), "M8"),
], ids=["track_rgbd", "track_monocular", "grab_imu"])
def test_left_out_entry_points_raise(call, item):
    tr = tracking.Tracker(_cam(), CFG, 28.0, Atlas(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        call(tr, np.zeros((H, W), np.uint8))


@pytest.mark.parametrize("mask, n_ok", [("0111", 0), ("1011", 0), ("1101", 1), ("1110", 2)])
def test_toggle_off_raises_where_its_host_path_would_run(seq, mask, n_ok):
    """An offload toggle that is off raises at the frame whose host path it
    selects: extraction and stereo at once, the local-map matcher at the
    first tracked frame, the motion-model matcher at the second."""
    tr = _cpu_tracker(seq, kernel_config=KernelConfig.from_bitmask(mask))
    f = seq.frames
    for i in range(n_ok):
        tr.track_stereo(f[i].left, f[i].right, f[i].timestamp)
    with pytest.raises(NotImplementedError, match="M5c"):
        tr.track_stereo(f[n_ok].left, f[n_ok].right, f[n_ok].timestamp)


def test_relocalization_without_a_database_is_false_and_with_one_raises(seq):
    tr = _cpu_tracker(seq)
    f = seq.frames[0]
    tr.track_stereo(f.left, f.right, f.timestamp)
    assert tr._relocalization(tr.last_frame) is False
    tr.reloc_db, tr.vocabulary = object(), object()
    with pytest.raises(NotImplementedError, match="M7"):
        tr._relocalization(tr.last_frame)


def test_kernel_config_bitmask():
    k = KernelConfig.from_bitmask("1001", pose_optimization=False)
    j = JaxKernelConfig.from_bitmask("1001", pose_optimization=False)
    assert (k.orb_extraction, k.stereo_match, k.search_local_points, k.pose_estimation,
            k.pose_optimization) == (j.orb_extraction, j.stereo_match, j.search_local_points,
                                     j.pose_estimation, j.pose_optimization)
    with pytest.raises(ValueError):
        KernelConfig.from_bitmask("10x1")
