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
  1e-12;
- the host sides of the offload toggles, over the same 20 frames under the
  masks of the JAX package's TestToggleMatrixE2E (0000, 1000, 0100, 0011)
  and 0000 with pose optimization bypassed: every frame stepwise, states,
  paths and keyframes equal; bindings equal on every frame where the front
  end is the host's or the host extraction feeds the device stereo (the
  frames are bit-equal there: NumPy over the same C++ source); under 1000
  (device extraction, host stereo and matchers) the (keypoint, map point)
  pairs compared as sets, >= 95% shared (F4); poses within 1e-3; ATE no
  worse than JAX's + 5 mm. The JAX side loads its own C++ source, built
  into a temporary directory (tests/test_torch_host_kernels.py,
  `jax_native_library`), so no test here builds under `native/`;
- the map's device mirror: after a point is erased and a new one takes its
  row, `_store_device` uploads again and equals the host store (ROADMAP
  P3; the JAX tracker's key misses this).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu import native as jnative
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
from fasttrack_tpu_torch.cameras.stereo import stereo_rig_from_numpy
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import ate
from fasttrack_tpu_torch.imu.preintegration import ImuCalib
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.ops import project_match as tpm
from fasttrack_tpu_torch.ops import stereo_match as tsm
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.slam_map import Atlas, MapPoint
from tests.test_torch_host_kernels import jax_native_library

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
def make_trackers(seq, mode=None, **kwargs):
    """(JAX Tracker, port Tracker on the CPU) for `seq`'s camera; `mode` =
    (bitmask, pose_optimization) gives each its package's KernelConfig."""
    bf = seq.fx * seq.baseline
    jk, tk = {}, {}
    if mode is not None:
        jk = dict(kernel_config=JaxKernelConfig.from_bitmask(mode[0], pose_optimization=mode[1]))
        tk = dict(kernel_config=KernelConfig.from_bitmask(mode[0], pose_optimization=mode[1]))
    jt = jtracking.Tracker(
        jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H),
        JaxOrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS), bf, JaxAtlas(),
        **jk, **kwargs,
    )
    tt = tracking.Tracker(
        make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"),
        OrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS), bf, Atlas(),
        device="cpu", **tk, **kwargs,
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


@contextlib.contextmanager
def one_torch_thread():
    """The test workers share the machine's cores, and the port's thousands
    of small CPU ops per frame thrash when every worker's torch pool spins a
    thread per core: the runs over a sequence take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_both(seq, frames, mode=None, **kwargs):
    jt, tt = make_trackers(seq, mode, **kwargs)
    log_j = [step(jt, f.left, f.right, f.timestamp) for f in frames]
    with one_torch_thread():
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


# ------------------------------------------------ the offload toggles' host sides
@pytest.fixture(scope="module")
def jax_host_kernels(tmp_path_factory):
    """The JAX host kernels over the JAX package's own C++ library, built
    into a temporary directory and not by `make` in `native/`, which races
    between test workers (ROADMAP)."""
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


# (mask, pose optimization): TestToggleMatrixE2E's masks, and 0000 bypassing PO
MODES = [("0000", True), ("1000", True), ("0100", True), ("0011", True), ("0000", False)]


@pytest.fixture(scope="module", params=MODES, ids=lambda m: f"{m[0]}_po{int(m[1])}")
def masked(request, seq, jax_host_kernels):
    return request.param, run_both(seq, seq.frames, request.param)


def _pairs(r):
    """The (keypoint, map point) bindings of a frame, as a set."""
    i = np.where(r["mp_ids"] >= 0)[0]
    return set(zip(i.tolist(), r["mp_ids"][i].tolist()))


def test_mask_states_paths_keyframes_and_series_equal(masked):
    (mask, po), (jt, tt, log_j, log_t) = masked
    for key in ("state", "path", "n_keyframes", "n_mappoints"):
        assert [r[key] for r in log_t] == [r[key] for r in log_j], key
    assert [r["state"] for r in log_t] == ["OK"] * 20
    assert [r["path"] for r in log_t] == ["stepwise"] * 20     # a toggle off: never fused
    for name in HOST_PATH_SERIES:
        assert len(tt.stats.series.get(name, [])) == len(jt.stats.series.get(name, [])), name
    assert len(tt.stats.series["orb_extraction"]) == 20
    assert "fused_dispatch" not in tt.stats.series and "store_uploads" not in tt.stats.series
    # a matcher toggle that is off never runs the device's matcher
    assert ("twm_exec" in tt.stats.series) == (mask[3] == "1")
    assert ("slp_exec" in tt.stats.series) == (mask[2] == "1")


def test_mask_bindings_equal(masked):
    (mask, po), (jt, tt, log_j, log_t) = masked
    if mask[0] == "0":
        # the host front end gives both packages the same frame, bit for bit
        fj, ft = jt.last_frame, tt.last_frame
        for name in ("kp_uv", "kp_level", "kp_angle", "desc_packed", "desc_signed", "valid"):
            np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name), err_msg=name)
        for i, (a, b) in enumerate(zip(log_t, log_j)):
            np.testing.assert_array_equal(a["mp_ids"], b["mp_ids"], err_msg=f"frame {i}")
    else:
        for i, (a, b) in enumerate(zip(log_t, log_j)):
            pa, pb = _pairs(a), _pairs(b)
            assert len(pa & pb) >= MIN_IDS_EQUAL_LATE * len(pa | pb), (i, len(pa & pb), len(pa | pb))
    assert all((r["mp_ids"] >= 0).sum() >= 100 for r in log_t)


def test_mask_poses_within_tolerance(masked):
    _, (_, _, log_j, log_t) = masked
    for i, (a, b) in enumerate(zip(log_t, log_j)):
        assert np.linalg.norm(a["R"] - b["R"]) < POSE_ATOL, i
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL, i


def test_mask_ate_no_worse_than_jax(masked, seq):
    (mask, po), (jt, tt, _, _) = masked

    def rmse(tracker):
        t_est = np.asarray([t for t, _, _ in tracker.trajectory])
        p_est = np.asarray([-R.T @ t_ for _, R, t_ in tracker.trajectory])
        return ate.absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)["rmse"]

    assert len(tt.trajectory) == len(jt.trajectory) == 20
    assert rmse(tt) <= rmse(jt) + ATE_MARGIN_M
    assert rmse(tt) < 0.05


def test_store_mirror_follows_a_reused_row(seq):
    """ROADMAP P3: upload the mirror, erase a point, add one that takes the
    freed row; the next `_store_device` must hold the new point's row. The
    old key (map, change_index, n_rows, cap) did not move, so the mirror
    kept the erased point's position and descriptor."""
    tt = make_trackers(seq)[1]
    f = seq.frames[0]
    tt.track_stereo(f.left, f.right, f.timestamp)
    m = tt.atlas.current
    st = m.store
    first = tt._store_device(m)
    assert tt._store_device(m) is first        # nothing changed: no upload
    victim = int(tt.last_frame.mp_ids[tt.last_frame.mp_ids >= 0][5])
    row = m.mappoints[victim].row
    before = (m.change_index, st.n_rows, st.cap)
    m.erase_mappoint(victim)
    mp = MapPoint(tt.atlas.next_mp_id(), st.pos[row] + 0.5, 0, 0)
    mp.desc_signed = -st.desc_signed[row]
    m.add_mappoint(mp)
    assert mp.row == row and (m.change_index, st.n_rows, st.cap) == before
    mirror = tt._store_device(m)
    np.testing.assert_array_equal(mirror.pos.numpy(), st.pos.astype(np.float32))
    np.testing.assert_array_equal(mirror.desc.numpy(), st.desc_signed)
    assert len(tt.stats.series["store_uploads"]) == 2


# ---------------------------------------------------------- what is left out
def _cpu_tracker(seq, **kwargs):
    return make_trackers(seq, **kwargs)[1]


def _cam():
    return make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu")


CFG = OrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS)


def test_kb8_camera_raises():
    """Since M9a a KB8 camera builds: with its rig it takes the fisheye
    route, without one the rectified route, as the JAX tracker does; the
    monocular tracker builds on it, visual (M9b) and inertial (M9c)."""
    cam = make_kannala_brandt8(190.0, 190.0, 160.0, 120.0, 0, 0, 0, 0, W, H, device="cpu")
    assert tracking.Tracker(cam, CFG, 28.0, Atlas(), device="cpu").stereo_rig is None
    rig = stereo_rig_from_numpy(cam, cam, np.eye(4) + np.eye(4, k=3) * 0.1, 19.0, device="cpu")
    tr = tracking.Tracker(cam, CFG, 19.0, Atlas(), stereo_rig=rig, device="cpu")
    assert tr.stereo_rig.left.params.device.type == "cpu"
    assert tracking.Tracker(cam, CFG, 28.0, Atlas(), monocular=True, device="cpu").monocular
    tr = tracking.Tracker(cam, CFG, 28.0, Atlas(), monocular=True, device="cpu",
                          imu_calib=ImuCalib.default(device="cpu"))
    assert tr.monocular and tr.use_imu and tr._Rbc_dev.device.type == "cpu"


def test_monocular_tracker_builds_and_resets_its_initializer():
    """The visual monocular tracker (M9b) builds with no reference frame;
    ResetActiveMap drops the reference, as the JAX tracker does
    (fasttrack_tpu/tracking.py:1012)."""
    tr = tracking.Tracker(_cam(), CFG, 1.0, Atlas(), monocular=True, device="cpu")
    assert tr.monocular and tr._init_reference is None
    tr.track_monocular(np.zeros((H, W), np.uint8), 0.0)   # no keypoint: no reference
    assert tr.state.name == "NOT_INITIALIZED" and tr._init_reference is None
    tr._init_reference = object()
    tr._reset_active_map()
    assert tr._init_reference is None and tr.state.name == "NOT_INITIALIZED"


@pytest.mark.parametrize("queued", [False, True], ids=["track_rgbd", "track_rgbd_after_grab_imu"])
def test_rgbd_entry_point_initializes_from_the_depth_map(seq, queued):
    """track_rgbd (M9d) on the first rendered frame and its exact depth map:
    the stereo initialization from the keypoints with a depth, one
    keyframe and a point for each of them. A visual tracker keeps queued
    IMU samples and does not read them, as the JAX Tracker does."""
    tr = tracking.Tracker(_cam(), CFG, 28.0, Atlas(), device="cpu")
    if queued:
        tr.grab_imu([(0.0, np.zeros(3), np.zeros(3))])     # queues, as the JAX Tracker does
    f = seq.frames[0]
    depth = synthetic.sequence_depths(seq._replace(frames=seq.frames[:1]))[0]
    pose = tr.track_rgbd(f.left, depth, f.timestamp)
    assert tr.state.name == "OK" and pose is not None
    assert len(tr.imu_queue) == int(queued)
    lf = tr.last_frame
    good = lf.valid & (lf.depth > 0)
    assert good.sum() > 100 and tr.atlas.current.n_keyframes() == 1
    assert tr.atlas.current.n_mappoints() == good.sum()
    # every depth the frame took is the map's value at its keypoint's pixel
    xi, yi = lf.kp_uv[good].astype(np.int64).T
    np.testing.assert_array_equal(lf.depth[good], depth[yi, xi])


HOST_PATH_SERIES = ("orb_extraction", "tracking_total", "twm", "tlm", "trk")


@pytest.mark.parametrize("mask, n_ok, present, absent", [
    ("0111", 0, ["device_fetches"], []),              # host extraction, device stereo
    ("1011", 0, ["device_fetches"], []),              # device extraction, host stereo
    ("1101", 1, ["trk", "tlm"], ["slp_exec"]),        # the local-map matcher
    ("1110", 2, ["twm", "tlm", "slp_exec"], ["twm_exec"]),   # the motion-model matcher
])
def test_toggle_off_raises_where_its_host_path_would_run(seq, jax_host_kernels, mask, n_ok,
                                                         present, absent):
    """Frame `n_ok` is where an offload toggle that is off first selects its
    host path (it raised there until the host sides were ported): extraction
    and stereo at frame 0, the local-map matcher at the first tracked frame,
    the motion-model matcher at the second. Now the frame runs that path: it
    records the series of the stages it ran and none of the device matcher
    it skipped, like the JAX tracker's, and binds what the JAX tracker
    binds."""
    jt, tt = make_trackers(seq, (mask, True))
    frames = seq.frames[:n_ok + 1]
    rows_j = [step(jt, f.left, f.right, f.timestamp) for f in frames]
    rows_t = [step(tt, f.left, f.right, f.timestamp) for f in frames]
    series = tt.stats.series
    for name in absent:
        assert name not in series and name not in jt.stats.series, name
    for name in ["orb_extraction", "tracking_total"] + present:
        assert len(series[name]) >= 1, name
    for name in HOST_PATH_SERIES:
        assert len(series.get(name, [])) == len(jt.stats.series.get(name, [])), name
    assert [r["state"] for r in rows_t] == [r["state"] for r in rows_j] == ["OK"] * (n_ok + 1)
    assert [r["path"] for r in rows_t] == ["stepwise"] * (n_ok + 1)
    np.testing.assert_array_equal(rows_t[-1]["mp_ids"], rows_j[-1]["mp_ids"])
    assert (rows_t[-1]["mp_ids"] >= 0).sum() >= 100


def test_relocalization_without_a_database_is_false_and_with_one_raises(seq):
    """Without a database there is nothing to relocalize against. With one
    (place recognition is ported: tests/test_torch_relocalization.py holds
    it against the JAX package), the first frame relocalizes against the
    keyframe it made, and a database that holds no keyframe yields no
    candidate and no pose."""
    from fasttrack_tpu_torch.bow import KeyFrameDatabase
    from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary, quantize

    tr = _cpu_tracker(seq)
    f = seq.frames[0]
    tr.track_stereo(f.left, f.right, f.timestamp)
    assert tr._relocalization(tr.last_frame) is False
    tr.reloc_db, tr.vocabulary = KeyFrameDatabase(), load_default_vocabulary()
    assert tr._relocalization(tr.last_frame) is False
    for kid, kf in tr.atlas.current.keyframes.items():
        tr.reloc_db.add(kid, quantize(tr.vocabulary, kf.desc_signed, kf.valid)[1])
    tr.ref_kf_id = None
    assert tr._relocalization(tr.last_frame) is True
    assert tr.ref_kf_id == 0 and tr.n_inliers >= 50


def test_kernel_config_bitmask():
    k = KernelConfig.from_bitmask("1001", pose_optimization=False)
    j = JaxKernelConfig.from_bitmask("1001", pose_optimization=False)
    assert (k.orb_extraction, k.stereo_match, k.search_local_points, k.pose_estimation,
            k.pose_optimization) == (j.orb_extraction, j.stereo_match, j.search_local_points,
                                     j.pose_estimation, j.pose_optimization)
    with pytest.raises(ValueError):
        KernelConfig.from_bitmask("10x1")
