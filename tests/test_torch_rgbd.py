"""The port's RGB-D sensor (M9d) against the JAX package, on the CPU.

The scene is the rendered sweep (`datasets.synthetic.generate_rgbd_sequence`:
320x240 at 20 fps, seed 3) with each frame's exact depth map, 512 features,
4 levels and TUM1.yaml's Camera.bf 40.0 and ThDepth 40.0 (rig_reading's
"test" RGB-D scene). Tolerances and why:

- `process_rgbd_frame` against the JAX function: the keypoints as sets
  (ROADMAP F4), `u_right` and `depth` exact on the common keypoints (the
  same gather and the same float32 arithmetic), on a depth map with holes
  (0, negative, NaN) and on keypoints moved to the image's border and past
  it, where the truncated coordinates are clipped;
- the depth renderer: the frames it is rendered beside stay bit-equal to
  the JAX renderer's, and its depth agrees with the rendered stereo pair:
  bf / depth against the port's rectified stereo matcher's disparity on
  frame 0, median relative error under 1% (the matcher's sub-pixel
  parabola on a bilinearly sampled texture; it reads ~0.2%);
- `Tracker.track_rgbd` (no mapper) against the JAX Tracker over 12 frames:
  states, keyframes and map points equal, bindings equal on >= 95% of the
  keypoints, poses within 1e-3 (f32 rounding through pose optimization);
  F40: the same fetches per frame in both (the JAX tracker does not count
  the reference-keyframe matcher's), every frame stepwise and no call of
  `_track_fused`; F41: under mask 0011 (host extraction and host
  stereo asked for) both trackers take the same device route, frame for
  frame equal to their 1111 run;
- `System(Sensor.RGBD)` over 30 frames and `System(Sensor.IMU_RGBD)` over
  50 frames with the exact 200 Hz stream and T_b_c1 = I, each package once
  (no vocabulary, inline, the port on one torch thread): the same init
  frame, every frame OK in both, the IMU init at the JAX package's frame
  +-1, the port's SE(3) ATE under 0.02 m and within 1.5x the JAX
  package's (both read 0.0072 m and 0.0112 m); `async_mapping=True` (port
  only) over 15 frames: every frame OK, the mapper drained, no thread left.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import rig_reading
from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu import native as jnative
from fasttrack_tpu import tracking as jtracking
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.datasets import synthetic as jsynthetic
from fasttrack_tpu.kernels import KernelConfig as JaxKernelConfig
from fasttrack_tpu.ops import extractor as jext
from fasttrack_tpu.slam_map import Atlas as JaxAtlas
from fasttrack_tpu_torch import frame_pipeline as tfp
from fasttrack_tpu_torch import tracking
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.ops import extractor as text
from fasttrack_tpu_torch.ops import host_kernels
from fasttrack_tpu_torch.slam_map import Atlas

H, W = 240, 320
N_FEATURES, N_LEVELS = 512, 4
BF = chip_smoke.RGBD_BF
JCFG = jext.OrbConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS)
CFG = text.OrbConfig(**JCFG._asdict())
N_FRAMES, N_INERTIAL_FRAMES = rig_reading.RGBD_SCENES["test"][-1]
N_TRACKER_FRAMES = 12
N_MASK_FRAMES = 6
POSE_ATOL = 1e-3
MIN_IDS_EQUAL = 0.95
STEREO_DEPTH_REL_ERR = 0.01
ATE_LIMIT_M = 0.02
ATE_FACTOR = 1.5


def numpy_hamming_matrix_packed(a, b):
    bits_a = np.unpackbits(np.ascontiguousarray(a, np.uint8), axis=1).astype(np.int32)
    bits_b = np.unpackbits(np.ascontiguousarray(b, np.uint8), axis=1).astype(np.int32)
    return (bits_a @ (1 - bits_b).T + (1 - bits_a) @ bits_b.T).astype(np.int32)


@pytest.fixture(scope="module")
def scene():
    """The inertial run's 50 frames (the sweep's period is 3 s for both
    lengths, so the first 30 are the visual run's) and their depth maps."""
    return synthetic.generate_rgbd_sequence(N_INERTIAL_FRAMES, H, W, fps=20.0,
                                            seed=chip_smoke.RGBD_SEED)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# -------------------------------------------------------- process_rgbd_frame
def kp_keys(x, y, level, valid):
    return {(float(x[i]), float(y[i]), int(level[i])): i for i in np.where(valid)[0]}


def common(want, got):
    """Indices (JAX, port) of the keypoints both frames hold, as sets."""
    a = kp_keys(*(np.asarray(getattr(want.kps, f)) for f in ("x", "y", "level", "valid")))
    b = kp_keys(*(getattr(got.kps, f).numpy() for f in ("x", "y", "level", "valid")))
    assert set(a) == set(b) and len(a) > 200
    return np.asarray([a[k] for k in a]), np.asarray([b[k] for k in a])


def holed(depth):
    """The depth map with holes: rows of 0, columns of negative depth, a
    lattice of NaN."""
    d = depth.copy()
    d[::7, :] = 0.0
    d[:, ::11] = -1.0
    d[5::13, 3::9] = np.nan
    return d


def both_frames(image, depth):
    want = jfp.process_rgbd_frame(jnp.asarray(image, jnp.float32), jnp.asarray(depth), JCFG,
                                  jnp.float32(BF))
    got = tfp.process_rgbd_frame(torch.from_numpy(image), torch.from_numpy(depth), CFG,
                                 torch.tensor(BF))
    return want, got


def test_process_rgbd_frame_equals_jax_on_a_depth_map_with_holes(scene):
    seq, depths = scene
    d = holed(depths[0])
    want, got = both_frames(seq.frames[0].left, d)
    ia, ib = common(want, got)
    for f in ("u_right", "depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[ib], np.asarray(getattr(want, f))[ia])
    assert got.kps_right is None and int(got.n_valid) == int(want.n_valid)
    depth = got.depth.numpy()
    # the holes took no depth, the rest took the map's value at the pixel
    x, y = got.kps.x.numpy()[ib], got.kps.y.numpy()[ib]
    z = d[y.astype(np.int64), x.astype(np.int64)]
    has = np.isfinite(z) & (z > 0)
    assert 100 < has.sum() < len(ib)
    np.testing.assert_array_equal(depth[ib][has], z[has])
    assert (depth[ib][~has] == -1).all() and (got.u_right.numpy()[ib][~has] == -1).all()
    np.testing.assert_allclose(got.u_right.numpy()[ib][has], x[has] - BF / z[has], rtol=0, atol=1e-4)
    # an invalid slot never takes a depth
    assert (depth[~got.kps.valid.numpy()] == -1).all()


def test_process_rgbd_frame_clips_keypoints_at_the_border(scene, monkeypatch):
    """Keypoints moved onto the last row and column, past them and to a
    negative fraction: the coordinates are truncated toward zero and
    clipped into the image, in both packages alike."""
    seq, depths = scene
    image = seq.frames[0].left
    cfg_j = JCFG._replace(n_features=N_FEATURES - 8)   # its own trace of the JAX program
    cfg_t = text.OrbConfig(**cfg_j._asdict())
    kj, _ = jext.extract_orb(jnp.asarray(image, jnp.float32), cfg_j)
    x, y, valid = np.asarray(kj.x).copy(), np.asarray(kj.y).copy(), np.asarray(kj.valid).copy()
    moved = np.where(valid)[0][:6]
    x[moved] = [W - 0.25, W + 2.7, -0.6, 10.5, W - 1.0, 50.0]
    y[moved] = [H - 0.5, 7.0, H + 4.2, -0.9, H - 1.0, H + 0.3]
    kj = kj._replace(x=jnp.asarray(x), y=jnp.asarray(y))
    kt, _ = text.extract_orb(torch.from_numpy(image), cfg_t)
    kt = kt._replace(x=torch.from_numpy(x), y=torch.from_numpy(y))
    monkeypatch.setattr(jfp, "extract_orb", lambda img, cfg: (kj, None))
    monkeypatch.setattr(tfp, "extract_orb", lambda img, cfg: (kt, None))
    d = depths[0]
    want = jfp.process_rgbd_frame(jnp.asarray(image, jnp.float32), jnp.asarray(d), cfg_j,
                                  jnp.float32(BF))
    got = tfp.process_rgbd_frame(torch.from_numpy(image), torch.from_numpy(d), cfg_t,
                                 torch.tensor(BF))
    for f in ("u_right", "depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    xi = np.clip(np.trunc(x[moved]), 0, W - 1).astype(np.int64)
    yi = np.clip(np.trunc(y[moved]), 0, H - 1).astype(np.int64)
    np.testing.assert_array_equal(got.depth.numpy()[moved], d[yi, xi])


# ------------------------------------------------------------ depth renderer
def test_depth_renderer_leaves_the_frames_bit_equal(scene):
    seq, _ = scene
    want = jsynthetic.generate_sequence(n_frames=3, h=H, w=W, fps=20.0, seed=chip_smoke.RGBD_SEED)
    short, depths = synthetic.generate_rgbd_sequence(3, H, W, fps=20.0, seed=chip_smoke.RGBD_SEED)
    for a, b, c in zip(short.frames, want.frames, seq.frames):
        for f in ("left", "right", "R_wc", "t_wc"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        # the first frames of the longer render are the same poses of the
        # same sweep (its period is 3 s for both lengths)
        np.testing.assert_array_equal(a.left, c.left)
    assert len(depths) == 3 and depths[0].shape == (H, W) and depths[0].dtype == np.float32


def test_depth_renderer_agrees_with_the_stereo_pair(scene):
    """bf / depth at each matched keypoint against the disparity the port's
    rectified stereo matcher measures on frame 0 of the rendered pair."""
    seq, depths = scene
    f = seq.frames[0]
    bf = seq.fx * seq.baseline
    stacked = torch.from_numpy(np.stack([f.left, f.right]).astype(np.uint8))
    fd = tfp.process_stereo_frame_stacked(stacked, CFG, torch.tensor(bf), torch.tensor(seq.baseline))
    x, y = fd.kps.x.numpy(), fd.kps.y.numpy()
    ok = fd.kps.valid.numpy() & (fd.u_right.numpy() >= 0)
    assert ok.sum() > 200
    z = depths[0][y[ok].astype(np.int64), x[ok].astype(np.int64)]
    measured = x[ok] - fd.u_right.numpy()[ok]
    rel = np.abs(measured - bf / z) / (bf / z)
    assert np.median(rel) < STEREO_DEPTH_REL_ERR, np.median(rel)
    # the two planes: the square at 2.5 m, the background at 4 m (the
    # camera sits ~0.08 m in front of the plane's origin)
    assert depths[0].min() > 2.3 and depths[0].max() < 4.0


# --------------------------------------------------------------- the trackers
def make_trackers(seq, mode=None):
    jk, tk = {}, {}
    if mode is not None:
        jk = dict(kernel_config=JaxKernelConfig.from_bitmask(mode))
        tk = dict(kernel_config=KernelConfig.from_bitmask(mode))
    jt = jtracking.Tracker(jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H), JCFG, BF,
                           JaxAtlas(), th_depth_factor=chip_smoke.RGBD_TH_DEPTH, **jk)
    tt = tracking.Tracker(make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"), CFG,
                          BF, Atlas(), th_depth_factor=chip_smoke.RGBD_TH_DEPTH, device="cpu",
                          **tk)
    return jt, tt


def step(tracker, frame, depth):
    series = tracker.stats.series
    fetches = len(series["device_fetches"])
    stepwise, trk = len(series["orb_extraction"]), len(series["trk"])
    tracker.track_rgbd(frame.left, depth, frame.timestamp)
    f = tracker.last_frame
    return dict(state=tracker.state.name, fetches=len(series["device_fetches"]) - fetches,
                stepwise=len(series["orb_extraction"]) - stepwise,
                trk=len(series["trk"]) - trk,
                n_keyframes=tracker.atlas.current.n_keyframes(),
                n_mappoints=tracker.atlas.current.n_mappoints(), mp_ids=f.mp_ids.copy(),
                R=f.R_cw.copy(), t=f.t_cw.copy())


def run_trackers(scene, n, mode=None):
    """Both packages' trackers over the first `n` frames, with every call of
    `_track_fused` counted (ROADMAP F40) and every call of the host
    extractor (F41)."""
    seq, depths = scene
    jt, tt = make_trackers(seq, mode)
    calls = {"fused": 0, "host_extract": 0}

    def counted(inner, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return inner(*args, **kwargs)
        return wrapper

    mp = pytest.MonkeyPatch()
    for cls in (jtracking.Tracker, tracking.Tracker):
        mp.setattr(cls, "_track_fused", counted(cls._track_fused, "fused"))
    from fasttrack_tpu.ops import host_kernels as jhost_kernels
    for module in (host_kernels, jhost_kernels):
        mp.setattr(module, "host_extract_orb_with_pyramid",
                   counted(module.host_extract_orb_with_pyramid, "host_extract"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        log_j = [step(jt, f, d) for f, d in zip(seq.frames[:n], depths)]
        log_t = [step(tt, f, d) for f, d in zip(seq.frames[:n], depths)]
    finally:
        torch.set_num_threads(n_threads)
        mp.undo()
    return log_j, log_t, calls


@pytest.fixture(scope="module")
def tracked(scene):
    return run_trackers(scene, N_TRACKER_FRAMES)


def test_track_rgbd_states_keyframes_and_points_equal_jax(tracked):
    log_j, log_t, _ = tracked
    assert [r["state"] for r in log_t] == [r["state"] for r in log_j] == ["OK"] * N_TRACKER_FRAMES
    assert [r["n_keyframes"] for r in log_t] == [r["n_keyframes"] for r in log_j]
    assert [r["n_mappoints"] for r in log_t] == [r["n_mappoints"] for r in log_j]
    assert log_t[0]["n_mappoints"] > 200


def test_track_rgbd_poses_and_bindings_equal_jax(tracked):
    log_j, log_t, _ = tracked
    for i, (a, b) in enumerate(zip(log_t, log_j)):
        assert np.linalg.norm(a["R"] - b["R"]) < POSE_ATOL, i
        assert np.linalg.norm(a["t"] - b["t"]) < POSE_ATOL, i
        assert float((a["mp_ids"] == b["mp_ids"]).mean()) >= MIN_IDS_EQUAL, i
    assert np.linalg.norm(log_t[-1]["t"] - log_t[0]["t"]) > 0.05      # the camera moved


def test_f40_the_rgbd_route_is_never_fused(tracked):
    """ROADMAP F40: the JAX RGB-D route always takes the stepwise programs
    (the snapshot's fetch, then the motion-model and local-map searches
    with their own), never the fused frame; the port mirrors it."""
    log_j, log_t, calls = tracked
    assert calls["fused"] == 0
    assert [r["stepwise"] for r in log_t] == [r["stepwise"] for r in log_j] == [1] * N_TRACKER_FRAMES
    # the same fetches, but for the reference-keyframe matcher's, which
    # the JAX tracker makes without counting it
    assert [r["trk"] for r in log_t] == [r["trk"] for r in log_j]
    fetches = [r["fetches"] for r in log_t]
    assert fetches == [r["fetches"] + r["trk"] for r in log_j]
    assert fetches[0] == 1 and min(fetches[1:]) >= 3


def test_f41_the_rgbd_front_end_reads_no_toggle(scene, tracked):
    """ROADMAP F41: mask 0011 asks for host extraction and host stereo; the
    RGB-D route of both packages extracts on the device all the same (no
    host extractor call) and tracks frame for frame as under 1111."""
    log_j, log_t, calls = run_trackers(scene, N_MASK_FRAMES, mode="0011")
    assert calls["host_extract"] == 0 and calls["fused"] == 0
    for log, ref in ((log_j, tracked[0]), (log_t, tracked[1])):
        for a, b in zip(log, ref[:N_MASK_FRAMES]):
            assert a["state"] == b["state"] and a["n_mappoints"] == b["n_mappoints"]
            np.testing.assert_array_equal(a["mp_ids"], b["mp_ids"])
            np.testing.assert_array_equal(a["R"], b["R"])
            np.testing.assert_array_equal(a["t"], b["t"])


# ---------------------------------------------------------------- the Systems
def imu_between(seq, t0, t1):
    sel = np.where((seq.imu_t > t0) & (seq.imu_t <= t1))[0]
    return [(float(seq.imu_t[i]), seq.imu_acc[i], seq.imu_gyro[i]) for i in sel]


def drive(system, scene, n, inertial):
    seq, depths = scene
    rows, t_prev = [], -1.0
    for f, d in zip(seq.frames[:n], depths):
        imu = imu_between(seq, t_prev, f.timestamp) if inertial else None
        system.track_rgbd(f.left, d, f.timestamp, imu=imu)
        t_prev = f.timestamp
        rows.append((system.tracking_state.name, bool(system.atlas.current.imu_initialized)))
    return rows


def se3_ate(system, seq):
    traj = system.tracker.trajectory
    return absolute_trajectory_error(np.asarray([t for t, _, _ in traj]),
                                     np.asarray([-R.T @ t for _, R, t in traj]),
                                     seq.gt_t, seq.gt_pos)


def run_systems(scene, inertial):
    """Each package's RGB-D System once over the scene, inline, no
    vocabulary."""
    from fasttrack_tpu.system import Sensor as JSensor
    from fasttrack_tpu.system import System as JSystem
    from fasttrack_tpu_torch.system import Sensor, System

    seq, _ = scene
    n = N_INERTIAL_FRAMES if inertial else N_FRAMES
    h, w, _, features, levels, _, _ = rig_reading.RGBD_SCENES["test"]
    out = {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    try:
        for pkg, sensor, make in (
                ("jax", JSensor.IMU_RGBD if inertial else JSensor.RGBD,
                 lambda s, sensor: JSystem(s, sensor, vocabulary=False)),
                ("torch", Sensor.IMU_RGBD if inertial else Sensor.RGBD,
                 lambda s, sensor: System(s, sensor, vocabulary=False, device="cpu"))):
            settings = rig_reading.rgbd_settings(pkg, seq, h, w, features, levels, inertial)
            system = make(settings, sensor)
            rows = drive(system, scene, n, inertial)
            system.shutdown()
            out[pkg] = (system, rows, se3_ate(system, seq))
    finally:
        mp.undo()
        torch.set_num_threads(n_threads)
    return out


@pytest.fixture(scope="module")
def visual_systems(scene):
    return run_systems(scene, inertial=False)


@pytest.fixture(scope="module")
def inertial_systems(scene):
    return run_systems(scene, inertial=True)


def test_rgbd_system_tracks_every_frame_as_jax(visual_systems):
    (jsys, jrows, _), (tsys, trows, _) = visual_systems["jax"], visual_systems["torch"]
    assert [r[0] for r in trows] == [r[0] for r in jrows] == ["OK"] * N_FRAMES
    assert tsys.atlas.current.n_keyframes() == jsys.atlas.current.n_keyframes() >= 2
    assert not tsys.tracker.monocular and not tsys.local_mapper.monocular
    assert len(tsys.stats.series["lm_keyframes"]) >= 1


def test_rgbd_system_ate_against_jax(visual_systems):
    j_ate, t_ate = visual_systems["jax"][2], visual_systems["torch"][2]
    assert t_ate["n"] == j_ate["n"] == N_FRAMES
    assert t_ate["rmse"] < ATE_LIMIT_M and t_ate["rmse"] <= ATE_FACTOR * j_ate["rmse"], (t_ate, j_ate)


def test_imu_rgbd_system_initializes_its_imu_at_the_jax_packages_frame(inertial_systems):
    (jsys, jrows, _), (tsys, trows, _) = inertial_systems["jax"], inertial_systems["torch"]
    assert [r[0] for r in trows] == ["OK"] * N_INERTIAL_FRAMES
    assert [r[0] for r in jrows] == ["OK"] * N_INERTIAL_FRAMES
    t_init = [r[1] for r in trows].index(True)
    j_init = [r[1] for r in jrows].index(True)
    assert abs(t_init - j_init) <= 1 and t_init < N_INERTIAL_FRAMES - 5, (t_init, j_init)
    assert tsys.tracker.use_imu and not tsys.tracker.monocular
    assert np.linalg.norm(tsys.tracker.bias[0]) < 0.05


def test_imu_rgbd_system_ate_against_jax(inertial_systems):
    j_ate, t_ate = inertial_systems["jax"][2], inertial_systems["torch"][2]
    assert t_ate["n"] == j_ate["n"] == N_INERTIAL_FRAMES
    assert t_ate["rmse"] < ATE_LIMIT_M and t_ate["rmse"] <= ATE_FACTOR * j_ate["rmse"], (t_ate, j_ate)


def test_rgbd_system_async_mapping(scene, one_torch_thread):
    from fasttrack_tpu_torch.system import Sensor, System

    seq, _ = scene
    before = {t.ident for t in threading.enumerate()}
    settings = rig_reading.rgbd_settings("torch", seq, H, W, N_FEATURES, N_LEVELS, False)
    system = System(settings, Sensor.RGBD, async_mapping=True, vocabulary=False, device="cpu")
    rows = drive(system, scene, 15, inertial=False)
    assert [r[0] for r in rows] == ["OK"] * 15
    t0 = time.perf_counter()
    while not system.local_mapper.is_idle() and time.perf_counter() - t0 < 60.0:
        time.sleep(0.05)
    assert system.local_mapper.is_idle() and sum(system.stats.series["lm_keyframes"]) >= 1
    system.shutdown()
    alive = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert not alive, alive
