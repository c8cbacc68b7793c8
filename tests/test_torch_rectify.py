"""The port's start-up camera transforms against the JAX package's, on the CPU.

EuRoC's rig as distributed: a distorted (radial-tangential) pinhole pair,
rectified at start-up, optionally resized first (Camera.newWidth /
newHeight). Tolerances and why:

- `compute_rectification` on tests/test_rectify.py's tilted rig (a 0.57 deg
  roll between the cameras): the new camera, `bf` and the right camera's
  tables equal the JAX package's to 1e-5 px. The left camera's tables
  differ (ROADMAP F23: the JAX package gives camera 1 the same half
  rotation as camera 2, so the pair keeps its roll): both packages are held
  to the geometry instead, every rectified pixel's table entry against the
  distorted projection of its ray, 1e-3 px, and the right table against
  the same 3D point at disparity bf / Z on the same row. The port passes;
  the JAX package's left table is off by more than 0.1 px;
- on a rig with no relative rotation (the baseline tilted off the x axis,
  so R1 is not I) the tables are bit-equal, and so are the frames both
  packages upload;
- `remap_bilinear` bit-equal on uint8, uint16 and float32;
- the resize scales the intrinsics and the frames as
  tests/test_robustness.py:206 checks, bit-equal to the JAX System's;
- F10: the port with T_b_c1 builds the IMU calibration the JAX System
  builds from T_b_c1 [R1^T | 0] (to 1e-7, float32), and one R1's angle away from
  what the JAX System builds from T_b_c1;
- a 320x240 distorted pair, body rotated 90 deg from camera 1, through
  both Systems, visual and inertial (the JAX one given T_b_c1 [R1^T | 0]),
  20 frames each (the visual run makes its first keyframe, the inertial
  one four and adjusts them; neither reaches IMU init, which needs 2 s):
  states, paths and keyframe frames equal on every frame,
  poses within 1e-3 m up to the first local bundle adjustment (after it
  the JAX package's float32 adjustment is chaotic at this spacing, ROADMAP
  P4, as tests/test_torch_system_inertial.py says), and the ATE of both
  under 0.02 m against the renderer's ground truth.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fasttrack_tpu import native as jnative
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.cameras import rectify as jrect
from fasttrack_tpu.settings import Settings as JaxSettings
from fasttrack_tpu.system import Sensor as JaxSensor
from fasttrack_tpu.system import System as JaxSystem
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.cameras import rectify as trect
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_rectify import make_rig
from tests.test_torch_system_inertial import (
    ate_rmse,
    frame_row,
    imu_between,
    numpy_hamming_matrix_packed,
    one_torch_thread,
)

H, W = 240, 320
N_FRAMES = 20
POSE_ATOL = 1e-3
ATE_LIMIT = 0.02


def torch_cam(jcam):
    return make_pinhole(*(float(v) for v in np.asarray(jcam.params)[:4]), jcam.width,
                        jcam.height, device="cpu")


def distorted_pixel(K, D, X):
    xd, yd = trect.distort_pinhole(np.asarray(D, np.float64), X[:, 0] / X[:, 2], X[:, 1] / X[:, 2])
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def table_errors(maps, R1, K1, D1, K2, D2, T_c1_c2, Kn, bf, rng):
    """For rectified pixels (u, v) and integer disparities d: the left table
    at (v, u) against the distorted projection of the ray's point at depth
    bf / d, and the right table at (v, u - d) against the same point's in
    camera 2 (px, largest of each)."""
    n = 200
    u = rng.integers(60, W - 40, n)
    v = rng.integers(30, H - 30, n)
    d = rng.integers(4, 20, n)
    Z = bf / d
    X_rect = np.stack([(u - Kn[0, 2]) / Kn[0, 0], (v - Kn[1, 2]) / Kn[1, 1], np.ones(n)], -1) * Z[:, None]
    X1 = X_rect @ R1                     # R1^T X_rect
    T_c2_c1 = np.linalg.inv(T_c1_c2)
    X2 = X1 @ T_c2_c1[:3, :3].T + T_c2_c1[:3, 3]
    left = np.stack([maps.map_lx[v, u], maps.map_ly[v, u]], -1)
    right = np.stack([maps.map_rx[v, u - d], maps.map_ry[v, u - d]], -1)
    return (np.abs(left - distorted_pixel(K1, D1, X1)).max(),
            np.abs(right - distorted_pixel(K2, D2, X2)).max())


def K_of(cam):
    fx, fy, cx, cy = np.asarray(cam.params, np.float64)[:4]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


# ---------------------------------------------------------------- rectification
def test_rectification_of_the_tilted_rig(rng):
    cam1, D1, cam2, D2, T, w, h = make_rig()
    want = jrect.compute_rectification(cam1, D1, cam2, D2, T, w, h)
    got = trect.compute_rectification(torch_cam(cam1), D1, torch_cam(cam2), D2, T, w, h,
                                      device="cpu")
    np.testing.assert_allclose(got.camera.params.numpy(), np.asarray(want.camera.params), atol=1e-5)
    assert got.bf == pytest.approx(want.bf, abs=1e-5)
    for name in ("map_rx", "map_ry"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-5)
    Kn, K1, K2 = K_of(got.camera), K_of(cam1), K_of(cam2)
    err_l, err_r = table_errors(got, got.R1, K1, D1, K2, D2, T, Kn, got.bf, rng)
    assert err_l < 1e-3 and err_r < 1e-3, (err_l, err_r)
    # the JAX package's right table is the port's; its left one keeps the roll (F23)
    err_l_jax, _ = table_errors(want, got.R1, K1, D1, K2, D2, T, Kn, got.bf, rng)
    assert err_l_jax > 0.1, err_l_jax
    assert np.abs(got.map_lx - want.map_lx).max() > 0.1


def untilted_rig():
    """tests/test_rectify.py's cameras with no relative rotation, the
    baseline tilted off the x axis (R1 != I)."""
    cam1, D1, cam2, D2, T, w, h = make_rig()
    T = np.eye(4)
    T[:3, 3] = [0.11, 0.004, -0.002]
    return cam1, D1, cam2, D2, T, w, h


def test_rectification_without_relative_rotation_is_bit_equal():
    cam1, D1, cam2, D2, T, w, h = untilted_rig()
    want = jrect.compute_rectification(cam1, D1, cam2, D2, T, w, h)
    got = trect.compute_rectification(torch_cam(cam1), D1, torch_cam(cam2), D2, T, w, h,
                                      device="cpu")
    for name in ("map_lx", "map_ly", "map_rx", "map_ry"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.camera.params.numpy(), np.asarray(want.camera.params))
    assert got.bf == want.bf and got.camera.params.device.type == "cpu"
    angle = np.degrees(np.arccos((np.trace(got.R1) - 1) / 2))
    assert 2.0 < angle < 2.5, angle
    np.testing.assert_allclose(got.R1 @ got.R1.T, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_remap_bilinear_is_bit_equal(rng, dtype):
    img = rng.uniform(0, 250 if dtype == np.uint8 else 9000, (H, W)).astype(dtype)
    my, mx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    mx = mx + rng.uniform(-3, 3, mx.shape).astype(np.float32)   # some fall outside
    my = my * np.float32(1.01) + rng.uniform(-2, 2, my.shape).astype(np.float32)
    got, want = trect.remap_bilinear(img, mx, my), jrect.remap_bilinear(img, mx, my)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------- resize
def resize_settings(pkg):
    kw = dict(width=320, height=240, new_width=160, new_height=120, bf=160.0 * 0.2,
              baseline=0.2, n_features=256, n_levels=3)
    if pkg == "jax":
        return JaxSettings(camera1=jax_make_pinhole(160.0, 160.0, 160.0, 120.0, 320, 240), **kw)
    return Settings(camera1=make_pinhole(160.0, 160.0, 160.0, 120.0, 320, 240, device="cpu"), **kw)


def test_resize_scales_intrinsics_and_frames_as_the_jax_system(monkeypatch):
    monkeypatch.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    seq = synthetic.generate_sequence(n_frames=6, h=240, w=320, seed=1)
    settings = resize_settings("torch")
    before = dataclasses.replace(settings)
    jsys = JaxSystem(resize_settings("jax"), JaxSensor.STEREO, vocabulary=False)
    tsys = System(settings, Sensor.STEREO, vocabulary=False, device="cpu")
    p = tsys.tracker.camera.params.numpy()
    np.testing.assert_array_equal(p, np.asarray(jsys.tracker.camera.params))
    assert abs(p[0] - 80.0) < 1e-6 and abs(p[2] - 80.0) < 1e-6
    assert tsys.tracker.cfg.width == 160 and tsys.tracker.cfg.height == 120
    assert tsys.tracker.bf == jsys.tracker.bf == pytest.approx(16.0)
    # the port works on a copy: the caller's settings are as they were
    assert settings.width == 320 and settings.camera1 is before.camera1 and settings.bf == before.bf
    f = seq.frames[0]
    np.testing.assert_array_equal(tsys._resize_input(f.left), jsys._resize_input(f.left))
    with one_torch_thread():
        for f in seq.frames:
            tsys.track_stereo(f.left, f.right, f.timestamp)
    assert tsys.tracking_state.name == "OK"
    assert len(tsys.stats.series["input_resize"]) == 6


# -------------------------------------------------------------------------- F10
def body_rotated_rig():
    """The renderer's EuRoC-like distorted pair at 320x240 (radtan of EuRoC's
    cameras), no relative rotation, the baseline tilted off x, the body
    rotated 90 deg about camera 1's z."""
    rig = synthetic.euroc_radtan_rig(W, H, tilt_x_deg=0.0)
    T = np.eye(4)
    T[:3, 3] = [0.11, 0.004, -0.002]
    return rig._replace(T_c1_c2=T)


def settings_pair(rig, T_b_c1_jax=None):
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    kw = dict(dist1=rig.dist1, dist2=rig.dist2, T_c1_c2=rig.T_c1_c2,
              bf=rig.params1[0] * 0.11, baseline=0.11, n_features=512, n_levels=4,
              width=W, height=H, th_depth=60.0, imu_frequency=200.0)
    js = JaxSettings(camera1=jax_make_pinhole(*rig.params1, W, H),
                     camera2=jax_make_pinhole(*rig.params2, W, H),
                     T_b_c1=T_b_c1 if T_b_c1_jax is None else T_b_c1_jax, **kw)
    ts = Settings(camera1=make_pinhole(*rig.params1, W, H, device="cpu"),
                  camera2=make_pinhole(*rig.params2, W, H, device="cpu"), T_b_c1=T_b_c1, **kw)
    return js, ts


def composed_extrinsic(rig, R1):
    """T_b_rect = T_b_c1 [R1^T | 0]."""
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    T = np.eye(4)
    T[:3, :3] = R1.T
    return T_b_c1 @ T


def calib_np(system):
    c = system.imu_calib
    return np.asarray(c.R_bc, np.float64), np.asarray(c.t_bc, np.float64)


def test_f10_the_port_composes_the_rectifying_rotation_into_the_extrinsic():
    rig = body_rotated_rig()
    _, ts = settings_pair(rig)
    tsys = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    R1 = tsys._rect.R1
    js, _ = settings_pair(rig, composed_extrinsic(rig, R1))
    jsys = JaxSystem(js, JaxSensor.IMU_STEREO, vocabulary=False)
    R_t, t_t = calib_np(tsys)
    R_j, t_j = calib_np(jsys)
    np.testing.assert_allclose(R_t, R_j, atol=1e-7)
    np.testing.assert_allclose(t_t, t_j, atol=1e-7)
    np.testing.assert_allclose(tsys.tracker._R_bc, rig.R_bc @ R1.T, atol=1e-7)


def test_f10_the_port_differs_from_the_jax_system_given_t_b_c1():
    rig = body_rotated_rig()
    js, ts = settings_pair(rig)
    tsys = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    jsys = JaxSystem(js, JaxSensor.IMU_STEREO, vocabulary=False)
    R_t, _ = calib_np(tsys)
    R_j, _ = calib_np(jsys)
    R1 = tsys._rect.R1
    angle = lambda R: np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert angle(R1) > 2.0
    assert angle(R_t.T @ R_j) == pytest.approx(angle(R1), abs=1e-4)
    np.testing.assert_allclose(R_j, rig.R_bc, atol=1e-7)     # the JAX System keeps T_b_c1


# ------------------------------------------------------------ the two Systems
@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=N_FRAMES, h=H, w=W, seed=5, rig=body_rotated_rig())


def run_pair(seq, sensor):
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    rig = body_rotated_rig()
    _, ts = settings_pair(rig)
    inertial = sensor == "inertial"
    tsys = System(ts, Sensor.IMU_STEREO if inertial else Sensor.STEREO, vocabulary=False,
                  device="cpu")
    js, _ = settings_pair(rig, composed_extrinsic(rig, tsys._rect.R1))
    jsys = JaxSystem(js, JaxSensor.IMU_STEREO if inertial else JaxSensor.STEREO,
                     vocabulary=False)
    log_j, log_t, t_prev = [], [], -1.0
    with one_torch_thread():
        for f in seq.frames:
            imu = imu_between(seq, t_prev, f.timestamp) if inertial else None
            jsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_j.append(frame_row(jsys))
            tsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_t.append(dict(frame_row(tsys),
                              adjusted=int(sum(tsys.stats.series["lm_local_bas"]))))
            t_prev = f.timestamp
    jsys.shutdown()
    tsys.shutdown()
    mp.undo()
    return jsys, tsys, log_j, log_t


@pytest.fixture(scope="module", params=["visual", "inertial"])
def ran(request, seq):
    return request.param, run_pair(seq, request.param)


def test_systems_agree_on_the_distorted_pair(ran, seq):
    sensor, (jsys, tsys, log_j, log_t) = ran
    for key in ("state", "stepwise", "n_keyframes"):
        assert [r[key] for r in log_t] == [r[key] for r in log_j], (sensor, key)
    assert [r["state"] for r in log_t] == ["OK"] * N_FRAMES
    kf_j = {k: kf.frame_id for k, kf in jsys.atlas.current.keyframes.items()}
    kf_t = {k: kf.frame_id for k, kf in tsys.atlas.current.keyframes.items()}
    # keyframes every 0.25 s before IMU init; the visual rule waits longer
    assert kf_t == kf_j and len(kf_t) >= (4 if sensor == "inertial" else 1)
    first_adjusted = next((i for i, r in enumerate(log_t) if r["adjusted"]), N_FRAMES)
    assert first_adjusted >= 5 and (first_adjusted < N_FRAMES) == (sensor == "inertial")
    for i in range(first_adjusted):
        np.testing.assert_allclose(log_t[i]["R"], log_j[i]["R"], atol=POSE_ATOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(log_t[i]["t"], log_j[i]["t"], atol=POSE_ATOL, err_msg=f"frame {i}")
    got, want = ate_rmse(seq, tsys), ate_rmse(seq, jsys)
    assert got < ATE_LIMIT and want < ATE_LIMIT, (sensor, got, want)
    assert len(tsys.stats.series["rectify_remap"]) == N_FRAMES
