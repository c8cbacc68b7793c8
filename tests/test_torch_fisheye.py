"""The port's Kannala-Brandt-8 fisheye route against the JAX package's, on the CPU.

TUM-VI's rig as distributed: a KB8 fisheye pair with its extrinsic
(datasets.synthetic.tumvi_kb8_rig), which takes the fisheye route. The same
inputs, made from a NumPy seed, go through both packages (the port with
device="cpu"). Tolerances and why:

- `unproject` (the fixed 10-step Newton inversion and its clamps): 1e-5
  relative to each ray's length (f32 tan near the image circle);
- the closed-form `project_jacobian` of both models against the JAX
  package's jax.jacfwd, on-axis points (r^2 < 1e-16: scale 1), points
  between the two clamps (1e-18 < r^2 < 1e-16), just off them, behind the
  camera and at the pinhole's |z| < 1e-9 clamp included: 1e-4 relative to
  the largest entry; `ba_core.projection_jacobian`'s stereo row is zero on
  a fisheye (mono) edge and u's row plus bf/z^2 on a stereo one;
- `triangulate_matches` on rays of the rig with noise, mismatches and far
  points (the parallax gate): masks equal, depth 1e-4 relative;
- `process_fisheye_frame_stacked` on a rendered 320x320 pair: keypoint
  (x, y, level) sets overlap >= 0.97 (tie order, ROADMAP F4), the sets of
  keypoints given a depth overlap >= 0.95, and on keypoints both give a
  depth the relative difference under 1e-3 for the median and the 90th
  percentile (a tie broken the other way pairs another right keypoint);
- `pose_optimize` on KB8 mono edges with outliers: poses 1e-4, masks equal;
  one local BA on a KB8 window and one VI pose optimization through a KB8
  camera: the tolerances of tests/test_torch_ba.py and
  tests/test_torch_inertial.py;
- tests/test_fisheye_e2e.py's scene (18 frames at 384x288, a KB8 pair
  0.22 m apart, gentle translation and yaw) through the visual `System` of
  both packages (vocabulary=False; the JAX side with its host Hamming
  matrix from NumPy): the tracker takes the fisheye route, states and
  keyframe frames equal on every frame, poses within 1e-3 m on every
  frame, and the first frame's depths as the JAX test checks them (> 80,
  median between 1.5 and 4.5 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu import native as jnative
from fasttrack_tpu.cameras import make_kannala_brandt8 as jax_make_kb8
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.cameras import models as jmodels
from fasttrack_tpu.cameras import stereo as jstereo
from fasttrack_tpu.geometry import SE3 as JaxSE3
from fasttrack_tpu.geometry import se3_compose, se3_exp
from fasttrack_tpu.imu import preintegration as jpre
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.optim import inertial as jin
from fasttrack_tpu.optim import local_ba as jba
from fasttrack_tpu.optim import pose_optimize as jax_pose_optimize
from fasttrack_tpu.settings import Settings as JaxSettings
from fasttrack_tpu.system import Sensor as JaxSensor
from fasttrack_tpu.system import System as JaxSystem
from fasttrack_tpu_torch import convert, parity
from fasttrack_tpu_torch.cameras import host_camera, make_kannala_brandt8, make_pinhole, project_np
from fasttrack_tpu_torch.cameras import models as tmodels
from fasttrack_tpu_torch.cameras.stereo import stereo_rig_from_numpy, triangulate_matches
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.frame_pipeline import process_fisheye_frame_stacked
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.optim import ba_core, local_ba, pose_optimize
from fasttrack_tpu_torch.optim import inertial as tin
from fasttrack_tpu_torch.datasets.synthetic import _render, make_texture
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_torch_system_inertial import numpy_hamming_matrix_packed, one_torch_thread

W = H = 320
RIG = synthetic.tumvi_kb8_rig(W, H, baseline=0.2)
P1, P2 = RIG.params1, RIG.params2
BF = float(P1[0] * 0.2)


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def cams(params=P1):
    return jax_make_kb8(*params, W, H), make_kannala_brandt8(*params, W, H, device="cpu")


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def points_in_view(rng, n, R=np.eye(3), t=np.zeros(3)):
    """World points whose camera-frame directions lie within 60 degrees of
    the axis, at 1.5-6 m, for a camera at (R, t) (X_c = R X_w + t)."""
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.7
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xc = d * rng.uniform(1.5, 6.0, (n, 1))
    return (Xc - t) @ R


# ------------------------------------------------------------- camera model
def test_kb8_unproject_equals_jax(rng):
    jcam, tcam = cams()
    uv = rng.uniform(0, W, (500, 2)).astype(np.float32)
    uv[0] = P1[2:4]                                   # on the axis
    uv[1] = P1[2:4] + 1e-4
    want = np.asarray(jmodels.unproject(jcam, J(uv)))
    got = tmodels.unproject(tcam, T(uv)).numpy()
    err = np.abs(got - want).max(-1) / np.linalg.norm(want, axis=-1)
    assert err.max() < 1e-5, err.max()
    assert got[0, 0] == 0.0 and got[0, 2] == 1.0


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_project_jacobian_equals_jax_autodiff(rng, kind):
    if kind == "kb8":
        jcam, tcam = cams()
    else:
        jcam = jax_make_pinhole(*P1[:4], W, H)
        tcam = make_pinhole(*P1[:4], W, H, device="cpu")
    X = rng.normal(size=(300, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) + 0.2
    X[:5, :2] = 0.0                                   # on the axis
    X[5:10, :2] = 5e-9                                # r^2 = 5e-17: between the clamps
    X[10:15, :2] = 1e-7                               # just off them
    X[15:20, 2] = -np.abs(X[15:20, 2])                # behind the camera
    X[20:25, 2] = 1e-10                               # the pinhole's depth clamp
    want = np.asarray(jmodels.project_jacobian(jcam, J(X)))
    got = tmodels.project_jacobian(tcam, T(X)).numpy()
    rel_close(got, want, 1e-4)
    assert np.isfinite(got).all()
    if kind == "kb8":   # the on-axis branch: scale 1
        np.testing.assert_allclose(got[:5, 0], [[P1[0], 0, 0]] * 5, rtol=1e-6)
    unc = tmodels.uncertainty2(tcam, T(X[:, :2]))
    np.testing.assert_array_equal(unc.numpy(), np.asarray(jmodels.uncertainty2(jcam, J(X[:, :2]))))


def test_projection_jacobian_stereo_row_on_a_fisheye(rng):
    _, tcam = cams()
    Xc = T(points_in_view(rng, 64).astype(np.float32))
    stereo = torch.from_numpy(rng.random(64) < 0.5)
    dP = ba_core.projection_jacobian(tcam, torch.tensor(BF), Xc, stereo)
    uv_rows = tmodels.project_jacobian(tcam, Xc)
    np.testing.assert_array_equal(dP[:, :2].numpy(), uv_rows.numpy())
    assert (dP[~stereo, 2] == 0).all()
    want = uv_rows[stereo, 0].clone()
    want[:, 2] += BF / Xc[stereo, 2] ** 2
    np.testing.assert_allclose(dP[stereo, 2].numpy(), want.numpy(), rtol=1e-6)


# ------------------------------------------------------------- triangulation
def rig_pair():
    jl, tl = cams(P1)
    jr, tr = cams(P2)
    T_c2_c1 = np.linalg.inv(RIG.T_c1_c2)
    jrig = jstereo.StereoRig(jl, jr, JaxSE3(J(T_c2_c1[:3, :3].astype(np.float32)),
                                            J(T_c2_c1[:3, 3].astype(np.float32))),
                             jnp.float32(BF))
    return jrig, stereo_rig_from_numpy(tl, tr, RIG.T_c1_c2, BF, device="cpu")


def test_stereo_rig_from_the_extrinsic_equals_the_jax_system_s():
    jrig, trig = rig_pair()
    np.testing.assert_array_equal(trig.T_rl.R.numpy(), np.asarray(jrig.T_rl.R))
    np.testing.assert_array_equal(trig.T_rl.t.numpy(), np.asarray(jrig.T_rl.t))
    assert float(trig.baseline) == pytest.approx(0.2, abs=1e-6)
    assert trig.to("cpu").left.params.device.type == "cpu"


def test_triangulate_matches_equals_jax(rng):
    jrig, trig = rig_pair()
    n = 400
    X1 = points_in_view(rng, n)
    X1[:40] *= 8.0                                    # far: fails the parallax gate
    T_c2_c1 = np.linalg.inv(RIG.T_c1_c2)
    X2 = X1 @ T_c2_c1[:3, :3].T + T_c2_c1[:3, 3]
    uv1 = project_np(host_camera(trig.left), X1) + rng.normal(0, 0.3, (n, 2))
    uv2 = project_np(host_camera(trig.right), X2) + rng.normal(0, 0.3, (n, 2))
    uv2[40:80] = uv2[rng.permutation(np.arange(40, 80))]   # mismatches
    s1 = 1.2 ** (2 * rng.integers(0, 4, n))
    s2 = 1.2 ** (2 * rng.integers(0, 4, n))
    args = [a.astype(np.float32) for a in (uv1, uv2, s1, s2)]
    zj, Xj, okj = jstereo.triangulate_matches(jrig, *(J(a) for a in args))
    zt, Xt, okt = triangulate_matches(trig, *(T(a) for a in args))
    ok = okt.numpy()
    np.testing.assert_array_equal(ok, np.asarray(okj))
    assert 200 < ok.sum() < 340 and not ok[:40].any()
    zj, zt = np.asarray(zj)[ok], zt.numpy()[ok]
    np.testing.assert_allclose(zt, zj, rtol=1e-4)
    # and, without the noise, the truth where the pair is right
    clean = [T(a.astype(np.float32)) for a in (
        project_np(host_camera(trig.left), X1), project_np(host_camera(trig.right), X2), s1, s2)]
    z_clean, _, ok_clean = triangulate_matches(trig, *clean)
    keep = ok_clean.numpy().copy()
    keep[40:80] = False
    assert keep.sum() > 250
    np.testing.assert_allclose(z_clean.numpy()[keep], X1[keep, 2], rtol=1e-3)


# ------------------------------------------------------------- the frame
JCFG = JaxOrbConfig(height=H, width=W, n_features=512, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())


def frame_dict(fd):
    k = fd.kps
    return {"x": np.asarray(k.x), "y": np.asarray(k.y), "level": np.asarray(k.level),
            "valid": np.asarray(k.valid), "desc_packed": np.asarray(k.desc_packed),
            "depth": np.asarray(fd.depth), "u_right": np.asarray(fd.u_right)}


def test_process_fisheye_frame_stacked_equals_jax():
    seq = synthetic.generate_sequence(n_frames=1, h=H, w=W, seed=5, rig=RIG, plane_z=3.0)
    f = seq.frames[0]
    stacked = np.stack([f.left, f.right]).astype(np.uint8)
    jrig, trig = rig_pair()
    a = frame_dict(jfp.process_fisheye_frame_stacked(J(stacked), JCFG, jrig))
    b = frame_dict(process_fisheye_frame_stacked(torch.from_numpy(stacked), CFG, trig))
    assert parity.keypoint_overlap(a, b) >= 0.97
    assert (b["u_right"] == -1).all() and (a["u_right"] == -1).all()
    ia, ib = parity.codetected(a, b)
    da, db = a["depth"][ia] > 0, b["depth"][ib] > 0
    assert (da | db).sum() > 100 and (da & db).sum() >= 0.95 * max(da.sum(), db.sum())
    both = da & db
    rel = np.abs(b["depth"][ib][both] - a["depth"][ia][both]) / a["depth"][ia][both]
    assert np.median(rel) < 1e-3 and np.percentile(rel, 90) < 1e-3, np.percentile(rel, [50, 90])


# ------------------------------------------------------------- the optimizers
def test_pose_optimize_on_kb8_equals_jax(rng):
    jcam, tcam = cams()
    n = 256
    X = points_in_view(rng, n).astype(np.float32)
    T_true = se3_exp(J(np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01], np.float32)))
    Xc = np.asarray(T_true.R) @ X.T
    Xc = Xc.T + np.asarray(T_true.t)
    uv = project_np(host_camera(tcam), Xc) + rng.normal(0, 0.5, (n, 2))
    uv[rng.choice(n, 40, replace=False)] += rng.uniform(15, 40, (40, 2))
    uv = uv.astype(np.float32)
    ur = np.full(n, -1.0, np.float32)                 # fisheye edges are mono
    T0 = se3_compose(se3_exp(J(np.array([0.05, 0.05, -0.05, 0.01, 0.02, -0.01], np.float32))),
                     T_true)
    inv_sigma2 = rng.choice(np.asarray([1.0, 1 / 1.44, 1 / 2.0736], np.float32), n)
    valid = np.ones(n, bool)
    valid[:3] = False
    want = jax_pose_optimize(jcam, jnp.float32(BF), T0, *(J(a) for a in (X, uv, ur, inv_sigma2, valid)))
    got = pose_optimize(tcam, torch.tensor(BF),
                        convert.se3_from_numpy(np.asarray(T0.R), np.asarray(T0.t), device="cpu"),
                        *(T(a) for a in (X, uv, ur, inv_sigma2, valid)))
    np.testing.assert_allclose(got.pose.R.numpy(), np.asarray(want.pose.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(T_true.t), atol=0.01)


def kb8_window(rng, L=128, K=6):
    """tests/test_torch_ba.py's window seen through the KB8 camera, every
    edge mono (u_right -1), two cameras fixed, 8 padding rows."""
    tcam = cams()[1]
    hc = host_camera(tcam)
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(2, 5, L)], 1)
    R = np.stack([Rotation.from_rotvec(rng.normal(0, 0.03, 3)).as_matrix() for _ in range(K)])
    t = np.stack([[0.25 * j - 0.6, 0.05 * rng.normal(), 0.05 * rng.normal()] for j in range(K)])
    Xc = np.einsum("kij,lj->lki", R, pts) + t[None]
    uv = project_np(hc, Xc)
    obs_uv = uv + rng.normal(0, 0.5, (L, K, 2))
    mask = (uv[..., 0] > 0) & (uv[..., 0] < W) & (uv[..., 1] > 0) & (uv[..., 1] < H) \
        & (rng.random((L, K)) < 0.85)
    mask[-8:] = False
    out = rng.choice(np.flatnonzero(mask.ravel()), 6, replace=False)
    obs_uv.reshape(-1, 2)[out] += 25.0
    inv_sigma2 = 1.0 / 1.2 ** (2 * rng.integers(0, 4, (L, K)))
    point_free = np.ones(L, bool)
    point_free[-8:] = False
    pts_init = pts + rng.normal(0, 0.03, (L, 3))
    pts_init[-8:] = 0.0
    cam_free = np.ones(K, bool)
    cam_free[-2:] = False
    R_init, t_init = R.copy(), t.copy()
    for j in range(K - 2):
        R_init[j] = Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix() @ R[j]
        t_init[j] = t[j] + rng.normal(0, 0.01, 3)
    return {"R": R_init.astype(np.float32), "t": t_init.astype(np.float32),
            "points": pts_init.astype(np.float32), "obs_uv": obs_uv.astype(np.float32),
            "obs_ur": np.full((L, K), -1.0, np.float32), "inv_sigma2": inv_sigma2.astype(np.float32),
            "mask": mask, "cam_free": cam_free, "point_free": point_free}


def test_local_ba_on_a_kb8_window_equals_jax():
    a = kb8_window(np.random.default_rng(7))
    jcam, tcam = cams()
    want = jba.local_bundle_adjustment(
        jba.BAProblem(JaxSE3(J(a["R"]), J(a["t"])), J(a["points"]), J(a["obs_uv"]),
                      J(a["obs_ur"]), J(a["inv_sigma2"]), J(a["mask"]), J(a["cam_free"]),
                      J(a["point_free"])), jcam, jnp.float32(BF))
    got = local_ba.local_bundle_adjustment(convert.ba_problem_from_numpy(a, device="cpu"), tcam,
                                           torch.tensor(BF))
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R), atol=1e-3)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=1e-3)
    free = a["point_free"] & a["mask"].any(1)
    np.testing.assert_allclose(got.points.numpy()[free], np.asarray(want.points)[free], atol=1e-3)
    assert np.abs(got.poses.t.numpy()[:4] - a["t"][:4]).max() > 1e-3


def test_pose_inertial_optimize_through_a_kb8_camera_equals_jax():
    """tests/test_torch_inertial.py's interval and tilted extrinsic, the
    points seen through the KB8 camera (every edge mono)."""
    from tests.test_torch_inertial import (
        G, JCALIB, R_BC, T_BC, assert_H_close, assert_state_close, jstate, tstate)

    rng = np.random.default_rng(7)
    n, dt = 40, 0.005
    a_w, v0 = np.array([0.3, -0.2, 0.1]), np.array([0.1, 0.0, 0.05])
    R_wb = Rotation.from_rotvec([0.2, -0.1, 0.3]).as_matrix()
    acc = np.tile(R_wb.T @ (a_w - G), (n, 1)).astype(np.float32)
    jp = jpre.preintegrate(J(acc), J(np.zeros((n, 3), np.float32)), J(np.full(n, dt, np.float32)),
                           JCALIB)
    tt = n * dt
    p2, v2 = v0 * tt + 0.5 * a_w * tt * tt, v0 + a_w * tt
    truth = (R_wb, p2, v2, np.zeros(3), np.zeros(3))
    R_cw, t_cw = (np.asarray(x, np.float64)
                  for x in jin.body_to_cam(jstate(truth), J(R_BC), J(T_BC)))
    jcam, tcam = cams()
    N = 256
    Xc = points_in_view(rng, N)
    Xw = ((Xc - t_cw) @ R_cw).astype(np.float32)
    uv = (project_np(host_camera(tcam), Xc) + rng.normal(0, 0.3, (N, 2))).astype(np.float32)
    obs = (Xw, uv, np.full(N, -1.0, np.float32), np.ones(N, np.float32), np.ones(N, bool))
    prev = (R_wb, np.zeros(3), v0, np.zeros(3), np.zeros(3))
    s0 = (R_wb @ Rotation.from_rotvec([0.01, 0.02, -0.01]).as_matrix(),
          p2 + [0.05, -0.04, 0.08], v2 + 0.1, np.zeros(3), np.zeros(3))
    want = jin.pose_inertial_optimize(jcam, jnp.float32(BF), J(R_BC), J(T_BC), jstate(prev), jp,
                                      jstate(s0), *(J(o) for o in obs))
    got = tin.pose_inertial_optimize(tcam, torch.tensor(BF), T(R_BC), T(T_BC), tstate(prev),
                                     convert.preintegrated_from_numpy(jp, device="cpu"),
                                     tstate(s0), *(T(o) for o in obs))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 200
    assert_state_close(got.state, want.state)
    assert_H_close(got.H, want.H, 1e-3)
    assert np.linalg.norm(got.state.p_w.numpy() - p2) < 0.01


# ------------------------------------------------------------- the System
E2E_W, E2E_H, E2E_FX, E2E_BASELINE = 384, 288, 160.0, 0.22
E2E_KB8 = (E2E_FX, E2E_FX, E2E_W / 2, E2E_H / 2, 0.02, -0.01, 0.003, -0.001, E2E_W, E2E_H)


@pytest.fixture(scope="module")
def e2e_frames():
    """tests/test_fisheye_e2e.py's sequence, rendered by the port."""
    rng = np.random.default_rng(3)
    tex = make_texture(rng, size=1024)
    cam = host_camera(make_kannala_brandt8(*E2E_KB8, device="cpu"))
    frames = []
    for i in range(18):
        ang = 0.02 * np.sin(0.5 * i)
        ca, sa = np.cos(ang), np.sin(ang)
        R_wc = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        t_wc = np.array([0.045 * i, 0.01 * np.sin(i), 0.0])
        left = _render(tex, 160.0, None, R_wc, t_wc, E2E_H, E2E_W, plane_z=3.5, camera=cam)
        right = _render(tex, 160.0, None, R_wc, t_wc + R_wc @ np.array([E2E_BASELINE, 0, 0]), E2E_H, E2E_W,
                        plane_z=3.5, camera=cam)
        frames.append((i / 10.0, left.astype(np.uint8), right.astype(np.uint8), t_wc))
    return frames


def e2e_settings(pkg):
    T = np.eye(4)
    T[:3, 3] = [E2E_BASELINE, 0, 0]
    kw = dict(camera_type="KannalaBrandt8", width=E2E_W, height=E2E_H, T_c1_c2=T, bf=E2E_BASELINE * E2E_FX,
              baseline=E2E_BASELINE, n_features=1024, n_levels=4, th_depth=40.0)
    if pkg == "jax":
        return JaxSettings(camera1=jax_make_kb8(*E2E_KB8), camera2=jax_make_kb8(*E2E_KB8), **kw)
    return Settings(camera1=make_kannala_brandt8(*E2E_KB8, device="cpu"),
                    camera2=make_kannala_brandt8(*E2E_KB8, device="cpu"), **kw)


def test_the_fisheye_scene_through_both_systems(e2e_frames, monkeypatch):
    monkeypatch.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    jsys = JaxSystem(e2e_settings("jax"), JaxSensor.STEREO, vocabulary=False)
    tsys = System(e2e_settings("torch"), Sensor.STEREO, vocabulary=False, device="cpu")
    assert tsys.tracker.stereo_rig is not None and tsys._rect is None
    with one_torch_thread():
        for i, (t, left, right, t_wc) in enumerate(e2e_frames):
            jsys.track_stereo(left, right, t)
            tsys.track_stereo(left, right, t)
            assert tsys.tracking_state.name == jsys.tracking_state.name == "OK", i
            jf, tf = jsys.tracker.last_frame, tsys.tracker.last_frame
            np.testing.assert_allclose(tf.R_cw, jf.R_cw, atol=1e-3, err_msg=f"frame {i}")
            np.testing.assert_allclose(tf.t_cw, jf.t_cw, atol=1e-3, err_msg=f"frame {i}")
            if i == 0:
                d = tf.depth[tf.depth > 0]
                assert len(d) > 80 and 1.5 < np.median(d) < 4.5
                assert (tf.u_right == -1).all()
    kf_j = {k: kf.frame_id for k, kf in jsys.atlas.current.keyframes.items()}
    kf_t = {k: kf.frame_id for k, kf in tsys.atlas.current.keyframes.items()}
    assert kf_t == kf_j
    # the fused frames ran after the first two
    assert len(tsys.stats.series["orb_extraction"]) < len(e2e_frames) - 5
    jsys.shutdown()
    tsys.shutdown()
