"""The port's visual-inertial optimizers and inertial fused step against the
JAX package, on the CPU.

Every case runs with a body <- camera extrinsic of ~45 degrees about a
tilted axis and a few centimetres of offset, like a real camera-IMU rig:
the rendered sequences have T_b_c1 = I, where a transposed R_bc or a sign
error in t_bc would pass. Tolerances and why:

- `inertial_residual`, `body_to_cam`, `cam_to_body`: 1e-5 (f32 rounding);
- the closed-form Jacobians against torch.func.jacfwd of the port's own
  residuals, in float64: 1e-6 relative (the JAX package differentiates with
  jax.jacfwd; the closed form is the derivative of the same functions up
  to so3_log's small-angle series);
- `pose_inertial_optimize` (with and without the ConstraintPoseImu prior),
  `pose_inertial_optimize_lastframe` and their `_packed` variants: inlier
  masks equal, R and p within 2e-4, v within 5e-4, biases within 1e-5 (40
  f32 LM steps, closed form against forward-mode Jacobians, whitening in
  float64 against the JAX package's float32: ROADMAP F9), H within 1e-3
  relative; the LastFrame solve's velocity, not converged in 40 steps on
  its case, within 2e-2, and within 5e-4 at 80 steps;
- `local_inertial_ba` on a 13-state window (4 fixed anchors, the gauge,
  8 free; 96 points, a third mono) and a 9-state one (the full-BA sweep's
  shape): inlier masks equal, states within 2e-4 (v 5e-4), points within
  5e-4 m, in float32 as the JAX package and in float64;
- `tlm_step_vi` with `pack_fused_vi_for_host` / `unpack_fused_vi`: matches,
  frustum and inliers equal, the state within 1e-3, H within 1e-2
  relative; the pack an exact round trip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu import fused_track as jft
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.geometry import SE3 as JaxSE3
from fasttrack_tpu.imu import preintegration as jpre
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.optim import inertial as jin
from fasttrack_tpu_torch import convert, fused_track, parity
from fasttrack_tpu_torch.cameras import host_camera, make_pinhole
from fasttrack_tpu_torch.frame_pipeline import FrameData
from fasttrack_tpu_torch.geometry.so3 import so3_exp
from fasttrack_tpu_torch.imu import preintegration as tpre
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.optim import inertial as tin

G = np.array([0.0, 0.0, -9.81])
R_BC = Rotation.from_rotvec([0.4, -0.6, 0.3]).as_matrix().astype(np.float32)
T_BC = np.array([0.05, -0.03, 0.02], np.float32)
FX, FY, CX, CY, BF = 400.0, 400.0, 320.0, 240.0, 40.0
JCALIB = jpre.ImuCalib.default(freq=200.0)
TCALIB = tpre.ImuCalib.default(freq=200.0, device="cpu")


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def jstate(s):
    return jin.BodyState(*(jnp.asarray(np.asarray(x, np.float32)) for x in s))


def tstate(s, dtype=np.float32):
    return convert.body_state_from_numpy(*s, device="cpu", dtype=dtype)


def assert_state_close(got, want, rp=2e-4, v=5e-4, b=1e-5):
    for name, tol in (("R_wb", rp), ("p_w", rp), ("v_w", v), ("bg", b), ("ba", b)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=tol, err_msg=name)


def assert_H_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert err < rtol, err


# ---------------------------------------------------------------- helpers
def test_residual_and_extrinsic_helpers_equal_jax(rng):
    for _ in range(5):
        s1 = (Rotation.from_rotvec(rng.normal(0, 0.8, 3)).as_matrix(), rng.normal(0, 1, 3),
              rng.normal(0, 1, 3), rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3))
        s2 = (Rotation.from_rotvec(rng.normal(0, 0.8, 3)).as_matrix(), rng.normal(0, 1, 3),
              rng.normal(0, 1, 3), rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3))
        acc = (rng.normal(0, 1, (20, 3)) + [0, 0, 9.81]).astype(np.float32)
        gyro = rng.normal(0, 0.3, (20, 3)).astype(np.float32)
        dts = np.full(20, 0.005, np.float32)
        jp = jpre.preintegrate(J(acc), J(gyro), J(dts), JCALIB)
        tp = tpre.preintegrate(T(acc), T(gyro), T(dts), TCALIB)
        for bias in (1, 2):
            want = jin.inertial_residual(jp, jstate(s1), jstate(s2), jstate(s1 if bias == 1 else s2))
            got = tin.inertial_residual(tp, tstate(s1), tstate(s2), tstate(s1 if bias == 1 else s2))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
        R_cw, t_cw = tin.body_to_cam(tstate(s1), T(R_BC), T(T_BC))
        jR, jt = jin.body_to_cam(jstate(s1), J(R_BC), J(T_BC))
        np.testing.assert_allclose(R_cw.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(t_cw.numpy(), np.asarray(jt), atol=1e-5)
        R_wb, p_w = tin.cam_to_body(R_cw, t_cw, T(R_BC), T(T_BC))
        np.testing.assert_allclose(R_wb.numpy(), s1[0], atol=1e-5)
        np.testing.assert_allclose(p_w.numpy(), s1[1], atol=1e-5)
        jRwb, jpw = jin.cam_to_body(jR, jt, J(R_BC), J(T_BC))
        np.testing.assert_allclose(p_w.numpy(), np.asarray(jpw), atol=1e-5)


def _f64_state(rng, scale=1.0):
    return tin.BodyState(so3_exp(torch.tensor(rng.normal(0, 0.5, 3))),
                         torch.tensor(rng.normal(0, scale, 3)), torch.tensor(rng.normal(0, 1, 3)),
                         torch.tensor(rng.normal(0, 0.02, 3)), torch.tensor(rng.normal(0, 0.1, 3)))


def test_closed_form_jacobians_equal_autodiff(rng):
    acc = rng.normal(0, 1, (30, 3)) + [0, 0, 9.81]
    gyro = rng.normal(0, 0.3, (30, 3))
    b0 = tpre.ImuBias(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64),
                      torch.tensor([0.1, 0.0, -0.05], dtype=torch.float64))
    pre = tpre.preintegrate(T(acc), T(gyro), torch.full((30,), 0.005, dtype=torch.float64),
                            TCALIB, b0)
    W9, Wbg, Wba = tin._split_whiten(T(tin.whitening_np(pre.C.numpy())))
    s1, s2 = _f64_state(rng), _f64_state(rng)
    z = torch.zeros(15, dtype=torch.float64)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for bias_on in (1, 2):
        _, J1, J2 = tin._edge(pre, W9, Wbg, Wba, s1, s2, bias_on)
        A1 = torch.func.jacfwd(lambda d: tin._edge(
            pre, W9, Wbg, Wba, tin.retract(s1, d), s2, bias_on, jacobians=False))(z)
        A2 = torch.func.jacfwd(lambda d: tin._edge(
            pre, W9, Wbg, Wba, s1, tin.retract(s2, d), bias_on, jacobians=False))(z)
        assert rel(J1, A1) < 1e-6 and rel(J2, A2) < 1e-6
    # carried to the LastFrame solve's additive coordinates
    dx = torch.tensor(rng.normal(0, 0.1, 15))
    sp = tin.retract(s1, dx)
    _, J1, _ = tin._edge(pre, W9, Wbg, Wba, sp, s2, 1)
    A = torch.func.jacfwd(lambda d: tin._edge(
        pre, W9, Wbg, Wba, tin.retract(s1, dx + d), s2, 1, jacobians=False))(z)
    assert rel(tin._to_global(J1, dx[0:3], sp.R_wb, s1.R_wb), A) < 1e-6
    # the visual rows
    cam = make_pinhole(FX, FY, CX, CY, 640, 480, device="cpu")
    R_bc, t_bc = T(R_BC).double(), T(T_BC).double()
    s = tin.BodyState(*(x * 0.1 if i == 1 else x for i, x in enumerate(_f64_state(rng))))
    R_cw, t_cw = tin.body_to_cam(s, R_bc, t_bc)
    Xw = (torch.tensor(rng.uniform([-2, -1, 3], [2, 1, 8], (40, 3))) - t_cw) @ R_cw
    uv = torch.tensor(rng.normal(320, 20, (40, 2)))
    ur = torch.where(torch.arange(40) % 3 == 0, -1.0, uv[:, 0] - 10)
    vis = tin._Visual(cam, torch.tensor(BF), R_bc, t_bc, Xw, uv, ur)
    Jv = vis.jacobian6(s, vis.residual(s)[1])
    A = torch.func.jacfwd(lambda d: vis.residual(tin.retract(s, d))[0])(z)
    assert rel(Jv, A[..., :6]) < 1e-9 and float(A[..., 6:].abs().max()) == 0.0


# ------------------------------------------------------------- pose optimizers
@pytest.fixture(scope="module")
def pose_problem():
    """tests/test_inertial.py's constant-acceleration interval (40 samples
    at 200 Hz), the body rotated and seen through the tilted extrinsic: 256
    points observed from the true current state with 0.3 px noise, a
    quarter of them mono; the start state 5-8 cm and 0.1 m/s off."""
    rng = np.random.default_rng(7)
    n, dt = 40, 0.005
    a_w, v0 = np.array([0.3, -0.2, 0.1]), np.array([0.1, 0.0, 0.05])
    R_wb = Rotation.from_rotvec([0.2, -0.1, 0.3]).as_matrix()
    acc = np.tile(R_wb.T @ (a_w - G), (n, 1)).astype(np.float32)
    gyro = np.zeros((n, 3), np.float32)
    dts = np.full(n, dt, np.float32)
    tt = n * dt
    p2, v2 = v0 * tt + 0.5 * a_w * tt * tt, v0 + a_w * tt
    jp = jpre.preintegrate(J(acc), J(gyro), J(dts), JCALIB)
    host = tpre.HostPreintegrated()
    host.integrate(acc, gyro, dts, TCALIB)
    truth = (R_wb, p2, v2, np.zeros(3), np.zeros(3))
    R_cw, t_cw = (np.asarray(x, np.float64) for x in jin.body_to_cam(jstate(truth), J(R_BC), J(T_BC)))
    N = 256
    Xc = rng.uniform([-3, -2, 4], [3, 2, 10], (N, 3))
    Xw = ((Xc - t_cw) @ R_cw).astype(np.float32)
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    ur = uv[:, 0] - BF / Xc[:, 2]
    ur[::4] = -1.0
    obs = (Xw, uv.astype(np.float32), ur.astype(np.float32), np.ones(N, np.float32),
           np.ones(N, bool))
    prev = (R_wb, np.zeros(3), v0, np.zeros(3), np.zeros(3))
    s0 = (R_wb @ Rotation.from_rotvec([0.01, 0.02, -0.01]).as_matrix(),
          p2 + [0.05, -0.04, 0.08], v2 + 0.1, np.zeros(3), np.zeros(3))
    prior_H = np.diag([1e4] * 3 + [1e2] * 3 + [1e2] * 3 + [1e6] * 6).astype(np.float32)
    return dict(jp=jp, host=host, truth=truth, obs=obs, prev=prev, s0=s0, prior_H=prior_H,
                jcam=jax_make_pinhole(FX, FY, CX, CY, 640, 480),
                tcam=make_pinhole(FX, FY, CX, CY, 640, 480, device="cpu"))


def _pose_args(pp, pkg):
    if pkg == "jax":
        return (pp["jcam"], jnp.float32(BF), J(R_BC), J(T_BC)), tuple(J(a) for a in pp["obs"])
    return (pp["tcam"], torch.tensor(BF), T(R_BC), T(T_BC)), tuple(T(a) for a in pp["obs"])


@pytest.mark.parametrize("with_prior", [False, True], ids=["anchored", "with-prior"])
def test_pose_inertial_optimize_equals_jax(pose_problem, with_prior):
    pp = pose_problem
    jhead, jobs = _pose_args(pp, "jax")
    thead, tobs = _pose_args(pp, "torch")
    kw_j = dict(prior_H=J(pp["prior_H"])) if with_prior else {}
    kw_t = dict(prior_H=T(pp["prior_H"])) if with_prior else {}
    want = jin.pose_inertial_optimize(*jhead, jstate(pp["prev"]), pp["jp"], jstate(pp["s0"]),
                                      *jobs, **kw_j)
    got = tin.pose_inertial_optimize(*thead, tstate(pp["prev"]),
                                     convert.preintegrated_from_numpy(pp["jp"], device="cpu"),
                                     tstate(pp["s0"]), *tobs, **kw_t)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 200
    assert_state_close(got.state, want.state)
    assert_H_close(got.H, want.H, 1e-3)
    # and it found the truth: the visual edges pin the pose
    assert np.linalg.norm(got.state.p_w.numpy() - pp["truth"][1]) < 0.01


def test_pose_inertial_optimize_lastframe_equals_jax(pose_problem):
    """The anchor carries a position error; the soft prior lets it relax
    (tests/test_inertial.py::test_soft_prior_beats_fixed_anchor)."""
    pp = pose_problem
    prev = (pp["prev"][0], pp["prev"][1] + [0.05, -0.04, 0.03], *pp["prev"][2:])
    jhead, jobs = _pose_args(pp, "jax")
    thead, tobs = _pose_args(pp, "torch")
    pre = convert.preintegrated_from_numpy(pp["jp"], device="cpu")
    want = jin.pose_inertial_optimize_lastframe(*jhead, jstate(prev), J(pp["prior_H"]), pp["jp"],
                                                jstate(pp["s0"]), *jobs)
    got = tin.pose_inertial_optimize_lastframe(
        *thead, tstate(prev), T(pp["prior_H"]), pre, tstate(pp["s0"]), *tobs)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    # In 4 x 10 steps the velocity has not converged on this problem (the
    # soft prior couples it to the anchor's, along a flat direction): both
    # are still moving, 1.4e-2 m/s apart. With 20 steps a round both reach
    # one point, within 5e-4.
    assert_state_close(got.state, want.state, v=2e-2)
    assert_H_close(got.H, want.H, 1e-3)
    want20 = jin.pose_inertial_optimize_lastframe(*jhead, jstate(prev), J(pp["prior_H"]),
                                                  pp["jp"], jstate(pp["s0"]), *jobs, iters=20)
    got20 = tin.pose_inertial_optimize_lastframe(
        *thead, tstate(prev), T(pp["prior_H"]), pre, tstate(pp["s0"]), *tobs, iters=20)
    assert_state_close(got20.state, want20.state)
    assert_H_close(got20.H, want20.H, 1e-3)
    assert got.H.shape == (15, 15) and np.linalg.eigvalsh(got.H.double().numpy()).min() > -1e-3
    fixed = tin.pose_inertial_optimize(*thead, tstate(prev), convert.preintegrated_from_numpy(
        pp["jp"], device="cpu"), tstate(pp["s0"]), *tobs)
    e_fixed = np.linalg.norm(fixed.state.p_w.numpy() - pp["truth"][1])
    e_soft = np.linalg.norm(got.state.p_w.numpy() - pp["truth"][1])
    assert e_fixed > 0.04 and e_soft < 0.2 * e_fixed, (e_soft, e_fixed)


def test_packed_variants_take_the_host_preintegration(pose_problem):
    """The tracker's calls: the host accumulation as one packed buffer,
    its whitening (from the float64 covariance) and the prior's square root
    passed in, against the plain calls that whiten the float32 copy: 1e-5
    (v 1e-4, along the LastFrame solve's slow direction; biases 1e-6)."""
    pp = pose_problem
    thead, tobs = _pose_args(pp, "torch")
    buf = T(tpre.pack_preintegrated(pp["host"]))
    W = T(tin.whitening_np(pp["host"].C).astype(np.float32))
    pre = convert.preintegrated_from_numpy(pp["host"], device="cpu")
    got = tin.pose_inertial_optimize_packed(*thead, tstate(pp["prev"]), buf, tstate(pp["s0"]),
                                            *tobs, whiten=W)
    want = tin.pose_inertial_optimize(*thead, tstate(pp["prev"]), pre, tstate(pp["s0"]), *tobs)
    assert_state_close(got.state, want.state, rp=1e-5, v=1e-4, b=1e-6)
    W_prior = T(tin.sqrtm_psd_np(pp["prior_H"]).astype(np.float32))
    got = tin.pose_inertial_optimize_lastframe_packed(
        *thead, tstate(pp["prev"]), T(pp["prior_H"]), buf, tstate(pp["s0"]), *tobs,
        whiten=W, W_prior=W_prior)
    want = tin.pose_inertial_optimize_lastframe(
        *thead, tstate(pp["prev"]), T(pp["prior_H"]), pre, tstate(pp["s0"]), *tobs)
    assert_state_close(got.state, want.state, rp=1e-5, v=1e-4, b=1e-6)
    jwant = jin.pose_inertial_optimize_lastframe_packed(
        *_pose_args(pp, "jax")[0], jstate(pp["prev"]), J(pp["prior_H"]),
        J(tpre.pack_preintegrated(pp["host"])), jstate(pp["s0"]), *_pose_args(pp, "jax")[1])
    assert_state_close(got.state, jwant.state)


def test_without_vision_the_state_stays_at_the_imu_prediction(pose_problem):
    pp = pose_problem
    thead, _ = _pose_args(pp, "torch")
    truth = pp["truth"]
    N = 16
    res = tin.pose_inertial_optimize(
        *thead, tstate(pp["prev"]), convert.preintegrated_from_numpy(pp["jp"], device="cpu"),
        tstate(truth), torch.zeros((N, 3)), torch.zeros((N, 2)), torch.full((N,), -1.0),
        torch.ones(N), torch.zeros(N, dtype=torch.bool))
    assert np.linalg.norm(res.state.p_w.numpy() - truth[1]) < 5e-3
    assert int(res.n_inliers) == 0


# ------------------------------------------------------------ local inertial BA
def _window(K, n_anchors, L=96, seed=3):
    """A smooth trajectory (constant body rate, sinusoidal position),
    keyframes 0.25 s apart with 50 IMU samples between each pair, L points
    in front of the middle keyframe seen by each keyframe with 0.5 px noise
    (60% stereo); the free states start 1-2 cm, 0.01 rad and 0.05 m/s off
    and the points 3 cm off. The first n_anchors + 1 states are fixed and
    the first n_anchors edges masked, as the mapper pads its windows."""
    rng = np.random.default_rng(seed)
    w_b = np.array([0.1, -0.2, 0.15])

    def pose(t):
        return (Rotation.from_rotvec(w_b * t).as_matrix(),
                np.array([0.5 * np.sin(t), 0.3 * t, 0.1 * np.cos(t)]))

    vel = lambda t: np.array([0.5 * np.cos(t), 0.3, -0.1 * np.sin(t)])
    accw = lambda t: np.array([-0.5 * np.sin(t), 0.0, -0.1 * np.cos(t)])
    ts = np.arange(K) * 0.25
    pres = []
    for k in range(K - 1):
        tt = ts[k] + 0.005 * (np.arange(50) + 0.5)
        acc = np.stack([pose(t)[0].T @ (accw(t) - G) for t in tt]).astype(np.float32)
        gyro = np.tile(w_b, (50, 1)).astype(np.float32)
        pres.append(jpre.preintegrate(J(acc), J(gyro), jnp.full(50, 0.005, jnp.float32), JCALIB))
    pre = jpre.Preintegrated(*(jnp.stack(x) for x in zip(*[p[:10] for p in pres])),
                             jpre.ImuBias(jnp.stack([p.b0.bg for p in pres]),
                                          jnp.stack([p.b0.ba for p in pres])),
                             jnp.stack([p.avgA for p in pres]), jnp.stack([p.avgW for p in pres]))
    Rs = np.stack([pose(t)[0] for t in ts])
    ps = np.stack([pose(t)[1] for t in ts])
    vs = np.stack([vel(t) for t in ts])
    R_cb, t_cb = R_BC.T, -R_BC.T @ T_BC
    Rcw = np.einsum("ij,kjl->kil", R_cb, Rs.transpose(0, 2, 1))
    tcw = t_cb[None] - np.einsum("kij,kj->ki", Rcw, ps)
    km = K // 2
    pts = (rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (L, 3)) - tcw[km]) @ Rcw[km]
    obs_uv = np.zeros((L, K, 2))
    obs_ur = np.full((L, K), -1.0)
    mask = np.zeros((L, K), bool)
    for k in range(K):
        Xc = pts @ Rcw[k].T + tcw[k]
        u, v = FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY
        mask[:, k] = (Xc[:, 2] > 0.5) & (u > 0) & (u < 640) & (v > 0) & (v < 480) \
            & (rng.random(L) < 0.7)
        obs_uv[:, k] = np.stack([u, v], -1) + rng.normal(0, 0.5, (L, 2))
        obs_ur[:, k] = np.where(rng.random(L) < 0.6, obs_uv[:, k, 0] - BF / Xc[:, 2], -1.0)
    free = np.ones(K, bool)
    free[:n_anchors + 1] = False
    pre_valid = np.ones(K - 1, bool)
    pre_valid[:n_anchors] = False
    noisy = lambda a, s: np.where(free[:, None], a + rng.normal(0, s, a.shape), a)
    dR = Rotation.from_rotvec(rng.normal(0, 0.01, (K, 3))).as_matrix()
    f32 = np.float32
    return dict(
        R_wb=np.where(free[:, None, None], Rs @ dR, Rs).astype(f32), p_w=noisy(ps, 0.02).astype(f32),
        v_w=noisy(vs, 0.05).astype(f32), bg=np.zeros((K, 3), f32), ba=np.zeros((K, 3), f32),
        state_free=free, pre=pre, pre_valid=pre_valid,
        points=(pts + rng.normal(0, 0.03, pts.shape)).astype(f32), point_free=np.ones(L, bool),
        obs_uv=obs_uv.astype(f32), obs_ur=obs_ur.astype(f32),
        inv_sigma2=np.ones((L, K), f32), mask=mask, truth=ps,
    )


@pytest.mark.parametrize("K, n_anchors", [(13, 4), (9, 0)], ids=["local-13", "full-sweep-9"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_local_inertial_ba_equals_jax(K, n_anchors, dtype):
    w = _window(K, n_anchors)
    prob_j = jin.InertialBAProblem(
        jin.BodyState(*(J(w[k]) for k in ("R_wb", "p_w", "v_w", "bg", "ba"))),
        J(w["state_free"]), w["pre"], J(w["pre_valid"]), J(w["points"]), J(w["point_free"]),
        J(w["obs_uv"]), J(w["obs_ur"]), J(w["inv_sigma2"]), J(w["mask"]))
    want = jin.local_inertial_ba(prob_j, jax_make_pinhole(FX, FY, CX, CY, 640, 480),
                                 jnp.float32(BF), J(R_BC), J(T_BC))
    prob_t = convert.inertial_ba_problem_from_numpy(w, device="cpu", dtype=dtype)
    got = tin.local_inertial_ba(prob_t, make_pinhole(FX, FY, CX, CY, 640, 480, device="cpu"),
                                torch.tensor(BF), T(R_BC), T(T_BC))
    assert got.points.dtype == prob_t.points.dtype
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert_state_close(got.states, want.states, b=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=5e-4)
    # the fixed states did not move, the free ones went to the truth
    fixed = ~w["state_free"]
    np.testing.assert_array_equal(got.states.p_w.numpy()[fixed].astype(np.float32), w["p_w"][fixed])
    err = np.abs(got.states.p_w.numpy() - w["truth"]).max()
    assert err < 0.25 * np.abs(w["p_w"] - w["truth"]).max(), err


def test_inertial_window_converter_checks_shapes():
    w = _window(9, 0)
    w["pre_valid"] = w["pre_valid"][:-1]
    with pytest.raises(ValueError):
        convert.inertial_ba_problem_from_numpy(w, device="cpu")


# ------------------------------------------------------------ the inertial fused step
H_IMG, W_IMG = 240, 320
JCFG = JaxOrbConfig(height=H_IMG, width=W_IMG, n_features=256, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())
SCALES = np.asarray([CFG.scale_factor**l for l in range(CFG.n_levels)], np.float64)
INTR = (230.0, 230.0, 160.0, 120.0)
SBF, MIN_Z = np.float32(0.11 * 230.0), np.float32(0.11)
T_PRED = np.asarray([-5.4, -2.7, 0.0]) * (float(SBF) / 7.0) / 230.0


@pytest.fixture(scope="module")
def vi_step():
    """tests/test_torch_fused_track.py's two frames and blocks, then the
    inertial stage: the last frame's body state through the extrinsic, its
    velocity what the view's walk implies (0.05 s per frame), a
    frame-to-frame preintegration of a hovering body, a diagonal prior."""
    f0, f1 = parity.stereo_frames(2, H_IMG, W_IMG, seed=13)
    bf, min_z = jnp.float32(SBF), jnp.float32(MIN_Z)
    fd0 = jfp.process_stereo_frame_stacked(J(f0), JCFG, bf, min_z)
    fd1 = jfp.process_stereo_frame_stacked(J(f1), JCFG, bf, min_z)
    k0 = {f: np.asarray(v) for f, v in fd0.kps._asdict().items()}
    k1 = {f: np.asarray(v) for f, v in fd1.kps._asdict().items()}
    last = dict(k0, depth=np.asarray(fd0.depth))
    cam_j = jax_make_pinhole(*INTR, W_IMG, H_IMG)
    cam_t = convert.camera_from_numpy("pinhole", np.asarray(cam_j.params), W_IMG, H_IMG,
                                      device="cpu")
    store = parity.new_store(1024)
    sel = np.where(last["depth"] > 0)[0]
    mp_rows = np.full(len(k0["x"]), -1, np.int64)
    mp_rows[sel] = parity.store_add_points(store, last, sel, np.eye(3), np.zeros(3), INTR, SCALES)
    q7, q_rows = parity.twm_query_block(store, mp_rows, k0["level"], k0["angle"],
                                        host_camera(cam_t), np.eye(3), T_PRED, SCALES)
    cand_rows, cand_ok, _ = parity.tlm_candidate_block(store, np.arange(store["n_rows"]), 512)

    # inertial operands: body = camera through the extrinsic
    R1 = (np.eye(3) @ R_BC.T).astype(np.float64)           # R_wb = R_wc R_bc^T, R_wc = I
    p1 = -R1 @ T_BC
    v1 = -T_PRED / 0.05                                     # the camera centre's walk
    host = tpre.HostPreintegrated()
    rng = np.random.default_rng(4)
    host.integrate(np.tile(R1.T @ -G, (10, 1)) + rng.normal(0, 0.01, (10, 3)),
                   rng.normal(0, 0.002, (10, 3)), np.full(10, 0.005), TCALIB)
    prior_H = np.diag([1e5] * 3 + [1e4] * 3 + [1e3] * 3 + [1e6] * 6)
    packed = tpre.pack_preintegrated(host)
    vi_buf = fused_track.vi_buffer(R1, p1, v1, np.zeros(3), np.zeros(3), prior_H, packed, v1,
                                   C=host.C)
    jax_buf = vi_buf[:547]

    st = store
    maxd = np.where(np.isfinite(st["max_dist"]), st["max_dist"], 1e6).astype(np.float32)
    store_j = (J(st["pos"]), J(st["desc_signed"]), J(st["normal"]), J(st["min_dist"]), J(maxd))
    T0_j = JaxSE3(jnp.eye(3, dtype=jnp.float32), J(T_PRED.astype(np.float32)))
    twm_j = jft.twm_step(fd1.kps, J(np.asarray(fd1.u_right)), JCFG, bf, cam_j, T0_j,
                         J(q7), J(q_rows), store_j[0], store_j[1])
    tlm_j = jft.tlm_step_vi(fd1.kps, J(np.asarray(fd1.u_right)), JCFG, bf, cam_j, twm_j,
                            J(cand_rows), J(cand_ok), *store_j, J(R_BC), J(T_BC), J(jax_buf))

    kps = convert.keypoints_from_numpy(**k1, device="cpu")
    store_t = convert.store_from_numpy(st["pos"], st["desc_signed"], st["normal"],
                                       st["min_dist"], st["max_dist"], device="cpu")
    qb = convert.query_block_from_numpy(q7, q_rows, cand_rows, cand_ok, device="cpu")
    u_right, bf_t = T(np.asarray(fd1.u_right)), torch.tensor(SBF)
    twm_t = fused_track.twm_step(kps, u_right, CFG, bf_t, cam_t,
                                 convert.se3_from_numpy(np.eye(3), T_PRED, device="cpu"),
                                 qb.q7, qb.q_rows, store_t.pos, store_t.desc)
    tlm_t = fused_track.tlm_step_vi(kps, u_right, CFG, bf_t, cam_t, twm_t, qb.cand_rows,
                                    qb.cand_ok, *store_t, T(R_BC), T(T_BC), T(vi_buf))
    fd = FrameData(kps, None, u_right, T(np.asarray(fd1.depth)), kps.valid.sum())
    return dict(twm_j=twm_j, tlm_j=tlm_j, twm_t=twm_t, tlm_t=tlm_t, fd=fd, vi_buf=vi_buf,
                packed=packed, prior_H=prior_H, host=host, v1=v1)


def test_vi_buffer_extends_the_jax_layout(vi_step):
    s = vi_step
    buf = s["vi_buf"]
    assert buf.dtype == np.float32 and buf.shape == (fused_track.VI_BUF_SIZE,) == (871,)
    np.testing.assert_array_equal(buf[246:544], s["packed"])
    np.testing.assert_allclose(buf[544:547], s["v1"], rtol=1e-7)
    np.testing.assert_allclose(buf[547:646], tin.whitening_np(s["host"].C).astype(np.float32))
    np.testing.assert_allclose(buf[646:].reshape(15, 15), tin.sqrtm_psd_np(s["prior_H"]),
                               rtol=1e-6)


def test_tlm_step_vi_equals_jax(vi_step):
    s = vi_step
    tlm_t, tlm_j = s["tlm_t"], s["tlm_j"]
    for f in ("idx", "keep", "in_frustum", "inliers"):
        np.testing.assert_array_equal(getattr(tlm_t, f).numpy(), np.asarray(getattr(tlm_j, f)), f)
    assert int(tlm_t.n_inliers) == int(tlm_j.n_inliers) > 100
    for f in ("R_wb", "p_w", "v_w", "bg", "ba"):
        np.testing.assert_allclose(getattr(tlm_t, f).numpy(), np.asarray(getattr(tlm_j, f)),
                                   rtol=0, atol=1e-3, err_msg=f)
    assert_H_close(tlm_t.H, tlm_j.H, 1e-2)


def test_pack_unpack_fused_vi_round_trip(vi_step):
    s = vi_step
    twm, tlm, fd = s["twm_t"], s["tlm_t"], s["fd"]
    N, M, P = fd.kps.x.shape[0], twm.idx.shape[0], tlm.idx.shape[0]
    buf = fused_track.pack_fused_vi_for_host(fd, twm, tlm)
    f32, packed, idxA, keepA, idxB, keepB, in_frustum, tail, H = fused_track.unpack_fused_vi(
        buf.numpy(), N, M, P)
    np.testing.assert_array_equal(f32[8], tlm.inliers.float().numpy())
    np.testing.assert_array_equal(packed, fd.kps.desc_packed.numpy())
    np.testing.assert_array_equal(idxA, twm.idx.numpy())
    np.testing.assert_array_equal(keepA, twm.keep.numpy())
    np.testing.assert_array_equal(idxB, tlm.idx.numpy())
    np.testing.assert_array_equal(keepB, tlm.keep.numpy())
    np.testing.assert_array_equal(in_frustum, tlm.in_frustum.numpy())
    state = torch.cat([tlm.R_wb.reshape(-1), tlm.p_w, tlm.v_w, tlm.bg, tlm.ba])
    np.testing.assert_array_equal(tail[:21], state.numpy())
    assert (int(tail[21]), int(tail[22])) == (int(twm.n_inliers), int(tlm.n_inliers))
    np.testing.assert_array_equal(H, tlm.H.numpy())
    assert buf.numel() == 9 * N * 4 + 248 * 4 + (M + P) * 4 + N * 32 + M + 2 * P
