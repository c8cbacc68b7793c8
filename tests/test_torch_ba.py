"""The port's bundle adjustment against the JAX package's, on the CPU.

The same windows, made from a NumPy seed, go through both packages (the port
with device="cpu"). Tolerances and why:

- `triangulate_two_view`: 1e-4 relative on well-conditioned rays (two f32
  SVDs of the same 4x4 systems);
- `jacobians`: the port's closed form against the JAX package's forward-mode
  autodiff, 1e-4 relative to the largest entry of each block;
- `schur_camera_contrib`, `assemble_and_solve`, `backsub_points`, one by one
  on the same inputs: 1e-4 relative to each output's largest entry (the f32
  sums over the landmarks run in another order);
- `local_bundle_adjustment` on a window of L = 128 points and K = 6 cameras
  (two fixed, stereo and mono observations, a few gross outliers): poses and
  points within 1e-3, the inlier mask equal wherever chi2 lies more than 1e-3
  relative away from its threshold. The port's solver works in the floating
  type of its window: float32 here, as the JAX package; the mapper's windows
  are float64 (ba_assembly.SOLVE_DTYPE), and the same window in float64 is
  held to the JAX result by the same tolerances.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.cameras import stereo as jstereo
from fasttrack_tpu.geometry import SE3 as JaxSE3
from fasttrack_tpu.optim import ba_core as jcore
from fasttrack_tpu.optim import local_ba as jba
from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.cameras import stereo as tstereo
from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.optim import ba_core as tcore
from fasttrack_tpu_torch.optim import local_ba as tba
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO

FX, FY, CX, CY, W, H = 260.0, 255.0, 160.0, 120.0, 320, 240
BF = FX * 0.11
RTOL = 1e-4
L, K = 128, 6


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def cams():
    return jax_make_pinhole(FX, FY, CX, CY, W, H), make_pinhole(FX, FY, CX, CY, W, H, device="cpu")


def rel_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _rotation(rng, angle):
    w = rng.normal(size=3)
    w *= angle / np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    return np.eye(3) + np.sin(th) / th * Kx + (1 - np.cos(th)) / th**2 * Kx @ Kx


def make_window(rng, n_outliers=6, noise=0.5, pose_noise=0.01, point_noise=0.03):
    """A BA window as `assemble_window` packs it: K cameras looking at a slab
    of L points, the last two cameras fixed, the last 8 point rows empty
    padding, observations noisy, stereo for near points, some gross
    outliers, poses and points perturbed from the truth."""
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(3, 7, L)], 1)
    R = np.stack([_rotation(rng, 0.05) for _ in range(K)])
    t = np.stack([np.array([0.25 * j - 0.6, 0.05 * rng.normal(), 0.05 * rng.normal()])
                  for j in range(K)])
    Xc = np.einsum("kij,lj->lki", R, pts) + t[None]
    u = FX * Xc[..., 0] / Xc[..., 2] + CX
    v = FY * Xc[..., 1] / Xc[..., 2] + CY
    obs_uv = np.stack([u, v], -1) + rng.normal(0, noise, (L, K, 2))
    ur = u - BF / Xc[..., 2] + rng.normal(0, noise, (L, K))
    stereo = (Xc[..., 2] < 5.0) & (rng.random((L, K)) < 0.8)
    obs_ur = np.where(stereo, ur, -1.0)
    mask = (u > 0) & (u < W) & (v > 0) & (v < H) & (rng.random((L, K)) < 0.85)
    levels = rng.integers(0, 4, (L, K))
    inv_sigma2 = 1.0 / 1.2 ** (2 * levels)
    out = rng.choice(np.flatnonzero(mask.ravel()), n_outliers, replace=False)
    obs_uv.reshape(-1, 2)[out] += rng.choice([-1, 1], (n_outliers, 2)) * 25.0
    point_free = np.ones(L, bool)
    point_free[-8:] = False            # padding rows: at the origin, no observation
    pts_init = pts + rng.normal(0, point_noise, (L, 3))
    pts_init[-8:] = 0.0
    mask[-8:] = False
    cam_free = np.ones(K, bool)
    cam_free[-2:] = False
    R_init, t_init = R.copy(), t.copy()
    for j in range(K - 2):
        R_init[j] = _rotation(rng, pose_noise) @ R[j]
        t_init[j] = t[j] + rng.normal(0, pose_noise, 3)
    return {
        "R": R_init.astype(np.float32), "t": t_init.astype(np.float32),
        "points": pts_init.astype(np.float32), "obs_uv": obs_uv.astype(np.float32),
        "obs_ur": obs_ur.astype(np.float32), "inv_sigma2": inv_sigma2.astype(np.float32),
        "mask": mask, "cam_free": cam_free, "point_free": point_free,
    }


def jax_problem(a):
    return jba.BAProblem(
        JaxSE3(J(a["R"]), J(a["t"])), J(a["points"]), J(a["obs_uv"]), J(a["obs_ur"]),
        J(a["inv_sigma2"]), J(a["mask"]), J(a["cam_free"]), J(a["point_free"]),
    )


# -------------------------------------------------------------- triangulation
def test_triangulate_two_view_equals_jax(rng):
    n = 500
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 8, n)], 1)
    R21 = _rotation(rng, 0.1)
    t21 = np.array([-0.4, 0.05, 0.02])
    X2 = X1 @ R21.T + t21
    r1 = (X1 / X1[:, 2:]).astype(np.float32)
    r2 = (X2 / X2[:, 2:] + rng.normal(0, 1e-3, (n, 3)) * [1, 1, 0]).astype(np.float32)
    want = np.asarray(jstereo.triangulate_two_view(
        J(r1), J(r2), JaxSE3(J(R21.astype(np.float32)), J(t21.astype(np.float32)))))
    got = tstereo.triangulate_two_view(
        T(r1), T(r2), SE3(T(R21.astype(np.float32)), T(t21.astype(np.float32)))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    # and it is a triangulation: close to the points the rays were made from
    assert np.median(np.linalg.norm(got - X1, axis=1)) < 0.1


def test_triangulate_two_view_broadcasts_a_batch_of_pairs(rng):
    B, n = 3, 40
    X1 = np.stack([rng.uniform(-1, 1, (B, n)), rng.uniform(-1, 1, (B, n)),
                   rng.uniform(2, 6, (B, n))], -1)
    R21 = np.stack([_rotation(rng, 0.1) for _ in range(B)])
    t21 = rng.normal(0, 0.3, (B, 3))
    X2 = np.einsum("bij,bnj->bni", R21, X1) + t21[:, None]
    r1, r2 = (X1 / X1[..., 2:]).astype(np.float32), (X2 / X2[..., 2:]).astype(np.float32)
    got = tstereo.triangulate_two_view(
        T(r1), T(r2), SE3(T(R21.astype(np.float32))[:, None], T(t21.astype(np.float32))[:, None]))
    np.testing.assert_allclose(got.numpy(), X1, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ Jacobians
def test_residuals_equal_jax(rng):
    a = make_window(rng)
    jcam, tcam = cams()
    r_j, behind_j = jcore.residuals(JaxSE3(J(a["R"]), J(a["t"])), J(a["points"]), jcam,
                                    jnp.float32(BF), J(a["obs_uv"]), J(a["obs_ur"]))
    r_t, behind_t = tcore.residuals(SE3(T(a["R"]), T(a["t"])), T(a["points"]), tcam,
                                    torch.tensor(BF), T(a["obs_uv"]), T(a["obs_ur"]))
    live = a["mask"]
    np.testing.assert_allclose(r_t.numpy()[live], np.asarray(r_j)[live], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(behind_t.numpy(), np.asarray(behind_j))


def test_analytic_jacobians_equal_jax_autodiff(rng):
    a = make_window(rng)
    jcam, tcam = cams()
    Jc_j, Jp_j = jcore.jacobians(JaxSE3(J(a["R"]), J(a["t"])), J(a["points"]), jcam,
                                 jnp.float32(BF), J(a["obs_uv"]), J(a["obs_ur"]))
    Jc_t, Jp_t = tcore.jacobians(SE3(T(a["R"]), T(a["t"])), T(a["points"]), tcam,
                                 torch.tensor(BF), T(a["obs_uv"]), T(a["obs_ur"]))
    assert Jc_t.shape == (L, K, 3, 6) and Jp_t.shape == (L, K, 3, 3)
    valid = a["mask"]                   # random valid observations, mono and stereo
    assert (a["obs_ur"][valid] >= 0).any() and (a["obs_ur"][valid] < 0).any()
    for got, want in ((Jc_t, Jc_j), (Jp_t, Jp_j)):
        got, want = got.numpy()[valid], np.asarray(want)[valid]
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        assert (np.abs(got - want) <= RTOL * scale).all()
    # a mono observation has no stereo row
    mono = valid & (a["obs_ur"] < 0)
    assert not Jc_t.numpy()[mono][:, 2].any() and not Jp_t.numpy()[mono][:, 2].any()


def test_jacobians_hold_the_clamped_depth_constant():
    """Behind the stereo clamp (z < 1e-6) the disparity term has no
    derivative, as differentiating through the clamp gives."""
    jcam, tcam = cams()
    R = np.eye(3, dtype=np.float32)[None]
    t = np.zeros((1, 3), np.float32)
    pts = np.array([[0.1, 0.2, -1.0], [0.3, -0.1, 2.0]], np.float32)
    uv = np.zeros((2, 1, 2), np.float32)
    ur = np.ones((2, 1), np.float32)
    Jc_j, Jp_j = jcore.jacobians(JaxSE3(J(R), J(t)), J(pts), jcam, jnp.float32(BF), J(uv), J(ur))
    Jc_t, Jp_t = tcore.jacobians(SE3(T(R), T(t)), T(pts), tcam, torch.tensor(BF), T(uv), T(ur))
    rel_close(Jc_t.numpy(), Jc_j)
    rel_close(Jp_t.numpy(), Jp_j)


# ------------------------------------------------------------ the Schur steps
@pytest.fixture
def schur_inputs(rng):
    """Jacobians, residuals and weights of a window, from the JAX side."""
    a = make_window(rng)
    jcam, _ = cams()
    poses = JaxSE3(J(a["R"]), J(a["t"]))
    r, behind = jcore.residuals(poses, J(a["points"]), jcam, jnp.float32(BF),
                                J(a["obs_uv"]), J(a["obs_ur"]))
    live = np.asarray(a["mask"] & ~np.asarray(behind))
    Jc, Jp = jcore.jacobians(poses, J(a["points"]), jcam, jnp.float32(BF),
                             J(a["obs_uv"]), J(a["obs_ur"]))
    sel = live[..., None, None]
    Jc = np.where(sel, np.asarray(Jc), 0.0).astype(np.float32)
    Jp = np.where(sel, np.asarray(Jp), 0.0).astype(np.float32)
    r = np.where(live[..., None], np.asarray(r), 0.0).astype(np.float32)
    w = (a["inv_sigma2"] * live).astype(np.float32)
    return a, Jc, Jp, r, w


def test_schur_camera_contrib_equals_jax(schur_inputs):
    _, Jc, Jp, r, w = schur_inputs
    lam = 1e-4
    want = jcore.schur_camera_contrib(J(Jc), J(Jp), J(r), J(w), jnp.float32(lam), jnp.float32)
    got = tcore.schur_camera_contrib(T(Jc), T(Jp), T(r), T(w), torch.tensor(lam), torch.float32)
    names = ("S_off", "rhs", "Hcc", "Hpp_inv", "Hcp", "bp")
    assert len(got) == len(want) == len(names)
    for name, g, wnt in zip(names, got, want):
        if name == "Hpp_inv":
            # a point seen once has a near-singular block: compare the
            # well-conditioned ones entry by entry
            wn = np.asarray(wnt)
            ok = np.abs(wn).max(axis=(1, 2)) < 1e3
            assert ok.sum() > L // 2
            scale = np.abs(wn[ok]).max(axis=(1, 2), keepdims=True)
            assert (np.abs(g.numpy()[ok] - wn[ok]) <= 1e-3 * scale).all(), name
        else:
            rel_close(g.numpy(), wnt, 1e-3 if name in ("S_off", "rhs") else RTOL)


def test_assemble_and_solve_equals_jax(schur_inputs):
    a, Jc, Jp, r, w = schur_inputs
    lam = jnp.float32(1e-4)
    S_off, rhs, Hcc, _, _, _ = jcore.schur_camera_contrib(J(Jc), J(Jp), J(r), J(w), lam, jnp.float32)
    want = jcore.assemble_and_solve(S_off, rhs, Hcc, lam, J(a["cam_free"]), jnp.float32)
    got = tcore.assemble_and_solve(T(np.asarray(S_off)), T(np.asarray(rhs)), T(np.asarray(Hcc)),
                                   torch.tensor(1e-4), T(a["cam_free"]), torch.float32)
    rel_close(got.numpy(), want, 1e-3)
    assert not got.numpy()[~a["cam_free"]].any()      # a fixed camera does not move
    assert np.abs(got.numpy()[a["cam_free"]]).max() > 1e-4


def test_backsub_points_and_pose_update_equal_jax(schur_inputs, rng):
    a, Jc, Jp, r, w = schur_inputs
    lam = jnp.float32(1e-4)
    _, _, _, Hpp_inv, Hcp, bp = jcore.schur_camera_contrib(J(Jc), J(Jp), J(r), J(w), lam, jnp.float32)
    # well-conditioned blocks only, as above
    ok = np.abs(np.asarray(Hpp_inv)).max(axis=(1, 2)) < 1e3
    dxc = rng.normal(0, 1e-2, (K, 6)).astype(np.float32)
    want = np.asarray(jcore.backsub_points(Hpp_inv, Hcp, bp, J(dxc), J(a["point_free"])))
    got = tcore.backsub_points(T(np.asarray(Hpp_inv)), T(np.asarray(Hcp)), T(np.asarray(bp)),
                               T(dxc), T(a["point_free"])).numpy()
    rel_close(got[ok], want[ok])
    assert not got[~a["point_free"]].any()
    P_j = jcore.apply_pose_update(JaxSE3(J(a["R"]), J(a["t"])), J(dxc))
    P_t = tcore.apply_pose_update(SE3(T(a["R"]), T(a["t"])), T(dxc))
    np.testing.assert_allclose(P_t.R.numpy(), np.asarray(P_j.R), atol=1e-6)
    np.testing.assert_allclose(P_t.t.numpy(), np.asarray(P_j.t), atol=1e-6)


def test_robust_weights_equal_jax(schur_inputs):
    a, _, _, r, _ = schur_inputs
    inl = a["mask"].astype(np.float32)
    for use_robust in (True, False):
        c_j, w_j = jcore.robust_weights(J(r), J(inl), J(a["inv_sigma2"]), J(a["obs_ur"]), use_robust)
        c_t, w_t = tcore.robust_weights(T(r), T(inl), T(a["inv_sigma2"]), T(a["obs_ur"]), use_robust)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ the solver
@pytest.fixture(scope="module")
def solved():
    a = make_window(np.random.default_rng(7))
    jcam, tcam = cams()
    want = jba.local_bundle_adjustment(jax_problem(a), jcam, jnp.float32(BF))
    got = tba.local_bundle_adjustment(
        convert.ba_problem_from_numpy(a, device="cpu"), tcam, torch.tensor(BF))
    return a, want, got


def test_local_ba_poses_and_points_equal_jax(solved):
    a, want, got = solved
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R), atol=1e-3)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=1e-3)
    free = a["point_free"] & a["mask"].any(1)
    np.testing.assert_allclose(got.points.numpy()[free], np.asarray(want.points)[free], atol=1e-3)
    # fixed cameras and padding rows stay where they were
    np.testing.assert_array_equal(got.poses.R.numpy()[-2:], a["R"][-2:])
    np.testing.assert_array_equal(got.poses.t.numpy()[-2:], a["t"][-2:])
    np.testing.assert_array_equal(got.points.numpy()[-8:], a["points"][-8:])
    # and it adjusted: the free poses moved
    assert np.abs(got.poses.t.numpy()[:4] - a["t"][:4]).max() > 1e-3


def test_local_ba_inlier_mask_equals_jax_away_from_the_threshold(solved):
    a, want, got = solved
    chi2 = np.asarray(want.chi2)
    delta2 = np.where(a["obs_ur"] >= 0, CHI2_STEREO, CHI2_MONO)
    clear = np.abs(chi2 - delta2) > 1e-3 * delta2
    got_inl, want_inl = got.inlier_mask.numpy(), np.asarray(want.inlier_mask)
    assert got_inl.dtype == bool and got_inl.shape == (L, K)
    np.testing.assert_array_equal(got_inl[clear], want_inl[clear])
    assert clear.mean() > 0.99
    # the gross outliers are out, most observations in
    assert 0 < (a["mask"] & ~got_inl).sum() < 0.1 * a["mask"].sum()
    assert not got_inl[~a["mask"]].any()
    np.testing.assert_allclose(got.chi2.numpy()[a["mask"]], chi2[a["mask"]], rtol=0.05, atol=0.05)


def test_local_ba_in_float64_equals_jax_by_the_same_tolerances(solved):
    """What the mapper runs: the window uploaded as float64. Every tensor of
    the result is float64, and it meets the JAX package's float32 result as
    the float32 run does."""
    a, want, got32 = solved
    _, tcam = cams()
    got = tba.local_bundle_adjustment(
        convert.ba_problem_from_numpy(a, device="cpu", dtype=np.float64), tcam, torch.tensor(BF))
    assert {t.dtype for t in (got.poses.R, got.poses.t, got.points, got.chi2)} == {torch.float64}
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R), atol=1e-3)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=1e-3)
    free = a["point_free"] & a["mask"].any(1)
    np.testing.assert_allclose(got.points.numpy()[free], np.asarray(want.points)[free], atol=1e-3)
    chi2 = np.asarray(want.chi2)
    delta2 = np.where(a["obs_ur"] >= 0, CHI2_STEREO, CHI2_MONO)
    clear = np.abs(chi2 - delta2) > 1e-3 * delta2
    np.testing.assert_array_equal(got.inlier_mask.numpy()[clear], np.asarray(want.inlier_mask)[clear])
    assert {t.dtype for t in (got32.poses.R, got32.points, got32.chi2)} == {torch.float32}


def test_local_ba_lowers_the_cost_and_stays_finite(solved):
    a, _, got = solved
    _, tcam = cams()
    prob = convert.ba_problem_from_numpy(a, device="cpu")
    inl = got.inlier_mask

    def cost(poses, points):
        r, _ = tcore.residuals(poses, points, tcam, torch.tensor(BF), prob.obs_uv, prob.obs_ur)
        return float(((r * r).sum(-1) * prob.inv_sigma2)[inl].sum())

    assert cost(got.poses, got.points) < cost(prob.poses, prob.points)
    assert torch.isfinite(got.poses.R).all() and torch.isfinite(got.points).all()


def test_local_ba_survives_dead_observations():
    """A point at a camera centre and an exploded point: their observations
    are selected out, not multiplied out, so nothing turns NaN."""
    a = make_window(np.random.default_rng(11), n_outliers=0)
    a["points"][0] = -a["R"][0].T @ a["t"][0]      # at camera 0's centre
    a["points"][1] = 1e30
    _, tcam = cams()
    got = tba.local_bundle_adjustment(
        convert.ba_problem_from_numpy(a, device="cpu"), tcam, torch.tensor(BF))
    assert torch.isfinite(got.poses.R).all() and torch.isfinite(got.poses.t).all()
    assert torch.isfinite(got.points[2:-8]).all()


def test_ba_problem_round_trip_and_shape_check(rng):
    a = make_window(rng)
    prob = convert.ba_problem_from_numpy(a, device="cpu")
    assert prob.mask.dtype == torch.bool and prob.points.dtype == torch.float32
    np.testing.assert_array_equal(prob.obs_ur.numpy(), a["obs_ur"])
    res = tba.BAResult(prob.poses, prob.points, prob.mask, prob.inv_sigma2)
    back = convert.ba_result_to_numpy(res)
    assert sorted(back) == ["R", "chi2", "inlier_mask", "points", "t"]
    np.testing.assert_array_equal(back["R"], a["R"])
    np.testing.assert_array_equal(back["inlier_mask"], a["mask"])
    bad = dict(a, points=a["points"][:-1])
    with pytest.raises(ValueError):
        convert.ba_problem_from_numpy(bad, device="cpu")
