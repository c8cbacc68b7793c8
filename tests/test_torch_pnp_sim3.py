"""The port's relocalization PnP, loop Sim3 solver, Sim3 refinement and
essential graphs against the JAX package's, on the CPU.

- `ransac_pnp`, `ml_refine`, `_dlt_pnp` and `solve_sim3` are host NumPy
  copies: equal to the JAX package's bit for bit on seeded data (the cases
  of tests/test_pnp.py and tests/test_loop_closing.py, outliers and the
  degenerate ones included).
- `optimize_sim3` (ROADMAP K13) runs in PyTorch, float32, with the
  Jacobian from `torch.func.jacfwd` where the JAX package takes
  `jax.jacfwd`: on the CPU it agrees with the JAX version within 1e-4 in
  s, R and t (f32 sums in another order over 15 LM iterations), with equal
  inlier masks and success, on the cases of tests/test_sim3_opt.py: pixel
  noise, heavy drift, fixed scale, gross outliers and too few points.
- Both essential graphs (`optimize_essential_graph`, and the 4-DoF one
  that only inertial loop closing, ROADMAP M7b, will call) are host float64
  copies: on tests/test_loop_closing.py's drifted chain with a loop edge
  they agree with the JAX package's within 1e-9.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from fasttrack_tpu.optim import pnp as jpnp
from fasttrack_tpu.optim import pose_graph as jpg
from fasttrack_tpu.optim import sim3_solver as jsolver
from fasttrack_tpu.optim.sim3_opt import optimize_sim3 as jax_optimize_sim3
from fasttrack_tpu_torch.optim import pnp as tpnp
from fasttrack_tpu_torch.optim import pose_graph as tpg
from fasttrack_tpu_torch.optim import sim3_solver as tsolver
from fasttrack_tpu_torch.optim.sim3_opt import optimize_sim3
from tests.test_pnp import FOCAL
from tests.test_pnp import make_case as pnp_case
from tests.test_sim3_opt import K, R_GT, S_GT, T_GT
from tests.test_sim3_opt import make_case as sim3_case

SIM3_ATOL = 1e-4
GRAPH_ATOL = 1e-9


# ------------------------------------------------------------------------ PnP
@pytest.mark.parametrize("seed, aniso, outliers", [(0, True, 0.15), (1, False, 0.0),
                                                   (2, True, 0.4), (3, True, 0.15)])
def test_ransac_pnp_equals_jax(seed, aniso, outliers):
    X, rays, sigma2, _ = pnp_case(seed=seed, aniso=aniso, outlier_frac=outliers)
    got = tpnp.ransac_pnp(X, rays, sigma2, FOCAL, seed=seed)
    want = jpnp.ransac_pnp(X, rays, sigma2, FOCAL, seed=seed)
    assert got.success == want.success
    np.testing.assert_array_equal(got.R_cw, want.R_cw)
    np.testing.assert_array_equal(got.t_cw, want.t_cw)
    np.testing.assert_array_equal(got.inliers, want.inliers)


def test_ml_refine_and_dlt_equal_jax():
    for seed in range(4):
        X, rays, sigma2, _ = pnp_case(seed=seed, outlier_frac=0.0)
        R0, t0 = tpnp._dlt_pnp(X, rays)
        jR0, jt0 = jpnp._dlt_pnp(X, rays)
        np.testing.assert_array_equal(R0, jR0)
        np.testing.assert_array_equal(t0, jt0)
        inl = np.ones(len(X), bool)
        inl[::5] = False
        got = tpnp.ml_refine(X, rays, sigma2, FOCAL, R0, t0, inl)
        want = jpnp.ml_refine(X, rays, sigma2, FOCAL, R0, t0, inl)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_pnp_degenerate_cases_equal_jax():
    got = tpnp.ransac_pnp(np.zeros((4, 3)), np.ones((4, 3)), np.ones(4), FOCAL)
    assert not got.success and not jpnp.ransac_pnp(
        np.zeros((4, 3)), np.ones((4, 3)), np.ones(4), FOCAL).success
    X = np.stack([np.linspace(-2, 2, 30), np.zeros(30), np.full(30, 6.0)], -1)
    Xc = X @ Rotation.from_rotvec([0.1, -0.2, 0.15]).as_matrix().T + np.array([0.3, -0.1, 0.2])
    rays = Xc / Xc[:, 2:]
    a = tpnp.ransac_pnp(X, rays, np.ones(30), FOCAL)
    b = jpnp.ransac_pnp(X, rays, np.ones(30), FOCAL)
    assert a.success == b.success
    np.testing.assert_array_equal(a.inliers, b.inliers)


# ----------------------------------------------------------------- Sim3 RANSAC
def _solver_case(rng, n=80, s=1.3, outliers=10):
    X1, X2, uv1, uv2 = sim3_case(seed=int(rng.integers(1 << 30)), n=n, drift=0.01)
    X1 = s / S_GT * X1
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        X2[idx] += rng.uniform(0.5, 2.0, size=(outliers, 3))
    return X1, X2, uv1, uv2


@pytest.mark.parametrize("fix_scale", [False, True])
@pytest.mark.parametrize("outliers", [0, 10, 60])
def test_solve_sim3_equals_jax(rng, fix_scale, outliers):
    X1, X2, uv1, uv2 = _solver_case(rng, outliers=outliers)
    sig1, sig2 = 1.2 ** (2 * rng.integers(0, 4, len(X1))), np.ones(len(X1))
    got = tsolver.solve_sim3(X1, X2, uv1, uv2, K, K, sig1, sig2, fix_scale=fix_scale)
    want = jsolver.solve_sim3(X1, X2, uv1, uv2, K, K, sig1, sig2, fix_scale=fix_scale)
    assert (got.success, got.n_inliers) == (want.success, want.n_inliers)
    assert got.s == want.s
    np.testing.assert_array_equal(got.R, want.R)
    np.testing.assert_array_equal(got.t, want.t)
    np.testing.assert_array_equal(got.inliers, want.inliers)


# -------------------------------------------------------- Sim3 refinement, K13
def _outlier_case():
    X1, X2, uv1, uv2 = sim3_case(drift=0.0, px_noise=0.5)
    rng = np.random.default_rng(3)
    bad = rng.choice(len(X1), 25, replace=False)
    uv1 = uv1.copy()
    uv1[bad] += rng.uniform(30, 80, size=(25, 2))
    R0 = Rotation.from_rotvec([0.01, 0, 0]).as_matrix() @ R_GT
    return (X1, X2, uv1, uv2), (S_GT * 1.02, R0, T_GT + 0.05), False


def _horn_case(fix_scale, **kw):
    X1, X2, uv1, uv2 = sim3_case(**kw)
    sig = np.ones(len(X1))
    horn = jsolver.solve_sim3(X1, X2, uv1, uv2, K, K, sig, sig, fix_scale=fix_scale)
    return (X1, X2, uv1, uv2), (horn.s, horn.R, horn.t), fix_scale


SIM3_CASES = {
    "pixel noise": lambda: _horn_case(False),
    "heavy drift": lambda: _horn_case(False, drift=0.05),
    "fixed scale": lambda: _horn_case(True),
    "gross outliers": _outlier_case,
    "levels": lambda: _horn_case(False, seed=11, px_noise=2.0),
}


@pytest.mark.parametrize("name", sorted(SIM3_CASES))
def test_optimize_sim3_equals_jax(name):
    (X1, X2, uv1, uv2), (s0, R0, t0), fix = SIM3_CASES[name]()
    rng = np.random.default_rng(len(name))
    sig1 = 1.2 ** (2 * rng.integers(0, 3, len(X1))) if name == "levels" else np.ones(len(X1))
    sig2 = np.ones(len(X1))
    got = optimize_sim3(X1, X2, uv1, uv2, K, K, sig1, sig2, s0, R0, t0, fix_scale=fix,
                        device="cpu")
    want = jax_optimize_sim3(X1, X2, uv1, uv2, K, K, sig1, sig2, s0, R0, t0, fix_scale=fix)
    assert got.success == want.success and got.success
    assert got.n_inliers == want.n_inliers
    np.testing.assert_array_equal(got.inliers, want.inliers)
    assert got.s == pytest.approx(want.s, abs=SIM3_ATOL)
    np.testing.assert_allclose(got.R, want.R, atol=SIM3_ATOL)
    np.testing.assert_allclose(got.t, want.t, atol=SIM3_ATOL)
    assert got.cost == pytest.approx(want.cost, rel=1e-3)
    np.testing.assert_allclose(got.R @ got.R.T, np.eye(3), atol=1e-12)
    if fix:
        assert got.s == pytest.approx(s0, abs=1e-5)


def test_optimize_sim3_too_few_points():
    args = (np.zeros((2, 3)), np.zeros((2, 3)), np.zeros((2, 2)), np.zeros((2, 2)), K, K,
            np.ones(2), np.ones(2), 1.0, np.eye(3), np.zeros(3))
    got, want = optimize_sim3(*args, device="cpu"), jax_optimize_sim3(*args)
    assert not got.success and not want.success and got.n_inliers == want.n_inliers == 0


# ----------------------------------------------------------- essential graphs
def _drifted_chain(mod, n=10, scale_drift=0.0):
    """tests/test_loop_closing.py's chain 0-1-...-9 with odometry edges and a
    loop edge 9 -> 0, initial poses drifted in y and rotation (and in scale
    by `scale_drift` per vertex)."""
    true = [mod.sim3_exp(np.array([0.5 * k, 0, 0, 0, 0, 0, 0.0])) for k in range(n)]
    edges = [(k, k + 1, mod.sim3_mul(true[k + 1], mod.sim3_inv(true[k]))) for k in range(n - 1)]
    edges.append((n - 1, 0, mod.sim3_mul(true[0], mod.sim3_inv(true[n - 1]))))
    init = {}
    for k in range(n):
        d = np.zeros(7)
        d[1], d[4], d[6] = 0.05 * k, 0.01 * k, scale_drift * k
        init[k] = mod.sim3_mul(mod.sim3_exp(d), true[k])
    init[0] = true[0]
    return init, edges


def _assert_poses_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, atol=GRAPH_ATOL, rtol=0)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_essential_graph_equals_jax(fix_scale):
    drift = 0.0 if fix_scale else 0.02   # a fixed scale cannot absorb scale drift
    init, edges = _drifted_chain(tpg, scale_drift=drift)
    jinit, jedges = _drifted_chain(jpg, scale_drift=drift)
    got = tpg.optimize_essential_graph(init, edges, {0}, fix_scale=fix_scale)
    want = jpg.optimize_essential_graph(jinit, jedges, {0}, fix_scale=fix_scale)
    _assert_poses_close(got, want)
    for i, j, Sji in edges:           # the loop closes
        r = tpg.sim3_log(*tpg.sim3_mul(tpg.sim3_mul(Sji, got[i]), tpg.sim3_inv(got[j])))
        assert np.abs(r).max() < 1e-2


def test_essential_graph_4dof_equals_jax():
    init, edges = _drifted_chain(tpg)
    jinit, jedges = _drifted_chain(jpg)
    got = tpg.optimize_essential_graph_4dof(init, edges, {0})
    want = jpg.optimize_essential_graph_4dof(jinit, jedges, {0})
    _assert_poses_close(got, want)
    assert tpg.optimize_essential_graph_4dof(init, [], {0}) == init


def test_sim3_ops_equal_jax(rng):
    for _ in range(10):
        xi = rng.normal(size=7) * 0.5
        a, b = tpg.sim3_exp(xi), jpg.sim3_exp(xi)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tpg.sim3_log(*a), jpg.sim3_log(*b))
        np.testing.assert_allclose(tpg.sim3_log(*a), xi, atol=1e-8)
