"""Essential-graph Sim3 pose-graph optimization
(Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1501).

Port of fasttrack_tpu/optim/pose_graph.py, a copy (host float64 with scipy).

Host float64 Gauss-Newton over Sim3 vertices with ANALYTIC edge Jacobians —
batched over every edge in one NumPy pass — and a sparse normal system
solved with scipy. For the edge residual r = log(Sji * Si * Sj^-1):

    d r / d(left-perturb Si)  =  Jl^-1(r) * Adj(Sji)
    d r / d(left-perturb Sj)  = -Jr^-1(r) = -(I + ad(r)/2 + ...)

with the Sim3 adjoint Adj(s,R,t) = [[sR, hat(t)R, -t],[0,R,0],[0,0,1]] on
xi = [rho, phi, sigma] and the inverse left Jacobian truncated at first
order, Jl^-1(r) ~= I - ad(r)/2 (exact at convergence where r -> 0; the
reference's g2o EdgeSim3 uses numeric differentiation, Optimizer.cc:1501 /
g2o types_seven_dof_expmap). Called only at loop closures / map merges, so
host float64 conditioning (SURVEY.md hard parts) comes for free.
`fix_scale=True` freezes the sigma coordinate (stereo / inertial maps, the
reference's bFixScale).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


# --- minimal float64 Sim3 ops (host, scalar) --------------------------------

def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _so3_exp(phi):
    th = np.linalg.norm(phi)
    K = _hat(phi)
    if th < 1e-10:
        return np.eye(3) + K + 0.5 * K @ K
    return (
        np.eye(3)
        + np.sin(th) / th * K
        + (1 - np.cos(th)) / th**2 * K @ K
    )


def _so3_log(R):
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    if th < 1e-10:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
        return w
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def _calc_W(phi, sigma):
    th = np.linalg.norm(phi)
    s = np.exp(sigma)
    K = _hat(phi)
    KK = K @ K
    eps = 1e-8
    if abs(sigma) < eps:
        C = 1.0
        if th < eps:
            A, B = 0.5, 1.0 / 6.0
        else:
            A = (1 - np.cos(th)) / th**2
            B = (th - np.sin(th)) / th**3
    else:
        C = (s - 1) / sigma
        if th < eps:
            A = ((sigma - 1) * s + 1) / sigma**2
            B = ((0.5 * sigma**2 - sigma + 1) * s - 1) / sigma**3
        else:
            a_ = s * np.sin(th)
            b_ = s * np.cos(th)
            c_ = th**2 + sigma**2
            A = (a_ * sigma + (1 - b_) * th) / (th * c_)
            B = (C - ((b_ - 1) * sigma + a_ * th) / c_) / th**2
    return C * np.eye(3) + A * K + B * KK


def sim3_exp(xi):
    """xi = [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[:3], xi[3:6], xi[6]
    R = _so3_exp(phi)
    t = _calc_W(phi, sigma) @ rho
    return np.exp(sigma), R, t


def sim3_log(s, R, t):
    phi = _so3_log(R)
    sigma = np.log(s)
    W = _calc_W(phi, sigma)
    rho = np.linalg.solve(W, t)
    return np.concatenate([rho, phi, [sigma]])


def sim3_mul(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb, sa * Ra @ tb + ta)


def sim3_inv(a):
    s, R, t = a
    si = 1.0 / s
    Ri = R.T
    return (si, Ri, -si * Ri @ t)


# --- batched float64 Sim3 ops (E, ...) --------------------------------------

def _bhat(v):
    """(E,3) -> (E,3,3) skew matrices."""
    E = len(v)
    H = np.zeros((E, 3, 3))
    H[:, 0, 1] = -v[:, 2]
    H[:, 0, 2] = v[:, 1]
    H[:, 1, 0] = v[:, 2]
    H[:, 1, 2] = -v[:, 0]
    H[:, 2, 0] = -v[:, 1]
    H[:, 2, 1] = v[:, 0]
    return H


def _bso3_log(R):
    """(E,3,3) -> (E,3)."""
    tr = np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    w = np.stack([
        R[:, 2, 1] - R[:, 1, 2],
        R[:, 0, 2] - R[:, 2, 0],
        R[:, 1, 0] - R[:, 0, 1],
    ], -1)
    small = th < 1e-10
    fac = np.where(small, 0.5, th / (2 * np.sin(np.where(small, 1.0, th))))
    return fac[:, None] * w


def _bcalc_W(phi, sigma):
    """Batched Sim3 left-Jacobian-of-translation W(phi, sigma): (E,3,3)."""
    th = np.linalg.norm(phi, axis=-1)
    s = np.exp(sigma)
    K = _bhat(phi)
    KK = K @ K
    eps = 1e-8
    th_s = np.where(th < eps, 1.0, th)       # masked-safe denominators
    sig_s = np.where(np.abs(sigma) < eps, 1.0, sigma)
    sig_small = np.abs(sigma) < eps
    th_small = th < eps
    C = np.where(sig_small, 1.0, (s - 1) / sig_s)
    # sigma small branch
    A_ss = np.where(th_small, 0.5, (1 - np.cos(th_s)) / th_s**2)
    B_ss = np.where(th_small, 1.0 / 6.0, (th_s - np.sin(th_s)) / th_s**3)
    # sigma large branch
    A_ls = ((sig_s - 1) * s + 1) / sig_s**2
    B_ls = ((0.5 * sig_s**2 - sig_s + 1) * s - 1) / sig_s**3
    a_ = s * np.sin(th_s)
    b_ = s * np.cos(th_s)
    c_ = th_s**2 + sig_s**2
    A_ll = (a_ * sig_s + (1 - b_) * th_s) / (th_s * c_)
    B_ll = (C - ((b_ - 1) * sig_s + a_ * th_s) / c_) / th_s**2
    A = np.where(sig_small, A_ss, np.where(th_small, A_ls, A_ll))
    B = np.where(sig_small, B_ss, np.where(th_small, B_ls, B_ll))
    eye = np.broadcast_to(np.eye(3), K.shape)
    return C[:, None, None] * eye + A[:, None, None] * K + B[:, None, None] * KK


def _bsim3_log(s, R, t):
    """Batched sim3_log: (E,), (E,3,3), (E,3) -> (E,7)."""
    phi = _bso3_log(R)
    sigma = np.log(s)
    W = _bcalc_W(phi, sigma)
    rho = np.linalg.solve(W, t[..., None])[..., 0]
    return np.concatenate([rho, phi, sigma[:, None]], -1)


def _bsim3_mul(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (sa * sb, Ra @ Rb,
            sa[:, None] * (Ra @ tb[..., None])[..., 0] + ta)


def _bsim3_inv(a):
    s, R, t = a
    si = 1.0 / s
    Ri = np.swapaxes(R, -1, -2)
    return (si, Ri, -si[:, None] * (Ri @ t[..., None])[..., 0])


def _badj(s, R, t):
    """Batched Sim3 adjoint on xi=[rho,phi,sigma]: (E,7,7).

    Adj(S) = [[ sR, hat(t)R, -t], [0, R, 0], [0, 0, 1]].
    Verified against the defining identity S exp(xi) S^-1 = exp(Adj(S) xi)."""
    E = len(s)
    A = np.zeros((E, 7, 7))
    A[:, :3, :3] = s[:, None, None] * R
    A[:, :3, 3:6] = _bhat(t) @ R
    A[:, :3, 6] = -t
    A[:, 3:6, 3:6] = R
    A[:, 6, 6] = 1.0
    return A


def _bad(xi):
    """Batched sim3 'little adjoint' ad(xi): (E,7,7).

    ad(xi) = [[hat(phi)+sigma I, hat(rho), -rho], [0, hat(phi), 0], [0,0,0]]."""
    E = len(xi)
    rho, phi, sigma = xi[:, :3], xi[:, 3:6], xi[:, 6]
    A = np.zeros((E, 7, 7))
    hp = _bhat(phi)
    A[:, :3, :3] = hp + sigma[:, None, None] * np.eye(3)
    A[:, :3, 3:6] = _bhat(rho)
    A[:, :3, 6] = -rho
    A[:, 3:6, 3:6] = hp
    return A


def _stack_poses(x, ids):
    s = np.array([x[k][0] for k in ids], float)
    R = np.stack([np.asarray(x[k][1], float) for k in ids])
    t = np.stack([np.asarray(x[k][2], float) for k in ids])
    return s, R, t


def _assemble_and_solve(n, dof, ei, ej, r, Ji, Jj, fixed_rows):
    """Build the GN normal system from per-edge (r, Ji, Jj) blocks and solve.

    Vectorized COO assembly: per edge the four blocks Ji^T Ji, Ji^T Jj,
    Jj^T Ji, Jj^T Jj land at (ei,ei), (ei,ej), (ej,ei), (ej,ej)."""
    JiT_r = np.einsum("erd,er->ed", Ji, r)
    JjT_r = np.einsum("erd,er->ed", Jj, r)
    b = np.zeros(n * dof)
    np.add.at(b.reshape(n, dof), ei, JiT_r)
    np.add.at(b.reshape(n, dof), ej, JjT_r)

    Hii = np.einsum("erd,erf->edf", Ji, Ji)
    Hij = np.einsum("erd,erf->edf", Ji, Jj)
    Hjj = np.einsum("erd,erf->edf", Jj, Jj)
    Hji = np.swapaxes(Hij, -1, -2)

    offs = np.arange(dof)
    blocks = [(ei, ei, Hii), (ei, ej, Hij), (ej, ei, Hji), (ej, ej, Hjj)]
    rows, cols, vals = [], [], []
    for ra, ca, blk in blocks:
        rows.append((ra[:, None, None] * dof + offs[None, :, None])
                    .repeat(dof, 2).reshape(-1))
        cols.append((ca[:, None, None] * dof + offs[None, None, :])
                    .repeat(dof, 1).reshape(-1))
        vals.append(blk.reshape(-1))
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n * dof, n * dof),
    )
    A = A + sp.eye(n * dof) * 1e-6
    free = np.ones(n * dof, bool)
    free[fixed_rows] = False
    fi = np.where(free)[0]
    if len(fi) == 0:
        return None
    try:
        dx_f = spla.spsolve(A[fi][:, fi].tocsc(), -b[fi])
    except Exception:
        return None
    if not np.all(np.isfinite(dx_f)):
        return None
    dx = np.zeros(n * dof)
    dx[fi] = dx_f
    return dx


def _edge_residuals(x_s, x_R, x_t, ei, ej, m_s, m_R, m_t):
    """r_e = log(Sji * Si * Sj^-1) batched over edges."""
    Si = (x_s[ei], x_R[ei], x_t[ei])
    Sj = (x_s[ej], x_R[ej], x_t[ej])
    M = _bsim3_mul(_bsim3_mul((m_s, m_R, m_t), Si), _bsim3_inv(Sj))
    return _bsim3_log(*M), M


def optimize_essential_graph_4dof(
    poses: dict[int, tuple],      # kf_id -> (1, R_cw, t_cw)
    edges: list[tuple],           # (id_i, id_j, (s, R, t) = Sji measured)
    fixed_ids: set[int],
    iterations: int = 15,
) -> dict[int, tuple]:
    """Gravity-preserving essential graph for inertial maps
    (Optimizer::OptimizeEssentialGraph4DoF, src/Optimizer.cc:5292): each
    vertex moves in yaw + translation only, so the loop correction can never
    tilt the gravity direction of an IMU-initialized map aligned to -z.

    Updates are RIGHT-multiplicative world-side perturbations
    x' = x o exp(lift(d))^-1 — a world-frame z-rotation + translation, which
    leaves the world z axis (gravity) invariant. Analytic Jacobians: with
    M' = exp(r) exp(-Adj(Sj) lift(d_i)) for vertex i and the sign flipped
    for vertex j, dr/dd_i = -Jr^-1(r) Adj(Sj) L and dr/dd_j = +Jr^-1(r)
    Adj(Sj) L, Jr^-1(r) ~= I + ad(r)/2."""
    ids = sorted(poses)
    index = {k: i for i, k in enumerate(ids)}
    n = len(ids)
    x = {k: poses[k] for k in ids}
    dof = 4
    if not edges or n == 0:
        return x

    L = np.zeros((7, 4))
    L[0, 0] = L[1, 1] = L[2, 2] = 1.0    # rho
    L[5, 3] = 1.0                        # phi_z (yaw about world z)

    ei = np.array([index[a] for a, _, _ in edges])
    ej = np.array([index[b] for _, b, _ in edges])
    m_s = np.array([m[0] for _, _, m in edges], float)
    m_R = np.stack([np.asarray(m[1], float) for _, _, m in edges])
    m_t = np.stack([np.asarray(m[2], float) for _, _, m in edges])

    fixed_rows = np.concatenate([
        np.arange(index[k] * dof, (index[k] + 1) * dof)
        for k in fixed_ids if k in index
    ]) if fixed_ids else np.array([], int)

    def lift(d4):
        xi = np.zeros(7)
        xi[:3] = d4[:3]
        xi[5] = d4[3]
        return xi

    for _ in range(iterations):
        x_s, x_R, x_t = _stack_poses(x, ids)
        r, _ = _edge_residuals(x_s, x_R, x_t, ei, ej, m_s, m_R, m_t)
        Jr_inv = np.broadcast_to(np.eye(7), (len(r), 7, 7)) + 0.5 * _bad(r)
        G = Jr_inv @ _badj(x_s[ej], x_R[ej], x_t[ej]) @ L
        dx = _assemble_and_solve(n, dof, ei, ej, r, -G, G, fixed_rows)
        if dx is None:
            break
        for k in ids:
            i = index[k]
            d = dx[i * dof:(i + 1) * dof]
            if np.abs(d).max() < 1e-12:
                continue
            x[k] = sim3_mul(x[k], sim3_inv(sim3_exp(lift(d))))
        if np.abs(dx).max() < 1e-8:
            break
    return x


def optimize_essential_graph(
    poses: dict[int, tuple],      # kf_id -> (s, R_cw, t_cw) Sim3 (s=1 pre-loop)
    edges: list[tuple],           # (id_i, id_j, (s, R, t) = Sji measured: j <- i)
    fixed_ids: set[int],
    fix_scale: bool = False,
    iterations: int = 15,
) -> dict[int, tuple]:
    """GN on the pose graph: edge residual r = log(Sji * Si * Sj^-1)
    (g2o EdgeSim3 with vertices storing world->camera Sim3s), analytic
    batched Jacobians (module docstring)."""
    ids = sorted(poses)
    index = {k: i for i, k in enumerate(ids)}
    n = len(ids)
    x = {k: poses[k] for k in ids}
    dof = 7
    if not edges or n == 0:
        return x

    ei = np.array([index[a] for a, _, _ in edges])
    ej = np.array([index[b] for _, b, _ in edges])
    m_s = np.array([m[0] for _, _, m in edges], float)
    m_R = np.stack([np.asarray(m[1], float) for _, _, m in edges])
    m_t = np.stack([np.asarray(m[2], float) for _, _, m in edges])
    adj_m = _badj(m_s, m_R, m_t)

    fixed_rows = [
        np.arange(index[k] * dof, (index[k] + 1) * dof)
        for k in fixed_ids if k in index
    ]
    if fix_scale:
        fixed_rows.append(np.arange(n) * dof + 6)
    fixed_rows = (np.concatenate(fixed_rows) if fixed_rows
                  else np.array([], int))

    for _ in range(iterations):
        x_s, x_R, x_t = _stack_poses(x, ids)
        r, _ = _edge_residuals(x_s, x_R, x_t, ei, ej, m_s, m_R, m_t)
        ad_r = _bad(r)
        eye = np.broadcast_to(np.eye(7), ad_r.shape)
        Jl_inv = eye - 0.5 * ad_r
        Jr_inv = eye + 0.5 * ad_r
        Ji = Jl_inv @ adj_m       # left-perturbation of Si
        Jj = -Jr_inv              # left-perturbation of Sj
        dx = _assemble_and_solve(n, dof, ei, ej, r, Ji, Jj, fixed_rows)
        if dx is None:
            break
        for k in ids:
            i = index[k]
            d = dx[i * dof:(i + 1) * dof]
            if np.abs(d).max() < 1e-12:
                continue
            x[k] = sim3_mul(sim3_exp(d), x[k])
        if np.abs(dx).max() < 1e-8:
            break
    return x
