"""Local bundle adjustment: masked LM with Schur-complement reduction.

Port of fasttrack_tpu/optim/local_ba.py. Parity target:
Optimizer::LocalBundleAdjustment (src/Optimizer.cc:1116):
covisibility-window keyframes (free) + frontier keyframes (fixed) + their
map points; 5 LM iterations, chi2 outlier removal (5.991 mono / 7.815
stereo), 10 more iterations; g2o block solver with landmark marginalization.

The BA window is a dense fixed-shape problem: an (L points) x (K cameras)
observation grid with a validity mask. The landmark blocks are eliminated in
closed form (3x3 inverses, batched) and the reduced camera system (6K x 6K)
is a single dense solve. 'Removing' an edge = zeroing its mask entry, and a
step is accepted or rejected with torch.where, so the fifteen iterations
never synchronise with the device. The solver computes in the floating type
of the window it is given (ba_assembly uploads float64 and says why).

The same routine covers GlobalBundleAdjustment (Optimizer.cc:60): a global
BA is a BA window containing every keyframe (possibly solved in blocks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.cameras.models import FISHEYE_KB8, Camera
from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.optim import ba_core
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-shape local BA window.

    K cameras (free where `cam_free`, the rest fixed), L landmarks,
    dense (L, K) observation grid with mask.
    """

    poses: SE3                 # batched (K,): Tcw
    points: torch.Tensor       # (L, 3)
    obs_uv: torch.Tensor       # (L, K, 2)
    obs_ur: torch.Tensor       # (L, K) right-u; <0 => mono
    inv_sigma2: torch.Tensor   # (L, K)
    mask: torch.Tensor         # (L, K) bool
    cam_free: torch.Tensor     # (K,) bool: False for frontier keyframes
    point_free: torch.Tensor   # (L,) bool


class BAResult(NamedTuple):
    poses: SE3
    points: torch.Tensor
    inlier_mask: torch.Tensor  # (L, K) bool: post-chi2 classification
    chi2: torch.Tensor         # (L, K)
    # () int32, counted on the device: the steps that the cost test accepted
    # and the behind-the-camera rule rejected (ROADMAP F24)
    n_rejected: torch.Tensor | None = None


def local_bundle_adjustment(
    problem: BAProblem,
    cam: Camera,
    bf: torch.Tensor,
    phase1_iters: int = 5,
    phase2_iters: int = 10,
    mono_edges_only: bool = False,
) -> BAResult:
    """`mono_edges_only`: the window is a monocular map's, whose every edge
    is a mono one, as a KB8 map's is; such windows reject a step that moves
    a live observation behind its camera (ROADMAP F24)."""
    is_stereo = problem.obs_ur >= 0
    reject_behind = cam.kind == FISHEYE_KB8 or mono_edges_only
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    obs_uv, obs_ur = problem.obs_uv, problem.obs_ur

    def weights(r, inlier, use_robust):
        chi2 = torch.sum(r * r, dim=-1) * problem.inv_sigma2
        # Masked/degenerate entries can be inf/NaN; select them out (0 * inf
        # would be NaN, so torch.where, not multiplication).
        chi2 = torch.where(inlier > 0, chi2, 0.0)
        w_rob = huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
        return chi2, w_rob * problem.inv_sigma2 * inlier

    def lm_iter(poses, points, inlier, lam, n_rej, use_robust):
        r, behind = ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)
        # Residuals can overflow to inf in float32 for exploded points; such
        # observations must be fully dead or inf*0 -> NaN poisons the einsums.
        live = inlier * (~behind) * torch.isfinite(r).all(dim=-1)
        r = torch.where(live[..., None] > 0, r, 0.0)
        chi2, w = weights(r, live, use_robust)
        Jc, Jp = ba_core.jacobians(poses, points, cam, bf, obs_uv, obs_ur)
        # Dead observations may have inf/NaN Jacobians (points at a camera
        # center in padded slots); zero them by selection before the einsums.
        dead = (live <= 0)[..., None, None]
        Jc = torch.where(dead | ~torch.isfinite(Jc), 0.0, Jc)
        Jp = torch.where(dead | ~torch.isfinite(Jp), 0.0, Jp)

        S_off, rhs, Hcc, Hpp_inv, Hcp, bp = ba_core.schur_camera_contrib(
            Jc, Jp, r, w, lam, points.dtype
        )
        dxc = ba_core.assemble_and_solve(
            S_off, rhs, Hcc, lam, problem.cam_free, points.dtype
        )
        dxp = ba_core.backsub_points(Hpp_inv, Hcp, bp, dxc, problem.point_free)

        poses_new = ba_core.apply_pose_update(poses, dxc)
        points_new = points + dxp

        # Accept/reject.
        r_new, behind_new = ba_core.residuals(
            poses_new, points_new, cam, bf, obs_uv, obs_ur
        )
        chi2_new, w_new = weights(r_new, inlier * (~behind_new), use_robust)
        c_old = torch.sum(chi2 * (w > 0))
        c_new = torch.sum(chi2_new * (w_new > 0))
        step_ok = torch.isfinite(dxc).all() & torch.isfinite(dxp).all()
        accept = (c_new < c_old) & step_ok
        if reject_behind:
            # A step that moves a live observation behind its camera drops
            # it from c_new, so a window of mono edges only (a KB8 map's:
            # fisheye points keep u_right = -1; a monocular map's) can lower
            # its cost by flipping its points behind the cameras, and its
            # map falls apart. Such a step is rejected there; a stereo
            # pinhole window keeps the JAX package's accept test (ROADMAP
            # F24).
            flips = ((live > 0) & behind_new).any()
            n_rej = n_rej + (accept & flips).to(n_rej.dtype)
            accept = accept & ~flips
        poses = SE3(
            torch.where(accept, poses_new.R, poses.R),
            torch.where(accept, poses_new.t, poses.t),
        )
        points = torch.where(accept, points_new, points)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        return poses, points, lam, n_rej

    def classify(poses, points):
        r, behind = ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)
        chi2 = torch.sum(r * r, dim=-1) * problem.inv_sigma2
        return problem.mask & (chi2 <= delta2) & (~behind), chi2

    poses, points = problem.poses, problem.points
    inlier = problem.mask.to(points.dtype)
    lam = torch.full((), 1e-4, dtype=points.dtype, device=points.device)
    n_rej = torch.zeros((), dtype=torch.int32, device=points.device)

    for _ in range(phase1_iters):
        poses, points, lam, n_rej = lm_iter(poses, points, inlier, lam, n_rej, use_robust=True)

    # chi2 outlier rejection between phases (Optimizer.cc LocalBA mid-check).
    inlier = classify(poses, points)[0].to(points.dtype)

    for _ in range(phase2_iters):
        poses, points, lam, n_rej = lm_iter(poses, points, inlier, lam, n_rej, use_robust=False)

    final_inlier, chi2 = classify(poses, points)
    return BAResult(poses, points, final_inlier, chi2, n_rej)
