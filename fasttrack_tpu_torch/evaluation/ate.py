"""Absolute trajectory error with Umeyama SE3/Sim3 alignment.

Port of fasttrack_tpu/evaluation/ate.py (NumPy only).

The reference's eval harness calls a (missing) evaluate3.py ATE script
(Examples/euroc_eval_examples.sh:62); this module is our in-tree equivalent:
ground-truth loading (EuRoC CSV / TUM formats, evaluation/Ground_truth/*),
timestamp association, least-squares alignment (optionally with scale for
monocular), and RMSE/statistics.
"""

from __future__ import annotations

import numpy as np


def load_ground_truth(path: str):
    """Load a ground-truth trajectory file. Returns (t, pos): (N,) seconds
    and (N,3) positions.

    Auto-detects the two formats the reference ships/consumes:
    - EuRoC GT CSV (evaluation/Ground_truth/EuRoC_left_cam/MH01_GT.txt):
      comma-separated `timestamp_ns, px, py, pz, qw, qx, qy, qz`
    - TUM trajectory (`f_<name>.txt` output, tum_eval format):
      space-separated `timestamp_s px py pz qx qy qz qw`
    """
    ts, ps = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            parts = line.split(",") if "," in line else line.split()
            if len(parts) < 4:
                continue
            vals = [float(x) for x in parts[:4]]
            t = vals[0]
            if t > 1e14:      # nanoseconds (EuRoC GT)
                t *= 1e-9
            ts.append(t)
            ps.append(vals[1:4])
    t = np.asarray(ts)
    p = np.asarray(ps)
    order = np.argsort(t)
    return t[order], p[order]


def evaluate_trajectory(traj, gt_path: str, with_scale: bool = False,
                        max_dt: float = 0.05):
    """ATE of a tracker trajectory (list of (timestamp, R_cw, t_cw), the
    System/Tracker in-memory format) against a ground-truth file. Camera
    centers are -R_cw^T t_cw. Returns the absolute_trajectory_error dict."""
    t_gt, p_gt = load_ground_truth(gt_path)
    t_est = np.asarray([t for t, _, _ in traj])
    p_est = np.asarray([-np.asarray(R).T @ np.asarray(tc)
                        for _, R, tc in traj])
    return absolute_trajectory_error(t_est, p_est, t_gt, p_gt,
                                     with_scale=with_scale, max_dt=max_dt)


def associate_trajectories(
    t_est: np.ndarray, p_est: np.ndarray, t_gt: np.ndarray, p_gt: np.ndarray,
    max_dt: float = 0.02,
):
    """Associate by nearest timestamp. Returns (p_est_a, p_gt_a)."""
    idx = np.searchsorted(t_gt, t_est)
    idx = np.clip(idx, 1, len(t_gt) - 1)
    left = idx - 1
    choose_left = np.abs(t_gt[left] - t_est) < np.abs(t_gt[idx] - t_est)
    nearest = np.where(choose_left, left, idx)
    ok = np.abs(t_gt[nearest] - t_est) <= max_dt
    return p_est[ok], p_gt[nearest[ok]]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform dst ~= s R src + t (Umeyama 1991).

    Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(
    t_est: np.ndarray, p_est: np.ndarray, t_gt: np.ndarray, p_gt: np.ndarray,
    with_scale: bool = False, max_dt: float = 0.02,
):
    """Returns dict with rmse/mean/median/std/min/max of the aligned ATE."""
    pe, pg = associate_trajectories(t_est, p_est, t_gt, p_gt, max_dt)
    if len(pe) < 3:
        return {"rmse": np.inf, "n": len(pe)}
    s, R, t = umeyama_alignment(pe, pg, with_scale)
    aligned = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(aligned - pg, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n": int(len(err)),
        "scale": s,
    }


def report_ate(system, gt_path: str, out_dir: str,
               with_scale: bool = False) -> dict:
    """Example-script-side ATE release gate (the role of euroc_eval_examples.sh:62's
    evaluate3.py call): evaluate the finished System's frame trajectory
    against `gt_path`, print ONE machine-readable JSON line, and write
    ate.json into the results directory."""
    import json
    import os

    ate = evaluate_trajectory(system.tracker.trajectory, gt_path,
                              with_scale=with_scale)
    line = {
        "ate_rmse": ate.get("rmse"),
        "ate_mean": ate.get("mean"),
        "ate_median": ate.get("median"),
        "n_associated": ate.get("n"),
        "scale": ate.get("scale", 1.0),
        "n_frames_tracked": len(system.tracker.trajectory),
        "gt": os.path.basename(gt_path),
    }
    print("ATE " + json.dumps(line))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ate.json"), "w") as f:
        json.dump(line, f, indent=1)
    return line
