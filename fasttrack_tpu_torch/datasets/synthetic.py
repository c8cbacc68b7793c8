"""Synthetic stereo-inertial sequence renderer with exact ground truth.

Port of fasttrack_tpu/datasets/synthetic.py (NumPy and SciPy only; the same
seed gives the same images, bit for bit).

Stands in for EuRoC/TUM-VI when no dataset is on disk (this build
environment has no network): a camera rig moves in front of a textured
plane; images are rendered by exact ray-plane intersection + bilinear
texture sampling, IMU samples are derived analytically from the continuous
trajectory. Used by the end-to-end tracking tests and the self-contained
demo script.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.ndimage import map_coordinates, zoom

from fasttrack_tpu_torch.imu.preintegration import GRAVITY_VALUE



def make_texture(rng, size=2048):
    """Multi-scale smooth random field squashed to high contrast.

    Deliberately NOT block/grid structured: axis-aligned periodic textures
    are self-similar, descriptors match the wrong instance, and association
    drift feeds back through the motion model (observed as exponential
    rotation drift). Curved iso-contours of smooth noise give every corner a
    unique neighborhood."""
    field = np.zeros((size, size), np.float32)
    for block, amp in [(128, 1.0), (32, 0.8), (8, 0.5)]:
        g = rng.normal(size=(size // block, size // block)).astype(np.float32)
        field += amp * zoom(g, block, order=3)
    field /= field.std()
    tex = 128.0 + 110.0 * np.tanh(1.5 * field)
    return np.clip(tex, 0, 255)


class SyntheticFrame(NamedTuple):
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    R_wc: np.ndarray  # camera-to-world
    t_wc: np.ndarray


class SyntheticSequence(NamedTuple):
    frames: list
    imu_t: np.ndarray      # (M,)
    imu_acc: np.ndarray    # (M, 3) body-frame specific force
    imu_gyro: np.ndarray   # (M, 3)
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    gt_t: np.ndarray       # (F,)
    gt_pos: np.ndarray     # (F, 3) camera centers (world)
    gt_R: np.ndarray       # (F, 3, 3) R_wc


def _render(tex, scale_px, K, R_wc, t_wc, h, w, plane_z, camera=None,
            fg_centers=((0.0, 0.0),)):
    """Render a two-depth scene from camera pose (R_wc, t_wc).

    Background plane at z=plane_z plus foreground textured squares at
    z = plane_z - 1.5, each covering +-1.3 x +-1.0 m around a center in
    `fg_centers`. A single fronto-parallel plane leaves camera-z nearly
    unobservable for visual-only pose estimation (~20 px/m here) — the
    estimate random-walks away and tracking collapses; the depth
    discontinuity restores full 6-DOF observability, like any real indoor
    scene. Long loop trajectories pass several centers so depth structure
    stays in view over the whole lap."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if camera is not None:
        # arbitrary camera model (a cameras.host.HostCamera, e.g. KB8
        # fisheye) via host unprojection
        from fasttrack_tpu_torch.cameras.host import unproject_np

        d = unproject_np(camera, np.stack([xs, ys], -1))
    else:
        d = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1
        )
    dw = d @ R_wc.T  # world direction per pixel
    tden = np.where(np.abs(dw[..., 2]) < 1e-9, 1e-9, dw[..., 2])

    def plane_hit(z_plane):
        tt = (z_plane - t_wc[2]) / tden
        px = t_wc[0] + tt * dw[..., 0]
        py = t_wc[1] + tt * dw[..., 1]
        return px, py

    # background
    pxb, pyb = plane_hit(plane_z)
    ub = pxb * scale_px + tex.shape[1] / 2
    vb = pyb * scale_px + tex.shape[0] / 2
    img = map_coordinates(tex, [vb, ub], order=1, mode="wrap")
    # foreground squares (offset texture coords decorrelate their pattern)
    z_near = plane_z - 1.5
    pxf, pyf = plane_hit(z_near)
    for k, (cx_f, cy_f) in enumerate(fg_centers):
        fg = (np.abs(pxf - cx_f) < 1.3) & (np.abs(pyf - cy_f) < 1.0)
        uf = pxf * scale_px + tex.shape[1] / 2 + tex.shape[1] // 3 \
            + k * (tex.shape[1] // 5)
        vf = pyf * scale_px + tex.shape[0] / 2 + tex.shape[0] // 3
        img_f = map_coordinates(tex, [vf, uf], order=1, mode="wrap")
        img = np.where(fg, img_f, img)
    return img.astype(np.float32)


def generate_sequence(
    n_frames=40,
    h=240,
    w=320,
    fps=20.0,
    imu_rate=200.0,
    baseline=0.11,
    plane_z=4.0,
    seed=0,
    motion_scale=1.0,
    trajectory="sweep",
) -> SyntheticSequence:
    """trajectory="sweep" (default): the small oscillation used by the unit
    tests. trajectory="loop": long lateral laps that RETURN to the start —
    every lap revisits earlier views, giving loop-closure opportunities and
    the accumulate-then-correct drift profile of a real EuRoC MH lap
    (euroc_eval_examples.sh sequences)."""
    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    # Longer focal keeps stereo well-conditioned: disparity = fx*b/z ~ 7 px
    # at the plane distance (matches EuRoC's bf/z regime).
    fx = fy = 0.8 * w
    cx, cy = w / 2, h / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    scale_px = 110.0  # texture pixels per world meter

    T_total = n_frames / fps

    # Keep accelerations hand-held-realistic: the sinusoid period never
    # drops below 3 s no matter how short the sequence (peak accel ~2 m/s^2;
    # at T=1.5 s it would be ~17 m/s^2 and any visual tracker falls over).
    P = max(T_total, 3.0)

    def pose_sweep(t):
        """Smooth lateral+vertical translation with mild yaw/roll."""
        s = motion_scale
        pos = np.array(
            [
                0.5 * s * np.sin(2 * np.pi * t / P),
                0.25 * s * np.sin(4 * np.pi * t / P + 0.5),
                0.1 * s * np.sin(2 * np.pi * t / P + 1.0),
            ]
        )
        yaw = 0.05 * s * np.sin(2 * np.pi * t / P)
        roll = 0.03 * s * np.sin(4 * np.pi * t / P)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cr, sr = np.cos(roll), np.sin(roll)
        Rz = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        return Rz @ Rx, pos

    def pose_loop(t):
        """Laps of a wide lateral circuit (~5 m across) with gentle height
        and depth modulation and a slow yaw scan; each lap period P_lap
        revisits the same views. Peak accel ~0.9 m/s^2 at the defaults."""
        s = motion_scale
        P_lap = max(min(T_total / 2.0, 30.0), 10.0)  # >=2 laps when long
        w1 = 2 * np.pi / P_lap
        pos = np.array(
            [
                2.5 * s * np.sin(w1 * t),
                0.5 * s * np.sin(2 * w1 * t + 0.7),
                0.3 * s * (np.cos(w1 * t) - 1.0),
            ]
        )
        yaw = 0.12 * s * np.sin(w1 * t + 0.3)
        roll = 0.04 * s * np.sin(2 * w1 * t)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cr, sr = np.cos(roll), np.sin(roll)
        Rz = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        return Rz @ Rx, pos

    def pose_rotation_only(t):
        """Pure rotation about the camera center (in-plane roll + a gentle
        scan): zero parallax, so monocular two-view initialization MUST
        refuse to build a map (TwoViewReconstruction CheckRT parallax
        gates); the failure mode real handheld footage shows when the user
        pivots in place."""
        s = motion_scale
        roll = 0.25 * s * np.sin(2 * np.pi * t / P)
        yaw = 0.06 * s * np.sin(4 * np.pi * t / P + 0.4)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cr, sr = np.cos(roll), np.sin(roll)
        Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, cy_, -sy], [0, sy, cy_]])
        return Rz @ Rx, np.zeros(3)

    pose_at = {
        "loop": pose_loop,
        "rotation_only": pose_rotation_only,
    }.get(trajectory, pose_sweep)
    fg_centers = (
        ((-3.2, 0.0), (0.0, 0.0), (3.2, 0.0)) if trajectory == "loop"
        else ((0.0, 0.0),)
    )

    frames = []
    gt_pos, gt_R, gt_t = [], [], []
    for i in range(n_frames):
        t = i / fps
        R_wc, t_wc = pose_at(t)
        left = _render(tex, scale_px, K, R_wc, t_wc, h, w, plane_z,
                       fg_centers=fg_centers)
        t_wc_r = t_wc + R_wc @ np.array([baseline, 0, 0])
        right = _render(tex, scale_px, K, R_wc, t_wc_r, h, w, plane_z,
                        fg_centers=fg_centers)
        frames.append(SyntheticFrame(t, left, right, R_wc, t_wc))
        gt_pos.append(t_wc)
        gt_R.append(R_wc)
        gt_t.append(t)

    # IMU: body frame == camera frame. Specific force f_b = R^T (a_w - g_w),
    # with g_w = (0, 0, -9.81); gyro w_b from finite-difference of R.
    dt = 1.0 / imu_rate
    ts = np.arange(0.0, T_total, dt)
    eps = 1e-4
    acc, gyr = [], []
    g_w = np.array([0.0, 0.0, -GRAVITY_VALUE])
    for t in ts:
        _, p0 = pose_at(max(t - eps, 0))
        R1, p1 = pose_at(t)
        _, p2 = pose_at(t + eps)
        a_w = (p2 - 2 * p1 + p0) / eps**2
        acc.append(R1.T @ (a_w - g_w))
        R2, _ = pose_at(t + eps)
        dR = R1.T @ R2
        # vee(log(dR)) / eps, small-angle
        w_hat = (dR - dR.T) / 2
        gyr.append(np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]]) / eps)

    return SyntheticSequence(
        frames=frames,
        imu_t=ts,
        imu_acc=np.asarray(acc, np.float32),
        imu_gyro=np.asarray(gyr, np.float32),
        fx=fx, fy=fy, cx=cx, cy=cy,
        baseline=baseline,
        gt_t=np.asarray(gt_t),
        gt_pos=np.asarray(gt_pos),
        gt_R=np.asarray(gt_R),
    )


# A drifted loop for the loop closer: tests/test_gba_merge.py's
# TestLoopClosureE2E scene, built with NumPy and the map types of the
# `slam_map` module given (this package's, or the JAX package's in the parity
# tests), and with each map point's viewing normal and distance band as the
# mapper sets them, so that the loop fusion's projection gate admits points.
LOOP_W, LOOP_H, LOOP_FX = 640, 480, 400.0


def _loop_leg(slam_map, atlas, pts_w, descs, n_kf, kf_x0=0.0, world_T=None, max_per_kf=256,
              scale_factor=1.2, n_levels=8):
    """A straight leg of keyframes 0.4 apart along x, looking down +z at the
    point cloud, with one map point per cloud point it sees; `world_T`
    (R_mw, t_mw) puts the leg and its points in a frame drifted from the
    world's (the return leg's accumulated drift, with its own duplicate
    points)."""
    m = atlas.current
    packed = np.packbits((descs > 0).astype(np.uint8), axis=1)
    kfs, mps = [], {}
    for k in range(n_kf):
        t_wc = np.array([kf_x0 + 0.4 * k, 0.0, 0.0])
        Xc = pts_w - t_wc
        uv = np.stack([LOOP_FX * Xc[:, 0] / Xc[:, 2] + LOOP_W / 2,
                       LOOP_FX * Xc[:, 1] / Xc[:, 2] + LOOP_H / 2], -1)
        vis = ((Xc[:, 2] > 1.0) & (uv[:, 0] > 10) & (uv[:, 0] < LOOP_W - 10)
               & (uv[:, 1] > 10) & (uv[:, 1] < LOOP_H - 10))
        idxs = np.where(vis)[0][:max_per_kf]
        n = len(idxs)
        R_cm, t_cm = np.eye(3), -t_wc
        if world_T is not None:
            R_mw, t_mw = world_T
            R_cm, t_cm = R_cm @ R_mw.T, R_cm @ (-R_mw.T @ t_mw) - t_wc
        kid = atlas.next_kf_id()
        kf = slam_map.KeyFrame(
            kid, kid, float(k), R_cm, t_cm, uv[idxs].astype(np.float32),
            np.zeros(n, np.int32), np.zeros(n, np.float32), packed[idxs],
            descs[idxs].astype(np.int8), np.full(n, -1.0, np.float32),
            np.full(n, -1.0, np.float32), np.ones(n, bool),
        )
        m.add_keyframe(kf)
        for fi, pi in enumerate(idxs):
            pid = int(pi)
            if pid not in mps:
                X = pts_w[pid] if world_T is None else world_T[0] @ pts_w[pid] + world_T[1]
                mp = slam_map.MapPoint(atlas.next_mp_id(), X, kid, kid)
                mp.desc_signed = descs[pid].astype(np.int8)
                mp.desc_packed = packed[pid]
                m.add_mappoint(mp)
                mps[pid] = mp
            mps[pid].add_observation(kid, fi)
            kf.mp_ids[fi] = mps[pid].mid
        kfs.append(kf)
    for mp in mps.values():
        mp.update_normal_and_depth(
            {k: m.keyframes[k].center for k in mp.observations},
            m.keyframes[mp.ref_kf_id].center, 0, scale_factor, n_levels)
    for kf in kfs:
        m.update_connections(kf)
    return kfs


def drifted_loop_scene(slam_map, seed=0):
    """(atlas, outbound keyframes, return keyframes, descriptors, drift): an
    outbound leg of 6 keyframes with clean poses over a 300-point cloud, and
    a return leg of 3 keyframes over the same places whose poses and points
    carry a drift of 0.06 rad and (0.25, -0.15, 0.1); `drift(kfs)` is the
    largest distance of the return leg's camera centres from the truth."""
    rng = np.random.default_rng(seed)
    pts_w = np.stack([rng.uniform(-3, 3, 300), rng.uniform(-2, 2, 300),
                      rng.uniform(5, 9, 300)], -1)
    descs = 2 * rng.integers(0, 2, size=(300, 256)).astype(np.uint8).astype(np.int8) - 1
    atlas = slam_map.Atlas()
    out = _loop_leg(slam_map, atlas, pts_w, descs, 6)
    th = 0.06
    Rd = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    back = _loop_leg(slam_map, atlas, pts_w, descs, 3, kf_x0=0.4,
                     world_T=(Rd, np.array([0.25, -0.15, 0.1])))

    def drift(kfs):
        return max(np.linalg.norm(kf.center - np.array([0.4 + 0.4 * k, 0, 0]))
                   for k, kf in enumerate(kfs))

    return atlas, out, back, descs, drift
