"""Synthetic stereo-inertial sequence renderer with exact ground truth.

Port of fasttrack_tpu/datasets/synthetic.py (NumPy and SciPy only; the same
seed gives the same images, bit for bit).

Stands in for EuRoC/TUM-VI when no dataset is on disk (this build
environment has no network): a camera rig moves in front of a textured
plane; images are rendered by exact ray-plane intersection + bilinear
texture sampling, IMU samples are derived analytically from the continuous
trajectory. Used by the end-to-end tracking tests and the self-contained
demo script.

`generate_sequence(rig=...)` renders the two camera rigs of the reference's
datasets instead of the default rectified pinhole pair: a distorted
(radial-tangential) pinhole pair as EuRoC ships it, or a Kannala-Brandt-8
fisheye pair as TUM-VI does, camera 2 posed by a rotated T_c1_c2 and the
IMU stream expressed in a body frame rotated from camera 1. Without `rig`
the output is bit-equal to the JAX package's renderer.

`render_depth` / `sequence_depths` / `generate_rgbd_sequence` give the
metric depth map of each rendered pinhole frame from the renderer's own
geometry (an RGB-D camera's input); the images are the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.ndimage import map_coordinates, zoom

from fasttrack_tpu_torch.cameras.host import HostCamera, unproject_np
from fasttrack_tpu_torch.cameras.rectify import distort_pinhole
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


class Rig(NamedTuple):
    """A rendered stereo rig. `kind` "radtan": pinhole intrinsics
    [fx fy cx cy] with plumb-bob distortion D = [k1 k2 p1 p2 (k3)] per
    camera; "kb8": [fx fy cx cy k0 k1 k2 k3] per camera and no D."""

    kind: str
    params1: np.ndarray
    params2: np.ndarray
    T_c1_c2: np.ndarray            # 4x4 camera 1 <- camera 2
    R_bc: np.ndarray               # 3x3 body <- camera 1 (zero lever arm)
    dist1: np.ndarray | None = None
    dist2: np.ndarray | None = None
    # a fisheye's image circle: rays further off the axis than `fov_deg`
    # fade to black over FOV_FADE_DEG (where the plane would be seen at a
    # grazing angle, its texture aliased to noise)
    fov_deg: float | None = None


FOV_FADE_DEG = 15.0
# both rigs: camera 2 rotated about x from camera 1, the body rotated from
# camera 1 about z (EuRoC's cam0 and TUM-VI's cam0 sit in their bodies
# nearly so)
TILT_X_DEG = 0.8
BODY_YAW_DEG = 90.0
# the KB8 rig's image circle, off the axis, by default: past ~75 deg the
# plane is seen at grazing angles and its texture aliases to noise
KB8_FOV_DEG = 75.0
# fixed-point steps that invert the plumb-bob distortion per pixel
RADTAN_INVERSE_ITERS = 50
FG_OFFSET_M = 1.5        # the foreground squares stand this far in front of the plane


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s_ = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s_, s_
    return R


def _extrinsic(baseline: float, tilt_x: float) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rot(0, tilt_x)
    T[:3, 3] = [baseline, 0.0, 0.0]
    return T


def euroc_radtan_rig(w: int = 752, h: int = 480, tilt_x_deg: float = TILT_X_DEG) -> Rig:
    """A distorted pinhole pair with EuRoC cam0's intrinsics and radtan
    coefficients (scaled to w x h from 752 x 480), camera 2 0.11 m along x
    and rotated `tilt_x_deg` about x, the body rotated from camera 1 by
    BODY_YAW_DEG about z."""
    sx, sy = w / 752.0, h / 480.0
    p1 = np.array([458.654 * sx, 457.296 * sy, 367.215 * sx, 248.375 * sy])
    p2 = np.array([457.587 * sx, 456.134 * sy, 379.999 * sx, 255.238 * sy])
    return Rig("radtan", p1, p2, _extrinsic(0.11, np.deg2rad(tilt_x_deg)),
               _rot(2, np.deg2rad(BODY_YAW_DEG)),
               np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
               np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05]))


def tumvi_kb8_rig(w: int = 512, h: int = 512, baseline: float = 0.101,
                  fov_deg: float = KB8_FOV_DEG) -> Rig:
    """A KB8 fisheye pair with TUM-VI's intrinsics and coefficients
    (512 x 512; scaled to w x h), posed as `euroc_radtan_rig`'s, its image
    circle `fov_deg` off the axis."""
    sx, sy = w / 512.0, h / 512.0
    k = [0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
         0.00020293673591811182]
    p1 = np.array([190.97847715128717 * sx, 190.9733070521226 * sy,
                   254.93170605935475 * sx, 256.8974428996504 * sy, *k])
    p2 = np.array([190.44236969414825 * sx, 190.4344384721956 * sy,
                   252.59949716835982 * sx, 254.91723064636983 * sy,
                   0.0034003170790442797, 0.001766278153469831,
                   -0.00266312569781606, 0.0003299517423931039])
    return Rig("kb8", p1, p2, _extrinsic(baseline, np.deg2rad(TILT_X_DEG)),
               _rot(2, np.deg2rad(BODY_YAW_DEG)), fov_deg=fov_deg)


def pixel_rays(kind: str, params, dist, h: int, w: int) -> np.ndarray:
    """(h, w, 3) rays with z == 1 through every pixel of a camera: "kb8" by
    the host unprojection, "radtan" by inverting the plumb-bob distortion
    per pixel (fixed-point steps; the distortion is monotonic over the
    image for EuRoC's coefficients)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.asarray(params, np.float64)
    if kind == "kb8":
        return unproject_np(HostCamera("kb8", p, w, h), np.stack([xs, ys], -1))
    xd = (xs - p[2]) / p[0]
    yd = (ys - p[3]) / p[1]
    x, y = xd.copy(), yd.copy()
    for _ in range(RADTAN_INVERSE_ITERS):
        xt, yt = distort_pinhole(np.asarray(dist, np.float64), x, y)
        x += xd - xt
        y += yd - yt
    return np.stack([x, y, np.ones_like(x)], -1)


def _world_rays(K, R_wc, h, w, camera=None, rays=None):
    """(dw, tden): every pixel's ray in the world frame, and its world z
    kept off zero, as the ray-plane intersection divides by it."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if rays is not None:
        d = rays        # (h, w, 3) per-pixel rays of a camera (pixel_rays)
    elif camera is not None:
        # arbitrary camera model (a cameras.host.HostCamera, e.g. KB8
        # fisheye) via host unprojection
        d = unproject_np(camera, np.stack([xs, ys], -1))
    else:
        d = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1
        )
    dw = d @ R_wc.T  # world direction per pixel
    tden = np.where(np.abs(dw[..., 2]) < 1e-9, 1e-9, dw[..., 2])
    return dw, tden


def _plane_hit(dw, tden, t_wc, z_plane):
    """(tt, px, py): each ray's parameter at the plane z = z_plane and the
    world x, y it meets there. A ray whose camera z is 1 (a pinhole ray)
    meets it at camera depth tt."""
    tt = (z_plane - t_wc[2]) / tden
    px = t_wc[0] + tt * dw[..., 0]
    py = t_wc[1] + tt * dw[..., 1]
    return tt, px, py


def _in_square(px, py, center):
    """The mask of a foreground square (+-1.3 x +-1.0 m about `center`)."""
    return (np.abs(px - center[0]) < 1.3) & (np.abs(py - center[1]) < 1.0)


def _render(tex, scale_px, K, R_wc, t_wc, h, w, plane_z, camera=None,
            fg_centers=((0.0, 0.0),), rays=None):
    """Render a two-depth scene from camera pose (R_wc, t_wc).

    Background plane at z=plane_z plus foreground textured squares at
    z = plane_z - 1.5, each covering +-1.3 x +-1.0 m around a center in
    `fg_centers`. A single fronto-parallel plane leaves camera-z nearly
    unobservable for visual-only pose estimation (~20 px/m here) — the
    estimate random-walks away and tracking collapses; the depth
    discontinuity restores full 6-DOF observability, like any real indoor
    scene. Long loop trajectories pass several centers so depth structure
    stays in view over the whole lap."""
    dw, tden = _world_rays(K, R_wc, h, w, camera, rays)
    # background
    _, pxb, pyb = _plane_hit(dw, tden, t_wc, plane_z)
    ub = pxb * scale_px + tex.shape[1] / 2
    vb = pyb * scale_px + tex.shape[0] / 2
    img = map_coordinates(tex, [vb, ub], order=1, mode="wrap")
    # foreground squares (offset texture coords decorrelate their pattern)
    z_near = plane_z - FG_OFFSET_M
    _, pxf, pyf = _plane_hit(dw, tden, t_wc, z_near)
    for k, center in enumerate(fg_centers):
        fg = _in_square(pxf, pyf, center)
        uf = pxf * scale_px + tex.shape[1] / 2 + tex.shape[1] // 3 \
            + k * (tex.shape[1] // 5)
        vf = pyf * scale_px + tex.shape[0] / 2 + tex.shape[0] // 3
        img_f = map_coordinates(tex, [vf, uf], order=1, mode="wrap")
        img = np.where(fg, img_f, img)
    return img.astype(np.float32)


def render_depth(K, R_wc, t_wc, h, w, plane_z, fg_centers=((0.0, 0.0),)) -> np.ndarray:
    """The metric depth map (camera z, float32) of what `_render` draws
    through the pinhole `K` from the pose (R_wc, t_wc): each pixel's ray
    parameter at the foreground square it meets (the same mask as the
    image's), else at the background plane. A pinhole ray has camera z = 1,
    so the parameter is the depth. Test data for the RGB-D sensor; the
    images are not touched."""
    dw, tden = _world_rays(K, R_wc, h, w)
    depth, _, _ = _plane_hit(dw, tden, t_wc, plane_z)
    tt_f, pxf, pyf = _plane_hit(dw, tden, t_wc, plane_z - FG_OFFSET_M)
    for center in fg_centers:
        depth = np.where(_in_square(pxf, pyf, center), tt_f, depth)
    return depth.astype(np.float32)


def sequence_depths(seq: SyntheticSequence) -> list:
    """Camera 1's depth map of every frame of a `generate_sequence` output
    rendered with its defaults (the pinhole pair, the plane at 4 m, the
    sweep's one square): one float32 array a frame."""
    K = np.array([[seq.fx, 0, seq.cx], [0, seq.fy, seq.cy], [0, 0, 1.0]])
    h, w = seq.frames[0].left.shape
    return [render_depth(K, f.R_wc, f.t_wc, h, w, 4.0) for f in seq.frames]


def generate_rgbd_sequence(n_frames, h, w, fps=20.0, seed=0):
    """`generate_sequence`'s sweep (its IMU stream, camera 1 as the body
    frame) with every frame's exact depth map: (sequence, depths)."""
    seq = generate_sequence(n_frames=n_frames, h=h, w=w, fps=fps, seed=seed)
    return seq, sequence_depths(seq)


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
    rig: Rig | None = None,
) -> SyntheticSequence:
    """trajectory="sweep" (default): the small oscillation used by the unit
    tests. trajectory="loop": long lateral laps that RETURN to the start —
    every lap revisits earlier views, giving loop-closure opportunities and
    the accumulate-then-correct drift profile of a real EuRoC MH lap
    (euroc_eval_examples.sh sequences).

    `rig`: render its two cameras instead (camera 1 on the trajectory,
    camera 2 at camera 1's pose times `rig.T_c1_c2`; `baseline` is ignored)
    and give the IMU stream in the rig's body frame (f_b = R_bc f_c,
    w_b = R_bc w_c); fx, fy, cx, cy are camera 1's and `baseline` the
    length of T_c1_c2's translation. The ground truth is camera 1's."""
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

    rays1 = rays2 = None
    R_12, t_12 = np.eye(3), np.array([baseline, 0, 0])
    fade1 = fade2 = None
    if rig is not None:
        rays1 = pixel_rays(rig.kind, rig.params1, rig.dist1, h, w)
        rays2 = pixel_rays(rig.kind, rig.params2, rig.dist2, h, w)
        if rig.fov_deg is not None:
            fade1, fade2 = (np.clip((rig.fov_deg - np.degrees(np.arctan(np.hypot(
                r[..., 0], r[..., 1])))) / FOV_FADE_DEG, 0.0, 1.0).astype(np.float32)
                for r in (rays1, rays2))
        R_12, t_12 = rig.T_c1_c2[:3, :3], rig.T_c1_c2[:3, 3]
        fx, fy, cx, cy = (float(v) for v in rig.params1[:4])
        baseline = float(np.linalg.norm(t_12))

    frames = []
    gt_pos, gt_R, gt_t = [], [], []
    for i in range(n_frames):
        t = i / fps
        R_wc, t_wc = pose_at(t)
        left = _render(tex, scale_px, K, R_wc, t_wc, h, w, plane_z,
                       fg_centers=fg_centers, rays=rays1)
        t_wc_r = t_wc + R_wc @ t_12
        R_wc_r = R_wc if rig is None else R_wc @ R_12
        right = _render(tex, scale_px, K, R_wc_r, t_wc_r, h, w, plane_z,
                        fg_centers=fg_centers, rays=rays2)
        if fade1 is not None:
            left, right = left * fade1, right * fade2
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
    if rig is not None:
        acc = np.asarray(acc) @ rig.R_bc.T
        gyr = np.asarray(gyr) @ rig.R_bc.T

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


def _loop_cloud(rng):
    """The 300-point cloud and its +-1 descriptors of the loop scenes, the
    first draws of `rng` (as tests/test_gba_merge.py's build_map draws them)."""
    pts_w = np.stack([rng.uniform(-3, 3, 300), rng.uniform(-2, 2, 300),
                      rng.uniform(5, 9, 300)], -1)
    descs = 2 * rng.integers(0, 2, size=(300, 256)).astype(np.uint8).astype(np.int8) - 1
    return pts_w, descs


def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])


def drifted_loop_scene(slam_map, seed=0, inertial=False):
    """(atlas, outbound keyframes, return keyframes, descriptors, drift): an
    outbound leg of 6 keyframes with clean poses over a 300-point cloud, and
    a return leg of 3 keyframes over the same places whose poses and points
    carry a drift of 0.06 rad and (0.25, -0.15, 0.1); `drift(kfs)` is the
    largest distance of the return leg's camera centres from the truth.

    With `inertial=True` the map is inertial and IMU-initialized and the
    keyframes (1 s apart, 0.4 along x) carry velocities consistent with
    their stored frames: (0.4, 0, 0) on the outbound leg, that velocity
    rotated by the drift on the return leg."""
    pts_w, descs = _loop_cloud(np.random.default_rng(seed))
    atlas = slam_map.Atlas()
    out = _loop_leg(slam_map, atlas, pts_w, descs, 6)
    Rd = _rot_z(0.06)
    back = _loop_leg(slam_map, atlas, pts_w, descs, 3, kf_x0=0.4,
                     world_T=(Rd, np.array([0.25, -0.15, 0.1])))
    if inertial:
        m = atlas.current
        m.is_inertial = m.imu_initialized = True
        v = np.array([0.4, 0.0, 0.0])
        for kf in out:
            kf.velocity = v.copy()
        for kf in back:
            kf.velocity = Rd @ v

    def drift(kfs):
        return max(np.linalg.norm(kf.center - np.array([0.4 + 0.4 * k, 0, 0]))
                   for k, kf in enumerate(kfs))

    return atlas, out, back, descs, drift


def two_map_scene(slam_map):
    """(atlas, old map, new map, old keyframes, new keyframes, descriptors):
    tracking, a loss, then a new map over the same places. The old map has
    8 keyframes 0.4 apart along x over a 300-point cloud; then
    `atlas.create_new_map()` and 4 keyframes from x = 0.8 over the same
    cloud and descriptors, with their own points, in a frame offset from
    the old one by a 0.15 rad yaw and (0.7, -0.4, 0.2). The new keyframes'
    true camera centres in the old frame are (0.8 + 0.4 k, 0, 0)."""
    pts_w, descs = _loop_cloud(np.random.default_rng(0))
    atlas = slam_map.Atlas()
    m_old = atlas.current
    kfs_a = _loop_leg(slam_map, atlas, pts_w, descs, 8)
    m_new = atlas.create_new_map()
    kfs_b = _loop_leg(slam_map, atlas, pts_w, descs, 4, kf_x0=0.8,
                      world_T=(_rot_z(0.15), np.array([0.7, -0.4, 0.2])))
    return atlas, m_old, m_new, kfs_a, kfs_b, descs


def noisy_leg_scene(slam_map):
    """(atlas, keyframes, cloud, descriptors): tests/test_gba_merge.py's
    drifted straight leg for the global BA, 12 keyframes over the 300-point
    cloud whose k-th pose carries a translation error of 0.01 k times a
    standard normal draw (points exact)."""
    rng = np.random.default_rng(0)
    pts_w, descs = _loop_cloud(np.random.default_rng(1))
    atlas = slam_map.Atlas()
    kfs = _loop_leg(slam_map, atlas, pts_w, descs, 12)
    for k, kf in enumerate(kfs):
        kf.set_pose(kf.R_cw, kf.t_cw + rng.normal(size=3) * 0.01 * k)
    return atlas, kfs, pts_w, descs


def drifted_leg_scene(slam_map):
    """(atlas, keyframes, bad): tests/test_parallel.py's scene for a local
    BA sharded over a mesh, tests/test_gba_merge.py's build_map(atlas,
    default_rng(0), n_kf=6, pose_noise=0.008): 6 keyframes 0.4 apart over the
    300-point cloud, the k-th pose's translation off by 0.008 k times a
    standard normal draw; then 4 observations of the fifth keyframe (its
    features 0, 3, 6 and 9) moved by 45 px, the chi2 outliers an adjustment
    must drop, listed in `bad` as (feature, map point id)."""
    rng = np.random.default_rng(0)
    pts_w, descs = _loop_cloud(rng)
    atlas = slam_map.Atlas()
    kfs = _loop_leg(slam_map, atlas, pts_w, descs, 6)
    for k, kf in enumerate(kfs):
        kf.set_pose(kf.R_cw, kf.t_cw + rng.normal(size=3) * 0.008 * k)
    bad = []
    for fi in range(0, 12, 3):
        mid = int(kfs[-2].mp_ids[fi])
        if mid >= 0:
            kfs[-2].kp_uv[fi] = kfs[-2].kp_uv[fi] + np.float32(45.0)
            bad.append((fi, mid))
    return atlas, kfs, bad


def mean_reprojection_error(m, kf_ids=None) -> float:
    """Mean pixel distance between the loop scenes' keypoints and their map
    points projected through the keyframes' poses (LOOP_FX, LOOP_W, LOOP_H),
    over the keyframes `kf_ids` (default: all) and points in front by 0.5."""
    errs = []
    for kid in (m.keyframes if kf_ids is None else kf_ids):
        kf = m.keyframes[kid]
        for fi, mid in enumerate(kf.mp_ids):
            mp = m.mappoints.get(int(mid)) if mid >= 0 else None
            if mp is None:
                continue
            Xc = kf.R_cw @ mp.position + kf.t_cw
            if Xc[2] < 0.5:
                continue
            uv = np.array([LOOP_FX * Xc[0] / Xc[2] + LOOP_W / 2,
                           LOOP_FX * Xc[1] / Xc[2] + LOOP_H / 2])
            errs.append(np.linalg.norm(uv - kf.kp_uv[fi]))
    return float(np.mean(errs))
