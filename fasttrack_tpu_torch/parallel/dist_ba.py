"""Distributed bundle adjustment and sharded frame extraction over a mesh.

Port of fasttrack_tpu/parallel/dist_ba.py. The landmarks of a BA window
split into equal contiguous shards along the mesh's axis ("map"); each
shard builds the Schur contributions of its landmarks (optim.ba_core, the
same math as the window solver), the reduced camera system is summed over
the shards, every process solves the (small, dense) 6K x 6K system itself,
and each shard back-substitutes its own points. Frame batches split over
the same shards for extraction.

Where the JAX package lets XLA insert the psum of a `shard_map`, the port
sums explicitly: within a process the shards' partial systems are added on
the mesh's first device, pairwise in shard order; across processes one
`torch.distributed.all_reduce` runs on the mesh's process group
(multihost.py makes one). The pairwise order makes 2 processes x 4 shards
add exactly what 1 process x 8 shards adds. A mesh may hold one device
several times: its shards then run one after another on that device, the
counterpart of the JAX package's virtual CPU devices, so the CPU tests and
one card can run any number of shards.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from fasttrack_tpu_torch.cameras.models import Camera
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.optim import ba_core
from fasttrack_tpu_torch.optim.local_ba import BAProblem
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO

DEAD_OBSERVATION_COST = 1e4     # what an observation behind its camera adds to the cost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices, in order, along `axis`; `group` is the
    process group the shards of all processes form (None within one
    process). Global shards = local shards x the group's size."""

    devices: tuple
    axis: str = "map"
    group: object = None

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The global number of shards."""
        return len(self.devices) * self.world_size


def make_mesh(n_devices: int | None = None, axis: str = "map", device=None) -> Mesh:
    """With no `device`: every visible CUDA device in order (the first
    `n_devices` of them), and a raise where there is no card. With a device
    ("cpu" or one CUDA device): `n_devices` (default 1) shards on that one
    device."""
    if device is None:
        first = resolve()
        if first.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if n_devices is not None:
                if not 0 < n_devices <= len(devices):
                    raise ValueError(f"asked for {n_devices} CUDA devices, {len(devices)} visible")
                devices = devices[:n_devices]
            return Mesh(tuple(devices), axis)
        device = first
    device = resolve(device)
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return Mesh((device,) * n, axis)


class ShardedBAProblem(NamedTuple):
    """A BA window split along its landmarks: this process's shards, each a
    BAProblem on its shard's device holding the cameras (replicated) and
    its contiguous slice of the landmarks."""

    shards: tuple


def shard_ba_problem(problem: BAProblem, mesh: Mesh) -> ShardedBAProblem:
    """The same whole window, given to every process -> the slices that
    this process's shards own, the cameras replicated on each: global
    shard j holds landmarks [j L / S, (j + 1) L / S) of S = mesh.size. L
    must divide by S, as `shard_map` requires."""
    L = problem.points.shape[0]
    if L % mesh.size:
        raise ValueError(f"{L} landmarks do not split into {mesh.size} equal shards")
    per = L // mesh.size
    first = mesh.rank * len(mesh.devices)
    shards = []
    for j, dev in enumerate(mesh.devices):
        sl = slice((first + j) * per, (first + j + 1) * per)
        shards.append(BAProblem(
            poses=SE3(problem.poses.R.to(dev), problem.poses.t.to(dev)),
            points=problem.points[sl].to(dev),
            obs_uv=problem.obs_uv[sl].to(dev),
            obs_ur=problem.obs_ur[sl].to(dev),
            inv_sigma2=problem.inv_sigma2[sl].to(dev),
            mask=problem.mask[sl].to(dev),
            cam_free=problem.cam_free.to(dev),
            point_free=problem.point_free[sl].to(dev),
        ))
    return ShardedBAProblem(tuple(shards))


# ------------------------------------------------------------------ collectives
def _cpu_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """gloo reduces and gathers host tensors: a card's tensor goes through
    the host. NCCL takes it where it is."""
    return t.device.type == "cuda" and dist.get_backend(mesh.group) != "nccl"


def _all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group is None:
        return t
    if _cpu_staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        return host.to(t.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's `t` concatenated along dim 0 in rank order."""
    if mesh.group is None:
        return t
    dtype = t.dtype
    x = t.to(torch.uint8) if dtype == torch.bool else t
    if _cpu_staged(mesh, x):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts).to(device=t.device, dtype=dtype)


def _tree_sum(parts: list) -> torch.Tensor:
    """Pairwise sum in order: ((p0 + p1) + (p2 + p3)) + ..."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def _reduce(parts: list, mesh: Mesh) -> torch.Tensor:
    """The shards' partial sums added on the mesh's first device, then over
    the process group."""
    dev0 = mesh.devices[0]
    return _all_reduce_sum(_tree_sum([p.to(dev0) for p in parts]), mesh)


def _gather(parts: list, mesh: Mesh) -> torch.Tensor:
    """The shards' rows in global order, whole on every process, on the
    mesh's first device."""
    dev0 = mesh.devices[0]
    return _all_gather_rows(torch.cat([p.to(dev0) for p in parts]), mesh)


# ------------------------------------------------------------------ the timer
class SectionTimer:
    """The time of each section of `distributed_bundle_adjustment`'s
    iterations, summed over them: CUDA events on the mesh's cards (each
    section from the previous mark to its own; on several cards the
    longest), the host's clock where the mesh is on the CPU. The sections
    follow each other without a gap, so their sum is the loop's time,
    idle stretches of the device included:

    - `shard_compute`: every shard's residuals, Jacobians and Schur blocks;
    - `reduce`: the partial systems (and the cost scalars) added over the
      shards and, across processes, the all-reduce;
    - `solve`: the replicated 6K x 6K solve and the pose update;
    - `backsub`: every shard's point update;
    - `cost`: every shard's cost of the candidate state;
    - `fetch`: the cost's copy to the host and the accept/reject there."""

    SECTIONS = ("shard_compute", "reduce", "solve", "backsub", "cost", "fetch")

    def __init__(self, mesh: Mesh):
        self._cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
        self._marks: list = []

    def _stamp(self):
        if not self._cards:
            return time.perf_counter()
        events = []
        for d in self._cards:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(d))
            events.append(e)
        return events

    def start(self):
        self._marks.append((None, self._stamp()))

    def mark(self, section: str):
        self._marks.append((section, self._stamp()))

    def totals_ms(self) -> dict:
        """{section: ms summed over the iterations}."""
        for d in self._cards:
            torch.cuda.synchronize(d)
        out = dict.fromkeys(self.SECTIONS, 0.0)
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            if name is None:
                continue
            if self._cards:
                out[name] += max(ea.elapsed_time(eb) for ea, eb in zip(a, b))
            else:
                out[name] += (b - a) * 1e3
        return out


def _mark(timer, section):
    if timer is not None:
        timer.mark(section)


# ------------------------------------------------------------------ one shard
class _Shard(NamedTuple):
    problem: BAProblem
    cam: Camera
    bf: torch.Tensor


def _shards(sp: ShardedBAProblem, cam: Camera, bf) -> list:
    """Each shard with the camera and bf on its device, bf in the window's
    floating type."""
    out = []
    for sh in sp.shards:
        dev, dt = sh.points.device, sh.points.dtype
        out.append(_Shard(sh, dataclasses.replace(cam, params=cam.params.to(dev)),
                          torch.as_tensor(bf).to(device=dev, dtype=dt)))
    return out


def _poses_on(poses: SE3, dev) -> SE3:
    return SE3(poses.R.to(dev), poses.t.to(dev))


def _linearize(s: _Shard, poses: SE3, points, lam):
    """One shard's Schur contributions at (poses, points) (JAX
    `_ba_shard_step` up to its psum)."""
    p = s.problem
    r, behind = ba_core.residuals(poses, points, s.cam, s.bf, p.obs_uv, p.obs_ur)
    live = p.mask.to(r.dtype) * (~behind) * torch.isfinite(r).all(dim=-1)
    r = torch.where(live[..., None] > 0, r, 0.0)
    _, w = ba_core.robust_weights(r, live, p.inv_sigma2, p.obs_ur, True)
    Jc, Jp = ba_core.jacobians(poses, points, s.cam, s.bf, p.obs_uv, p.obs_ur)
    dead = (live <= 0)[..., None, None]
    Jc = torch.where(dead | ~torch.isfinite(Jc), 0.0, Jc)
    Jp = torch.where(dead | ~torch.isfinite(Jp), 0.0, Jp)
    return ba_core.schur_camera_contrib(Jc, Jp, r, w, lam, points.dtype)


def _cost(s: _Shard, poses: SE3, points) -> torch.Tensor:
    """One shard's chi2 over its live observations plus
    DEAD_OBSERVATION_COST for each observation behind its camera or with a
    non-finite residual, so that the accept test cannot prefer a state that
    throws points behind the cameras (JAX `_ba_shard_cost`)."""
    p = s.problem
    r, behind = ba_core.residuals(poses, points, s.cam, s.bf, p.obs_uv, p.obs_ur)
    alive = ~behind & torch.isfinite(r).all(dim=-1)
    mask = p.mask.to(r.dtype)
    live = mask * alive
    r = torch.where(live[..., None] > 0, r, 0.0)
    chi2, _ = ba_core.robust_weights(r, live, p.inv_sigma2, p.obs_ur, True)
    return torch.sum(chi2) + torch.sum(mask * ~alive) * DEAD_OBSERVATION_COST


def _classify(s: _Shard, poses: SE3, points):
    """One shard's per-observation chi2 and inlier classification, with no
    collective (JAX `_ba_shard_chi2`)."""
    p = s.problem
    r, behind = ba_core.residuals(poses, points, s.cam, s.bf, p.obs_uv, p.obs_ur)
    r = torch.where(torch.isfinite(r), r, 1e6)
    chi2 = torch.sum(r * r, dim=-1) * p.inv_sigma2
    delta2 = torch.where(p.obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
    return p.mask & (chi2 <= delta2) & ~behind, chi2


# ------------------------------------------------------------------ the solver
def _step(shards: list, mesh: Mesh, poses: SE3, points: list, lam: float, timer=None):
    """One damped Gauss-Newton step: (new poses on the first device, the
    shards' new points)."""
    dev0 = mesh.devices[0]
    dt = points[0].dtype
    parts = []
    for s, pts in zip(shards, points):
        dev = pts.device
        lam_d = torch.full((), lam, dtype=dt, device=dev)
        parts.append(_linearize(s, _poses_on(poses, dev), pts, lam_d))
    _mark(timer, "shard_compute")
    K = poses.R.shape[0]
    total = _reduce([torch.cat([S.reshape(-1), rhs.reshape(-1), Hcc.reshape(-1)])
                     for S, rhs, Hcc, *_ in parts], mesh)
    n_s, n_r = 36 * K * K, 6 * K
    S_off = total[:n_s].reshape(K, K, 6, 6)
    rhs = total[n_s:n_s + n_r].reshape(K, 6)
    Hcc = total[n_s + n_r:].reshape(K, 6, 6)
    _mark(timer, "reduce")
    lam0 = torch.full((), lam, dtype=dt, device=dev0)
    cam_free = shards[0].problem.cam_free.to(dev0)
    dxc = ba_core.assemble_and_solve(S_off, rhs, Hcc, lam0, cam_free, dt)
    new_poses = ba_core.apply_pose_update(poses, dxc)
    _mark(timer, "solve")
    new_points = []
    for s, pts, (_, _, _, Hpp_inv, Hcp, bp) in zip(shards, points, parts):
        dx = dxc.to(pts.device)
        new_points.append(pts + ba_core.backsub_points(Hpp_inv, Hcp, bp, dx, s.problem.point_free))
    _mark(timer, "backsub")
    return new_poses, new_points


def _total_cost(shards: list, mesh: Mesh, poses: SE3, points: list, timer=None) -> float:
    costs = [_cost(s, _poses_on(poses, pts.device), pts) for s, pts in zip(shards, points)]
    _mark(timer, "cost")
    total = _reduce(costs, mesh)
    _mark(timer, "reduce")
    return float(total)


def _start(problem, cam, bf, mesh):
    sp = problem if isinstance(problem, ShardedBAProblem) else shard_ba_problem(problem, mesh)
    shards = _shards(sp, cam, bf)
    poses = _poses_on(sp.shards[0].poses, mesh.devices[0])
    return shards, poses, [s.problem.points for s in shards]


def distributed_ba_iteration(problem, cam: Camera, bf, mesh: Mesh, lam: float = 1e-4):
    """One damped Gauss-Newton iteration of the BA window, landmarks sharded
    over the mesh. `problem` is a whole window (a BAProblem, the same on
    every process) or this process's shards (`shard_ba_problem`).
    Returns (poses, points) in the global shapes, on the mesh's first
    device, whole on every process."""
    shards, poses, points = _start(problem, cam, bf, mesh)
    poses, points = _step(shards, mesh, poses, points, lam)
    return poses, _gather(points, mesh)


def distributed_bundle_adjustment(problem, cam: Camera, bf, mesh: Mesh, iters: int = 10,
                                  lam0: float = 1e-4, timer: SectionTimer | None = None):
    """Landmark-sharded Levenberg-Marquardt: damped Gauss-Newton steps with
    the accept/reject on the host (the reference's g2o LM schedule,
    Optimizer.cc:1116), one cost fetch before the loop and one per
    iteration, as in the JAX package: an accepted step halves `lam` (to no
    less than 1e-8), a rejected one quadruples it.

    `problem` as `distributed_ba_iteration` takes it, in the floating type
    to solve in. Returns (poses, points, costs, inlier_mask, chi2): the
    costs of the accepted states (the first is the starting state's), then
    the final per-observation chi2 and its inlier classification, as the
    window solver's BAResult holds them; all in the global shapes and
    order, on the mesh's first device, whole on every process. `timer`
    (a SectionTimer) times the iterations' sections."""
    shards, poses, points = _start(problem, cam, bf, mesh)
    lam = lam0
    c = _total_cost(shards, mesh, poses, points)
    costs = [c]
    if timer is not None:
        timer.start()
    for _ in range(iters):
        cand_poses, cand_points = _step(shards, mesh, poses, points, lam, timer)
        c_new = _total_cost(shards, mesh, cand_poses, cand_points, timer)
        if math.isfinite(c_new) and c_new < c:
            poses, points, c = cand_poses, cand_points, c_new
            lam = max(lam * 0.5, 1e-8)
            costs.append(c)
        else:
            lam = lam * 4.0
        _mark(timer, "fetch")
    classified = [_classify(s, _poses_on(poses, pts.device), pts) for s, pts in zip(shards, points)]
    inlier = _gather([i for i, _ in classified], mesh)
    chi2 = _gather([x for _, x in classified], mesh)
    return poses, _gather(points, mesh), costs, inlier, chi2


# ------------------------------------------------------------------ extraction
def sharded_extract_batch(images, config, mesh: Mesh):
    """ORB features of a batch of frames (B, H, W) (uint8 or float), the
    frames split over the mesh's global shards in order: each shard runs its
    frames through `extract_orb_stacked` on its device. Returns one
    Keypoints whose fields are stacked (B, N) in frame order, on the mesh's
    first device, whole on every process. B must divide by the shard
    count."""
    from fasttrack_tpu_torch.ops.extractor import Keypoints, extract_orb_stacked

    images = torch.as_tensor(images)
    B = images.shape[0]
    if B % mesh.size:
        raise ValueError(f"{B} frames do not split into {mesh.size} equal shards")
    per = B // mesh.size
    first = mesh.rank * len(mesh.devices)
    fields = []
    for j, dev in enumerate(mesh.devices):
        frames = images[(first + j) * per:(first + j + 1) * per].to(dev)
        kps, _ = extract_orb_stacked(frames, config)
        fields.append([torch.stack(f) for f in zip(*kps)])
    return Keypoints(*(_gather(list(f), mesh) for f in zip(*fields)))
