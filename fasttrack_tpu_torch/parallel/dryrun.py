"""The multi-device dry run: the port's counterpart of
`__graft_entry__.dryrun_multichip` and the window of
`tools/bench_multichip.py`.

`make_problem` draws the synthetic covisibility window with the JAX tool's
NumPy calls in the JAX tool's order, so its arrays equal that tool's bit
for bit; it returns them as NumPy (`convert.ba_problem_from_numpy` takes
them to a device). `dryrun_multichip(n)` extracts a batch of tiny frames
over n shards, runs the landmark-sharded LM on a small window and asserts
that its cost falls, then sweeps the K = 40, L = 4,096 window over 1, n/2
and n shards.

    python -m fasttrack_tpu_torch.parallel.dryrun [N] [--device cpu|cuda:0]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.cameras import make_pinhole, project
from fasttrack_tpu_torch.geometry import SE3, se3_apply, se3_exp
from fasttrack_tpu_torch.optim.local_ba import BAProblem
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.parallel.dist_ba import (
    SectionTimer,
    distributed_bundle_adjustment,
    make_mesh,
    sharded_extract_batch,
)

# make_problem's pinhole camera (fx, fy, cx, cy, width, height) and bf
CAMERA = (400.0, 400.0, 376.0, 240.0, 752, 480)
BF = 40.0


def make_problem(K=100, L=10240, obs_per_point=8, seed=0):
    """(arrays, camera, bf, n_obs): a forward trajectory of K keyframes
    0.4 apart viewing L points, each point observed by the `obs_per_point`
    keyframes from its birth on where it projects into the image (0.3 px
    noise); poses and points start perturbed (0.02 and 0.05). `arrays` are
    the BAProblem fields as `convert.BA_FIELDS` names them, float32;
    `camera` is CAMERA."""
    rng = np.random.default_rng(seed)
    bf = BF
    X = np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(6, 20, L) + np.repeat(
            np.linspace(0, 0.4 * K, L // obs_per_point + 1),
            obs_per_point)[:L],
    ], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.stack([np.zeros(K), np.zeros(K), -0.4 * np.arange(K)], -1)
    t = t.astype(np.float32)

    obs_uv = np.zeros((L, K, 2), np.float32)
    obs_ur = np.full((L, K), -1.0, np.float32)
    mask = np.zeros((L, K), bool)
    birth = (np.arange(L) * K // L).astype(np.int32)
    for l in range(L):
        for k in range(birth[l], min(birth[l] + obs_per_point, K)):
            Xc = R[k] @ X[l] + t[k]
            if Xc[2] < 0.5:
                continue
            u = 400.0 * Xc[0] / Xc[2] + 376.0
            v = 400.0 * Xc[1] / Xc[2] + 240.0
            if 0 <= u < 752 and 0 <= v < 480:
                obs_uv[l, k] = (u + rng.normal(0, 0.3), v + rng.normal(0, 0.3))
                obs_ur[l, k] = u - bf / Xc[2]
                mask[l, k] = True

    arrays = {
        "R": R,
        "t": t + rng.normal(0, 0.02, t.shape).astype(np.float32),
        "points": X + rng.normal(0, 0.05, X.shape).astype(np.float32),
        "obs_uv": obs_uv,
        "obs_ur": obs_ur,
        "inv_sigma2": np.ones((L, K), np.float32),
        "mask": mask,
        "cam_free": np.arange(K) >= 2,
        "point_free": np.ones(L, bool),
    }
    return arrays, CAMERA, bf, int(mask.sum())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_solve(problem, cam, bf, mesh, iters):
    """(result, seconds, split in ms per iteration): one warm-up iteration,
    then `iters` timed ones (the host's clock around the synchronised run)
    with their sections (SectionTimer)."""
    dev = mesh.devices[0]
    distributed_bundle_adjustment(problem, cam, bf, mesh, iters=1)
    _sync(dev)
    timer = SectionTimer(mesh)
    t0 = time.perf_counter()
    out = distributed_bundle_adjustment(problem, cam, bf, mesh, iters=iters, timer=timer)
    _sync(dev)
    seconds = time.perf_counter() - t0
    return out, seconds, {k: v / iters for k, v in timer.totals_ms().items()}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Sharded extraction of `n_devices` tiny frames, the sharded LM on a
    K = 4, L = 8 n window (asserting that its cost falls), and the scaling
    sweep of the K = 40, L = 4,096 window over {1, max(2, n // 2), n}
    shards; on `device` (None: every visible card, as make_mesh takes them;
    "cpu" or one card: n shards of it). Prints the JAX entry's two lines and
    returns what they say."""
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)

    # 1) frame-parallel extraction of a batch of n tiny frames
    cfg = OrbConfig(height=64, width=96, n_features=32, n_levels=2)
    small = rng.integers(0, 256, size=(n_devices, 8, 12))
    imgs = np.kron(small, np.ones((1, 8, 8))).astype(np.float32)
    kps = sharded_extract_batch(torch.from_numpy(imgs), cfg, mesh)
    n_kps = int(kps.valid.sum())

    # 2) the sharded LM: landmarks over the mesh, the reduced camera system
    # summed, the 6K x 6K solve replicated, points back-substituted per shard
    K, L = 4, 8 * n_devices
    cam = make_pinhole(100.0, 100.0, 48.0, 32.0, 96, 64, device=dev)
    bf = 10.0
    X = np.stack([rng.uniform(-2, 2, size=L), rng.uniform(-1.5, 1.5, size=L),
                  rng.uniform(4, 10, size=L)], axis=-1).astype(np.float32)
    xi = torch.tensor([[0.1 * k, 0, 0, 0, 0.01 * k, 0] for k in range(K)],
                      dtype=torch.float32, device=dev)
    P = se3_exp(xi)
    Xt = torch.from_numpy(X).to(dev)
    Xc = se3_apply(SE3(P.R[None], P.t[None]), Xt[:, None])
    uv = project(cam, Xc)
    problem = BAProblem(
        poses=P, points=Xt + 0.01, obs_uv=uv, obs_ur=uv[..., 0] - bf / Xc[..., 2],
        inv_sigma2=torch.ones((L, K), device=dev),
        mask=torch.ones((L, K), dtype=torch.bool, device=dev),
        cam_free=torch.arange(K, device=dev) >= 1,
        point_free=torch.ones(L, dtype=torch.bool, device=dev),
    )
    _, _, costs, _, _ = distributed_bundle_adjustment(problem, cam, bf, mesh, iters=5)
    if not (len(costs) >= 2 and costs[-1] < costs[0]):
        raise RuntimeError(f"distributed BA failed to reduce cost: {costs}")
    print(f"dryrun_multichip({n_devices}): extracted {n_kps} kps across {mesh.size} shards "
          f"on {dev}; distributed LM costs {[round(c, 4) for c in costs]}")

    # 3) the scaling sweep on a window of realistic size: iterations a
    # second at 1, n/2 and n shards (shards of one device share it: this
    # measures the sharded program's overhead against n, not an interconnect)
    arrays, cam_args, bf2, n_obs = make_problem(K=40, L=4096, obs_per_point=6)
    sweep = []
    for n in sorted({1, max(2, n_devices // 2), n_devices}):
        m2 = make_mesh(n, device=dev) if device is not None else make_mesh(n)
        d2 = m2.devices[0]
        prob = convert.ba_problem_from_numpy(arrays, d2)
        cam2 = make_pinhole(*cam_args, device=d2)
        distributed_bundle_adjustment(prob, cam2, bf2, m2, iters=1)    # warm-up
        _sync(d2)
        t0 = time.perf_counter()
        _, _, cc, _, _ = distributed_bundle_adjustment(prob, cam2, bf2, m2, iters=3)
        _sync(d2)
        dt = time.perf_counter() - t0
        sweep.append({"n": n, "iters_per_s": round(3 / dt, 2), "cost_final": round(cc[-1], 2)})
    table = {"window": {"kfs": 40, "points": 4096, "obs": n_obs}, "device": str(dev),
             "table": sweep}
    print("dist_ba_scaling " + json.dumps(table))
    return {"kps": n_kps, "costs": costs, "scaling": table}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", help="shards (default: every visible card)")
    ap.add_argument("--device", default=None, help='"cpu" or one card (default: the cards)')
    a = ap.parse_args()
    dryrun_multichip(a.n or torch.cuda.device_count(), device=a.device)
