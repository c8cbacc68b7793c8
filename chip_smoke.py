"""Smoke run of the PyTorch port (fasttrack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Five phases, each printing a line; any failure raises and exits non-zero:
1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ops/csrc with nvcc (sm_90a);
3. kernel against plain: hamming_penalty_matrix on the card against its
   plain PyTorch version at the tracking path's shapes and a ragged one —
   bitwise equal — and both timed with CUDA events;
4. main path: tracking_hot_path on consecutive 752x480 stereo frames
   (8 levels, 1024 features, a 2048-point local map built from the
   previous frame's stereo keypoints), one packed device->host fetch per
   frame, with per-frame checks and ms/frame;
5. card against CPU: the same frame through the port on the CPU, held to
   the golden-check thresholds (keypoint overlap, descriptor bits, depth).

The line before the last two is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import subprocess
import time

import numpy as np
import torch

from fasttrack_tpu_torch import convert, parity
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.frame_pipeline import (
    pack_frame_for_host,
    pack_hot_path_for_host,
    process_stereo_frame_stacked,
    tracking_hot_path,
    unpack_hot_path,
)
from fasttrack_tpu_torch.geometry import se3_identity
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops.extractor import OrbConfig

H, W = 480, 752
CFG = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
INTRINSICS = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0, as bench.py
BF = 47.9
N_MAP = 2048
N_WARMUP, N_FRAMES = 3, 30
STEP = (3, 5)  # (dy, dx) px the view moves per frame: content moves (-5, -3)
KERNEL_SHAPES = [(1024, 1024), (2048, 1024), (1200, 1000)]


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, iters=50) -> float:
    """Mean ms per call over `iters` calls, CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_inputs(rng, M, N, device):
    q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
    k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
    qp = rng.choice(np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32), M).astype(np.float32)
    kp = rng.choice(np.asarray([0.0, 1e9, 2.0e9, 7.25], np.float32), N).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (q, k, qp, kp))


def phase_kernel(device):
    rng = np.random.default_rng(0)
    kern = hamming_kernel.hamming_penalty_matrix
    plain = hamming_kernel.hamming_penalty_matrix_reference
    rows, max_err = [], 0.0
    for M, N in KERNEL_SHAPES:
        args = kernel_inputs(rng, M, N, device)
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"launch counter did not count at {(M, N)}")
        want = plain(*args)
        check(torch.equal(got, want), f"kernel differs from plain at {(M, N)}")
        max_err = max(max_err, float((got - want).abs().max()))
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: plain(*args))
        k1 = cuda_ms(lambda: kern(*args))
        k2 = cuda_ms(lambda: kern(*args))
        p2 = cuda_ms(lambda: plain(*args))
        rows.append({"shape": [M, N], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2})
    return rows, max_err


def host_frame(f32, desc) -> dict:
    f = f32.cpu().numpy()
    return {"x": f[0], "y": f[1], "level": f[2].astype(np.int32), "valid": f[6] > 0.5,
            "depth": f[5], "desc_packed": desc.cpu().numpy()}


def phase_main_path(device, frames, card):
    cam = make_pinhole(*INTRINSICS, W, H, device=device)
    bf = torch.tensor(BF, device=device)
    min_z = torch.tensor(BF / INTRINSICS[0], device=device)
    T0 = se3_identity(device=device)
    shift = (-float(STEP[1]), -float(STEP[0]))
    n_kp = CFG.total_features

    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(device), CFG, bf, min_z)
    prev = host_frame(*pack_frame_for_host(fd))
    kern = hamming_kernel.hamming_penalty_matrix
    kern.launches = 0
    times, stats, last = [], [], 0
    for i in range(1, len(frames)):
        mp = parity.map_from_frame(prev, INTRINSICS, N_MAP, CFG.n_levels, shift=shift)
        local_map = convert.map_from_numpy(**mp, device=device)
        torch.cuda.synchronize()
        before = kern.launches
        t0 = time.perf_counter()
        images = torch.from_numpy(frames[i]).to(device)
        fd, res, opt = tracking_hot_path(images, CFG, bf, min_z, cam, T0, *local_map)
        buf = pack_hot_path_for_host(fd, res, opt).cpu()   # the frame's one fetch
        dt = (time.perf_counter() - t0) * 1e3
        host = unpack_hot_path(buf.numpy(), n_kp, N_MAP)

        n_valid = int(host["valid"].sum())
        n_stereo = int((host["depth"] > 0).sum())
        n_match = int(host["match_ok"].sum())
        pose_ok = bool(np.isfinite(host["R"]).all() and np.isfinite(host["t"]).all())
        check(kern.launches == before + 2, f"frame {i}: {kern.launches - before} kernel launches, not 2")
        check(n_valid > 0 and n_stereo > 0 and n_match > 0 and pose_ok,
              f"frame {i}: valid={n_valid} stereo={n_stereo} matches={n_match} pose finite={pose_ok}")
        # the pose must explain the matches: reprojection of the inliers
        inl = host["inliers"]
        Xc = mp["pos"] @ host["R"].T + host["t"]
        u = INTRINSICS[0] * Xc[:, 0] / Xc[:, 2] + INTRINSICS[2]
        v = INTRINSICS[1] * Xc[:, 1] / Xc[:, 2] + INTRINSICS[3]
        j = host["match_idx"]
        err = np.hypot(u - host["x"][j], v - host["y"][j])[inl]
        rms = float(np.sqrt(np.mean(err**2))) if inl.any() else float("inf")
        check(host["n_inliers"] >= 0.5 * n_match and rms < 3.0,
              f"frame {i}: {host['n_inliers']} inliers of {n_match} matches, reprojection rms {rms:.2f} px")
        if i > N_WARMUP:
            times.append(dt)
        stats.append((n_valid, n_stereo, n_match, host["n_inliers"], rms))
        prev, last = host, i
    launches = kern.launches
    check(launches == 2 * (len(frames) - 1), f"main path launched the kernel {launches} times")
    s = np.asarray(stats, np.float64)
    print(
        f"phase 4 main path: {len(times)} timed frames (+{N_WARMUP} warm-up) at {W}x{H}, "
        f"{CFG.n_levels} levels, {CFG.n_features} features, map {N_MAP}: "
        f"median {np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame "
        f"(per-frame sync: one packed fetch) on {card}; per frame median: "
        f"valid {np.median(s[:, 0]):.0f}, stereo {np.median(s[:, 1]):.0f}, "
        f"matches {np.median(s[:, 2]):.0f}, inliers {np.median(s[:, 3]):.0f}, "
        f"reprojection rms {np.median(s[:, 4]):.3f} px; kernel launches {launches}"
    )
    return launches, prev, last


def phase_card_vs_cpu(frames, card_frame, i):
    bf, min_z = torch.tensor(BF), torch.tensor(BF / INTRINSICS[0])
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[i]), CFG, bf, min_z)
    k = fd.kps
    cpu = {"x": k.x.numpy(), "y": k.y.numpy(), "level": k.level.numpy(), "valid": k.valid.numpy(),
           "depth": fd.depth.numpy(), "desc_packed": k.desc_packed.numpy()}
    report = parity.golden_compare(card_frame, cpu)
    print(f"phase 5 card against CPU (frame {i}): {json.dumps(report)}")
    check(report["pass"], f"card and CPU disagree beyond the golden thresholds: {report}")


def main():
    # 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 1 device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    hamming_kernel.load_kernel()
    print(f"phase 2 build: hamming_penalty.cu built and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernel against plain
    rows, max_err = phase_kernel(device)
    for r in rows:
        print(f"phase 3 kernel against plain {r['shape']}: bitwise equal; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms ({card})")

    # 4. main path
    frames = parity.stereo_frames(1 + N_WARMUP + N_FRAMES, H, W, seed=0, step=STEP)
    launches, card_frame, last = phase_main_path(device, frames, card)

    # 5. card against CPU
    phase_card_vs_cpu(frames, card_frame, last)

    search = next(r for r in rows if r["shape"] == [2048, 1024])
    print(json.dumps({"kernels": [{
        "name": "hamming_penalty",
        "route": "cuda",
        "source": "fasttrack_tpu_torch/ops/csrc/hamming_penalty.cu",
        "replaces": "fasttrack_tpu/ops/pallas_kernels.py:44",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": search["ms"],
        "plain_ms": search["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
