"""Smoke run of the PyTorch port (fasttrack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and exits non-zero:
1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles both CUDA kernels from ops/csrc with nvcc (sm_90a), side
   by side;
3. kernels against plain: hamming_penalty_matrix (bitwise equal) and the
   fused hamming_penalty_topk (values and indices equal) against their
   plain PyTorch versions at the tracker's shapes, ragged ones, N < K, an
   input built to tie, and K = 2 as match_fisheye calls it (validity
   penalties of 1e9, so that whole rows tie); device time of each beside
   its plain version,
   what the fused kernel replaces (matrix kernel + stable sort) and
   matrix kernel + torch.topk;
4. hot path: tracking_hot_path on consecutive 752x480 stereo frames
   (8 levels, 1024 features, a 2048-point local map built from the
   previous frame's stereo keypoints), one packed device->host fetch per
   frame, with per-frame checks and ms/frame;
5. card against CPU: the same frame through the port on the CPU, held to
   the golden-check thresholds (keypoint overlap, descriptor bits, depth);
6. fused step: the tracker's per-frame chain frame -> twm_step -> tlm_step
   -> one packed fetch on consecutive frames at the same width, against a
   device-resident point store of 8192 rows with 4096 local-map candidate
   slots, the host side as the tracker does it (parity.py), with per-frame
   checks and ms/frame;
7. fused step, card against CPU: one frame's twm_step and tlm_step on the
   CPU from the same keypoints and blocks;
8. tracker: a rendered 752x480 stereo sequence (datasets.synthetic: two
   depths, 6-DOF motion, ground truth) through Tracker.track_stereo from
   the first frame: stereo initialization, one stepwise frame (reference
   keyframe, local map), then fused single-fetch frames, keyframes and new
   map points over the real map, with per-frame checks, the ATE against
   ground truth and ms/frame;
9. tracker, card against CPU: the first frames again through
   Tracker(device="cpu"): states, keyframes, bindings and poses.

The line before the last two is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Each kernel's `launches` is what the three
paths (phases 4, 6 and 8) launched, counted from 0 at each path's start. The
matrix kernel's is 0: since its top-K was fused no tracker path calls it
(modules of later slices will), and phase 3 alone holds it against plain.
Imports nothing of JAX.
"""

import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from fasttrack_tpu_torch import convert, fused_track, parity
from fasttrack_tpu_torch.cameras import host_camera, make_pinhole
from fasttrack_tpu_torch.datasets.synthetic import generate_sequence
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
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
from fasttrack_tpu_torch.ops.stereo_match import valid_penalty
from fasttrack_tpu_torch.ops.topk import top_k
from fasttrack_tpu_torch.slam_map import Atlas
from fasttrack_tpu_torch.tracking import Tracker

H, W = 480, 752
CFG = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
INTRINSICS = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0, as bench.py
BF = 47.9
N_MAP = 2048
N_WARMUP, N_FRAMES = 3, 10      # hot path
N_FUSED_FRAMES = 30             # fused step, after the same warm-up
STORE_CAP = 8192                # rows of the device-resident point store
KEYFRAME_EVERY = 4              # frames between insertions of new map points
STEP = (3, 5)  # (dy, dx) px the view moves per frame: content moves (-5, -3)
TOP_K = 64
MATRIX_SHAPES = [(1024, 1024), (2048, 1024), (1200, 1000)]
# (M, N, kind of input, K); 33 x 40 has N < K. "validity": what match_fisheye
# gives the kernel (penalties 0 or 1e9, invalid rows tie across all columns).
TOPK_CASES = [(1024, 1024, "random", 64), (2048, 1024, "random", 64), (4096, 1024, "random", 64),
              (1200, 1000, "random", 64), (33, 40, "random", 64), (1024, 1024, "tied", 64),
              (1024, 1024, "validity", 2), (1000, 900, "validity", 2), (1024, 1024, "tied", 2)]
N_TRACKER_FRAMES = 40           # the rendered sequence of phase 8
N_TRACKER_CPU_FRAMES = 6        # of them, again on the CPU in phase 9
# ATE RMSE limit of phase 8 (m). The same 40 frames through Tracker(device="cpu")
# give 0.0033 m; the limit leaves room for f32 sums taken in another order and
# for a keyframe decision that falls a frame earlier or later.
ATE_LIMIT_M = 0.02
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core rate: a +-1 product is an int8 MAC


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


def device_kernels(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


TIMER = {"mode": "profiler"}    # "events" once the tracer has failed; never back


def profiler_ms(fn, calls, windows):
    """Median over `windows` windows of the summed duration of the kernels
    one call launches, from torch.profiler over `calls` calls; None when
    the tracer does not deliver. The tracer can lose the first few kernels
    of a window (after an earlier window that also traced the host it loses
    exactly the first two), so each window opens with 8 spin kernels that
    are not counted. A window that shows no kernel, or some kernel not a
    whole number of times per call, is taken again; three such windows in
    a row and the tracer is given up."""
    readings, spoilt = [], 0
    while len(readings) < windows:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for k in device_kernels(prof):
            if "spin_kernel" not in k.name:
                by_name.setdefault(k.name, []).append(k.time_range.elapsed_us())
        if not by_name or any(len(d) % calls for d in by_name.values()):
            spoilt += 1
            if spoilt == 3:
                print("timer: torch.profiler gave three timing windows in a row with no kernel or "
                      "with dropped kernel events (last: "
                      + str({n[:60]: len(d) for n, d in by_name.items()}) + f" over {calls} calls); "
                      "every later device time is taken with CUDA events behind a spin kernel")
                return None
            continue
        spoilt = 0
        readings.append(sum(np.sum(d) for d in by_name.values()) / calls / 1e3)
    return float(np.median(readings))


def events_ms(fn, calls, windows):
    """Median over `windows` windows of the time between two CUDA events
    around `calls` calls, per call. A spin kernel holds the stream while the
    host queues the first event, every call and the last event, so the
    events bracket the kernels running back to back and none of the host's
    time: a window in which the spin ended before the host was done (the
    first event already reached) is taken again behind a longer spin. The
    gaps between consecutive kernels are inside the reading, which the
    profiler's kernel durations leave out."""
    readings, spin = [], 20_000_000
    while len(readings) < windows:
        first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        first.record()
        for _ in range(calls):
            fn()
        last.record()
        host_was_late = first.query()
        torch.cuda.synchronize()
        if host_was_late:
            spin *= 2
            check(spin < 2_000_000_000, "the host cannot queue a timing window behind a spin kernel")
            continue
        readings.append(first.elapsed_time(last) / calls)
    return float(np.median(readings))


def device_ms(fn, calls=20, windows=3) -> float:
    """Device time of one call in ms, by TIMER["mode"]: the profiler's
    kernel durations, or, once the tracer has failed in this run, CUDA
    events that bracket the kernels alone. Never a host clock."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if TIMER["mode"] == "profiler":
        ms = profiler_ms(fn, calls, windows)
        if ms is not None:
            return ms
        TIMER["mode"] = "events"
    return events_ms(fn, calls, windows)


def in_turns(plain, kern):
    """(kernel ms, plain ms, timer): plain, kernel, kernel, plain, all four
    by one timer; taken again if the timer changed on the way."""
    while True:
        mode = TIMER["mode"]
        p1, k1, k2, p2 = device_ms(plain), device_ms(kern), device_ms(kern), device_ms(plain)
        if TIMER["mode"] == mode:
            return (k1 + k2) / 2, (p1 + p2) / 2, mode


def kernel_inputs(rng, M, N, device, kind="random"):
    """+-1 descriptors and penalties among 0, small values, 1e9 and 2e9
    (where f32 rounding makes the addition order matter); "tied": rows
    drawn from 4 descriptors, so that most distances are equal; "validity":
    penalties as match_fisheye makes them from validity masks (a fifth of
    the rows and columns at 1e9: such a row ties across all its columns)."""
    if kind == "validity":
        q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
        k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
        qp = valid_penalty(torch.from_numpy(rng.random(M) > 0.2)).numpy()
        kp = valid_penalty(torch.from_numpy(rng.random(N) > 0.2)).numpy()
    elif kind == "tied":
        base = (2 * rng.integers(0, 2, (4, 256)) - 1).astype(np.int8)
        q, k = base[rng.integers(0, 4, M)], base[rng.integers(0, 4, N)]
        pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
        qp, kp = rng.choice(pens, M), rng.choice(pens, N)
    else:
        q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
        k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
        qp = rng.choice(np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32), M)
        kp = rng.choice(np.asarray([0.0, 1e9, 2.0e9, 7.25], np.float32), N)
    arrays = (q, k, qp.astype(np.float32), kp.astype(np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def bound_ms(M, N, out_bytes):
    """The least time the card could take: the larger of the bytes that must
    move (each operand read once as int8, penalties, the output written
    once) over the memory rate and the M * N * 256 int8 multiply-adds over
    the tensor cores' rate. Returns (ms, "bytes" or "operations")."""
    by_bytes = ((M + N) * (256 + 4) + out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * M * N * 256 / INT8_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_matrix_kernel(device, card):
    rng = np.random.default_rng(0)
    kern = hamming_kernel.hamming_penalty_matrix
    plain = hamming_kernel.hamming_penalty_matrix_reference
    rows, max_err = {}, 0.0
    for M, N in MATRIX_SHAPES:
        args = kernel_inputs(rng, M, N, device)
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"matrix launch counter did not count at {(M, N)}")
        want = plain(*args)
        check(torch.equal(got, want), f"matrix kernel differs from plain at {(M, N)}")
        max_err = max(max_err, float((got - want).abs().max()))
        k_ms, p_ms, timer = in_turns(lambda: plain(*args), lambda: kern(*args))
        b, by = bound_ms(M, N, M * N * 4)
        rows[(M, N)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by, "timer": timer}
        print(f"phase 3 matrix kernel against plain {(M, N)}: bitwise equal; device time ({timer}) "
              f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
              f"bound {b * 1e3:.2f} us ({by}) ({card})")
    return rows, max_err


def phase_topk_kernel(device, card):
    rng = np.random.default_rng(1)
    kern = hamming_kernel.hamming_penalty_topk
    plain = hamming_kernel.hamming_penalty_topk_reference
    matrix = hamming_kernel.hamming_penalty_matrix
    rows, max_err, mismatches = {}, 0.0, 0

    def replaced(*args, k):   # what the matchers did before: kernel matrix, stable sort, slice
        neg, idx = top_k(-matrix(*args), min(k, args[1].shape[0]))
        return -neg, idx

    for M, N, kind, K in TOPK_CASES:
        args = kernel_inputs(rng, M, N, device, kind)
        before = kern.launches
        values, indices = kern(*args, K)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"top-k launch counter did not count at {(M, N, K)}")
        want_v, want_i = plain(*args, K)
        check(values.shape == want_v.shape == (M, min(K, N)), f"top-k shape at {(M, N, K)}")
        bad = int((indices != want_i).sum())
        mismatches += bad
        max_err = max(max_err, float((values - want_v).abs().max()))
        check(torch.equal(values, want_v) and bad == 0,
              f"top-k kernel differs from plain at {(M, N, kind, K)}: {bad} indices")
        line = f"phase 3 top-k kernel against plain {(M, N)} K={K} {kind}: values and indices equal"
        if kind == "validity":
            tie_rows = int((args[2] > 0).sum())
            check(tie_rows > 0, f"no penalised row among the inputs at {(M, N, K)}")
            line += f" ({tie_rows} rows penalised by 1e9 tie across their columns)"
        if M >= 1024 and kind != "tied":
            while True:
                k_ms, p_ms, timer = in_turns(lambda: plain(*args, K), lambda: kern(*args, K))
                rep = device_ms(lambda: replaced(*args, k=K))
                lib = device_ms(lambda: torch.topk(matrix(*args), K, largest=False))
                if TIMER["mode"] == timer:
                    break
            b, by = bound_ms(M, N, M * K * 12)
            rows[(M, N, K)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
                               "replaced_ms": rep, "matrix_plus_torch_topk_ms": lib, "timer": timer}
            line += (f"; device time ({timer}) kernel {k_ms * 1e3:.2f} us, plain "
                     f"{p_ms * 1e3:.2f} us, matrix kernel + stable sort {rep * 1e3:.2f} us, "
                     f"matrix kernel + torch.topk {lib * 1e3:.2f} us (its tie order is unspecified), "
                     f"bound {b * 1e3:.2f} us ({by})")
        print(f"{line} ({card})")
    return rows, max_err, mismatches


def host_frame(f32, desc) -> dict:
    f = f32.cpu().numpy()
    return {"x": f[0], "y": f[1], "level": f[2].astype(np.int32), "angle": f[3],
            "valid": f[6] > 0.5, "depth": f[5], "desc_packed": desc.cpu().numpy()}


def reprojection_rms(pos, R, t, x, y) -> float:
    """RMS pixel distance between world points `pos` seen from (R, t) and
    the keypoints (x, y)."""
    if len(pos) == 0:
        return float("inf")
    Xc = pos @ R.T + t
    u = INTRINSICS[0] * Xc[:, 0] / Xc[:, 2] + INTRINSICS[2]
    v = INTRINSICS[1] * Xc[:, 1] / Xc[:, 2] + INTRINSICS[3]
    return float(np.sqrt(np.mean((u - x) ** 2 + (v - y) ** 2)))


def phase_hot_path(device, frames, card):
    cam = make_pinhole(*INTRINSICS, W, H, device=device)
    bf = torch.tensor(BF, device=device)
    min_z = torch.tensor(BF / INTRINSICS[0], device=device)
    T0 = se3_identity(device=device)
    shift = (-float(STEP[1]), -float(STEP[0]))
    n_kp = CFG.total_features

    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(device), CFG, bf, min_z)
    prev = host_frame(*pack_frame_for_host(fd))
    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    hamming_kernel.hamming_penalty_matrix.launches = 0
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
        inl, j = host["inliers"], host["match_idx"]
        rms = reprojection_rms(mp["pos"][inl], host["R"], host["t"], host["x"][j][inl], host["y"][j][inl])
        check(host["n_inliers"] >= 0.5 * n_match and rms < 3.0,
              f"frame {i}: {host['n_inliers']} inliers of {n_match} matches, reprojection rms {rms:.2f} px")
        if i > N_WARMUP:
            times.append(dt)
        stats.append((n_valid, n_stereo, n_match, host["n_inliers"], rms))
        prev, last = host, i
    launches = kern.launches
    check(launches == 2 * (len(frames) - 1), f"hot path launched the top-k kernel {launches} times")
    s = np.asarray(stats, np.float64)
    print(
        f"phase 4 hot path: {len(times)} timed frames (+{N_WARMUP} warm-up) at {W}x{H}, "
        f"{CFG.n_levels} levels, {CFG.n_features} features, map {N_MAP}: "
        f"median {np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame "
        f"(per-frame sync: one packed fetch) on {card}; per frame median: "
        f"valid {np.median(s[:, 0]):.0f}, stereo {np.median(s[:, 1]):.0f}, "
        f"matches {np.median(s[:, 2]):.0f}, inliers {np.median(s[:, 3]):.0f}, "
        f"reprojection rms {np.median(s[:, 4]):.3f} px; top-k kernel launches {launches} (2 per frame), "
        f"matrix kernel launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return launches, hamming_kernel.hamming_penalty_matrix.launches, prev, last


def phase_card_vs_cpu(frames, card_frame, i):
    bf, min_z = torch.tensor(BF), torch.tensor(BF / INTRINSICS[0])
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[i]), CFG, bf, min_z)
    k = fd.kps
    cpu = {"x": k.x.numpy(), "y": k.y.numpy(), "level": k.level.numpy(), "valid": k.valid.numpy(),
           "depth": fd.depth.numpy(), "desc_packed": k.desc_packed.numpy()}
    report = parity.golden_compare(card_frame, cpu)
    print(f"phase 5 card against CPU (frame {i}): {json.dumps(report)}")
    check(report["pass"], f"card and CPU disagree beyond the golden thresholds: {report}")


def phase_fused_step(device, frames, card):
    """The tracker's OK-state frame, host side as Tracker._track_fused: the
    world is the first frame's camera; map points are made from stereo
    keypoints at the first frame and every KEYFRAME_EVERY-th after it, and
    the store is uploaded again only then."""
    cam = make_pinhole(*INTRINSICS, W, H, device=device)
    cam_host = host_camera(cam)
    bf = torch.tensor(BF, device=device)
    min_z = torch.tensor(BF / INTRINSICS[0], device=device)
    scales = np.asarray([CFG.scale_factor**l for l in range(CFG.n_levels)], np.float64)
    N = M = CFG.total_features
    P = parity.TLM_CAP
    depth_m = BF / 7.0  # the frames' right image is the left shifted by 7 px

    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(device), CFG, bf, min_z)
    last = host_frame(*pack_frame_for_host(fd))
    R_last, t_last = np.eye(3), np.zeros(3)
    velocity = (np.eye(3), np.zeros(3))   # T_cur o T_last^-1 of the previous step
    store = parity.new_store(STORE_CAP)

    def add_points(frame, mp_rows, R, t):
        sel = np.where((frame["depth"] > 0) & (mp_rows < 0))[0]
        mp_rows[sel] = parity.store_add_points(store, frame, sel, R, t, INTRINSICS, scales)
        return convert.store_from_numpy(
            store["pos"], store["desc_signed"], store["normal"], store["min_dist"],
            store["max_dist"], device=device,
        )

    last_rows = np.full(N, -1, np.int64)
    store_dev = add_points(last, last_rows, R_last, t_last)
    uploads = 1

    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    hamming_kernel.hamming_penalty_matrix.launches = 0
    times, stats, kept = [], [], None
    for i in range(1, len(frames)):
        R_pred = velocity[0] @ R_last
        t_pred = velocity[0] @ t_last + velocity[1]
        q7, q_rows = parity.twm_query_block(
            store, last_rows, last["level"], last["angle"], cam_host, R_pred, t_pred, scales
        )
        cand = np.arange(store["n_rows"])[::-1]          # newest points first
        cand_rows, cand_ok, _ = parity.tlm_candidate_block(store, cand, P)
        torch.cuda.synchronize()
        before = kern.launches
        t0 = time.perf_counter()
        images = torch.from_numpy(frames[i]).to(device)
        qb = convert.query_block_from_numpy(q7, q_rows, cand_rows, cand_ok, device=device)
        T0 = convert.se3_from_numpy(R_pred, t_pred, device=device)
        fd = process_stereo_frame_stacked(images, CFG, bf, min_z)
        twm = fused_track.twm_step(fd.kps, fd.u_right, CFG, bf, cam, T0,
                                   qb.q7, qb.q_rows, store_dev.pos, store_dev.desc)
        tlm = fused_track.tlm_step(fd.kps, fd.u_right, CFG, bf, cam, twm,
                                   qb.cand_rows, qb.cand_ok, *store_dev)
        buf = fused_track.pack_fused_for_host(fd, twm, tlm).cpu()   # the frame's one fetch
        dt = (time.perf_counter() - t0) * 1e3
        f32, packed, idxA, keepA, idxB, keepB, in_frustum, tail = fused_track.unpack_fused(
            buf.numpy(), N, M, P
        )

        check(kern.launches == before + 3,
              f"fused frame {i}: {kern.launches - before} top-k launches, not 3 "
              "(stereo, motion-model search, local-map search)")
        frame = {"x": f32[0], "y": f32[1], "level": f32[2].astype(np.int32), "angle": f32[3],
                 "depth": f32[5], "valid": f32[6] > 0.5, "desc_packed": packed}
        R = parity.orthonormalize(tail[:9].reshape(3, 3).astype(np.float64))
        t = tail[9:12].astype(np.float64)
        n_twm, n_tlm = int(keepA.sum()), int(keepB.sum())
        pose_ok = bool(np.isfinite(tail).all())
        check(n_twm > 0 and n_tlm > 0 and pose_ok,
              f"fused frame {i}: TWM matches {n_twm}, TLM matches {n_tlm}, pose finite={pose_ok}")
        rows = parity.bind_fused_frame(N, last_rows, idxA, keepA, cand_rows.astype(np.int64),
                                       cand_ok, idxB, keepB, f32[8] > 0.5)
        # keypoints the final optimization was given: TWM inliers and TLM matches
        twm_kp = idxA[keepA]
        n_bound = len(np.union1d(twm_kp[f32[7][twm_kp] > 0.5], idxB[keepB]))
        n_inl = int(tail[13])
        b = rows >= 0
        rms = reprojection_rms(store["pos"][rows[b]].astype(np.float64), R, t,
                               frame["x"][b], frame["y"][b])
        check(n_inl >= 0.5 * n_bound and rms < 3.0,
              f"fused frame {i}: {n_inl} inliers of {n_bound} bindings, reprojection rms {rms:.2f} px")
        if i > N_WARMUP:
            times.append(dt)
        stats.append((n_twm, n_tlm, int(in_frustum.sum()), n_inl, rms))
        if i == len(frames) - 1:   # kept for the card-against-CPU phase
            kept = dict(kps=fd.kps, u_right=fd.u_right, T0=(R_pred, t_pred), q7=q7, q_rows=q_rows,
                        cand_rows=cand_rows, cand_ok=cand_ok, twm=twm, tlm=tlm,
                        store={k: v.copy() for k, v in store.items() if k != "n_rows"})

        # the motion model, and new map points at a keyframe
        R_rel = R @ R_last.T
        velocity = (R_rel, t - R_rel @ t_last)
        R_last, t_last, last, last_rows = R, t, frame, rows
        if i % KEYFRAME_EVERY == 0:
            store_dev = add_points(last, last_rows, R_last, t_last)
            uploads += 1

    launches = kern.launches
    check(launches == 3 * (len(frames) - 1), f"fused path launched the top-k kernel {launches} times")
    # The view walked STEP px per frame over a plane at depth_m. A plane seen
    # head-on leaves rotation and translation nearly interchangeable, so the
    # trajectory is held to where it puts the first frame's centre point.
    n = len(frames) - 1
    centre = R_last @ np.asarray([0.0, 0.0, depth_m]) + t_last
    u = INTRINSICS[0] * centre[0] / centre[2] + INTRINSICS[2]
    v = INTRINSICS[1] * centre[1] / centre[2] + INTRINSICS[3]
    want_u, want_v = INTRINSICS[2] - n * STEP[1], INTRINSICS[3] - n * STEP[0]
    drift = float(np.hypot(u - want_u, v - want_v))
    check(drift < 3.0, f"trajectory: the first centre point lands at ({u:.2f}, {v:.2f}) px after "
                       f"{n} frames, expected ({want_u:.2f}, {want_v:.2f})")
    s = np.asarray(stats, np.float64)
    print(
        f"phase 6 fused step: {len(times)} timed frames (+{N_WARMUP} warm-up) at {W}x{H}, "
        f"{CFG.n_levels} levels, {CFG.n_features} features, store {STORE_CAP} rows "
        f"({store['n_rows']} live, {uploads} uploads), {M} queries, {P} candidate slots: "
        f"median {np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame "
        f"(per-frame sync: one packed fetch) on {card}; per frame median: "
        f"TWM matches {np.median(s[:, 0]):.0f}, TLM matches {np.median(s[:, 1]):.0f}, "
        f"in frustum {np.median(s[:, 2]):.0f}, inliers {np.median(s[:, 3]):.0f}, "
        f"reprojection rms {np.median(s[:, 4]):.3f} px; after {n} frames the first frame's centre "
        f"point is {drift:.3f} px from where the walk puts it; top-k kernel launches {launches} "
        f"(3 per frame), matrix kernel launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return launches, hamming_kernel.hamming_penalty_matrix.launches, kept


def phase_fused_card_vs_cpu(kept):
    """The last fused frame's two steps on the CPU, from the card's
    keypoints and the same blocks: matches equal, poses within 1e-3."""
    cpu = torch.device("cpu")
    kps = type(kept["kps"])(*(f.to(cpu) for f in kept["kps"]))
    st = kept["store"]
    store = convert.store_from_numpy(st["pos"], st["desc_signed"], st["normal"], st["min_dist"],
                                     st["max_dist"], device=cpu)
    qb = convert.query_block_from_numpy(kept["q7"], kept["q_rows"], kept["cand_rows"],
                                        kept["cand_ok"], device=cpu)
    cam = make_pinhole(*INTRINSICS, W, H, device=cpu)
    bf = torch.tensor(BF)
    u_right = kept["u_right"].to(cpu)
    twm = fused_track.twm_step(kps, u_right, CFG, bf, cam,
                               convert.se3_from_numpy(*kept["T0"], device=cpu),
                               qb.q7, qb.q_rows, store.pos, store.desc)
    tlm = fused_track.tlm_step(kps, u_right, CFG, bf, cam, twm, qb.cand_rows, qb.cand_ok, *store)
    report = {}
    for name, card, host in (("twm", kept["twm"], twm), ("tlm", kept["tlm"], tlm)):
        keep_equal = torch.equal(card.keep.to(cpu), host.keep)
        k = host.keep
        idx_equal = torch.equal(card.idx.to(cpu)[k], host.idx[k])
        dR = float((card.pose_R.to(cpu) - host.pose_R).abs().max())
        dt = float((card.pose_t.to(cpu) - host.pose_t).abs().max())
        report[name] = {"keep_equal": keep_equal, "idx_equal_where_kept": idx_equal,
                        "matches": int(k.sum()), "pose_R_maxdiff": dR, "pose_t_maxdiff": dt}
        check(keep_equal and idx_equal and dR < 1e-3 and dt < 1e-3,
              f"fused step card against CPU, {name}: {report[name]}")
    print(f"phase 7 fused step card against CPU: {json.dumps(report)}")


def tracker_step(tracker, frame) -> dict:
    """One frame of the rendered sequence through `tracker.track_stereo`,
    timed on the host's clock (the call ends after its last fetch), and
    what the checks read. A frame went stepwise if it recorded
    `orb_extraction` (the fused path records it only when it falls back)."""
    series = tracker.stats.series
    counts = {k: len(series[k]) for k in ("orb_extraction", "device_fetches", "store_uploads")}
    kern = hamming_kernel.hamming_penalty_topk
    launches, top2 = kern.launches, kern.launches_by_k[2]
    if tracker.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.track_stereo(frame.left, frame.right, frame.timestamp)
    ms = (time.perf_counter() - t0) * 1e3
    last, m = tracker.last_frame, tracker.atlas.current
    return {
        "ms": ms, "state": tracker.state.name,
        "path": "stepwise" if len(series["orb_extraction"]) > counts["orb_extraction"] else "fused",
        "fetches": len(series["device_fetches"]) - counts["device_fetches"],
        "uploads": len(series["store_uploads"]) - counts["store_uploads"],
        "launches": kern.launches - launches, "launches_k2": kern.launches_by_k[2] - top2,
        "keyframes": m.n_keyframes(), "mappoints": m.n_mappoints(),
        "bound": int((last.mp_ids >= 0).sum()), "inliers": tracker.n_inliers,
        "stereo": int((last.valid & (last.depth > 0)).sum()),
        "mp_ids": last.mp_ids.copy(), "R": last.R_cw.copy(), "t": last.t_cw.copy(),
    }


def make_tracker(seq, device) -> Tracker:
    cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device)
    return Tracker(cam, CFG, seq.fx * seq.baseline, Atlas(), device=device)


def phase_tracker(device, seq, card):
    """The whole tracking thread on the card: Tracker.track_stereo over the
    rendered sequence, from the first frame, with no local mapper (the
    tracker makes the close stereo points of each keyframe itself)."""
    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    kern.launches_by_k.clear()
    hamming_kernel.hamming_penalty_matrix.launches = 0
    tracker = make_tracker(seq, device)
    log = [tracker_step(tracker, f) for f in seq.frames]

    first = log[0]
    check(first["state"] == "OK" and first["stereo"] > 300 and first["keyframes"] == 1,
          f"tracker frame 0 did not initialize: {first['state']}, {first['stereo']} stereo points "
          "(the gate is 100)")
    for i, r in enumerate(log[1:], 1):
        check(r["state"] == "OK", f"tracker frame {i}: state {r['state']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"tracker frame {i}: pose")
    series = tracker.stats.series
    check(log[1]["path"] == "stepwise" and len(series["trk"]) >= 1 and len(series["tlm"]) >= 1
          and log[1]["launches_k2"] == 1,
          f"tracker frame 1 did not go stepwise through the reference keyframe (K = 2) and the "
          f"local map: {log[1]['path']}, K=2 launches {log[1]['launches_k2']}")
    fused = [r for r in log[2:] if r["path"] == "fused"]
    for i, r in enumerate(log[2:], 2):
        if r["path"] != "fused":
            print(f"phase 8 tracker frame {i} went stepwise: the motion-model search of the fused "
                  f"frame found fewer than 10 inliers ({r['fetches']} fetches, "
                  f"{r['inliers']} inliers)")
        else:
            check(r["fetches"] == 1, f"tracker frame {i}: {r['fetches']} fetches on the fused path")
            check(r["launches"] == 3 and r["launches_k2"] == 0,
                  f"tracker frame {i}: {r['launches']} top-k launches on the fused path, not 3")
    check(len(fused) >= 30, f"only {len(fused)} of {len(log) - 2} frames took the fused path")
    n_kf = log[-1]["keyframes"]
    check(n_kf >= 2, f"{n_kf} keyframes after {len(log)} frames")
    # the device mirror follows the map: uploaded by the first fused frame
    # and by the first one after each keyframe, by no other frame
    pending, kf_before = True, 0
    for i, r in enumerate(log):
        want = int(pending and r["path"] == "fused")
        check(r["uploads"] == want,
              f"tracker frame {i} ({r['path']}): {r['uploads']} uploads of the point store, "
              f"not {want}")
        pending = (pending and not want) or r["keyframes"] != kf_before
        kf_before = r["keyframes"]
    uploads = len(series["store_uploads"])

    traj = tracker.trajectory
    t_est = np.asarray([t for t, _, _ in traj])
    p_est = np.asarray([-R.T @ t_ for _, R, t_ in traj])
    ate = absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)
    check(ate["n"] == len(seq.frames) and ate["rmse"] < ATE_LIMIT_M,
          f"tracker ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")

    times = [r["ms"] for r in fused[N_WARMUP:]]
    med = lambda key, rows=fused: float(np.median([r[key] for r in rows]))
    host = {k: float(np.median(series[k][N_WARMUP:]))
            for k in ("fused_host_pre", "fused_dispatch", "fused_host_post")}
    # the fused frames end the run, so their waits end the series
    sync = float(np.median(series["sync_ms"][-(len(fused) - N_WARMUP):]))
    print(
        f"phase 8 tracker: {len(log)} frames at {W}x{H}, {CFG.n_levels} levels, "
        f"{CFG.n_features} features through Tracker.track_stereo on {card}: frame 0 initialized "
        f"with {first['stereo']} stereo points ({first['mappoints']} map points); frame 1 stepwise "
        f"(reference keyframe K=2, local map) {log[1]['ms']:.1f} ms, {log[1]['fetches']} fetches; "
        f"{len(fused)} fused frames, 1 fetch and 3 top-k launches each: median "
        f"{np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame over "
        f"{len(times)} (after {N_WARMUP} warm-up); of it on the host's clock, median: packing the "
        f"blocks {host['fused_host_pre']:.3f} ms, dispatch of the device chain "
        f"{host['fused_dispatch']:.3f} ms, wait in the fetch {sync:.3f} ms, bookkeeping after it "
        f"{host['fused_host_post']:.3f} ms; per fused frame median: bound {med('bound'):.0f}, "
        f"inliers {med('inliers'):.0f}; keyframes {n_kf}, map points {log[-1]['mappoints']}, "
        f"store uploads {uploads} (rows {tracker.atlas.current.store.n_rows} of "
        f"{tracker.atlas.current.store.cap}); ATE RMSE {ate['rmse']:.4f} m (limit {ATE_LIMIT_M}); "
        f"top-k kernel launches {kern.launches} ({dict(kern.launches_by_k)} by K), matrix kernel "
        f"launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return kern.launches, hamming_kernel.hamming_penalty_matrix.launches, kern.launches_by_k[2], log


def phase_tracker_card_vs_cpu(seq, card_log):
    """The first frames through Tracker(device="cpu"): the same state and
    path per frame, the same keyframes, bindings equal on >= 98% of the
    keypoints, poses within 1e-3."""
    tracker = make_tracker(seq, "cpu")
    report = []
    for i, frame in enumerate(seq.frames[:N_TRACKER_CPU_FRAMES]):
        cpu, card = tracker_step(tracker, frame), card_log[i]
        same = float((cpu["mp_ids"] == card["mp_ids"]).mean())
        dR = float(np.abs(cpu["R"] - card["R"]).max())
        dt = float(np.abs(cpu["t"] - card["t"]).max())
        report.append({"frame": i, "state": cpu["state"], "path": cpu["path"],
                       "keyframes": cpu["keyframes"], "mp_ids_equal": same,
                       "pose_R_maxdiff": dR, "pose_t_maxdiff": dt})
        check((cpu["state"], cpu["path"], cpu["keyframes"], cpu["mappoints"])
              == (card["state"], card["path"], card["keyframes"], card["mappoints"])
              and same >= 0.98 and dR < 1e-3 and dt < 1e-3,
              f"tracker card against CPU, frame {i}: {report[-1]} against card state "
              f"{card['state']}, path {card['path']}, keyframes {card['keyframes']}")
    print(f"phase 9 tracker card against CPU: {json.dumps(report)}")


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
    hamming_kernel.load_kernels()
    print(f"phase 2 build: {hamming_kernel.MATRIX_SOURCE} and {hamming_kernel.TOPK_SOURCE} built "
          f"side by side and loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against plain
    matrix_rows, matrix_err = phase_matrix_kernel(device, card)
    topk_rows, topk_err, mismatches = phase_topk_kernel(device, card)

    # 4. hot path, 5. card against CPU
    frames = parity.stereo_frames(1 + N_WARMUP + N_FUSED_FRAMES, H, W, seed=0, step=STEP)
    hot_frames = frames[: 1 + N_WARMUP + N_FRAMES]
    hot_launches, hot_matrix, card_frame, last = phase_hot_path(device, hot_frames, card)
    phase_card_vs_cpu(hot_frames, card_frame, last)

    # 6. fused step, 7. card against CPU
    fused_launches, fused_matrix, kept = phase_fused_step(device, frames, card)
    phase_fused_card_vs_cpu(kept)

    # 8. tracker, 9. card against CPU
    t0 = time.perf_counter()
    seq = generate_sequence(n_frames=N_TRACKER_FRAMES, h=H, w=W)
    print(f"rendered {N_TRACKER_FRAMES} stereo frames at {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s (fx {seq.fx:.1f}, baseline {seq.baseline} m)")
    tracker_launches, tracker_matrix, tracker_k2, tracker_log = phase_tracker(device, seq, card)
    phase_tracker_card_vs_cpu(seq, tracker_log)

    search, local_map = matrix_rows[(2048, 1024)], topk_rows[(4096, 1024, TOP_K)]
    top2 = topk_rows[(1024, 1024, 2)]
    print(json.dumps({"kernels": [
        {
            "name": "hamming_penalty_topk",
            "route": "cuda",
            "source": "fasttrack_tpu_torch/ops/csrc/hamming_topk.cu",
            "replaces": "fasttrack_tpu/ops/pallas_kernels.py:44",
            "launches": hot_launches + fused_launches + tracker_launches,
            "launches_hot_path": hot_launches,
            "launches_fused_step": fused_launches,
            "launches_tracker": tracker_launches,
            "max_abs_err": topk_err,
            "index_mismatches": mismatches,
            "shape": [4096, 1024],
            "ms": local_map["ms"],
            "plain_ms": local_map["plain_ms"],
            "bound_ms": local_map["bound_ms"],
            "bound_by": local_map["bound_by"],
            "timer": local_map["timer"],
            "library_ms": None,   # no one PyTorch call computes it; see the two below
            "replaced_ms": local_map["replaced_ms"],
            "matrix_plus_torch_topk_ms": local_map["matrix_plus_torch_topk_ms"],
            # its second use: match_fisheye's best and second best (K = 2)
            "k2": {"shape": [1024, 1024], "k": 2, "launches_tracker": tracker_k2,
                   **{key: top2[key] for key in (
                       "ms", "plain_ms", "bound_ms", "bound_by", "timer", "replaced_ms",
                       "matrix_plus_torch_topk_ms")}},
        },
        {
            "name": "hamming_penalty",
            "route": "cuda",
            "source": "fasttrack_tpu_torch/ops/csrc/hamming_penalty.cu",
            "replaces": "fasttrack_tpu/ops/pallas_kernels.py:44",
            "launches": hot_matrix + fused_matrix + tracker_matrix,   # 0: no tracker path calls it
            "on_a_driven_path": False,
            "launches_hot_path": hot_matrix,
            "launches_fused_step": fused_matrix,
            "launches_tracker": tracker_matrix,
            "max_abs_err": matrix_err,
            "shape": [2048, 1024],
            "ms": search["ms"],
            "plain_ms": search["plain_ms"],
            "bound_ms": search["bound_ms"],
            "bound_by": search["bound_by"],
            "timer": search["timer"],
            "library_ms": None,   # no one PyTorch call computes it
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
