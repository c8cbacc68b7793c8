"""Where the PyTorch port's tracking paths spend their time, on one GPU.

    python3 profile_torch.py [--trace FILE.json] [--earlier-matrix-source FILE.cu ...]

At chip_smoke.py's configuration (752x480, 8 levels, 1024 features) it
prints, for the hot path (a 2048-point map built from the previous frame)
and for the fused tracker step (store of 8192 rows, 1024 queries, 4096
candidate slots):
- stage times with a synchronise after each stage, median of 10 frames
  (hot path: extract, stereo match, search, pose optimization; fused step:
  extraction, stereo, TWM, TLM, pack + fetch);
- from torch.profiler over 3 frames: kernel launches per frame, device
  busy time per frame, the device's idle share of the window, and the
  kernels with the most device time;
then, for the tracker (Tracker.track_stereo over chip_smoke.py's rendered
sequence, real map, keyframes), the same profile of three fused frames in the
middle of the run, and the host's share of a fused frame outside the device
chain (packing the query blocks, dispatch, the wait in the one fetch, the
bookkeeping after it) as the tracker's own stats record it;
then the device time per call of both Hamming kernels against their plain
versions at the paths' shapes, of an empty kernel (the floor under any
kernel), of a plain fill of the matrix kernel's output (the same bytes,
written only), and, with --earlier-matrix-source, of an earlier version of the
matrix kernel's source (same C interface) in turns with the current one.
Profiling slows the host, so the profiled window's idle share is an upper
bound of the unprofiled run's. Needs CUDA; imports nothing of JAX.
"""

import argparse
import collections
import ctypes
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fasttrack_tpu_torch import convert, fused_track, parity
from fasttrack_tpu_torch.cameras import host_camera, make_pinhole
from fasttrack_tpu_torch.frame_pipeline import (
    FrameData,
    _search_optimize_stage,
    _stereo_match_stage,
    pack_frame_for_host,
    pack_hot_path_for_host,
    process_stereo_frame_stacked,
    tracking_hot_path,
)
from fasttrack_tpu_torch.geometry import se3_identity
from fasttrack_tpu_torch.ops import cuda_build, hamming_kernel
from fasttrack_tpu_torch.ops.extractor import extract_orb_pair_stacked
from fasttrack_tpu_torch.ops.project_match import search_by_projection


def busy_us(kernels) -> float:
    """Union of the kernels' device intervals, in microseconds."""
    iv = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, (cs_, ce) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > ce:
            busy, cs_, ce = busy + ce - cs_, s, e
        else:
            ce = max(ce, e)
    return busy + ce - cs_


def sync_times(steps):
    """ms of each callable in `steps`, run in order with a synchronise after
    each; a step receives the results of the steps before it."""
    out, results = [], []
    for step in steps:
        t0 = time.perf_counter()
        results.append(step(*results))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def median_stages(steps, names, label, card):
    for _ in range(3):
        sync_times(steps)
    st = np.median([sync_times(steps) for _ in range(10)], axis=0)
    print(f"{label} stages ms (synchronised, {card}): "
          + ", ".join(f"{n} {v:.3f}" for n, v in zip(names, st)))


def profile_frames(frame, label, card, trace=None, n=3, warmup=3):
    for _ in range(warmup):
        frame()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            frame()
        wall_us = (time.perf_counter() - t0) * 1e6  # before the profiler's own teardown
    kernels = cs.device_kernels(prof)
    cs.check(kernels, "the profiler recorded no device kernels")
    busy = busy_us(kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k.name][0] += k.time_range.elapsed_us()
        by_name[k.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "path": label, "card": card, "frames": n, "launches_per_frame": len(kernels) / n,
        "device_busy_ms_per_frame": busy / n / 1e3,
        "profiled_wall_ms_per_frame": wall_us / n / 1e3,
        "idle_share_upper_bound": 1.0 - busy / wall_us,
        "top_kernels_ms_per_frame": [
            [name[:90], round(v[0] / n / 1e3, 4), v[1] // n] for name, v in top
        ],
    }))
    if trace:
        prof.export_chrome_trace(trace)


def hot_path(dev, card, cam, bf, min_z, frames, trace):
    cfg = cs.CFG
    T0 = se3_identity(device=dev)
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(dev), cfg, bf, min_z)
    prev = cs.host_frame(*pack_frame_for_host(fd))
    mp = parity.map_from_frame(prev, cs.INTRINSICS, cs.N_MAP, cfg.n_levels, shift=(-5.0, -3.0))
    lm = convert.map_from_numpy(**mp, device=dev)
    img = torch.from_numpy(frames[1]).to(dev)

    def search(ex, sm):
        kl = ex[0]
        return search_by_projection(lm.u, lm.v, lm.desc, lm.radius, lm.lmin, lm.lmax, lm.ok,
                                    kl.x, kl.y, kl.desc_signed, kl.level, kl.valid)

    median_stages([
        lambda: extract_orb_pair_stacked(img, cfg),
        lambda ex: _stereo_match_stage(ex[0], ex[1], ex[2].raw, ex[3].raw, cfg, bf, min_z)[0],
        search,
        lambda ex, sm, res: _search_optimize_stage(ex[0], sm.u_right, cfg, bf, cam, T0, *lm),
    ], ["extract", "stereo", "search", "search + pose"], "hot path", card)

    def frame():
        fd, res, opt = tracking_hot_path(img, cfg, bf, min_z, cam, T0, *lm)
        return pack_hot_path_for_host(fd, res, opt).cpu()

    profile_frames(frame, "hot path", card, trace)


def fused_step(dev, card, cam, bf, min_z, frames):
    """The second frame of the walk against a store made from the first."""
    cfg = cs.CFG
    scales = np.asarray([cfg.scale_factor**l for l in range(cfg.n_levels)], np.float64)
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(dev), cfg, bf, min_z)
    last = cs.host_frame(*pack_frame_for_host(fd))
    store = parity.new_store(cs.STORE_CAP)
    rows = np.full(cfg.total_features, -1, np.int64)
    sel = np.where(last["depth"] > 0)[0]
    rows[sel] = parity.store_add_points(store, last, sel, np.eye(3), np.zeros(3),
                                        cs.INTRINSICS, scales)
    st = convert.store_from_numpy(store["pos"], store["desc_signed"], store["normal"],
                                  store["min_dist"], store["max_dist"], device=dev)
    q7, q_rows = parity.twm_query_block(store, rows, last["level"], last["angle"],
                                        host_camera(cam), np.eye(3), np.zeros(3), scales)
    cand_rows, cand_ok, _ = parity.tlm_candidate_block(store, np.arange(store["n_rows"])[::-1])
    qb = convert.query_block_from_numpy(q7, q_rows, cand_rows, cand_ok, device=dev)
    T0 = se3_identity(device=dev)
    img = torch.from_numpy(frames[1]).to(dev)

    def twm(ex, sm):
        return fused_track.twm_step(ex[0], sm.u_right, cfg, bf, cam, T0,
                                    qb.q7, qb.q_rows, st.pos, st.desc)

    def tlm(ex, sm, tw):
        return fused_track.tlm_step(ex[0], sm.u_right, cfg, bf, cam, tw,
                                    qb.cand_rows, qb.cand_ok, *st)

    def pack(ex, sm, tw, tl):
        fd = FrameData(ex[0], ex[1], sm.u_right, sm.depth, ex[0].valid.sum())
        return fused_track.pack_fused_for_host(fd, tw, tl).cpu()

    median_stages([
        lambda: extract_orb_pair_stacked(img, cfg),
        lambda ex: _stereo_match_stage(ex[0], ex[1], ex[2].raw, ex[3].raw, cfg, bf, min_z)[0],
        twm, tlm, pack,
    ], ["extraction", "stereo", "TWM", "TLM", "pack + fetch"], "fused step", card)

    def frame():
        fd = process_stereo_frame_stacked(img, cfg, bf, min_z)
        tw = fused_track.twm_step(fd.kps, fd.u_right, cfg, bf, cam, T0,
                                  qb.q7, qb.q_rows, st.pos, st.desc)
        tl = fused_track.tlm_step(fd.kps, fd.u_right, cfg, bf, cam, tw,
                                  qb.cand_rows, qb.cand_ok, *st)
        return fused_track.pack_fused_for_host(fd, tw, tl).cpu()

    profile_frames(frame, "fused step", card)


def tracker_frames(dev, card, n_warmup=10):
    """Three fused frames of Tracker.track_stereo on the rendered sequence,
    after `n_warmup` frames that initialize the map and settle the path."""
    seq = cs.generate_sequence(n_frames=n_warmup + 3, h=cs.H, w=cs.W)
    tracker = cs.make_tracker(seq, dev)
    rows = [cs.tracker_step(tracker, f) for f in seq.frames[:n_warmup]]
    cs.check(rows[-1]["state"] == "OK" and rows[-1]["path"] == "fused",
             f"the tracker did not reach the fused path in {n_warmup} frames: {rows[-1]['state']}")
    todo = iter(seq.frames[n_warmup:])

    def frame():
        f = next(todo)
        tracker.track_stereo(f.left, f.right, f.timestamp)

    n_before = len(tracker.stats.series["fused_dispatch"])
    profile_frames(frame, "tracker, fused frame", card, warmup=0)
    series = tracker.stats.series
    cs.check(len(series["fused_dispatch"]) == n_before + 3,
             "a profiled tracker frame went stepwise")
    # unprofiled: the host's clock over the settled fused frames before the profile
    settled = slice(3, n_before)
    print(json.dumps({
        "path": "tracker, fused frame, unprofiled", "card": card, "frames": n_before - 3,
        "ms_per_frame_median": float(
            np.median([r["ms"] for r in rows if r["path"] == "fused"][3:])),
        "host_ms_median": {
            "pack_query_blocks": float(np.median(series["fused_host_pre"][settled])),
            "dispatch_device_chain": float(np.median(series["fused_dispatch"][settled])),
            "wait_in_fetch": float(np.median(series["sync_ms"][-(n_before - 3) - 3:-3])),
            "bookkeeping_after_fetch": float(np.median(series["fused_host_post"][settled])),
        },
        "fetches_per_frame": 1, "store_uploads": len(series["store_uploads"]),
        "keyframes": tracker.atlas.current.n_keyframes(),
    }))


EMPTY_KERNEL_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def compile_library(source: Path) -> ctypes.CDLL:
    """`source` compiled with the package's nvcc flags into a temporary
    directory, loaded."""
    out = Path(tempfile.mkdtemp(prefix="profile_kernel_")) / f"{source.stem}.so"
    proc = subprocess.run(cuda_build.nvcc_command(cuda_build.find_nvcc(), source, out),
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed on {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def empty_kernel():
    """A callable that launches a kernel that does nothing on the current
    stream: its device time is the floor under any kernel's."""
    source = Path(tempfile.mkdtemp(prefix="empty_kernel_")) / "empty.cu"
    source.write_text(EMPTY_KERNEL_SOURCE)
    lib = compile_library(source)
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def call():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"empty kernel launch failed ({err})")

    return call


def earlier_matrix_kernel(source: Path):
    """A callable like hamming_penalty_matrix over an earlier version of the
    kernel's source (same `hamming_penalty_launch` C interface)."""
    lib = compile_library(source)
    lib.hamming_penalty_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hamming_penalty_launch.restype = ctypes.c_int

    def call(q, k, qp, kp):
        res = torch.empty((q.shape[0], k.shape[0]), dtype=torch.float32, device=q.device)
        err = lib.hamming_penalty_launch(q.data_ptr(), k.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                                         res.data_ptr(), q.shape[0], k.shape[0],
                                         torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"earlier kernel launch failed ({err})")
        return res

    return call


def kernel_times(dev, card, earlier_sources):
    rng = np.random.default_rng(0)
    us = lambda fn: round(cs.device_ms(fn) * 1e3, 3)
    print(f"empty kernel device time ({card}): {us(empty_kernel())} us")
    matrix = hamming_kernel.hamming_penalty_matrix
    matrix_plain = hamming_kernel.hamming_penalty_matrix_reference
    earlier = {src: earlier_matrix_kernel(Path(src)) for src in earlier_sources}
    for M, N in ((1024, 1024), (2048, 1024), (4096, 1024)):
        a = cs.kernel_inputs(rng, M, N, dev)
        row = {"bound_us": round(cs.bound_ms(M, N, M * N * 4)[0] * 1e3, 3),
               "kernel_us": [us(lambda: matrix(*a))]}
        for src, fn in earlier.items():   # in turns: current, earlier, earlier, current
            cs.check(torch.equal(fn(*a), matrix(*a)), f"{src} and the current kernel differ")
            row[f"earlier_us {src}"] = [us(lambda: fn(*a)), us(lambda: fn(*a))]
            row["kernel_us"].append(us(lambda: matrix(*a)))
        row["plain_us"] = us(lambda: matrix_plain(*a))
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
        row["fill_of_the_output_us"] = us(lambda: out.fill_(1.0))  # the same bytes, written only
        print(f"hamming_penalty (matrix) device time at {(M, N)} ({card}): {json.dumps(row)}")

    topk = hamming_kernel.hamming_penalty_topk
    topk_plain = hamming_kernel.hamming_penalty_topk_reference
    for M, N in ((1024, 1024), (2048, 1024), (4096, 1024)):
        a = cs.kernel_inputs(rng, M, N, dev)
        row = {
            "bound_us": round(cs.bound_ms(M, N, M * cs.TOP_K * 12)[0] * 1e3, 3),
            "kernel_us": [us(lambda: topk(*a, cs.TOP_K)), us(lambda: topk(*a, cs.TOP_K))],
            "plain_us": us(lambda: topk_plain(*a, cs.TOP_K)),
            "matrix_kernel_plus_stable_sort_us": us(lambda: cs.top_k(-matrix(*a), cs.TOP_K)),
            "matrix_kernel_plus_torch_topk_us": us(
                lambda: torch.topk(matrix(*a), cs.TOP_K, largest=False)),
        }
        dm = matrix(*a)
        row["torch_topk_alone_us"] = us(lambda: torch.topk(dm, cs.TOP_K, largest=False))
        print(f"hamming_penalty_topk device time at {(M, N)} ({card}): {json.dumps(row)}")
    a = cs.kernel_inputs(rng, 1024, 1024, dev, "validity")   # match_fisheye's call
    row = {
        "bound_us": round(cs.bound_ms(1024, 1024, 1024 * 2 * 12)[0] * 1e3, 3),
        "kernel_us": [us(lambda: topk(*a, 2)), us(lambda: topk(*a, 2))],
        "plain_us": us(lambda: topk_plain(*a, 2)),
        "matrix_kernel_plus_torch_topk_us": us(lambda: torch.topk(matrix(*a), 2, largest=False)),
    }
    print(f"hamming_penalty_topk K=2 device time at (1024, 1024) ({card}): {json.dumps(row)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="write a chrome trace of the hot path's profiled frames here")
    ap.add_argument("--earlier-matrix-source", action="append", default=[],
                    help="an earlier hamming_penalty.cu to time in turns with the current one "
                         "(may be given several times)")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    hamming_kernel.load_kernels()
    frames = parity.stereo_frames(2, cs.H, cs.W, seed=0, step=cs.STEP)
    cam = make_pinhole(*cs.INTRINSICS, cs.W, cs.H, device=dev)
    bf = torch.tensor(cs.BF, device=dev)
    min_z = torch.tensor(cs.BF / cs.INTRINSICS[0], device=dev)
    hot_path(dev, card, cam, bf, min_z, frames, args.trace)
    fused_step(dev, card, cam, bf, min_z, frames)
    tracker_frames(dev, card)
    kernel_times(dev, card, args.earlier_matrix_source)


if __name__ == "__main__":
    main()
