"""Where the PyTorch port's tracking paths spend their time, on one GPU.

    python3 profile_torch.py [--trace FILE.json] [--earlier-matrix-source FILE.cu ...]
                             [--earlier-topk-source FILE.cu ...]

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
then, for the local mapper, one keyframe's LocalMapper.process_keyframe in
the middle of a System run over the same rendered sequence (inline mapping),
step by step (cull points, triangulate, fuse, local bundle adjustment, cull
keyframes): kernel launches, device busy time and host time of each step
under the profiler with a synchronise after each, beside the unprofiled host
times the mapper's own stats recorded for every keyframe of the run;
then, for the stereo-inertial system (System(..., Sensor.IMU_STEREO) over a
rendered 80-frame sequence with its IMU stream, inline mapping), one inertial
fused frame after IMU init step by step (extraction + stereo, twm_step,
tlm_step_vi, pack + fetch) and one local inertial BA window (the whole
window with its host assembly and write-back, the solve alone), with kernel
launches, device busy time and host time of each under the profiler, and
the launches of one LM iteration of the LastFrame VI optimizer, of the
keyframe-anchored one, of the visual one and of the inertial window BA
(one iteration against two, from the recorded inputs);
then the device time per call of both Hamming kernels against their plain
versions at the paths' shapes (the mapper's 10240 x 1024 triangulation launch
and a 3000 x 1024 fusion matrix among them), of the batched 4x4 SVD that
triangulates the 10240 candidate pairs, of an empty kernel (the floor under any
kernel), of a plain fill of the matrix kernel's output (the same bytes,
written only), and, with --earlier-matrix-source, of an earlier version of the
matrix kernel's source (same C interface) in turns with the current one. The
top-K kernel is timed at every shape the paths give it (TOPK_TABLE) beside
its plain version, the matrix kernel + torch.topk (+ torch.argmin at K = 1),
the number of device kernels one call launches and, for K > 2, its list
path under each split of the key side (the launch plan's evidence) and at
K = 2 (its products and strips with almost no merges); with
--earlier-topk-source, an earlier hamming_topk.cu with the first version's C
interface (a scratch buffer of 8 * (ceil(N / 32) * 32 + M) int32) is held
equal to the current kernel on +-1 inputs and timed in turns with it
(current, earlier, earlier, current). A run given an earlier source of
either kernel times the kernels only, without the paths' profiles.
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
from fasttrack_tpu_torch import convert, fused_track, local_mapping, parity, tracking
from fasttrack_tpu_torch.cameras import host_camera, make_pinhole
from fasttrack_tpu_torch.cameras.stereo import triangulate_two_view
from fasttrack_tpu_torch.frame_pipeline import (
    FrameData,
    _search_optimize_stage,
    _stereo_match_stage,
    pack_frame_for_host,
    pack_hot_path_for_host,
    process_stereo_frame_stacked,
    tracking_hot_path,
)
from fasttrack_tpu_torch.geometry import SE3, se3_identity
from fasttrack_tpu_torch.ops import cuda_build, hamming_kernel
from fasttrack_tpu_torch.ops.extractor import extract_orb_pair_stacked
from fasttrack_tpu_torch.ops.project_match import search_by_projection
from fasttrack_tpu_torch.optim import inertial, pose_optimize


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


MAPPER_STEPS = ("_track_new_points", "_cull_recent_mappoints", "_create_new_mappoints",
                "_search_in_neighbors", "_local_ba", "_cull_keyframes")


def mapper_keyframe(dev, card, n_frames=62, profiled_kid=3):
    """System.track_stereo over the rendered sequence with inline mapping;
    the keyframe `profiled_kid` (the fourth: three neighbours, a bundle
    adjustment over four cameras) runs its steps under the profiler."""
    seq = cs.generate_sequence(n_frames=n_frames, h=cs.H, w=cs.W)
    system = cs.make_system(seq, dev)
    mapper = system.local_mapper
    profiled, on = {}, {"kid": None}

    def watched(name, inner):
        def step(*args, **kwargs):
            if on["kid"] != profiled_kid:
                return inner(*args, **kwargs)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(8):          # the tracer may lose a window's first kernels
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            kernels = [k for k in cs.device_kernels(prof) if "spin_kernel" not in k.name]
            by_name = collections.Counter()
            for k in kernels:
                by_name[k.name[:70]] += k.time_range.elapsed_us()
            profiled[name.lstrip("_")] = {
                "launches": len(kernels),
                "device_busy_ms": busy_us(kernels) / 1e3 if kernels else 0.0,
                "host_ms_profiled_synchronised": host_ms,
                "top_kernels_ms": [[n, round(us / 1e3, 4)] for n, us in by_name.most_common(4)],
            }
            return out
        return step

    for name in MAPPER_STEPS:
        setattr(mapper, name, watched(name, getattr(mapper, name)))
    inner_process = mapper.process_keyframe

    def process_keyframe(kf):
        on["kid"] = kf.kid
        inner_process(kf)
        on["kid"] = None

    mapper.process_keyframe = process_keyframe
    for f in seq.frames:
        system.track_stereo(f.left, f.right, f.timestamp)
        cs.check(system.tracking_state.name == "OK", "the system lost track while profiling")
    system.shutdown()
    cs.check("local_ba" in profiled, f"keyframe {profiled_kid} was not reached or not adjusted")
    series = system.stats.series
    m = system.atlas.current
    print(json.dumps({
        "path": f"local mapper, keyframe {profiled_kid} of {int(sum(series['lm_keyframes']))}, "
                "by step", "card": card, "profiled": profiled,
        "host_ms_by_keyframe_unprofiled_but_for_the_profiled_one": {
            k[3:]: [round(v, 3) for v in series[k]] for k in (
                "lm_total", "lm_track_new_points", "lm_cull_points", "lm_triangulate", "lm_fuse",
                "lm_local_ba", "lm_cull_keyframes")},
        "counts_by_keyframe": {k[3:]: [int(v) for v in series[k]] for k in (
            "lm_points_culled", "lm_points_triangulated", "lm_points_fused")},
        "totals": {k[3:]: int(sum(series[k])) for k in (
            "lm_triangulation_passes", "lm_fuse_searches", "lm_local_bas", "lm_device_fetches")},
        "keyframes_in_map": m.n_keyframes(), "map_points": m.n_mappoints(),
    }))


def profiled(fn):
    """(result, {launches, device_busy_ms, host_ms}) of one call under the
    profiler, with a synchronise before and after."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):                  # the tracer may lose a window's first kernels
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [k for k in cs.device_kernels(prof) if "spin_kernel" not in k.name]
    return out, {"launches": len(kernels),
                 "device_busy_ms": round(busy_us(kernels) / 1e3, 4) if kernels else 0.0,
                 "host_ms_profiled_synchronised": round(host_ms, 3)}


def inertial_frame_and_window(dev, card, n_frames=80):
    """The stereo-inertial system over a rendered sequence; the last fused
    inertial frame's calls and the last inertial window's solve are
    recorded, then replayed step by step under the profiler."""
    seq = cs.generate_sequence(n_frames=n_frames, h=cs.H, w=cs.W)
    system = cs.make_inertial_system(seq, dev)
    rec = {}
    wrapped = {}
    for mod, name in ((tracking, "process_stereo_frame_stacked"), (tracking, "twm_step"),
                      (tracking, "tlm_step_vi"), (local_mapping, "local_inertial_ba")):
        inner = getattr(mod, name)

        def call(*args, _inner=inner, _name=name):
            rec[_name] = args
            return _inner(*args)

        wrapped[(mod, name)] = inner
        setattr(mod, name, call)
    windows = []
    inner_window = system.local_mapper._inertial_window_ba

    def window(chain, *args, **kwargs):
        windows.append((chain, args, kwargs))
        return inner_window(chain, *args, **kwargs)

    system.local_mapper._inertial_window_ba = window
    try:
        t_prev = -1.0
        for f in seq.frames:
            system.track_stereo(f.left, f.right, f.timestamp,
                                imu=cs.imu_between(seq, t_prev, f.timestamp))
            t_prev = f.timestamp
            cs.check(system.tracking_state.name == "OK", "the inertial system lost track")
    finally:
        for (mod, name), inner in wrapped.items():
            setattr(mod, name, inner)
    cs.check(system.atlas.current.imu_initialized and "tlm_step_vi" in rec and windows,
             "the inertial system did not reach a fused inertial frame and a window")
    series = system.stats.series
    steps = {}
    fd, steps["extraction + stereo"] = profiled(
        lambda: tracking.process_stereo_frame_stacked(*rec["process_stereo_frame_stacked"]))
    twm_args, tlm_args = rec["twm_step"], rec["tlm_step_vi"]
    twm, steps["twm_step"] = profiled(
        lambda: fused_track.twm_step(fd.kps, fd.u_right, *twm_args[2:]))
    tlm, steps["tlm_step_vi"] = profiled(
        lambda: fused_track.tlm_step_vi(fd.kps, fd.u_right, *tlm_args[2:5], twm, *tlm_args[6:]))
    _, steps["pack + fetch"] = profiled(
        lambda: fused_track.pack_fused_vi_for_host(fd, twm, tlm).cpu())
    chain, wargs, wkwargs = windows[-1]
    _, whole = profiled(lambda: system.local_mapper._inertial_window_ba(chain, *wargs, **wkwargs))
    ba_args = rec["local_inertial_ba"]
    res, solve = profiled(lambda: inertial.local_inertial_ba(*ba_args))
    _, fetch = profiled(lambda: [t.cpu() for t in (*res.states, res.points)])

    # launches of one LM iteration: one iteration against two, from the inputs above
    buf = tlm_args[-1]
    o = 246 + 298
    prev = inertial.BodyState(buf[0:9].reshape(3, 3), buf[9:12], buf[12:15], buf[15:18],
                              buf[18:21])
    pre = inertial.unpack_preintegrated(buf[246:o])
    whiten, W_prior = buf[o + 3:o + 102], buf[o + 102:].reshape(15, 15)
    cam, bf, R_bc, t_bc = tlm_args[4], tlm_args[3], tlm_args[13], tlm_args[14]
    sf = torch.tensor([cs.CFG.scale_factor ** l for l in range(cs.CFG.n_levels)], device=dev)
    obs = (twm.Xw_kp, torch.stack([fd.kps.x, fd.kps.y], -1), fd.u_right,
           1.0 / sf[fd.kps.level] ** 2, twm.bound_kp)
    calls = {
        "lastframe VI optimizer": lambda it: inertial.pose_inertial_optimize_lastframe(
            cam, bf, R_bc, t_bc, prev, buf[21:246].reshape(15, 15), pre, prev, *obs,
            rounds=1, iters=it, whiten=whiten, W_prior=W_prior),
        "keyframe-anchored VI optimizer": lambda it: inertial.pose_inertial_optimize(
            cam, bf, R_bc, t_bc, prev, pre, prev, *obs, rounds=1, iters=it, whiten=whiten),
        "visual pose optimizer": lambda it: pose_optimize(
            cam, bf, SE3(twm.pose_R, twm.pose_t), *obs, rounds=1, iters=it),
        "inertial window BA": lambda it: inertial.local_inertial_ba(*ba_args, iters=it),
    }
    per_iteration = {}
    for name, fn in calls.items():
        one = profiled(lambda: fn(1))[1]["launches"]
        two = profiled(lambda: fn(2))[1]["launches"]
        per_iteration[name] = {"launches_per_lm_iteration": two - one,
                               "launches_one_iteration_call": one}
    print(json.dumps({
        "path": "stereo-inertial system: one fused inertial frame by step (profiled, a "
                "synchronise after each), one inertial window", "card": card,
        "fused_inertial_frame": steps,
        "frame_total": {k: round(sum(v[k] for v in steps.values()), 4) for k in (
            "launches", "device_busy_ms", "host_ms_profiled_synchronised")},
        "inertial_window": {"whole, host assembly to write-back": whole, "solve": solve,
                            "fetch of states and points": fetch,
                            "states": int(ba_args[0].state_free.shape[0]),
                            "points": int(ba_args[0].points.shape[0]),
                            "dtype": str(ba_args[0].points.dtype)},
        "per_lm_iteration": per_iteration,
        "unprofiled_host_ms_median": {k: round(float(np.median(series[k])), 3) for k in (
            "fused_host_pre", "fused_dispatch", "fused_host_post", "lm_inertial_window")
            if series[k]},
        "fused_inertial_frames": int(sum(series["fused_vi_frames"])),
    }))


def triangulation_svd(dev, card):
    """The batched 4x4 SVD of triangulate_two_view at the mapper's shape (10
    neighbour keyframes x 1024 rows): device time, and the host's clock
    around a synchronised call (torch.linalg.svd checks for errors on the
    host, which synchronises)."""
    rng = np.random.default_rng(3)
    B, n = 10, 1024
    X1 = np.stack([rng.uniform(-2, 2, (B, n)), rng.uniform(-1.5, 1.5, (B, n)),
                   rng.uniform(2, 8, (B, n))], -1)
    t21 = rng.normal(0, 0.2, (B, 3))
    X2 = X1 + t21[:, None]
    r1 = torch.from_numpy((X1 / X1[..., 2:]).astype(np.float32)).to(dev)
    r2 = torch.from_numpy((X2 / X2[..., 2:]).astype(np.float32)).to(dev)
    T21 = SE3(torch.eye(3, device=dev).expand(B, 1, 3, 3).contiguous(),
              torch.from_numpy(t21.astype(np.float32)).to(dev)[:, None])
    call = lambda: triangulate_two_view(r1, r2, T21)
    err = float((call() - torch.from_numpy(X1.astype(np.float32)).to(dev)).abs().max())
    cs.check(err < 1e-2, f"triangulation of exact rays is off by {err}")
    # the profiler's kernel durations only: the call synchronises (the SVD's
    # error check), so CUDA events behind a spin kernel cannot bracket it
    device_ms = cs.profiler_ms(call, calls=5, windows=3)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"triangulate_two_view at {(B, n)} (one batched 4x4 SVD of {B * n} systems) ({card}): "
          + json.dumps({"device_ms": "not measured (the profiler dropped kernel events)"
                        if device_ms is None else round(device_ms, 4),
                        "host_ms_synchronised_median":
                        round(float(np.median(walls)), 4), "max_abs_err_m": err}))


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


def earlier_topk_kernel(source: Path):
    """A callable like hamming_penalty_topk over an earlier version of the
    kernel's source with the first version's C interface (its scratch
    buffer allocated here, as its wrapper did)."""
    lib = compile_library(source)
    lib.hamming_topk_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hamming_topk_launch.restype = ctypes.c_int

    def call(q, k, qp, kp, top):
        M, N = q.shape[0], k.shape[0]
        K = min(top, N)
        values = torch.empty((M, K), dtype=torch.float32, device=q.device)
        indices = torch.empty((M, K), dtype=torch.int64, device=q.device)
        scratch = torch.empty(8 * (-(-N // 32) * 32 + M), dtype=torch.int32, device=q.device)
        err = lib.hamming_topk_launch(q.data_ptr(), k.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                                      scratch.data_ptr(), values.data_ptr(), indices.data_ptr(),
                                      M, N, K, torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"earlier top-k kernel launch failed ({err})")
        return values, indices

    return call


def kernels_per_call(fn, calls=5) -> float:
    """Device kernels one call of `fn` launches, from torch.profiler. The
    tracer can lose the first kernels of a window, so the window opens with
    8 spin kernels that are not counted (as chip_smoke.profiler_ms does)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return len([k for k in cs.device_kernels(prof) if "spin_kernel" not in k.name]) / calls


# The top-K kernel's shapes on the paths (M, N, K, kind of input): the
# stereo match and TWM, the fused frame's TLM, match_fisheye (K = 2), the
# flat vocabulary's _assign (K = 1), the mapper's triangulation, and KITTI's
# widths (stereo, TWM and the reference-keyframe match, TLM, triangulation)
TOPK_TABLE = [(1024, 1024, 64, "random"), (2048, 1024, 64, "random"), (4096, 1024, 64, "random"),
              (1024, 1024, 2, "validity"), (1024, 4096, 1, "words"),
              (cs.EPI_ROWS, 1024, 64, "validity"), (2000, 2000, 64, "random"),
              (2000, 2000, 2, "validity"), (4096, 2000, 64, "random"),
              (20480, 2048, 64, "validity")]


def topk_times(dev, card, earlier_sources):
    rng = np.random.default_rng(4)
    us = lambda fn: round(cs.device_ms(fn) * 1e3, 3)
    topk = hamming_kernel.hamming_penalty_topk
    topk_plain = hamming_kernel.hamming_penalty_topk_reference
    matrix = hamming_kernel.hamming_penalty_matrix
    earlier = {src: earlier_topk_kernel(Path(src)) for src in earlier_sources}
    for M, N, K, kind in TOPK_TABLE:
        a = cs.kernel_inputs(rng, M, N, dev, kind)
        got = topk(*a, K)
        want = topk_plain(*a, K)
        cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                 f"top-k kernel differs from plain at {(M, N, K, kind)}")
        plan = hamming_kernel.topk_launch_plan(M, N, K)
        row = {"bound_us": round(cs.bound_ms(M, N, M * K * 12)[0] * 1e3, 3),
               "plan": {"path": plan.path, "rows": plan.rows, "ctas": plan.ctas, "split": plan.split,
                        "part_tiles": plan.part_tiles, "strip_tiles": plan.strip_tiles,
                        "shared_bytes": plan.shared_bytes},
               "kernels_per_call": kernels_per_call(lambda: topk(*a, K)),
               "kernel_us": [us(lambda: topk(*a, K))]}
        for src, fn in earlier.items():   # in turns: current, earlier, earlier, current
            old = fn(*a, K)
            cs.check(torch.equal(old[0], got[0]) and torch.equal(old[1], got[1]),
                     f"{src} and the current top-k kernel differ at {(M, N, K, kind)}")
            row[f"earlier_us {src}"] = [us(lambda: fn(*a, K)), us(lambda: fn(*a, K))]
            row[f"earlier_kernels_per_call {src}"] = kernels_per_call(lambda: fn(*a, K))
            row["kernel_us"].append(us(lambda: topk(*a, K)))
        if K > 2:
            # the plan rule's evidence, the list path under each split; and
            # at K = 2 under the picked split, where a row's threshold is its
            # second best and few keys reach its list: the same products and
            # strips with almost no merges
            picked = hamming_kernel.topk_launch_plan
            row["list_split_us"] = {}
            try:
                for split in (1, 2, 4):
                    other = hamming_kernel.topk_plan(M, N, K, hamming_kernel.PATH_LIST, split)
                    hamming_kernel.topk_launch_plan = lambda *_, plan=other: plan
                    row["list_split_us"][split] = us(lambda: topk(*a, K))
                other = hamming_kernel.topk_plan(M, N, 2, hamming_kernel.PATH_LIST, plan.split)
                hamming_kernel.topk_launch_plan = lambda *_, plan=other: plan
                row["list_path_at_k_2_us"] = us(lambda: topk(*a, 2))
            finally:
                hamming_kernel.topk_launch_plan = picked
        row["plain_us"] = us(lambda: topk_plain(*a, K))
        row["matrix_kernel_plus_torch_topk_us"] = us(
            lambda: torch.topk(matrix(*a), K, largest=False))
        if K == 1:
            row["matrix_kernel_plus_torch_argmin_us"] = us(
                lambda: torch.argmin(matrix(*a), dim=1))
        print(f"hamming_penalty_topk device time at {(M, N)}, K {K}, {kind} ({card}): "
              f"{json.dumps(row)}")


def kernel_times(dev, card, earlier_sources):
    rng = np.random.default_rng(0)
    us = lambda fn: round(cs.device_ms(fn) * 1e3, 3)
    print(f"empty kernel device time ({card}): {us(empty_kernel())} us")
    matrix = hamming_kernel.hamming_penalty_matrix
    matrix_plain = hamming_kernel.hamming_penalty_matrix_reference
    earlier = {src: earlier_matrix_kernel(Path(src)) for src in earlier_sources}
    for M, N in ((1024, 1024), (2048, 1024), (4096, 1024), cs.FUSION_SHAPE):
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



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="write a chrome trace of the hot path's profiled frames here")
    ap.add_argument("--earlier-matrix-source", action="append", default=[],
                    help="an earlier hamming_penalty.cu to time in turns with the current one "
                         "(may be given several times)")
    ap.add_argument("--earlier-topk-source", action="append", default=[],
                    help="an earlier hamming_topk.cu (the first version's C interface) to hold "
                         "equal to and time in turns with the current one (may be given several "
                         "times)")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    hamming_kernel.load_kernels()
    if not (args.earlier_matrix_source or args.earlier_topk_source):
        frames = parity.stereo_frames(2, cs.H, cs.W, seed=0, step=cs.STEP)
        cam = make_pinhole(*cs.INTRINSICS, cs.W, cs.H, device=dev)
        bf = torch.tensor(cs.BF, device=dev)
        min_z = torch.tensor(cs.BF / cs.INTRINSICS[0], device=dev)
        hot_path(dev, card, cam, bf, min_z, frames, args.trace)
        fused_step(dev, card, cam, bf, min_z, frames)
        tracker_frames(dev, card)
        mapper_keyframe(dev, card)
        inertial_frame_and_window(dev, card)
        triangulation_svd(dev, card)
    kernel_times(dev, card, args.earlier_matrix_source)
    topk_times(dev, card, args.earlier_topk_source)


if __name__ == "__main__":
    main()
