"""Where the PyTorch port's tracking hot path spends its time, on one GPU.

    python3 profile_torch.py [--trace FILE.json]

At chip_smoke.py's configuration (752x480, 8 levels, 1024 features, a
2048-point map built from the previous frame) it prints:
- stage times with a synchronise after each stage (extract, stereo match,
  search, pose optimization), median of 10 frames;
- from torch.profiler over 3 frames: kernel launches per frame, device
  busy time per frame, the device's idle share of the window, and the
  kernels with the most device time;
- the Hamming+penalty kernel's device time per call against its plain
  version's, at the path's two shapes.
Profiling slows the host, so the profiled window's idle share is an upper
bound of the unprofiled run's. Needs CUDA; imports nothing of JAX.
"""

import argparse
import collections
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fasttrack_tpu_torch import convert, parity
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.frame_pipeline import (
    _search_optimize_stage,
    _stereo_match_stage,
    pack_frame_for_host,
    pack_hot_path_for_host,
    process_stereo_frame_stacked,
    tracking_hot_path,
)
from fasttrack_tpu_torch.geometry import se3_identity
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops.extractor import extract_orb_pair_stacked
from fasttrack_tpu_torch.ops.project_match import search_by_projection


def device_kernels(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


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


def device_us_per_call(kernels, calls: int) -> dict:
    """Device time of one call from `calls` profiled calls: the mean
    duration of each kernel name times its launches per call. The tracer
    may drop the first launch of a window, so launches per call are
    rounded rather than summed."""
    by_name = collections.defaultdict(list)
    for k in kernels:
        by_name[k.name].append(k.time_range.elapsed_us())
    per_call = {n: round(len(d) / calls) for n, d in by_name.items()}
    return {
        "device_us_per_call": sum(np.mean(d) * per_call[n] for n, d in by_name.items()),
        "kernels_per_call": sum(per_call.values()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="write a chrome trace of the profiled frames here")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a GPU")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    cfg = cs.CFG
    frames = parity.stereo_frames(2, cs.H, cs.W, seed=0, step=cs.STEP)
    cam = make_pinhole(*cs.INTRINSICS, cs.W, cs.H, device=dev)
    bf = torch.tensor(cs.BF, device=dev)
    min_z = torch.tensor(cs.BF / cs.INTRINSICS[0], device=dev)
    T0 = se3_identity(device=dev)
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(dev), cfg, bf, min_z)
    prev = cs.host_frame(*pack_frame_for_host(fd))
    mp = parity.map_from_frame(prev, cs.INTRINSICS, cs.N_MAP, cfg.n_levels, shift=(-5.0, -3.0))
    lm = convert.map_from_numpy(**mp, device=dev)
    img = torch.from_numpy(frames[1]).to(dev)

    def stages():
        t = [time.perf_counter()]
        kl, kr, pl, pr = extract_orb_pair_stacked(img, cfg)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        sm, _ = _stereo_match_stage(kl, kr, pl.raw, pr.raw, cfg, bf, min_z)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        search_by_projection(lm.u, lm.v, lm.desc, lm.radius, lm.lmin, lm.lmax, lm.ok,
                             kl.x, kl.y, kl.desc_signed, kl.level, kl.valid)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        _search_optimize_stage(kl, sm.u_right, cfg, bf, cam, T0, *lm)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        d = np.diff(t) * 1e3
        return [d[0], d[1], d[2], d[3] - d[2]]  # the last stage re-runs the search

    for _ in range(3):
        stages()
    st = np.median([stages() for _ in range(10)], axis=0)
    print(f"stages ms (synchronised, {card}): extract {st[0]:.3f}, stereo {st[1]:.3f}, "
          f"search {st[2]:.3f}, pose {st[3]:.3f}")

    def frame():
        fd, res, opt = tracking_hot_path(img, cfg, bf, min_z, cam, T0, *lm)
        return pack_hot_path_for_host(fd, res, opt).cpu()

    for _ in range(3):
        frame()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            frame()
        wall_us = (time.perf_counter() - t0) * 1e6  # before the profiler's own teardown
    kernels = device_kernels(prof)
    cs.check(kernels, "the profiler recorded no device kernels")
    busy = busy_us(kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k.name][0] += k.time_range.elapsed_us()
        by_name[k.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "card": card, "frames": n, "launches_per_frame": len(kernels) / n,
        "device_busy_ms_per_frame": busy / n / 1e3,
        "profiled_wall_ms_per_frame": wall_us / n / 1e3,
        "idle_share_upper_bound": 1.0 - busy / wall_us,
        "top_kernels_ms_per_frame": [
            [name[:90], round(v[0] / n / 1e3, 4), v[1] // n] for name, v in top
        ],
    }))
    if args.trace:
        prof.export_chrome_trace(args.trace)

    rng = np.random.default_rng(0)
    for M, N in ((1024, 1024), (2048, 1024)):
        a = cs.kernel_inputs(rng, M, N, dev)
        row = {}
        for name, fn in (("kernel", hamming_kernel.hamming_penalty_matrix),
                         ("plain", hamming_kernel.hamming_penalty_matrix_reference)):
            for _ in range(3):
                fn(*a)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                for _ in range(20):
                    fn(*a)
                torch.cuda.synchronize()
            row[name] = device_us_per_call(device_kernels(p), 20)
        print(f"hamming_penalty device time at {(M, N)} ({card}): {json.dumps(row)}")


if __name__ == "__main__":
    main()
