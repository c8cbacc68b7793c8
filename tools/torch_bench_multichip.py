#!/usr/bin/env python3
"""The landmark-sharded bundle adjustment's scaling bench, for the port.

The counterpart of tools/bench_multichip.py: the same synthetic
covisibility window (default 100 keyframes, 10,240 points, 8 observations a
point; `parallel.dryrun.make_problem` draws it bit for bit as the JAX tool
does), 8 LM iterations at 1, 2, 4 and 8 shards, and beside each the split
of an iteration that the JAX table never had: shard compute, the reduction
(and all-reduce), the replicated solve, back-substitution, the cost pass
and the cost's fetch (`parallel.SectionTimer`: CUDA events on the card, the
host's clock on the CPU). Every time is printed beside the card's name and
power limit.

CAVEAT, printed with the result: the shards here are shards of ONE device
(cuda:0, or the CPU), run one after another; the table measures the sharded
program's work and overhead against N, not an interconnect.

    python tools/torch_bench_multichip.py [--device cpu]
    python tools/torch_bench_multichip.py --processes N [--shards M] [--device cpu]

`--processes N` spawns N processes that join one torch.distributed group
(gloo: the processes share one card, or run on the CPU), each with M shards
(default 1), and solve the same seeded window (BMC_K, BMC_L, BMC_ITERS;
default 40 keyframes, 4,096 points, 6 iterations) with the partial systems
all-reduced across them; process 0 prints the MULTIHOST line, with the
all-reduce's share of an iteration.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

CAVEAT = ("the shards are shards of one device, run one after another: the table measures "
          "the sharded program's work and overhead against N, not an interconnect")


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or that the
    device is the host's CPU."""
    if torch.device(device).type != "cuda":
        return "host CPU (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.device(device).index or 0].strip()


SHARDS = (1, 2, 4, 8)


def main(device=None):
    """The scaling table: the window (BMC_K, BMC_L, BMC_ITERS) at each of
    SHARDS shards of one device (None: the card, cuda:0). Prints a line per
    N and the JSON table, and returns the table."""
    from fasttrack_tpu_torch import convert
    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.device import resolve
    from fasttrack_tpu_torch.parallel import make_mesh
    from fasttrack_tpu_torch.parallel.dryrun import make_problem, timed_solve

    K = int(os.environ.get("BMC_K", 100))
    L = int(os.environ.get("BMC_L", 10240))
    iters = int(os.environ.get("BMC_ITERS", 8))
    dev = resolve(device)
    where = card(dev)
    arrays, cam_args, bf, n_obs = make_problem(K=K, L=L)
    problem = convert.ba_problem_from_numpy(arrays, dev)
    cam = make_pinhole(*cam_args, device=dev)
    table = []
    for n in SHARDS:
        (_, _, costs, _, _), seconds, split = timed_solve(
            problem, cam, bf, make_mesh(n, device=dev), iters)
        row = {"n_shards": n, "ms_per_iter": 1e3 * seconds / iters,
               "iters_per_s": iters / seconds, "split_ms_per_iter": split,
               "cost_initial": costs[0], "cost_final": costs[-1], "accepted": len(costs) - 1}
        table.append(row)
        print(f"N={n}: {row['ms_per_iter']:.2f} ms/iteration ("
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
              + f" ms), cost {costs[0]:.1f} -> {costs[-1]:.3f} ({where})", flush=True)
    out = {"bench": "dist_ba_scaling", "device": str(dev), "card": where,
           "window": {"keyframes": K, "points": L, "observations": n_obs},
           "iters": iters, "table": table, "caveat": CAVEAT}
    print(json.dumps(out), flush=True)
    return out


def worker(process_id: int, num_processes: int, port: int):
    """One process of a multi-process run: join the group, take the SAME
    seeded window as every other process, shard it over the group's global
    shards and solve it, the partial systems all-reduced across the
    processes. Process 0 prints the MULTIHOST line."""
    import torch.distributed as dist

    from fasttrack_tpu_torch import convert
    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.parallel import (
        initialize_distributed,
        make_global_mesh,
        shard_ba_problem,
    )
    from fasttrack_tpu_torch.parallel.dryrun import make_problem, timed_solve

    device = os.environ.get("BMC_DEVICE") or None
    if not initialize_distributed(f"localhost:{port}", num_processes, process_id, device=device):
        raise RuntimeError("initialize_distributed joined no group")
    try:
        K = int(os.environ.get("BMC_K", 40))
        L = int(os.environ.get("BMC_L", 4096))
        iters = int(os.environ.get("BMC_ITERS", 6))
        mesh = make_global_mesh(device=device, n_devices=int(os.environ.get("BMC_SHARDS", 1)))
        arrays, cam_args, bf, n_obs = make_problem(K=K, L=L, obs_per_point=6)
        problem = shard_ba_problem(convert.ba_problem_from_numpy(arrays, "cpu"), mesh)
        cam = make_pinhole(*cam_args, device=mesh.devices[0])
        (poses, _, costs, inlier, _), seconds, split = timed_solve(problem, cam, bf, mesh, iters)
        if process_id == 0:
            total = sum(split.values())
            print("MULTIHOST " + json.dumps({
                "bench": "dist_ba_multihost", "processes": num_processes,
                "backend": dist.get_backend(), "local_shards": len(mesh.devices),
                "global_shards": mesh.size, "device": str(mesh.devices[0]),
                "card": card(mesh.devices[0]),
                "window": {"keyframes": K, "points": L, "observations": n_obs},
                "iters": iters, "seconds": seconds, "ms_per_iter": 1e3 * seconds / iters,
                "split_ms_per_iter": split, "reduce_share": split["reduce"] / total,
                "costs": costs, "cost_initial": costs[0], "cost_final": costs[-1],
                "poses_t": poses.t.cpu().tolist(), "inliers": int(inlier.sum()),
            }), flush=True)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess(num_processes: int, shards_per_process: int = 1, device=None,
                     timeout: float = 600.0, env=None) -> dict:
    """Spawn `num_processes` processes of `worker` on a free local port, each
    with `shards_per_process` shards of `device` (None: the card), one torch
    thread each, and `env` added to their environment; waits for all of
    them (at most `timeout` seconds each, then every one is killed), fails
    on any non-zero exit and returns process 0's MULTIHOST line."""
    here = os.path.abspath(__file__)
    port = free_port()
    procs = []
    for pid in range(num_processes):
        child = dict(os.environ, **(env or {}))
        child.update(BMC_WORKER=f"{pid}:{num_processes}:{port}",
                     BMC_SHARDS=str(shards_per_process), BMC_DEVICE=device or "",
                     OMP_NUM_THREADS="1",
                     PYTHONPATH=os.path.dirname(os.path.dirname(here))
                     + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, here], env=child, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {pid} failed, rc {p.returncode}:\n{o[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("MULTIHOST "):
            print(line, flush=True)
            return json.loads(line[len("MULTIHOST "):])
    raise RuntimeError(f"no MULTIHOST line from process 0:\n{outs[0][-3000:]}")


if __name__ == "__main__":
    if os.environ.get("BMC_WORKER"):
        torch.set_num_threads(1)
        pid, nproc, port = os.environ["BMC_WORKER"].split(":")
        worker(int(pid), int(nproc), int(port))
    else:
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        ap.add_argument("--processes", type=int, default=0)
        ap.add_argument("--shards", type=int, default=1, help="shards a process (--processes)")
        ap.add_argument("--device", default=None, help='"cpu" (default: the card)')
        a = ap.parse_args()
        if a.processes:
            run_multiprocess(a.processes, a.shards, a.device)
        else:
            main(a.device)
