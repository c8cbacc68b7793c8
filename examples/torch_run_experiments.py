#!/usr/bin/env python3
"""Experiment harness of the PyTorch/CUDA port (fasttrack_tpu_torch), the
counterpart of examples/run_experiments.py: sweep offload-toggle bitmasks x
pose optimization on/off over a sequence, N iterations each (the
reference's run_experiments.sh / run_script.sh workflow,
Results/poseOptimization_{on,off}/<mask>/run<i>/ layout), then write the
mean tracking time and ATE of each setting into Results/summary.json.

Each run is one process of examples/torch_run_synthetic.py (the default, no
dataset needed) or, with --euroc, of examples/torch_stereo_euroc.py, its
output in the run's ostream.txt; --device goes to every run (default: the
CUDA device).

Usage: python examples/torch_run_experiments.py [--modes 0000 1111 ...]
       [--po on off] [--iters N] [--frames N] [--results DIR]
       [--euroc SEQ --settings YAML] [--gt GT] [--device cuda:0|cpu]
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="*",
                    default=["0000", "1000", "1100", "1111"])
    ap.add_argument("--po", nargs="*", default=["on", "off"])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--results", default="Results")
    ap.add_argument("--euroc", default=None, help="EuRoC sequence dir")
    ap.add_argument("--settings", default=None, help="YAML (with --euroc)")
    ap.add_argument("--gt", default=None,
                    help="ground-truth file: every run also reports ATE "
                         "(euroc_eval_examples.sh role)")
    ap.add_argument("--device", default=None,
                    help="torch device of every run (default: the CUDA device)")
    args = ap.parse_args(argv)

    for mode, po, it in itertools.product(args.modes, args.po, range(args.iters)):
        out = os.path.join(
            args.results, f"poseOptimization_{po}", mode, f"run{it}"
        )
        os.makedirs(out, exist_ok=True)
        if args.euroc:
            cmd = [sys.executable, os.path.join(HERE, "torch_stereo_euroc.py"),
                   args.settings, args.euroc,
                   "--mode", mode, "--po", "1" if po == "on" else "0",
                   "--out", out]
            if args.gt:
                cmd += ["--gt", args.gt]
        else:
            cmd = [sys.executable, os.path.join(HERE, "torch_run_synthetic.py"),
                   "--frames", str(args.frames),
                   "--mode", mode, "--po", "1" if po == "on" else "0",
                   "--out", out]
        if args.device:
            cmd += ["--device", args.device]
        print("==>", " ".join(cmd))
        with open(os.path.join(out, "ostream.txt"), "w") as log:
            subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, check=False)

    # aggregate mean tracking times (the absent calculate_average_results.py)
    summary = {}
    for mode, po in itertools.product(args.modes, args.po):
        times = []
        base = os.path.join(args.results, f"poseOptimization_{po}", mode)
        for it in range(args.iters):
            p = os.path.join(base, f"run{it}", "summary.json")
            if os.path.exists(p):
                with open(p) as f:
                    s = json.load(f)
                if "tracking_total" in s:
                    times.append(s["tracking_total"]["mean"])
        if times:
            summary[f"{mode}/po_{po}"] = sum(times) / len(times)
        ates = []
        for it in range(args.iters):
            p = os.path.join(base, f"run{it}", "ate.json")
            if os.path.exists(p):
                with open(p) as f:
                    ates.append(json.load(f)["ate_rmse"])
        if ates:
            summary[f"{mode}/po_{po}/ate_rmse"] = sum(ates) / len(ates)
    print(json.dumps(summary, indent=2))
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
