"""The port's KITTI loader and driver and its experiment harness (M9f), on
the CPU.

KITTI: tests/test_drivers.py's layout (the renderer's 12 frames at 320x240,
seed 3, as image_0/%06d.png, image_1/ and times.txt) with its settings
file, and the renderer's trajectory in the TUM format as ground truth.

- `KittiSequence` against the JAX package's on that layout: the same
  timestamps and paths, the same images bit for bit;
- `examples/torch_kitti_stereo.py --device cpu --gt` (the shipped
  vocabulary): f_traj_kitti.txt with 12 lines of 12 numbers, kf_traj.txt,
  the stats, and an SE(3) ATE in ate.json of at most 0.02 m.

The harness: `examples/torch_run_experiments.py` lays out
Results/poseOptimization_<po>/<mask>/run<i>/ and aggregates each run's
summary.json and ate.json into Results/summary.json as the JAX harness
(examples/run_experiments.py) does:

- both harnesses over the same recorded runs (each run's process replaced
  by one that writes the same numbers): the same directories and files,
  the same summary, exact;
- the port's harness for real, `--device cpu`, masks 1111 and 1100 with
  pose optimization on, 6 frames each through
  `examples/torch_run_synthetic.py`: every run tracked and wrote the files
  the JAX script writes, with ate.json's keys, and the summary has the
  JAX harness's keys.
"""

import json
import os
import runpy
import subprocess

import numpy as np
import pytest

from fasttrack_tpu.datasets import loaders as jloaders
from fasttrack_tpu.datasets.synthetic import generate_sequence
from fasttrack_tpu_torch.datasets import KittiSequence
from fasttrack_tpu_torch.nputils import matrix_to_quat
from tests.test_drivers import save_gray, write_settings
from tests.test_torch_system import one_torch_thread

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
ATE_LIMIT_M = 0.02
N_FRAMES = 12


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    seq = generate_sequence(n_frames=N_FRAMES, h=240, w=320, seed=3)
    root = tmp_path_factory.mktemp("kitti")
    with open(root / "times.txt", "w") as f:
        for fr in seq.frames:
            f.write(f"{fr.timestamp:.6e}\n")
    gt = []
    for i, fr in enumerate(seq.frames):
        save_gray(str(root / "image_0" / f"{i:06d}.png"), fr.left)
        save_gray(str(root / "image_1" / f"{i:06d}.png"), fr.right)
        q = matrix_to_quat(fr.R_wc)       # [w x y z]
        p = fr.t_wc
        gt.append(f"{fr.timestamp:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                  f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    with open(root / "gt.txt", "w") as f:
        f.write("\n".join(gt) + "\n")
    write_settings(str(root / "s.yaml"), seq)
    return str(root)


def test_kitti_sequence_equals_jax(layout):
    got, want = KittiSequence(layout), jloaders.KittiSequence(layout)
    assert len(got) == len(want) == N_FRAMES
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.left_paths == want.left_paths and got.right_paths == want.right_paths
    assert got.left_paths[3].endswith(os.path.join("image_0", "000003.png"))
    for i in (0, N_FRAMES - 1):
        (tg, lg, rg), (tw, lw, rw) = got[i], want[i]
        assert tg == tw
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(rg, rw)
        assert lg.dtype == np.float32 and lg.shape == (240, 320)


@pytest.fixture(scope="module")
def driven(layout, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kitti_out"))
    module = runpy.run_path(os.path.join(EXAMPLES, "torch_kitti_stereo.py"))
    with one_torch_thread():
        system = module["main"]([os.path.join(layout, "s.yaml"), layout, "--out", out,
                                 "--gt", os.path.join(layout, "gt.txt"), "--device", "cpu"])
    return out, system


def test_kitti_example_writes_the_kitti_trajectory(driven):
    out, system = driven
    rows = np.loadtxt(os.path.join(out, "f_traj_kitti.txt"))
    assert rows.shape == (N_FRAMES, 12)
    M = rows[-1].reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-6)
    assert os.path.isfile(os.path.join(out, "kf_traj.txt"))
    assert os.path.isfile(os.path.join(out, "summary.json"))
    assert system.device.type == "cpu" and system.loop_closer is not None


def test_kitti_example_passes_the_ate_gate(driven):
    out, system = driven
    with open(os.path.join(out, "ate.json")) as f:
        ate = json.load(f)
    assert ate["ate_rmse"] <= ATE_LIMIT_M, ate
    assert ate["n_frames_tracked"] == N_FRAMES and ate["n_associated"] == N_FRAMES
    assert ate["scale"] == 1.0 and ate["gt"] == "gt.txt"


# ---------------------------------------------------------------- the harness
def recorded_runs(monkeypatch):
    """Replace each run's process by one that writes the run's summary.json
    and ate.json with numbers made from its mask and setting."""
    calls = []

    def run(cmd, stdout=None, stderr=None, check=False):
        out = cmd[cmd.index("--out") + 1]
        mode, po = cmd[cmd.index("--mode") + 1], cmd[cmd.index("--po") + 1]
        calls.append(os.path.basename(cmd[1]))
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump({"tracking_total": {"mean": int(mode, 2) + 0.5 * int(po)}}, f)
        with open(os.path.join(out, "ate.json"), "w") as f:
            json.dump({"ate_rmse": 0.001 * int(mode, 2)}, f)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", run)
    return calls


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, dirs, files in os.walk(root) for n in dirs + files)


def test_both_harnesses_lay_out_and_summarize_alike(tmp_path, monkeypatch):
    argv = ["--modes", "0000", "1100", "--po", "on", "off", "--iters", "2", "--frames", "5"]
    summaries, calls = {}, {}
    for name, script in (("jax", "run_experiments.py"), ("torch", "torch_run_experiments.py")):
        calls[name] = recorded_runs(monkeypatch)
        results = str(tmp_path / name)
        main = runpy.run_path(os.path.join(EXAMPLES, script))["main"]
        monkeypatch.setattr("sys.argv", [script] + argv + ["--results", results])
        main()
        with open(os.path.join(results, "summary.json")) as f:
            summaries[name] = json.load(f)
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    assert "poseOptimization_off/1100/run1/ostream.txt" in tree(tmp_path / "torch")
    assert summaries["torch"] == summaries["jax"] and len(summaries["jax"]) == 8
    assert calls["torch"] == ["torch_run_synthetic.py"] * 8
    assert calls["jax"] == ["run_synthetic.py"] * 8


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    results = str(tmp_path_factory.mktemp("harness") / "Results")
    main = runpy.run_path(os.path.join(EXAMPLES, "torch_run_experiments.py"))["main"]
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")     # each run's torch on one thread
    try:
        summary = main(["--modes", "1111", "1100", "--po", "on", "--frames", "6",
                        "--results", results, "--device", "cpu"])
    finally:
        mp.undo()
    return results, summary


def test_the_harness_runs_the_port_on_every_setting(harness):
    results, summary = harness
    assert sorted(summary) == ["1100/po_on", "1100/po_on/ate_rmse",
                               "1111/po_on", "1111/po_on/ate_rmse"]
    with open(os.path.join(results, "summary.json")) as f:
        assert json.load(f) == summary
    for mode in ("1111", "1100"):
        run = os.path.join(results, "poseOptimization_on", mode, "run0")
        with open(os.path.join(run, "ostream.txt")) as f:
            log = f.read()
        assert "tracked 6/6 frames" in log, log[-2000:]
        with open(os.path.join(run, "ate.json")) as f:
            ate = json.load(f)
        assert sorted(ate) == ["ate_rmse", "gt", "n_associated"] and ate["gt"] == "synthetic-exact"
        assert ate["ate_rmse"] < 0.05 and summary[f"{mode}/po_on/ate_rmse"] == ate["ate_rmse"]
        assert len(np.loadtxt(os.path.join(run, "f_traj.txt"))) == 6
        for name in ("kf_traj.txt", "summary.json", os.path.join("data", "tracking_total.txt")):
            assert os.path.isfile(os.path.join(run, name)), name
