"""The port's TUM RGB-D loader and example script (M9d), on the CPU.

A TUM RGB-D layout is written from the rendered sweep (320x240 at 20 fps,
seed 3, 24 frames): rgb/<t>.png (8-bit), depth/<t>.png (16-bit, metres x
5000, as the TUM RGB-D distribution stores them), rgb.txt and depth.txt
with the depth stamps 6 ms after the images' (an extra image with no depth
map within 0.02 s and an extra depth map with no image), groundtruth.txt
in the TUM trajectory format, and a settings file in ORB-SLAM3's TUM1.yaml
form at the renderer's camera (Stereo.b giving Camera.bf 40, ThDepth 40,
512 features, 4 levels).

- `TumRgbdSequence` against the JAX package's on that layout: the same
  association (nearest stamp within `max_dt` 0.02 s; the frame without a
  depth map left out; with `max_dt` 0.005 s every frame left out), the
  same images and depth maps, bit for bit; the depth is the 16-bit value
  over 5000, within the renderer's depth by half a step (0.1 mm);
- `examples/torch_tum_rgbd.py --device cpu --gt` on the layout (the
  shipped vocabulary): every frame tracked, the trajectory, keyframe and
  stats files written, and the SE(3) ATE in ate.json at most 0.02 m (the
  port reads 0.0099 m);
- ROADMAP F42: neither package's settings read DepthMapFactor, so the
  example's hook, the JAX example's own, never fires, and a sequence
  stored at another factor is read at 5000.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from fasttrack_tpu.datasets import loaders as jloaders
from fasttrack_tpu.settings import load_settings as jax_load_settings
from fasttrack_tpu_torch.datasets import TumRgbdSequence, synthetic
from fasttrack_tpu_torch.nputils import matrix_to_quat
from fasttrack_tpu_torch.settings import load_settings

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLE = os.path.join(ROOT, "examples", "torch_tum_rgbd.py")
H, W = 240, 320
N_FRAMES = 24
T0 = 1305031102.0          # a TUM RGB-D stamp (fr1), seconds
DEPTH_LAG_S = 0.006
ATE_LIMIT_M = 0.02

SETTINGS_YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 256.0
Camera1.fy: 256.0
Camera1.cx: 160.0
Camera1.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 20.0
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.b: 0.15625
RGBD.DepthMapFactor: {factor}
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_png(path, array):
    from PIL import Image

    Image.fromarray(array).save(path)


def write_layout(root, factor=5000.0):
    """The rendered sweep as a TUM RGB-D sequence at `factor`; returns the
    settings file's path."""
    seq, depths = synthetic.generate_rgbd_sequence(N_FRAMES, H, W, fps=20.0, seed=3)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb_lines, depth_lines, gt_lines = ["# color images"], ["# depth maps"], ["# ground truth"]
    for f, d in zip(seq.frames, depths):
        t = T0 + f.timestamp
        name = f"{t:.6f}.png"
        write_png(os.path.join(root, "rgb", name), np.clip(np.round(f.left), 0, 255).astype(np.uint8))
        dname = f"{t + DEPTH_LAG_S:.6f}.png"
        write_png(os.path.join(root, "depth", dname), np.round(d * factor).astype(np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        depth_lines.append(f"{t + DEPTH_LAG_S:.6f} depth/{dname}")
        q = matrix_to_quat(f.R_wc)        # [w x y z]
        p = f.t_wc
        gt_lines.append(f"{t:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                        f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    # an image with no depth map within max_dt, and a depth map with no image
    t_last = T0 + seq.frames[-1].timestamp
    rgb_lines.append(f"{t_last + 0.5:.6f} rgb/{t_last:.6f}.png")
    depth_lines.append(f"{t_last + 2.0:.6f} depth/{t_last + DEPTH_LAG_S:.6f}.png")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    settings = os.path.join(root, "TUM1.yaml")
    with open(settings, "w") as fh:
        fh.write(SETTINGS_YAML.format(factor=factor))
    return settings, seq, depths


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tum_rgbd"))
    settings, seq, depths = write_layout(root)
    return root, settings, seq, depths


def run_script(argv):
    old = sys.argv
    sys.argv = [EXAMPLE] + argv
    try:
        runpy.run_path(EXAMPLE, run_name="__main__")
    finally:
        sys.argv = old


def test_tum_rgbd_sequence_equals_jax(layout):
    root, _, _, depths = layout
    got, want = TumRgbdSequence(root), jloaders.TumRgbdSequence(root)
    assert len(got) == len(want) == N_FRAMES           # the unpaired image is left out
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.rgb_paths == want.rgb_paths and got.depth_paths == want.depth_paths
    assert got.depth_factor == want.depth_factor == 5000.0
    for i in (0, N_FRAMES - 1):
        (tg, ig, dg), (tw, iw, dw) = got[i], want[i]
        assert tg == tw
        np.testing.assert_array_equal(ig, iw)
        np.testing.assert_array_equal(dg, dw)
        assert dg.dtype == np.float32 and dg.shape == (H, W)
        # 16-bit at 5000: the renderer's depth within half a step
        assert np.abs(dg - depths[i]).max() <= 0.5 / 5000 + 1e-6


def test_tum_rgbd_sequence_association_takes_max_dt(layout):
    root = layout[0]
    for max_dt in (0.005, 0.0065):
        got = TumRgbdSequence(root, max_dt=max_dt)
        want = jloaders.TumRgbdSequence(root, max_dt=max_dt)
        assert len(got) == len(want) == (0 if max_dt < DEPTH_LAG_S else N_FRAMES)


def test_example_tracks_the_layout_and_passes_the_ate_gate(layout, tmp_path):
    root, settings = layout[:2]
    out = str(tmp_path / "out")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_script([settings, root, "--out", out, "--gt", os.path.join(root, "groundtruth.txt"),
                    "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    with open(os.path.join(out, "ate.json")) as fh:
        ate = json.load(fh)
    assert ate["n_frames_tracked"] == ate["n_associated"] == N_FRAMES
    assert ate["ate_rmse"] <= ATE_LIMIT_M, ate
    for name in ("f_traj.txt", "kf_traj.txt"):
        with open(os.path.join(out, name)) as fh:
            assert len(fh.read().splitlines()) >= (N_FRAMES if name == "f_traj.txt" else 1)
    assert any(name.endswith(".json") and name != "ate.json" for name in os.listdir(out))


def test_f42_depth_map_factor_is_not_read(tmp_path, monkeypatch):
    """A sequence stored at 1000 with a settings file that says so: neither
    package's settings hold the factor, and the example hands the System
    the depth read at 5000 (a fifth of the truth), as the JAX example
    does."""
    root = str(tmp_path / "seq")
    os.makedirs(root)
    settings, _, depths = write_layout(root, factor=1000.0)
    assert not hasattr(load_settings(settings, device="cpu"), "depth_map_factor")
    assert not hasattr(jax_load_settings(settings), "depth_map_factor")
    from fasttrack_tpu_torch import system

    seen = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            self.tracking_state = system.TrackingState.OK
            self.tracker = type("T", (), {"trajectory": []})()
            self.stats = type("S", (), {"mean": lambda self, k: 0.0})()

        def track_rgbd(self, img, depth, t, imu=None):
            seen.append(depth)

        def __getattr__(self, name):
            return lambda *a, **k: None

    monkeypatch.setattr(system, "System", Recorder)
    run_script([settings, root, "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert len(seen) == N_FRAMES
    np.testing.assert_allclose(seen[0], np.round(depths[0] * 1000.0) / 5000.0, rtol=0, atol=1e-6)
