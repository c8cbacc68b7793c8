"""The port's TUM-VI loader and example script, and its EuRoC script on a
distorted pair, on the CPU.

Both rigs are rendered by datasets.synthetic and written in the mav0
layout the datasets are distributed in (cam0/cam1 PNGs named by their ns
timestamps, imu0/data.csv, a ground-truth CSV and a File.version 1.0
settings file with the rig's calibration):

- `TumViSequence`: equal to the JAX package's on that layout (timestamps,
  paths, images bit-equal, the IMU stream);
- `examples/torch_stereo_tumvi.py` on a KB8 pair (320x320, 20 frames):
  every frame tracked through the fisheye route, its ATE line under the
  EuRoC script's gate of 0.10 m (a KB8 map's bundle adjustment has mono
  edges only, ROADMAP F24, and TUM-VI's 190 px focal length scaled to
  320 px resolves 0.5 deg a pixel), and
  `--imu` without imu0/data.csv exits with an error that names it;
- `examples/torch_stereo_euroc.py` on a distorted (radtan) pair with a
  rotated extrinsic, settings.yaml as EuRoC writes it (Camera1.k1 ...,
  Camera2.*, Stereo.T_c1_c2): rectified at start-up, all 16 frames
  tracked, the ATE gate of the EuRoC script's test (under 0.10 m).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from fasttrack_tpu.datasets import loaders as jloaders
from fasttrack_tpu_torch.datasets import TumViSequence, synthetic
from tests.test_torch_euroc_example import EXAMPLES, one_torch_thread, run_script

BASE_NS = 1520530308199447626


def _matrix(T):
    return ("!!opencv-matrix\n   rows: 4\n   cols: 4\n   dt: f\n   data: ["
            + ", ".join(f"{v:.12f}" for v in np.asarray(T).reshape(-1)) + "]\n")


def write_mav0(root, seq, rig, settings_head, imu=True):
    """The rendered sequence in the mav0 layout, with gt.txt and
    settings.yaml (`settings_head` plus the rig's calibration)."""
    cams = [os.path.join(root, "mav0", c, "data") for c in ("cam0", "cam1")]
    for c in cams:
        os.makedirs(c, exist_ok=True)
    gt = ["#timestamp [ns],p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    from scipy.spatial.transform import Rotation

    for f in seq.frames:
        ns = BASE_NS + int(round(f.timestamp * 1e9))
        for c, img in zip(cams, (f.left, f.right)):
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(c, f"{ns}.png"))
        x, y, z, w = Rotation.from_matrix(f.R_wc).as_quat()
        p = f.t_wc
        gt.append(f"{ns}.0,{p[0]:.10f},{p[1]:.10f},{p[2]:.10f},{w:.10f},{x:.10f},{y:.10f},{z:.10f}")
    with open(os.path.join(root, "gt.txt"), "w") as fh:
        fh.write("\n".join(gt) + "\n")
    if imu:
        os.makedirs(os.path.join(root, "mav0", "imu0"), exist_ok=True)
        rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
        for t, g, a in zip(seq.imu_t, seq.imu_gyro, seq.imu_acc):
            ns = BASE_NS + int(round(float(t) * 1e9))
            rows.append(f"{ns},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}")
        with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    names = (["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"] if rig.kind == "kb8"
             else ["fx", "fy", "cx", "cy"])
    lines = [settings_head]
    for i, (params, dist) in enumerate(((rig.params1, rig.dist1), (rig.params2, rig.dist2)), 1):
        lines += [f"Camera{i}.{n}: {float(v)!r}" for n, v in zip(names, params)]
        if dist is not None:
            lines += [f"Camera{i}.{n}: {float(v)!r}" for n, v in zip(("k1", "k2", "p1", "p2"), dist)]
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    lines += ["Stereo.T_c1_c2: " + _matrix(rig.T_c1_c2), "IMU.T_b_c1: " + _matrix(T_b_c1),
              "IMU.Frequency: 200.0"]
    with open(os.path.join(root, "settings.yaml"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


HEAD = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "{kind}"
Camera.width: {w}
Camera.height: {h}
Camera.fps: 20.0
Stereo.ThDepth: 60.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4"""


@pytest.fixture(scope="module")
def tumvi(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tumvi"))
    rig = synthetic.tumvi_kb8_rig(320, 320, baseline=0.2)
    seq = synthetic.generate_sequence(n_frames=20, h=320, w=320, seed=5, rig=rig, plane_z=3.0)
    write_mav0(root, seq, rig, HEAD.format(kind="KannalaBrandt8", w=320, h=320))
    return root


def test_tumvi_sequence_equals_jax(tumvi):
    got, want = TumViSequence(tumvi), jloaders.TumViSequence(tumvi)
    assert len(got) == len(want) == 20
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.left_paths == want.left_paths and got.right_paths == want.right_paths
    for i in (0, 19):
        (tg, lg, rg), (tw, lw, rw) = got[i], want[i]
        assert tg == tw and lg.shape == (320, 320)
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(rg, rw)
    for name in ("t", "gyro", "acc"):
        np.testing.assert_array_equal(getattr(got.imu, name), getattr(want.imu, name))


def test_tumvi_example_tracks_the_fisheye_pair(tumvi, tmp_path):
    out = tmp_path / "out"
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_stereo_tumvi.py"), [
            os.path.join(tumvi, "settings.yaml"), tumvi, "--out", str(out),
            "--gt", os.path.join(tumvi, "gt.txt"), "--device", "cpu"])
    with open(out / "ate.json") as f:
        ate = json.load(f)
    assert ate["n_frames_tracked"] == 20 and ate["n_associated"] == 20, ate
    assert np.isfinite(ate["ate_rmse"]) and ate["ate_rmse"] < 0.10, ate
    assert (out / "f_traj.txt").is_file() and (out / "kf_traj.txt").is_file()
    # the fisheye route: extraction and the K = 2 match on the device, no
    # rectified stereo stage
    assert (out / "data" / "orb_extraction.txt").is_file()


def test_tumvi_example_with_imu_needs_the_imu_stream(tmp_path):
    root = str(tmp_path / "seq")
    rig = synthetic.tumvi_kb8_rig(64, 64)
    seq = synthetic.generate_sequence(n_frames=2, h=64, w=64, rig=rig)
    write_mav0(root, seq, rig, HEAD.format(kind="KannalaBrandt8", w=64, h=64), imu=False)
    with pytest.raises(SystemExit) as e:
        run_script(os.path.join(EXAMPLES, "torch_stereo_tumvi.py"), [
            os.path.join(root, "settings.yaml"), root, "--imu", "--out", str(tmp_path / "o"),
            "--device", "cpu"])
    assert isinstance(e.value.code, str) and "imu0/data.csv" in e.value.code
    assert not (tmp_path / "o").exists()


def test_euroc_example_rectifies_a_distorted_settings_file(tmp_path):
    root = str(tmp_path / "euroc")
    rig = synthetic.euroc_radtan_rig(320, 240)
    seq = synthetic.generate_sequence(n_frames=16, h=240, w=320, seed=3, rig=rig)
    write_mav0(root, seq, rig, HEAD.format(kind="PinHole", w=320, h=240), imu=False)
    out = tmp_path / "out"
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_stereo_euroc.py"), [
            os.path.join(root, "settings.yaml"), root, "--out", str(out),
            "--gt", os.path.join(root, "gt.txt"), "--device", "cpu"])
    with open(out / "ate.json") as f:
        ate = json.load(f)
    assert ate["n_frames_tracked"] == 16 and ate["n_associated"] >= 10, ate
    assert np.isfinite(ate["ate_rmse"]) and ate["ate_rmse"] < 0.10, ate
    with open(out / "data" / "rectify_remap.txt") as f:
        assert len(f.read().splitlines()) == 16      # every frame remapped on the host
