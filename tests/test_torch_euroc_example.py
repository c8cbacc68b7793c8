"""The port's settings parser, EuRoC loader and EuRoC example script, on the CPU.

- `load_settings`: field for field equal to the JAX package's on the
  settings file that the JAX package's example-script tests write, with and without
  a distortion, extrinsic and IMU block (cameras compared by kind, size and
  parameters);
- `EurocSequence`, `load_image`, `ImuData`: equal to the JAX package's on
  the layout that tools/render_euroc_synthetic.py writes;
- `examples/torch_stereo_euroc.py` end to end on that layout with
  `--device cpu --gt`: the ATE gate of the JAX package's test of its script
  (`ate_rmse < 0.10`, `n_associated >= 10`), and an ATE no worse than the
  JAX script's on the same files by more than 5 mm, both scripts with their
  package's shipped vocabulary (place recognition on), the JAX one on its
  own native build;
- `--imu` on a rendered layout of 70 frames with its IMU stream (the
  inertial gate, ROADMAP F6: IMU init needs 2 s of keyframes, which 16
  frames never reach): ate.json says `imu_initialized` and the ATE is
  under 0.10 m; on a layout without `imu0/data.csv` the script exits with
  an error that names it;
- `--mode` and `--po` run the offload toggles' host sides: `--mode 0000
  --po 0` (everything on the host, pose optimization bypassed) and `--mode
  1011` (device extraction, host stereo) track all 16 frames and pass the
  same ATE gate;
- `examples/torch_mono_euroc.py` (M9b) on the same layout with `--device
  cpu --gt`, beside the JAX package's `examples/mono_euroc.py` on the same
  files: it initializes, writes the trajectory files, and its Sim(3)
  ATE is no worse than the JAX script's by more than 5 mm; with `--imu`
  (M9c) on the 70-frame layout with its IMU stream that the stereo script's
  inertial gate renders: the IMU initializes, the trajectory and stats
  files are written, and the SE(3) ATE is under twice the port's reading,
  over all frames and over those after the IMU init.
"""

import contextlib
import dataclasses
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from fasttrack_tpu.datasets import loaders as jloaders
from fasttrack_tpu.settings import load_settings as jax_load_settings
from fasttrack_tpu_torch.datasets import EurocSequence, ImuData, load_image, loaders
from fasttrack_tpu_torch.settings import Settings, load_settings
from tests.test_torch_host_kernels import jax_native_library

ROOT = os.path.join(os.path.dirname(__file__), "..")
# examples/torch_mono_euroc.py --imu on the 70 frames (the port reads 0.129 m
# over all of them, the visual map's scale drifting before the IMU init, and
# 0.0131 m over the 26 from the init's frame on): twice the first reading,
# 1.5 times the second
MONO_IMU_ATE_LIMIT_M, MONO_IMU_ATE_AFTER_INIT_LIMIT_M = 0.26, 0.02
EXAMPLES = os.path.join(ROOT, "examples")
TOOLS = os.path.join(ROOT, "tools")

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
Stereo.ThDepth: 60.0
Stereo.b: 0.11
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
{extra}
"""

DISTORTED = """Camera1.k1: -0.28
Camera1.k2: 0.07
Camera1.p1: 0.0002
Camera1.p2: 0.00002
Camera2.fx: 257.0
Camera2.fy: 256.5
Camera2.cx: 161.0
Camera2.cy: 119.0
Camera2.k1: -0.27
Camera2.k2: 0.06
Camera2.p1: 0.0
Camera2.p2: 0.0
Camera2.k3: 0.001
Camera.newWidth: 160
Camera.newHeight: 120
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.11, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.0, -1.0, 0.0, 0.01, 1.0, 0.0, 0.0, 0.02, 0.0, 0.0, 1.0, 0.03, 0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 0.0002
IMU.NoiseAcc: 0.003
IMU.GyroWalk: 0.00002
IMU.AccWalk: 0.004
IMU.Frequency: 400.0
System.LoadAtlasFromFile: "in.osa"
System.SaveAtlasToFile: "out.osa"
ORBextractor.iniThFAST: 15
ORBextractor.minThFAST: 5
"""


@contextlib.contextmanager
def one_torch_thread():
    """The test workers share the machine's cores, and the port's thousands
    of small CPU ops per frame thrash when every worker's torch pool spins a
    thread per core: the long runs below take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_script(path, argv):
    old = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


# -------------------------------------------------------------------- settings
def assert_settings_equal(got: Settings, want):
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("camera1", "camera2"):
            assert (g is None) == (w is None), name
            if g is not None:
                assert (g.kind, g.width, g.height) == (w.kind, w.width, w.height)
                np.testing.assert_array_equal(g.params.numpy(), np.asarray(w.params))
                assert g.params.device.type == "cpu"
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w and type(g) is type(w), name


@pytest.mark.parametrize("extra", ["", DISTORTED, "Camera.bf: 30.5\n"],
                         ids=["plain", "distorted+imu+atlas", "legacy-bf"])
def test_load_settings_equals_jax(tmp_path, extra):
    path = str(tmp_path / "s.yaml")
    yaml = SETTINGS_YAML.format(extra=extra)
    if extra.startswith("Camera.bf"):
        yaml = yaml.replace("Stereo.b: 0.11\n", "")
    with open(path, "w") as f:
        f.write(yaml)
    got, want = load_settings(path, device="cpu"), jax_load_settings(path)
    assert_settings_equal(got, want)
    assert got.bf == pytest.approx(30.5 if extra.startswith("Camera.bf") else 256.0 * 0.11)
    if extra == DISTORTED:
        assert got.dist2.shape == (5,) and got.T_b_c1[0, 1] == -1.0 and got.new_width == 160


def test_load_settings_reads_fisheye_and_the_monocular_prefix(tmp_path):
    path = str(tmp_path / "s.yaml")
    with open(path, "w") as f:
        f.write("""%YAML:1.0
Camera.type: "KannalaBrandt8"
Camera.fx: 190.0
Camera.fy: 191.0
Camera.cx: 254.0
Camera.cy: 256.0
Camera.k1: 0.003
Camera.k2: 0.0007
Camera.k3: -0.0002
Camera.k4: 0.00002
Camera.width: 512
Camera.height: 512
""")
    assert_settings_equal(load_settings(path, device="cpu"), jax_load_settings(path))


def test_settings_defaults_equal_jax_and_need_no_yaml():
    from fasttrack_tpu.settings import Settings as JaxSettings

    assert_settings_equal(Settings(), JaxSettings())
    # the YAML parser is loaded where a file is read, not with the module
    import fasttrack_tpu_torch.settings as module

    assert "yaml" not in vars(module)


def test_load_settings_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "s.yaml")
    with open(path, "w") as f:
        f.write(SETTINGS_YAML.format(extra=""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_settings(path)


# ---------------------------------------------------------------- the rendered layout
@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    run_script(os.path.join(TOOLS, "render_euroc_synthetic.py"), [root, "--frames", "16"])
    return root


def test_euroc_sequence_equals_jax(rendered):
    got, want = EurocSequence(rendered), jloaders.EurocSequence(rendered)
    assert len(got) == len(want) == 16
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.left_paths == want.left_paths and got.right_paths == want.right_paths
    for i in (0, 7, 15):
        (tg, lg, rg), (tw, lw, rw) = got[i], want[i]
        assert tg == tw and lg.dtype == np.float32 and lg.shape == (240, 320)
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(rg, rw)
    assert isinstance(got.imu, ImuData)
    for name in ("t", "gyro", "acc"):
        np.testing.assert_array_equal(getattr(got.imu, name), getattr(want.imu, name))
    t0, t1 = got.timestamps[2], got.timestamps[3]
    between, want_between = got.imu.between(t0, t1), want.imu.between(t0, t1)
    assert len(between) == len(want_between) > 0
    for (ta, aa, ga), (tb, ab, gb) in zip(between, want_between):
        assert ta == tb and (aa == ab).all() and (ga == gb).all()
    np.testing.assert_array_equal(load_image(got.left_paths[1]),
                                  jloaders.load_image(want.left_paths[1]))


def test_euroc_sequence_takes_a_timestamps_file(rendered, tmp_path):
    stamps = sorted(os.path.splitext(p)[0]
                    for p in os.listdir(os.path.join(rendered, "mav0", "cam0", "data")))
    path = tmp_path / "stamps.txt"
    path.write_text("\n".join(stamps[::2]) + "\n\n")
    got = EurocSequence(rendered, str(path))
    want = jloaders.EurocSequence(rendered, str(path))
    assert len(got) == 8 and got.left_paths == want.left_paths
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert loaders.EurocSequence is EurocSequence


def test_rendered_settings_equal_jax(rendered):
    path = os.path.join(rendered, "settings.yaml")
    assert_settings_equal(load_settings(path, device="cpu"), jax_load_settings(path))


# ------------------------------------------------------------ the example script
@pytest.fixture(scope="module")
def driven(rendered, tmp_path_factory):
    """The port's script and the JAX package's on the same rendered files."""
    out_t = str(tmp_path_factory.mktemp("out_torch"))
    out_j = str(tmp_path_factory.mktemp("out_jax"))
    args = [os.path.join(rendered, "settings.yaml"), rendered,
            "--gt", os.path.join(rendered, "gt.txt")]
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_stereo_euroc.py"),
                   args + ["--out", out_t, "--device", "cpu"])
    # both scripts load their package's shipped vocabulary; the JAX side runs
    # its own native build (the tree vocabulary's host Hamming matrix)
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        run_script(os.path.join(EXAMPLES, "stereo_euroc.py"), args + ["--out", out_j])
    return out_t, out_j


def test_example_passes_the_ate_gate(driven):
    out_t, _ = driven
    ate_path = os.path.join(out_t, "ate.json")
    assert os.path.exists(ate_path)
    with open(ate_path) as f:
        ate = json.load(f)
    assert np.isfinite(ate["ate_rmse"])
    assert ate["ate_rmse"] < 0.10, ate  # cm-level on the easy scene
    assert ate["n_associated"] >= 10
    assert ate["n_frames_tracked"] == 16 and ate["gt"] == "gt.txt"


def test_example_ate_no_worse_than_the_jax_example(driven):
    out_t, out_j = driven
    with open(os.path.join(out_t, "ate.json")) as f:
        got = json.load(f)
    with open(os.path.join(out_j, "ate.json")) as f:
        want = json.load(f)
    assert got["n_associated"] == want["n_associated"]
    assert got["ate_rmse"] <= want["ate_rmse"] + 0.005


@pytest.mark.parametrize("name", ["f_traj.txt", "f_traj_euroc.txt", "kf_traj.txt"])
def test_example_writes_the_trajectories_of_the_jax_example(driven, name):
    out_t, out_j = driven
    got, want = np.loadtxt(os.path.join(out_t, name)), np.loadtxt(os.path.join(out_j, name))
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=2e-3)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12)


def test_example_writes_stats(driven):
    out_t, _ = driven
    assert os.path.isfile(os.path.join(out_t, "summary.json"))
    assert os.path.isfile(os.path.join(out_t, "data", "tracking_total.txt"))
    assert os.path.isfile(os.path.join(out_t, "data", "lm_total.txt"))


@pytest.mark.parametrize("flags, item", [(["--mode", "1011"], "1011"),
                                         (["--mode", "0000", "--po", "0"], "0000")])
def test_example_exits_with_the_message_of_what_is_not_ported(rendered, tmp_path, flags, item):
    """The modes that exited until the host sides of the toggles were
    ported now track the layout and pass the ATE gate."""
    out = tmp_path / "o"
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_stereo_euroc.py"), [
            os.path.join(rendered, "settings.yaml"), rendered, "--out", str(out),
            "--gt", os.path.join(rendered, "gt.txt"), "--device", "cpu"] + flags)
    with open(out / "ate.json") as f:
        ate = json.load(f)
    assert np.isfinite(ate["ate_rmse"]) and ate["ate_rmse"] < 0.10, (item, ate)
    assert ate["n_frames_tracked"] == 16 and ate["n_associated"] >= 10
    assert (out / "f_traj.txt").is_file() and (out / "data" / "orb_extraction.txt").is_file()


# ------------------------------------------------------------ the inertial gate
@pytest.fixture(scope="module")
def rendered_imu(tmp_path_factory):
    """70 rendered frames with their IMU stream: IMU init needs 6 keyframes
    over 2 s (40 frames at 20 Hz)."""
    root = str(tmp_path_factory.mktemp("seq_imu"))
    run_script(os.path.join(TOOLS, "render_euroc_synthetic.py"), [root, "--frames", "70"])
    return root


@pytest.fixture(scope="module")
def driven_imu(rendered_imu, tmp_path_factory):
    """The port's stereo script with --imu on the 70 frames."""
    root = rendered_imu
    out = str(tmp_path_factory.mktemp("out_imu"))
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_stereo_euroc.py"), [
            os.path.join(root, "settings.yaml"), root, "--imu", "--gt",
            os.path.join(root, "gt.txt"), "--out", out, "--device", "cpu"])
    return out


def test_example_with_imu_initializes_and_passes_the_ate_gate(driven_imu):
    with open(os.path.join(driven_imu, "ate.json")) as f:
        ate = json.load(f)
    assert ate["imu_initialized"] is True, ate
    assert ate["ate_rmse"] < 0.10 and ate["n_associated"] >= 60, ate
    assert ate["n_frames_tracked"] == 70
    with open(os.path.join(driven_imu, "data", "lm_imu_inits.txt")) as f:
        assert f.read().split() == ["0:", "1.0000"]


def test_example_with_imu_needs_the_imu_stream(tmp_path):
    root = str(tmp_path / "seq")
    run_script(os.path.join(TOOLS, "render_euroc_synthetic.py"),
               [root, "--frames", "4", "--no-imu"])
    with pytest.raises(SystemExit) as e:
        run_script(os.path.join(EXAMPLES, "torch_stereo_euroc.py"), [
            os.path.join(root, "settings.yaml"), root, "--imu", "--out", str(tmp_path / "o"),
            "--device", "cpu"])
    assert isinstance(e.value.code, str) and "imu0/data.csv" in e.value.code
    assert not (tmp_path / "o").exists()


# ------------------------------------------------------ the monocular script
@pytest.fixture(scope="module")
def driven_mono(rendered, tmp_path_factory):
    """The port's monocular script and the JAX package's on the rendered files."""
    out_t = str(tmp_path_factory.mktemp("out_mono_torch"))
    out_j = str(tmp_path_factory.mktemp("out_mono_jax"))
    args = [os.path.join(rendered, "settings.yaml"), rendered,
            "--gt", os.path.join(rendered, "gt.txt")]
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_mono_euroc.py"),
                   args + ["--out", out_t, "--device", "cpu"])
    with jax_native_library(tmp_path_factory.mktemp("jax_native_mono")):
        run_script(os.path.join(EXAMPLES, "mono_euroc.py"), args + ["--out", out_j])
    return out_t, out_j


def test_mono_example_initializes_and_writes_the_trajectories(driven_mono):
    out_t, out_j = driven_mono
    for name in ("f_traj.txt", "f_traj_euroc.txt", "kf_traj.txt"):
        got = np.atleast_2d(np.loadtxt(os.path.join(out_t, name)))
        want = np.atleast_2d(np.loadtxt(os.path.join(out_j, name)))
        assert got.shape[1] == want.shape[1], name
        assert len(got) >= 2, name          # the two keyframes of the init at least
    with open(os.path.join(out_t, "data", "mono_two_view.txt")) as f:
        assert len(f.read().split()) >= 2   # one two-view attempt at least
    with open(os.path.join(out_t, "ate.json")) as f:
        ate = json.load(f)
    assert np.isfinite(ate["ate_rmse"]) and ate["n_frames_tracked"] >= 10, ate
    assert np.isfinite(ate["scale"])        # a Sim(3) alignment


def test_mono_example_ate_no_worse_than_the_jax_example(driven_mono):
    out_t, out_j = driven_mono
    with open(os.path.join(out_t, "ate.json")) as f:
        got = json.load(f)
    with open(os.path.join(out_j, "ate.json")) as f:
        want = json.load(f)
    assert got["n_frames_tracked"] == want["n_frames_tracked"], (got, want)
    assert got["ate_rmse"] <= want["ate_rmse"] + 0.005, (got, want)


def test_mono_example_with_imu_initializes_and_passes_the_ate_gate(rendered_imu, tmp_path):
    """--imu (M9c): the monocular-inertial System on the 70 rendered frames
    and their IMU csv; its map is metric after the IMU init, so the ATE is
    taken after an SE(3) alignment, as the JAX example takes it."""
    out = tmp_path / "o"
    with one_torch_thread():
        run_script(os.path.join(EXAMPLES, "torch_mono_euroc.py"), [
            os.path.join(rendered_imu, "settings.yaml"), rendered_imu, "--imu",
            "--gt", os.path.join(rendered_imu, "gt.txt"), "--out", str(out), "--device", "cpu"])
    with open(out / "ate.json") as f:
        ate = json.load(f)
    assert ate["imu_initialized"] is True and ate["scale"] == 1.0, ate
    assert ate["ate_rmse"] < MONO_IMU_ATE_LIMIT_M and ate["n_associated"] >= 60, ate
    assert ate["n_after_imu_init"] >= 10, ate
    assert ate["ate_rmse_after_imu_init"] < MONO_IMU_ATE_AFTER_INIT_LIMIT_M, ate
    for name in ("f_traj.txt", "f_traj_euroc.txt", "kf_traj.txt"):
        assert len(np.atleast_2d(np.loadtxt(out / name))) >= 2, name
    with open(out / "data" / "lm_imu_inits.txt") as f:
        assert f.read().split() == ["0:", "1.0000"]
