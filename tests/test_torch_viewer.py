"""The port's headless viewer (fasttrack_tpu_torch/viewer.py, M9f) against
the JAX package's (fasttrack_tpu/viewer.py), on the CPU.

- `FrameDrawer.draw` bit-equal to the JAX one on the same arrays: a gray
  and a colour image, keypoints at the borders, tracked, free and invalid
  ones, each tracking state's banner and none;
- over a port System that tracked 4 rendered frames (320x240, seed 3):
  `MapDrawer.draw` and `Viewer.render_once` bit-equal to the JAX module's
  drawers on the same atlas and tracker (both are host NumPy and
  matplotlib Agg), with the shapes tests/test_robustness.py::TestViewer
  checks for the JAX viewer: the frame view at the image's size in RGB, an
  RGB map view;
- the Viewer's thread writes frames while it runs and stops.
"""

import os
import time
import types

import numpy as np
import pytest
from PIL import Image

from fasttrack_tpu import viewer as jviewer
from fasttrack_tpu_torch import viewer
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from fasttrack_tpu_torch.tracking import TrackingState
from tests.test_torch_system import one_torch_thread

H, W = 240, 320


@pytest.mark.parametrize("state", [TrackingState.OK, TrackingState.RECENTLY_LOST,
                                   TrackingState.LOST, None], ids=str)
@pytest.mark.parametrize("channels", [1, 3])
def test_frame_drawer_equals_jax(rng, state, channels):
    shape = (H, W) if channels == 1 else (H, W, 3)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    n = 200
    uv = np.concatenate([rng.uniform(0, [W, H], (n - 4, 2)),
                         [[0, 0], [W - 1, H - 1], [1.5, H - 2], [W - 2, 0.7]]]).astype(np.float32)
    frame = types.SimpleNamespace(kp_uv=uv, mp_ids=np.where(rng.random(n) < 0.5, 7, -1),
                                  valid=rng.random(n) < 0.9)
    got = viewer.FrameDrawer().draw(img, frame, state)
    want = jviewer.FrameDrawer().draw(img, frame, state)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tracked():
    seq = synthetic.generate_sequence(n_frames=4, h=H, w=W, seed=3)
    s = Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"),
                 bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
                 th_depth=60.0, n_features=512, n_levels=4)
    system = System(s, Sensor.STEREO, vocabulary=False, device="cpu")
    with one_torch_thread():
        for f in seq.frames:
            system.track_stereo(f.left, f.right, f.timestamp)
    system.shutdown()
    return seq, system


def test_map_drawer_equals_jax(tracked):
    _, system = tracked
    traj = system.tracker.trajectory
    got = viewer.MapDrawer().draw(system.atlas, traj)
    want = jviewer.MapDrawer().draw(system.atlas, traj)
    assert got.ndim == 3 and got.shape[2] == 3 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_render_once_equals_jax(tracked, tmp_path):
    seq, system = tracked
    paths = {}
    for name, mod in (("torch", viewer), ("jax", jviewer)):
        v = mod.Viewer(system, str(tmp_path / name), fps=1.0)
        v.push_image(seq.frames[3].left)
        paths[name] = v.render_once()
    assert [os.path.basename(p) for p in paths["torch"]] == ["frame_000000.png", "map_000000.png"]
    for got, want in zip(paths["torch"], paths["jax"]):
        a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
        np.testing.assert_array_equal(a, b)
    fr = np.asarray(Image.open(paths["torch"][0]))
    assert fr.shape == (H, W, 3)
    mp = np.asarray(Image.open(paths["torch"][1]))
    assert mp.ndim == 3 and mp.shape[2] == 3


def test_the_viewer_thread_writes_and_stops(tracked, tmp_path):
    seq, system = tracked
    v = viewer.Viewer(system, str(tmp_path), fps=10.0)
    v.push_image(seq.frames[0].left)
    v.start()
    deadline = time.time() + 30
    while not any(n.startswith("map_") for n in os.listdir(tmp_path)) and time.time() < deadline:
        time.sleep(0.05)
    v.stop()
    assert not v._thread.is_alive()
    names = os.listdir(tmp_path)
    assert any(n.startswith("frame_") for n in names) and any(n.startswith("map_") for n in names)
