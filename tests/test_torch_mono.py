"""The port's monocular path against the JAX package, on the CPU.

- `extract_orb` for one image (320x240, 4 levels, 512 features, a uint8
  image) against the JAX package's: the keypoints as sets (ROADMAP F4),
  the descriptor bits of every common keypoint exact (F2), their angles
  within 1e-4 rad; and the port's own: `extract_orb(img)` equals the left
  half of `extract_orb_pair(img, other)` bit for bit. `build_pyramid`
  against the JAX package's within 1e-3 gray levels (the same operator
  products, summed in another order);
- `process_mono_frame` against the JAX package's: the same keypoints,
  u_right and depth -1 everywhere, the valid count;
- `System(Sensor.MONOCULAR, device="cpu")` against the JAX `System` on
  tests/test_mono_e2e.py's scene (320x240, 30 frames, seed 3, 512
  features, 4 levels, the shipped vocabulary), each package run once: the
  same initialization frame, every frame after it OK in both, more than
  200 map points, and a Sim(3)-aligned ATE under that test's 0.08 m and
  no more than twice the JAX package's on the same frames;
- `async_mapping=True` (port only) over the scene's first 15 frames:
  initialized and tracking, the mapper drained, no thread alive after
  `shutdown()`;
- tests/test_stress_sequences.py's rotation-only footage, on the port: no
  map from it, then an initialization once translation begins;
- the keyframe rule's monocular reference ratio (0.9) in both packages;
- `fix_scale=False` reaches the loop closer (and its global BA) of a
  monocular System only.

The System runs take one torch thread (`one_torch_thread`).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu.ops import extractor as jext
from fasttrack_tpu.ops import pyramid as jpyr
from fasttrack_tpu_torch import frame_pipeline as tfp
from fasttrack_tpu_torch import parity
from fasttrack_tpu_torch.ops import extractor as text
from fasttrack_tpu_torch.ops import pyramid as tpyr

H, W = 240, 320
JCFG = jext.OrbConfig(height=H, width=W, n_features=512, n_levels=4)
CFG = text.OrbConfig(**JCFG._asdict())
ATE_GATE_M = 0.08          # tests/test_mono_e2e.py


@pytest.fixture(scope="module")
def image():
    return parity.stereo_frames(1, H, W, seed=5)[0]     # (2, H, W) uint8


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def kp_keys(k, valid):
    x, y, lv = (np.asarray(getattr(k, f)) for f in ("x", "y", "level"))
    idx = np.where(valid)[0]
    return {(float(x[i]), float(y[i]), int(lv[i])): i for i in idx}


def assert_keypoints_match(jk, tk):
    """Keypoint sets equal; common keypoints' bits exact, angles 1e-4."""
    a = kp_keys(jk, np.asarray(jk.valid))
    b = kp_keys(tk, tk.valid.numpy())
    assert len(b) > 200 and set(a) == set(b)
    ia = np.asarray([a[k] for k in a])
    ib = np.asarray([b[k] for k in a])
    np.testing.assert_array_equal(tk.desc_packed.numpy()[ib], np.asarray(jk.desc_packed)[ia])
    np.testing.assert_allclose(tk.angle.numpy()[ib], np.asarray(jk.angle)[ia], rtol=0, atol=1e-4)


def test_build_pyramid_equals_jax(image):
    want = jpyr.build_pyramid(jnp.asarray(image[0]), JCFG.pyramid)
    got = tpyr.build_pyramid(torch.from_numpy(image[0]), CFG.pyramid)
    assert got.raw.shape == (CFG.n_levels, H, W)
    np.testing.assert_allclose(got.raw.numpy(), np.asarray(want.raw), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.blurred.numpy(), np.asarray(want.blurred), rtol=0, atol=1e-3)


def test_extract_orb_equals_jax(image):
    jk, _ = jext.extract_orb(jnp.asarray(image[0]).astype(jnp.float32), JCFG)
    tk, pyr = text.extract_orb(torch.from_numpy(image[0]), CFG)
    assert tk.x.shape == (CFG.total_features,) and pyr.raw.shape == (CFG.n_levels, H, W)
    assert_keypoints_match(jk, tk)


def test_extract_orb_is_the_pairs_left_half_bit_for_bit(image):
    mono, pyr = text.extract_orb(torch.from_numpy(image[0]), CFG)
    left, _, pyr_l, _ = text.extract_orb_pair(
        torch.from_numpy(image[0]), torch.from_numpy(image[1]), CFG)
    for f in text.Keypoints._fields:
        assert torch.equal(getattr(mono, f), getattr(left, f)), f
    assert torch.equal(pyr.raw, pyr_l.raw) and torch.equal(pyr.blurred, pyr_l.blurred)
    # the closure of make_extract_fn is the same function
    again, _ = text.make_extract_fn(CFG)(torch.from_numpy(image[0]))
    assert torch.equal(again.desc_packed, mono.desc_packed)


def test_process_mono_frame_equals_jax(image):
    want = jfp.process_mono_frame(jnp.asarray(image[0]).astype(jnp.float32), JCFG)
    got = tfp.process_mono_frame(torch.from_numpy(image[0]), CFG)
    assert got.kps_right is None and want.kps_right is None
    assert_keypoints_match(want.kps, got.kps)
    assert (got.u_right == -1).all() and (got.depth == -1).all()
    assert int(got.n_valid) == int(want.n_valid) == int(got.kps.valid.sum())


# ---------------------------------------------------------------- the System
def make_settings(pkg, seq):
    """tests/test_mono_e2e.py's make_mono_system settings."""
    if pkg == "jax":
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.settings import Settings

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H)
    else:
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.settings import Settings

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
    s = Settings()
    s.width, s.height, s.camera1 = W, H, cam
    s.bf, s.n_features, s.n_levels = 0.0, 512, 4
    return s


def run_system(system, frames, t_offset=0.0):
    states = []
    for fr in frames:
        system.track_monocular(fr.left, t_offset + fr.timestamp)
        states.append(system.tracking_state.name)
    return states


def sim3_ate(system, seq):
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error

    traj = system.tracker.trajectory
    return absolute_trajectory_error(
        np.asarray([t for t, _, _ in traj]), np.asarray([-R.T @ t for _, R, t in traj]),
        seq.gt_t, seq.gt_pos, with_scale=True)


@pytest.fixture(scope="module")
def mono_seq():
    from fasttrack_tpu_torch.datasets.synthetic import generate_sequence

    return generate_sequence(n_frames=30, h=H, w=W, seed=3)


@pytest.fixture(scope="module")
def both_systems(mono_seq):
    """Each package's monocular System once over the scene."""
    from fasttrack_tpu.system import Sensor as JSensor
    from fasttrack_tpu.system import System as JSystem
    from fasttrack_tpu_torch.system import Sensor, System

    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for pkg, make in (("jax", lambda s: JSystem(s, JSensor.MONOCULAR)),
                          ("torch", lambda s: System(s, Sensor.MONOCULAR, device="cpu"))):
            system = make(make_settings(pkg, mono_seq))
            states = run_system(system, mono_seq.frames)
            system.shutdown()
            out[pkg] = (system, states, sim3_ate(system, mono_seq))
    finally:
        torch.set_num_threads(n)
    return out


def test_mono_system_initializes_on_the_jax_packages_frame(both_systems):
    (_, js, _), (system, ts, _) = both_systems["jax"], both_systems["torch"]
    assert "OK" in js and ts.index("OK") == js.index("OK")
    init = ts.index("OK")
    assert ts[:init] == ["NOT_INITIALIZED"] * init
    assert system.atlas.current.n_keyframes() >= 2
    assert len(system.stats.series["mono_two_view"]) >= 1


def test_mono_system_tracks_every_frame_after_init(both_systems):
    for pkg in ("jax", "torch"):
        _, states, _ = both_systems[pkg]
        init = states.index("OK")
        assert states[init:] == ["OK"] * (len(states) - init), (pkg, states)


def test_mono_system_ate_and_map_against_jax(both_systems):
    (_, _, j_ate), (system, ts, t_ate) = both_systems["jax"], both_systems["torch"]
    assert t_ate["rmse"] < ATE_GATE_M, t_ate
    assert t_ate["rmse"] <= 2 * j_ate["rmse"], (t_ate, j_ate)
    assert system.atlas.current.n_mappoints() > 200
    # every point of a monocular map was made by the two views or the
    # mapper's epipolar triangulation: no keyframe carries a depth
    assert all((kf.depth < 0).all() for kf in system.atlas.current.keyframes.values())
    assert sum(system.stats.series["lm_points_triangulated"]) > 0


def test_mono_system_rejects_flips_in_its_windows(both_systems):
    """The monocular windows take F24's rule: the count is recorded per
    adjustment, and every local BA ran."""
    system = both_systems["torch"][0]
    series = system.stats.series
    assert len(series["lm_ba_steps_rejected"]) == len(series["lm_local_bas"]) > 0
    assert system.local_mapper.monocular and system.tracker.monocular


def test_mono_system_async_mapping(mono_seq, one_torch_thread):
    from fasttrack_tpu_torch.system import Sensor, System

    before = {t.ident for t in threading.enumerate()}
    system = System(make_settings("torch", mono_seq), Sensor.MONOCULAR, async_mapping=True,
                    device="cpu")
    states = run_system(system, mono_seq.frames[:15])
    init = states.index("OK")
    assert init <= 2 and states[init:] == ["OK"] * (15 - init), states
    deadline = 60.0
    import time

    t0 = time.perf_counter()
    while not system.local_mapper.is_idle() and time.perf_counter() - t0 < deadline:
        time.sleep(0.05)
    assert system.local_mapper.is_idle()
    assert sum(system.stats.series["lm_keyframes"]) >= 2
    system.shutdown()
    alive = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert not alive, alive


@pytest.fixture(scope="module")
def rotation_then_translation():
    """tests/test_stress_sequences.py's TestRotationOnlyMono on the port, in
    one System: 12 rotation-only frames, then 10 with translation."""
    from fasttrack_tpu_torch.datasets.synthetic import generate_sequence
    from fasttrack_tpu_torch.system import Sensor, System

    rot = generate_sequence(n_frames=12, h=H, w=W, seed=3, trajectory="rotation_only")
    trans = generate_sequence(n_frames=10, h=H, w=W, seed=3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = System(make_settings("torch", trans), Sensor.MONOCULAR, device="cpu")
        rot_states = run_system(system, rot.frames)
        after_rot = (system.tracking_state.name, system.atlas.current.n_keyframes(),
                     system.atlas.current.n_mappoints())
        trans_states = run_system(system, trans.frames, rot.frames[-1].timestamp + 0.05)
        system.shutdown()
    finally:
        torch.set_num_threads(n)
    return rot_states, after_rot, trans_states


def test_mono_refuses_a_rotation_only_init(rotation_then_translation):
    rot_states, (state, n_kf, n_mp), _ = rotation_then_translation
    assert "OK" not in rot_states and state != "OK"
    assert n_kf <= 1 and n_mp < 50


def test_mono_initializes_once_translation_begins(rotation_then_translation):
    assert "OK" in rotation_then_translation[2], rotation_then_translation[2]


class _StubKeyframe:
    def __init__(self, tracked):
        self.tracked = tracked

    def tracked_map_points(self, mappoints, min_obs):
        return self.tracked


@pytest.mark.parametrize("n_inliers, mono_wants, stereo_wants", [
    (85, True, False),     # between the stereo ratio (0.75) and the monocular one (0.9)
    (95, False, False),
    (70, True, True),
])
def test_keyframe_rule_monocular_ratio(n_inliers, mono_wants, stereo_wants):
    """Tracking.cc:3193's reference ratio: 0.9 for a monocular tracker, 0.75
    for stereo (past 2 keyframes), in both packages, on the same map state
    (100 tracked points in the reference keyframe, none close)."""
    from fasttrack_tpu.cameras import make_pinhole as jpinhole
    from fasttrack_tpu.slam_map import Atlas as JAtlas
    from fasttrack_tpu.tracking import Tracker as JTracker
    from fasttrack_tpu.tracking import TrackedFrame as JFrame
    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.slam_map import Atlas
    from fasttrack_tpu_torch.tracking import Tracker, TrackedFrame

    n = 8
    fields = dict(frame_id=5, timestamp=0.25, kp_uv=np.zeros((n, 2)),
                  kp_level=np.zeros(n, np.int32), kp_angle=np.zeros(n),
                  desc_packed=np.zeros((n, 32), np.uint8), desc_signed=np.ones((n, 256), np.int8),
                  u_right=np.full(n, -1.0), depth=np.full(n, -1.0), valid=np.ones(n, bool))
    for mono in (True, False):
        got = []
        for make, frame_cls in (
            (lambda: Tracker(make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu"),
                             CFG, 1.0, Atlas(), monocular=mono, device="cpu"), TrackedFrame),
            (lambda: JTracker(jpinhole(256.0, 256.0, 160.0, 120.0, W, H), JCFG, 1.0, JAtlas(),
                              monocular=mono), JFrame),
        ):
            tr = make()
            m = tr.atlas.current
            for kid in range(3):
                m.keyframes[kid] = _StubKeyframe(100)
            tr.ref_kf_id, tr.frame_id, tr.last_kf_frame_id = 2, 5, 4
            tr.n_inliers = n_inliers
            got.append(tr._need_new_keyframe(frame_cls(**fields)))
        assert got == [mono_wants if mono else stereo_wants] * 2


def test_fix_scale_reaches_the_loop_closer_for_monocular_only(monkeypatch):
    """The JAX System passes fix_scale=False for MONOCULAR only
    (fasttrack_tpu/system.py:160-162); the port's closer takes it to its
    Sim3 solver, its refinement, its graph and its global BA, whose
    windows then reject flips as a monocular map's local BA does."""
    from fasttrack_tpu_torch import loop_closing
    from fasttrack_tpu_torch.system import Sensor, System

    seen = []
    monkeypatch.setattr(loop_closing, "global_bundle_adjustment",
                        lambda *a, **kw: seen.append(kw["mono_edges_only"]))
    for sensor, fixed in ((Sensor.MONOCULAR, False), (Sensor.STEREO, True)):
        s = make_settings("torch", type("Seq", (), dict(fx=256.0, fy=256.0, cx=160.0, cy=120.0)))
        s.bf = 28.0 if sensor is Sensor.STEREO else 0.0
        system = System(s, sensor, device="cpu")
        assert system.loop_closer.fix_scale is fixed
        system.loop_closer._run_global_ba(set())
        system.shutdown()
    assert seen == [True, False]
