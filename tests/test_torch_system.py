"""The port's stereo `System` against the JAX package's, on the CPU.

One rendered 320x240 sequence of 60 frames (datasets.synthetic, seed 3) goes
through `System(settings, Sensor.STEREO, vocabulary=False)` of both packages,
built from the same numbers, inline mapping, the port with device="cpu"; the
JAX side runs as its own tests run it, with the C++ library's Hamming matrix
replaced by the same integers from NumPy. Four keyframes, two local bundle
adjustments. Tolerances and why:

- tracking state, path taken and keyframe frames equal on every frame;
- map-point count within 2% on every frame (a borderline chi2 or
  reprojection gate may fall either side);
- per-frame poses within 2e-3 (rotation: largest entry of the difference;
  translation: metres): f32 rounding through pose optimization and two
  bundle adjustments, analytic against forward-mode Jacobians;
- ATE RMSE of the port no worse than the JAX package's by more than 5 mm;
- the trajectory files of both equal to 1e-5 in every number.
"""

import contextlib

import numpy as np
import pytest
import torch

from fasttrack_tpu import native as jnative
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.kernels import KernelConfig as JaxKernelConfig
from fasttrack_tpu.settings import Settings as JaxSettings
from fasttrack_tpu.system import Sensor as JaxSensor
from fasttrack_tpu.system import System as JaxSystem
from fasttrack_tpu_torch import kernels, nputils
from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary, make_random_vocabulary
from fasttrack_tpu_torch.cameras import make_kannala_brandt8, make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import ate
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_torch_host_kernels import jax_native_library

H, W = 240, 320
N_FRAMES = 60
POSE_ATOL = 2e-3
ATE_MARGIN_M = 0.005


def numpy_hamming_matrix_packed(a, b):
    bits_a = np.unpackbits(np.ascontiguousarray(a, np.uint8), axis=1).astype(np.int32)
    bits_b = np.unpackbits(np.ascontiguousarray(b, np.uint8), axis=1).astype(np.int32)
    return (bits_a @ (1 - bits_b).T + (1 - bits_a) @ bits_b.T).astype(np.int32)


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


def settings_pair(seq):
    kw = dict(bf=seq.fx * seq.baseline, baseline=seq.baseline, n_features=512, n_levels=4,
              width=W, height=H)
    return (
        JaxSettings(camera1=jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H), **kw),
        Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"), **kw),
    )


def frame_row(system):
    tr = system.tracker
    f = tr.last_frame
    m = system.atlas.current
    return dict(
        state=system.tracking_state.name,
        stepwise=len(tr.stats.series["orb_extraction"]),
        n_keyframes=m.n_keyframes(), n_mappoints=m.n_mappoints(),
        R=f.R_cw.copy(), t=f.t_cw.copy(),
    )


@pytest.fixture(scope="module")
def ran():
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    seq = synthetic.generate_sequence(n_frames=N_FRAMES, h=H, w=W, seed=3)
    js, ts = settings_pair(seq)
    jsys = JaxSystem(js, JaxSensor.STEREO, vocabulary=False)
    tsys = System(ts, Sensor.STEREO, vocabulary=False, device="cpu")
    log_j, log_t = [], []
    with one_torch_thread():
        for f in seq.frames:
            jsys.track_stereo(f.left, f.right, f.timestamp)
            log_j.append(frame_row(jsys))
            tsys.track_stereo(f.left, f.right, f.timestamp)
            log_t.append(frame_row(tsys))
    jsys.shutdown()
    tsys.shutdown()
    mp.undo()
    return seq, jsys, tsys, log_j, log_t


def test_states_paths_and_keyframe_frames_equal(ran):
    _, jsys, tsys, log_j, log_t = ran
    assert [r["state"] for r in log_t] == [r["state"] for r in log_j] == ["OK"] * N_FRAMES
    assert [r["stepwise"] for r in log_t] == [r["stepwise"] for r in log_j]
    assert log_t[-1]["stepwise"] == 2               # init and one stepwise frame, then fused
    assert [r["n_keyframes"] for r in log_t] == [r["n_keyframes"] for r in log_j]
    kf_j = {k: kf.frame_id for k, kf in jsys.atlas.current.keyframes.items()}
    kf_t = {k: kf.frame_id for k, kf in tsys.atlas.current.keyframes.items()}
    assert kf_t == kf_j and len(kf_t) >= 4
    assert sum(tsys.stats.series["lm_local_bas"]) >= 2
    assert tsys.tracker.ref_kf_id == jsys.tracker.ref_kf_id


def test_mappoint_count_within_two_percent(ran):
    _, _, _, log_j, log_t = ran
    for i, (rj, rt) in enumerate(zip(log_j, log_t)):
        assert abs(rt["n_mappoints"] - rj["n_mappoints"]) <= 0.02 * rj["n_mappoints"], i
    # the mapper changed the map: points were culled or fused away, others made
    counts = [r["n_mappoints"] for r in log_t]
    assert len(set(counts)) >= 3


def test_per_frame_poses_equal(ran):
    _, _, _, log_j, log_t = ran
    for i, (rj, rt) in enumerate(zip(log_j, log_t)):
        np.testing.assert_allclose(rt["R"], rj["R"], atol=POSE_ATOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(rt["t"], rj["t"], atol=POSE_ATOL, err_msg=f"frame {i}")


def _ate(seq, system):
    traj = system.tracker.trajectory
    ts = np.asarray([t for t, _, _ in traj])
    pos = np.asarray([-R.T @ t for _, R, t in traj])
    return ate.absolute_trajectory_error(ts, pos, ts, seq.gt_pos[:len(ts)])["rmse"]


def test_ate_no_worse_than_jax(ran):
    seq, jsys, tsys, _, _ = ran
    got, want = _ate(seq, tsys), _ate(seq, jsys)
    assert got <= want + ATE_MARGIN_M
    assert got < 0.05


def test_keyframe_poses_and_covisibility_equal(ran):
    _, jsys, tsys, _, _ = ran
    mj, mt = jsys.atlas.current, tsys.atlas.current
    for kid, kf in mt.keyframes.items():
        np.testing.assert_allclose(kf.R_cw, mj.keyframes[kid].R_cw, atol=POSE_ATOL)
        np.testing.assert_allclose(kf.t_cw, mj.keyframes[kid].t_cw, atol=POSE_ATOL)
        assert sorted(kf.covisible) == sorted(mj.keyframes[kid].covisible)


@pytest.mark.parametrize("saver, atol", [
    ("save_trajectory_tum", 1e-5), ("save_trajectory_euroc", 1e-5),
    ("save_trajectory_kitti", 1e-5), ("save_keyframe_trajectory_tum", 1e-5),
])
def test_trajectory_files_equal_jax(ran, tmp_path, saver, atol):
    _, jsys, tsys, log_j, log_t = ran
    # the same trajectory through both savers: the files must say the same
    path_j, path_t = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    keep = tsys.tracker.trajectory
    keep_kf = {k: (kf.R_cw, kf.t_cw) for k, kf in tsys.atlas.current.keyframes.items()}
    try:
        tsys.tracker.trajectory = jsys.tracker.trajectory
        for k, kf in tsys.atlas.current.keyframes.items():
            kf.R_cw, kf.t_cw = jsys.atlas.current.keyframes[k].R_cw, jsys.atlas.current.keyframes[k].t_cw
        getattr(jsys, saver)(path_j)
        getattr(tsys, saver)(path_t)
    finally:
        tsys.tracker.trajectory = keep
        for k, kf in tsys.atlas.current.keyframes.items():
            kf.R_cw, kf.t_cw = keep_kf[k]
    want, got = np.loadtxt(path_j), np.loadtxt(path_t)
    assert got.shape == want.shape and got.shape[0] >= 4
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(1.0, np.abs(want[:, 1:]).max()))
    if saver == "save_trajectory_euroc":
        np.testing.assert_array_equal(got[:, 0], want[:, 0])      # nanoseconds, as integers


def test_save_stats_writes_the_mapper_series(ran, tmp_path):
    _, _, tsys, _, _ = ran
    tsys.save_stats(str(tmp_path))
    for name in ("tracking_total", "lm_total", "lm_local_ba", "lm_triangulate", "lm_fuse"):
        assert (tmp_path / "data" / f"{name}.txt").is_file(), name
    assert (tmp_path / "summary.json").is_file()


def test_matrix_to_quat_equals_jax(rng):
    import jax.numpy as jnp

    from fasttrack_tpu.geometry.so3 import matrix_to_quat as jax_matrix_to_quat

    for _ in range(20):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        got = nputils.matrix_to_quat(R)
        np.testing.assert_allclose(got, np.asarray(jax_matrix_to_quat(jnp.asarray(R))), atol=1e-6)
        assert got[0] >= 0 and abs(np.linalg.norm(got) - 1) < 1e-12
    # a half turn, where the trace is no pivot
    got = nputils.matrix_to_quat(np.diag([1.0, -1.0, -1.0]))
    np.testing.assert_allclose(np.abs(got), [0, 1, 0, 0], atol=1e-12)


# ------------------------------------------------------------ localization mode
def test_localization_mode_and_wrong_entry_points(ran):
    seq, _, _, _, _ = ran
    _, ts = settings_pair(seq)
    system = System(ts, Sensor.STEREO, vocabulary=False, device="cpu")
    assert system.device == torch.device("cpu")
    assert system.tracker.device == system.local_mapper.device == torch.device("cpu")
    assert system.tracker.local_mapper is system.local_mapper
    assert system.local_mapper.tracker is system.tracker
    assert system.tracker.stats is system.stats is system.local_mapper.stats
    assert system.tracker.th_depth == pytest.approx(ts.th_depth * seq.baseline)
    system.activate_localization_mode()
    assert system.tracker.localization_only
    system.deactivate_localization_mode()
    assert not system.tracker.localization_only
    f = seq.frames[0]
    with pytest.raises(RuntimeError, match="non-RGBD"):
        system.track_rgbd(f.left, f.left, 0.0)
    with pytest.raises(RuntimeError, match="non-mono"):
        system.track_monocular(f.left, 0.0)
    with pytest.raises(RuntimeError, match="non-inertial"):
        system.track_stereo(f.left, f.right, 0.0, imu=[(0.0, np.zeros(3), np.zeros(3))])
    system.shutdown()


# -------------------------------------------------------------- what is left out
def _settings(**kw):
    base = dict(camera1=make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu"),
                bf=28.0, width=W, height=H, n_features=256, n_levels=4)
    base.update(kw)
    return Settings(**base)


LEFT_OUT = {
    "IMU_MONOCULAR": (dict(), dict(sensor=Sensor.IMU_MONOCULAR), "M9"),
    "IMU_RGBD": (dict(), dict(sensor=Sensor.IMU_RGBD), "M9"),
    "MONOCULAR": (dict(), dict(sensor=Sensor.MONOCULAR), "M9"),
    "RGBD": (dict(), dict(sensor=Sensor.RGBD), "M9"),
    "load_atlas": (dict(load_atlas="a.osa"), dict(), "M9"),
    "save_atlas": (dict(save_atlas="a.osa"), dict(), "M9"),
}


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_left_out_branch_raises_with_its_item(name):
    settings_kw, system_kw, item = LEFT_OUT[name]
    kw = dict(sensor=Sensor.STEREO, vocabulary=False, device="cpu")
    kw.update(system_kw)
    with pytest.raises(NotImplementedError, match=item):
        System(_settings(**settings_kw), **kw)


# the start-up camera transforms and the fisheye rig (M9a): each builds and
# takes its route
M9A_BRANCHES = {
    "input resize": (dict(new_width=160, new_height=120),
                     lambda s: s.tracker.cfg.width == 160 and s._resize_to == (120, 160)),
    "rectification": (dict(
        camera2=make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu"),
        T_c1_c2=np.eye(4) + np.eye(4, k=3) * 0.1, dist1=np.array([-0.28, 0.07, 0.0, 0.0])),
        lambda s: s._rect is not None and s.tracker.stereo_rig is None),
    "fisheye": (dict(camera_type="KannalaBrandt8", camera1=make_kannala_brandt8(
        190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, device="cpu"), camera2=make_kannala_brandt8(
        190.0, 190.0, 254.0, 256.0, 0, 0, 0, 0, device="cpu"),
        T_c1_c2=np.eye(4) + np.eye(4, k=3) * 0.1),
        lambda s: s.tracker.stereo_rig is not None and s._rect is None),
}


@pytest.mark.parametrize("name", sorted(M9A_BRANCHES))
def test_m9a_branches_build(name):
    settings_kw, took_its_route = M9A_BRANCHES[name]
    system = System(_settings(**settings_kw), sensor=Sensor.STEREO, vocabulary=False,
                    device="cpu")
    assert took_its_route(system)


# place recognition in every configuration: with the mapping thread the loop
# closer and its global BA run on threads of their own, and the
# stereo-inertial system closes loops inertially
# (tests/test_torch_loop_threads.py, test_torch_inertial_loop.py)
PLACE_RECOGNITION = {
    "default vocabulary": dict(vocabulary=None, async_mapping=True),
    "a vocabulary": dict(vocabulary=make_random_vocabulary(64), sensor=Sensor.IMU_STEREO),
    "IMU_STEREO": dict(sensor=Sensor.IMU_STEREO, vocabulary=None),
}


@pytest.mark.parametrize("name", sorted(PLACE_RECOGNITION))
def test_place_recognition_builds_with_a_wired_loop_closer(name):
    kw = dict(sensor=Sensor.STEREO, device="cpu")
    kw.update(PLACE_RECOGNITION[name])
    system = System(_settings(), **kw)
    lc, lm, tracker = system.loop_closer, system.local_mapper, system.tracker
    assert lc is not None and lc.voc is system.vocabulary is tracker.vocabulary
    if kw["vocabulary"] is None:
        assert system.vocabulary is load_default_vocabulary()
    assert lm.loop_closer is lc and lc.local_mapper is lm and lc.tracker is tracker
    assert tracker.reloc_db is lc.db and system.atlas.kf_db is lc.db
    assert lc.fix_scale and lc.run_async == lm.run_async == kw.get("async_mapping", False)
    assert (lm.imu_calib is not None) == (kw["sensor"] is Sensor.IMU_STEREO)
    system.shutdown()
    assert all(t is None or not t.is_alive() for t in (lm._thread, lc._thread, lc._gba_thread))


def test_the_vocabulary_message_says_what_to_pass():
    """The default runs place recognition with the port's shipped
    vocabulary, for the stereo and the stereo-inertial sensor alike."""
    system = System(_settings(), device="cpu")
    assert system.vocabulary is load_default_vocabulary()
    assert system.loop_closer is not None and system.tracker.vocabulary is system.vocabulary
    system.shutdown()
    system = System(_settings(), Sensor.IMU_STEREO, device="cpu")
    assert system.vocabulary is load_default_vocabulary()
    assert system.loop_closer.local_mapper.imu_calib is system.imu_calib is not None
    system.shutdown()


def test_an_undistorted_pair_needs_no_rectification():
    s = _settings(camera2=make_pinhole(256.0, 256.0, 160.0, 120.0, W, H, device="cpu"),
                  T_c1_c2=np.eye(4), dist1=np.zeros(4), dist2=np.zeros(4),
                  new_width=W, new_height=H)
    system = System(s, vocabulary=False, device="cpu")
    for call in (system.save_atlas, system.load_atlas):
        with pytest.raises(NotImplementedError, match="M9"):
            call("a.osa")
    system.shutdown()


def test_run_mode_is_the_systems_default():
    assert kernels.get_run_mode() == KernelConfig()
    mode = KernelConfig.from_bitmask("1111", pose_optimization=False)
    try:
        kernels.set_run_mode(mode)
        assert kernels.get_run_mode() is mode
        system = System(_settings(), vocabulary=False, device="cpu")
        assert system.kcfg is mode and system.tracker.kcfg is mode
        other = KernelConfig()
        assert System(_settings(), kernel_config=other, vocabulary=False,
                      device="cpu").tracker.kcfg is other
    finally:
        kernels.set_run_mode(KernelConfig())
    assert kernels.get_run_mode() == KernelConfig()


def test_a_toggle_that_is_off_raises_at_the_first_frame(ran, tmp_path):
    """Mask 0111 (host ORB extraction; it raised at the first frame until
    the host sides were ported) through both systems over the first 8
    frames, inline mapping: every frame stepwise and OK, the same keyframes,
    poses within 2e-3. The JAX host kernels load the JAX package's own C++
    library, built into tmp_path (tests/test_torch_host_kernels.py), so
    nothing builds under `native/`."""
    seq, _, _, _, _ = ran
    js, ts = settings_pair(seq)
    jsys = JaxSystem(js, JaxSensor.STEREO, kernel_config=JaxKernelConfig.from_bitmask("0111"),
                     vocabulary=False)
    tsys = System(ts, kernel_config=KernelConfig.from_bitmask("0111"), vocabulary=False,
                  device="cpu")
    with one_torch_thread(), jax_native_library(tmp_path):
        for i, f in enumerate(seq.frames[:8]):
            jsys.track_stereo(f.left, f.right, f.timestamp)
            tsys.track_stereo(f.left, f.right, f.timestamp)
            rj, rt = frame_row(jsys), frame_row(tsys)
            assert (rt["state"], rt["stepwise"], rt["n_keyframes"]) == (
                rj["state"], rj["stepwise"], rj["n_keyframes"])
            assert (rt["state"], rt["stepwise"]) == ("OK", i + 1)
            assert abs(rt["n_mappoints"] - rj["n_mappoints"]) <= 0.02 * rj["n_mappoints"], i
            assert np.abs(rt["R"] - rj["R"]).max() < POSE_ATOL, i
            assert np.abs(rt["t"] - rj["t"]).max() < POSE_ATOL, i
    jsys.shutdown()
    tsys.shutdown()
    np.testing.assert_array_equal(tsys.tracker.last_frame.desc_packed,
                                  jsys.tracker.last_frame.desc_packed)
    assert "fused_dispatch" not in tsys.stats.series
    assert sum(tsys.stats.series["lm_keyframes"]) >= 1


def test_async_mapping_drains_its_queue(ran):
    """Mapping on its own thread over 20 frames: every frame OK, every
    keyframe that was inserted is processed once the mapper is idle."""
    import time

    seq, _, _, _, _ = ran
    _, ts = settings_pair(seq)
    system = System(ts, vocabulary=False, async_mapping=True, device="cpu")
    for f in seq.frames[:20]:
        system.track_stereo(f.left, f.right, f.timestamp)
        assert system.tracking_state.name == "OK"
    deadline = time.monotonic() + 120
    while not system.local_mapper.is_idle() and time.monotonic() < deadline:
        time.sleep(0.02)
    system.shutdown()
    assert system.local_mapper.is_idle() and system.local_mapper.queue_size() == 0
    assert sum(system.stats.series["lm_keyframes"]) == system.atlas.current.n_keyframes() >= 2
    assert _ate(seq, system) < 0.05
