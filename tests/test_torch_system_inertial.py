"""The port's stereo-inertial `System` against the JAX package's, on the CPU.

tests/test_inertial.py's sequence (datasets.synthetic, 70 frames at 320x240,
seed 5, the exact IMU stream at 200 Hz, T_b_c1 = I) goes through
`System(settings, Sensor.IMU_STEREO, vocabulary=False)` of both packages,
built from the same numbers, inline mapping, the port with device="cpu";
the JAX side runs as its own tests run it, with the C++ library's Hamming
matrix replaced by the same integers from NumPy. Keyframes every 0.25 s
until IMU init at frame 40 (the ninth keyframe), then the inertial fused
frames, two local inertial BAs. Tolerances and why:

- tracking state, path taken and keyframe frames equal on every frame; IMU
  init at the same frame and keyframe in both;
- poses within 2e-3 on every frame before the first local bundle
  adjustment has run (frames 0-15). At that adjustment the JAX run is
  chaotic: keyframes 5 frames apart (the pre-init rule) are the spacing at
  which ROADMAP P4 found the JAX package's float32 visual adjustment driven
  by rounding noise. The port parts from it there by millimetres to
  centimetres whether its adjustment runs in float64 (its default), in
  float32, or is the JAX package's own solver fed the port's window, so
  nothing can follow the JAX run past it. Past it the test holds both runs
  to the renderer's ground truth instead;
- ATE RMSE of the port below tests/test_inertial.py's 0.06 m, and no worse
  than the JAX package's by more than 5 mm; the gyro bias of the port
  (the stream has none) below 0.05 rad/s;
- mask 0000 (every offload toggle off, BASELINE.md's CPU row) over the
  first 20 frames through both systems: states, paths, keyframe frames
  equal, every frame stepwise, the last frame's descriptors bit-equal
  (host extraction on both sides), poses within 2e-3 up to the first local
  adjustment, ATE against the ground truth as above;
- the blank-wall run of tests/test_inertial.py (frames 45-50 textureless)
  through the port alone: the IMU dead-reckons through it, tracking
  recovers to OK, ATE < 0.12 m.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from fasttrack_tpu import local_mapping as jmapping
from fasttrack_tpu import native as jnative
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.settings import Settings as JaxSettings
from fasttrack_tpu.system import Sensor as JaxSensor
from fasttrack_tpu.system import System as JaxSystem
from fasttrack_tpu_torch import local_mapping as tmapping
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
from fasttrack_tpu_torch.imu import preintegration as tpre
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from fasttrack_tpu_torch.tracking import TrackingState

H, W = 240, 320
N_FRAMES = 70
POSE_ATOL = 2e-3
FIRST_ADJUSTED_FRAME = 16     # the first frame tracked against an adjusted map
ATE_LIMIT = 0.06              # tests/test_inertial.py
ATE_MARGIN_M = 0.005
FULL_BA_ATOL = 1e-3           # the converged full inertial BA, beyond the maps' parting


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


def settings_pair(seq, T_b_c1=None):
    kw = dict(bf=seq.fx * seq.baseline, baseline=seq.baseline, n_features=512, n_levels=4,
              width=W, height=H, th_depth=60.0, imu_frequency=200.0,
              T_b_c1=np.eye(4) if T_b_c1 is None else T_b_c1)
    return (
        JaxSettings(camera1=jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H), **kw),
        Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"), **kw),
    )


def imu_between(seq, t0, t1):
    sel = (seq.imu_t > t0) & (seq.imu_t <= t1)
    return [(float(t), seq.imu_acc[i], seq.imu_gyro[i])
            for i, t in zip(np.where(sel)[0], seq.imu_t[sel])]


def frame_row(system):
    tr = system.tracker
    f = tr.last_frame
    m = system.atlas.current
    return dict(state=system.tracking_state.name, stepwise=len(tr.stats.series["orb_extraction"]),
                n_keyframes=m.n_keyframes(), imu_initialized=bool(m.imu_initialized),
                R=f.R_cw.copy(), t=f.t_cw.copy())


def ate_rmse(seq, system):
    traj = system.tracker.trajectory
    t_est = np.asarray([t for t, _, _ in traj])
    p_est = np.asarray([-R.T @ t for _, R, t in traj])
    return absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)["rmse"]


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=N_FRAMES, h=H, w=W, seed=5)


@pytest.fixture(scope="module")
def ran(seq):
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    js, ts = settings_pair(seq)
    jsys = JaxSystem(js, JaxSensor.IMU_STEREO, vocabulary=False)
    tsys = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    log_j, log_t = [], []
    t_prev = -1.0
    with one_torch_thread():
        for f in seq.frames:
            imu = imu_between(seq, t_prev, f.timestamp)
            jsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_j.append(frame_row(jsys))
            tsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_t.append(dict(frame_row(tsys),
                              adjusted=int(sum(tsys.stats.series["lm_local_bas"]))))
            t_prev = f.timestamp
    jsys.shutdown()
    tsys.shutdown()
    mp.undo()
    return jsys, tsys, log_j, log_t


def test_states_paths_keyframes_and_imu_init_equal(ran):
    jsys, tsys, log_j, log_t = ran
    for key in ("state", "stepwise", "n_keyframes", "imu_initialized"):
        assert [r[key] for r in log_t] == [r[key] for r in log_j], key
    assert [r["state"] for r in log_t] == ["OK"] * N_FRAMES
    kf_j = {k: kf.frame_id for k, kf in jsys.atlas.current.keyframes.items()}
    kf_t = {k: kf.frame_id for k, kf in tsys.atlas.current.keyframes.items()}
    assert kf_t == kf_j and len(kf_t) >= 9
    init = [r["imu_initialized"] for r in log_t].index(True)
    assert init == [r["imu_initialized"] for r in log_j].index(True) == 40
    assert tsys.local_mapper.imu_init_time == jsys.local_mapper.imu_init_time
    # before init every frame went stepwise; after it the inertial fused path
    assert log_t[init - 1]["stepwise"] == init
    series = tsys.stats.series
    assert sum(series["fused_vi_frames"]) == N_FRAMES - log_t[-1]["stepwise"] >= 20
    assert sum(series["lm_imu_inits"]) == 1 and sum(series["lm_inertial_bas"]) >= 2
    assert sum(series["vi_pose_anchor"]) + sum(series["vi_pose_lastframe"]) >= 1


def test_poses_equal_until_the_first_adjustment(ran):
    _, tsys, log_j, log_t = ran
    assert sum(tsys.stats.series["lm_local_bas"]) >= 1
    for i in range(FIRST_ADJUSTED_FRAME):
        np.testing.assert_allclose(log_t[i]["R"], log_j[i]["R"], atol=POSE_ATOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(log_t[i]["t"], log_j[i]["t"], atol=POSE_ATOL, err_msg=f"frame {i}")


def test_ate_and_gyro_bias(ran, seq):
    jsys, tsys, _, _ = ran
    got, want = ate_rmse(seq, tsys), ate_rmse(seq, jsys)
    assert got < ATE_LIMIT and got <= want + ATE_MARGIN_M, (got, want)
    assert np.linalg.norm(tsys.tracker.bias[0]) < 0.05, tsys.tracker.bias


def test_keyframes_carry_the_inertial_chain(ran):
    _, tsys, _, _ = ran
    m = tsys.atlas.current
    kfs = sorted(m.keyframes.values(), key=lambda k: k.kid)
    assert kfs[0].prev_kf_id is None and kfs[0].preintegrated is None
    for a, b in zip(kfs, kfs[1:]):
        if b.prev_kf_id == a.kid:                  # unless a keyframe between was culled
            assert a.next_kf_id == b.kid
            assert b.preintegrated.dT == pytest.approx(b.timestamp - a.timestamp, abs=1e-9)
    assert all(k.velocity is not None and k.imu_bias is not None for k in kfs)
    chain = tsys.local_mapper._temporal_chain(kfs[-1])
    assert chain[-1] is kfs[-1] and [k.timestamp for k in chain] == sorted(k.timestamp for k in chain)
    # gravity was aligned to -z at init: the world's z is up
    assert tsys.tracker.last_kf_state is not None


# ------------------------------------------------------------------ dead reckoning
def test_dead_reckoning_through_a_blank_wall(seq):
    _, ts = settings_pair(seq)
    system = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    blank = np.full_like(seq.frames[0].left, 128)
    states = []
    t_prev = -1.0
    with one_torch_thread():
        for i, f in enumerate(seq.frames):
            imu = imu_between(seq, t_prev, f.timestamp)
            img = (blank, blank) if 45 <= i <= 50 else (f.left, f.right)
            system.track_stereo(*img, f.timestamp, imu=imu)
            states.append(system.tracking_state.name)
            t_prev = f.timestamp
    system.shutdown()
    assert system.atlas.current.imu_initialized
    assert "RECENTLY_LOST" in states[45:51] and states[-1] == "OK"
    assert sum(system.stats.series["dead_reckoning_frames"]) >= 1
    assert len(system.tracker.trajectory) >= N_FRAMES - 3
    assert ate_rmse(seq, system) < 0.12


# ------------------------------------------------ mask 0000: BASELINE's CPU row
N_HOST_FRAMES = 20


@pytest.fixture(scope="module")
def ran_host(seq, tmp_path_factory):
    """The first 20 frames (pre-init: keyframes every 0.25 s) with every
    offload toggle off, through both systems; the JAX host kernels load the
    JAX package's own C++ library, built into a temporary directory
    (tests/test_torch_host_kernels.py)."""
    from fasttrack_tpu.kernels import KernelConfig as JaxKernelConfig
    from fasttrack_tpu_torch.kernels import KernelConfig
    from tests.test_torch_host_kernels import jax_native_library

    js, ts = settings_pair(seq)
    jsys = JaxSystem(js, JaxSensor.IMU_STEREO, kernel_config=JaxKernelConfig.from_bitmask("0000"),
                     vocabulary=False)
    tsys = System(ts, Sensor.IMU_STEREO, kernel_config=KernelConfig.from_bitmask("0000"),
                  vocabulary=False, device="cpu")
    log_j, log_t = [], []
    t_prev = -1.0
    with one_torch_thread(), jax_native_library(tmp_path_factory.mktemp("jax_native")):
        for f in seq.frames[:N_HOST_FRAMES]:
            imu = imu_between(seq, t_prev, f.timestamp)
            jsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_j.append(frame_row(jsys))
            tsys.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            log_t.append(dict(frame_row(tsys),
                              adjusted=int(sum(tsys.stats.series["lm_local_bas"]))))
            t_prev = f.timestamp
        jsys.shutdown()
        tsys.shutdown()
    return jsys, tsys, log_j, log_t


def test_mask_0000_states_paths_and_keyframes_equal(ran_host):
    jsys, tsys, log_j, log_t = ran_host
    for key in ("state", "stepwise", "n_keyframes", "imu_initialized"):
        assert [r[key] for r in log_t] == [r[key] for r in log_j], key
    assert [r["state"] for r in log_t] == ["OK"] * N_HOST_FRAMES
    assert [r["stepwise"] for r in log_t] == list(range(1, N_HOST_FRAMES + 1))
    kf_j = {k: kf.frame_id for k, kf in jsys.atlas.current.keyframes.items()}
    kf_t = {k: kf.frame_id for k, kf in tsys.atlas.current.keyframes.items()}
    assert kf_t == kf_j and len(kf_t) >= 4        # every 0.25 s before init
    series = tsys.stats.series
    assert "twm_exec" not in series and "slp_exec" not in series and "fused_vi_frames" not in series


def test_mask_0000_poses_equal_until_the_first_adjustment(ran_host, seq):
    """Poses within 2e-3 up to the frame whose keyframe the first local
    bundle adjustment ran on (frame 10 here: the host front end's map
    reaches it a keyframe earlier than the device run above); past it the
    JAX run is chaotic (P4, as above), so both are held to the ground truth."""
    jsys, tsys, log_j, log_t = ran_host
    first = [r["adjusted"] for r in log_t].index(1)
    assert 5 <= first < N_HOST_FRAMES - 1
    for i in range(first + 1):
        np.testing.assert_allclose(log_t[i]["R"], log_j[i]["R"], atol=POSE_ATOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(log_t[i]["t"], log_j[i]["t"], atol=POSE_ATOL, err_msg=f"frame {i}")
    got, want = ate_rmse(seq, tsys), ate_rmse(seq, jsys)
    assert got < ATE_LIMIT and got <= want + ATE_MARGIN_M, (got, want)
    np.testing.assert_array_equal(tsys.tracker.last_frame.desc_packed,
                                  jsys.tracker.last_frame.desc_packed)


# ------------------------------------------------------------------ wiring, resets
def test_system_builds_the_calibration_from_the_settings(seq):
    R = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    T_bc = np.eye(4)
    T_bc[:3, :3], T_bc[:3, 3] = R, [0.01, 0.02, 0.03]
    _, ts = settings_pair(seq, T_b_c1=T_bc)
    ts.imu_noise_gyro, ts.imu_frequency = 2e-4, 400.0
    system = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    cal = system.imu_calib
    np.testing.assert_array_equal(cal.R_bc.numpy(), R.astype(np.float32))
    np.testing.assert_array_equal(cal.t_bc.numpy(), np.float32([0.01, 0.02, 0.03]))
    assert (cal.noise_gyro, cal.freq) == (2e-4, 400.0)
    assert system.tracker.imu_calib is cal and system.local_mapper.imu_calib is cal
    assert system.tracker.use_imu and cal.R_bc.device.type == "cpu"
    np.testing.assert_array_equal(system.tracker._R_bc, R)
    # the samples reach the tracker's queue
    system.tracker_grab_imu([(0.1, np.ones(3), np.zeros(3))])
    assert len(system.tracker.imu_queue) == 1
    for sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_RGBD):
        with pytest.raises(NotImplementedError, match="M9"):
            System(ts, sensor, vocabulary=False, device="cpu")
    for call in (system.save_atlas, system.load_atlas):
        with pytest.raises(NotImplementedError, match="M9"):
            call("a.osa")
    with pytest.raises(NotImplementedError, match="M9"):
        system.local_mapper._scale_refinement(None)
    # the converged full inertial BA of the post-loop global BA: a lone
    # keyframe's chain holds no window, so one sweep and done
    lone = types.SimpleNamespace(kid=0, prev_kf_id=None, R_cw=np.eye(3), t_cw=np.zeros(3))
    assert system.local_mapper.full_inertial_ba_converged(lone) == 1


def test_losing_track_before_imu_init_resets_the_map(seq):
    """The bad-IMU guard (Tracking.cc:1862-1867): a map that loses track
    before its IMU initialized is reset, not kept; so is one after a
    forward timestamp jump of more than 3 s."""
    _, ts = settings_pair(seq)
    system = System(ts, Sensor.IMU_STEREO, vocabulary=False, device="cpu")
    f = seq.frames
    with one_torch_thread():
        system.track_stereo(f[0].left, f[0].right, f[0].timestamp,
                            imu=imu_between(seq, -1.0, f[0].timestamp))
        tr = system.tracker
        assert system.atlas.current.n_keyframes() == 1 and tr.last_kf_state is not None
        tr._handle_lost()
        assert system.atlas.current.n_keyframes() == 0 and tr.state == TrackingState.NOT_INITIALIZED
        assert tr.last_kf_state is None and tr.pre_from_kf is None and tr._prior_H is None
        assert sum(system.stats.series["bad_imu_reset"]) == 1
        system.track_stereo(f[1].left, f[1].right, f[1].timestamp)
        assert tr.state == TrackingState.OK
        system.track_stereo(f[2].left, f[2].right, f[2].timestamp + 3.5)
    assert sum(system.stats.series["timestamp_jump_forward"]) == 1
    assert sum(system.stats.series["bad_imu_reset"]) == 2


# ------------------------------------------------------------------ mapper pieces
def test_merge_preintegrated_equals_jax(rng):
    a, b = tpre.HostPreintegrated(), tpre.HostPreintegrated()
    cal = tpre.ImuCalib.default(device="cpu")
    for p in (a, b):
        p.integrate(rng.normal(0, 1, (10, 3)) + [0, 0, 9.81], rng.normal(0, 0.3, (10, 3)),
                    np.full(10, 0.005), cal)
    got = tmapping._merge_preintegrated(a, b)
    want = jmapping._merge_preintegrated(a, b)
    for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.dT == pytest.approx(0.1)
    R_bc = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R_cw = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(size=3)
    for x, y in zip(tmapping._body_from_cam_np(R_cw, t, R_bc, t),
                    jmapping._body_from_cam_np(R_cw, t, R_bc, t)):
        np.testing.assert_array_equal(x, y)


def test_inertial_cull_rules_follow_the_chain():
    """A keyframe is culled only between two chain neighbours less than 3 s
    apart, its preintegration merged into the next one (and, as in the JAX
    package, a link to keyframe 0 counts as none)."""
    lm = tmapping.LocalMapper.__new__(tmapping.LocalMapper)
    lm.imu_calib = object()
    lm.stats = types.SimpleNamespace(record_count=lambda *a: None)
    erased = []
    kfs = {}

    def kf(kid, ts, prev, nxt):
        k = types.SimpleNamespace(kid=kid, timestamp=ts, prev_kf_id=prev, next_kf_id=nxt,
                                  mp_ids=np.arange(30), kp_level=np.zeros(30, int),
                                  preintegrated=None, best_covisible=lambda n: [])
        kfs[kid] = k
        return k

    m = types.SimpleNamespace(imu_initialized=True, init_kf_id=0, keyframes=kfs)
    mps = {}
    m.mappoints = mps
    m.erase_keyframe = lambda kid: (erased.append(kid), kfs.pop(kid))
    lm.atlas = types.SimpleNamespace(current=m)
    cur = kf(9, 4.0, 3, None)
    a, b, c = kf(1, 0.0, 0, 2), kf(2, 0.5, 1, 3), kf(3, 1.0, 2, 9)
    for i in range(30):      # every point of 1-3 seen by 3 other keyframes at level 0
        mps[i] = types.SimpleNamespace(bad=False, observations={1: i, 2: i, 3: i, 9: i, 4: i})
    kfs[4] = types.SimpleNamespace(kid=4, kp_level=np.zeros(30, int))
    pa = tpre.HostPreintegrated()
    pb = tpre.HostPreintegrated()
    b.preintegrated, c.preintegrated = pa, pb
    cur.best_covisible = lambda n: [1, 2, 3]
    lm._cull_keyframes(cur)
    # 1: its link to keyframe 0 counts as none; 2: culled, merged into 3;
    # 3: then between 1 and 9, 4 s apart: kept
    assert erased == [2] and c.prev_kf_id == 1 and a.next_kf_id == 3
    assert c.preintegrated is not pb and c.preintegrated.dT == 0.0
    m.imu_initialized = False
    lm._cull_keyframes(cur)
    assert erased == [2]


# ------------------------------------- the converged full inertial BA (after `ran`)
def test_converged_full_inertial_ba_equals_jax(ran):
    """`LocalMapper.full_inertial_ba_converged` over each package's whole
    inertial chain after the run (the post-loop global BA of an
    IMU-initialized map): the same number of sweeps in both, and a second
    call is one sweep that moves no keyframe by more than 1e-3 m
    (tests/test_inertial_loop.py's fixed point). The two maps part by
    millimetres before the call (P4, above), so the poses after it are held
    to each other within FULL_BA_ATOL beyond what they parted by before.
    Last in the file: it moves the keyframes of `ran`'s maps."""
    jsys, tsys, _, _ = ran
    out = {}
    for name, system in (("jax", jsys), ("torch", tsys)):
        m = system.atlas.current
        latest = m.keyframes[max(m.keyframes)]
        before = {k: kf.t_cw.copy() for k, kf in m.keyframes.items()}
        with one_torch_thread():
            rounds = system.local_mapper.full_inertial_ba_converged(latest)
            after = {k: kf.t_cw.copy() for k, kf in m.keyframes.items()}
            again = system.local_mapper.full_inertial_ba_converged(latest)
        moved = max(float(np.abs(m.keyframes[k].t_cw - t).max()) for k, t in after.items())
        out[name] = dict(rounds=rounds, before=before, after=after, again=again, moved=moved)
    t, j = out["torch"], out["jax"]
    assert t["rounds"] == j["rounds"] >= 1
    assert t["again"] == j["again"] == 1
    assert t["moved"] < 1e-3 and j["moved"] < 1e-3, (t["moved"], j["moved"])
    assert sorted(t["after"]) == sorted(j["after"])
    parted = max(float(np.abs(t["before"][k] - j["before"][k]).max()) for k in t["before"])
    for k in t["after"]:
        np.testing.assert_allclose(t["after"][k], j["after"][k], atol=parted + FULL_BA_ATOL,
                                   rtol=0, err_msg=f"keyframe {k}")
