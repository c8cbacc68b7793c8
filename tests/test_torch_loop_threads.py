"""The port's loop-closer and global-BA threads, on the CPU.

`LoopCloser(run_async=True)` as the JAX package runs it
(fasttrack_tpu/loop_closing.py:76-130): `insert_keyframe` queues the
keyframe for the loop-closer thread, which processes it under the map lock;
a global BA runs on a thread of its own that takes the map lock per block,
and `stop()` joins both. Held here:

- tests/test_gba_merge.py's drifted map (datasets.synthetic.
  drifted_loop_scene) fed from this thread through `insert_keyframe`: the
  loop closes on the closer's thread at the same keyframe as the
  synchronous closer, with the same corrected poses and points (1e-12: the
  same host and CPU arithmetic in the same order, only on another thread),
  and as the JAX package's `LoopCloser(run_async=True)` on the same scene
  (the same closure; poses and points within
  tests/test_torch_loop_closing.py's 1e-4, the JAX side on its own native
  build);
- tests/test_gba_merge.py::test_gba_off_critical_path at the port: the
  global BA of a drifted 12-keyframe leg runs on its own thread while 4
  keyframes are inserted into the map under its lock, joins, and leaves the
  reprojection error of the original keyframes below 0.5 of its start;
- `stop()` joins both threads; an exception on the closer's thread ends it
  (as in the JAX package), is logged and counted in `n_thread_errors`;
- ROADMAP F19 pinned: a second correction made under the map lock waits out
  the running GBA's join, as in the JAX package;
- a 320x240 `System(Sensor.STEREO, async_mapping=True)` with a 64-word
  flat vocabulary and `System(Sensor.IMU_STEREO, async_mapping=True)` with
  the shipped one over 20 frames: the mapper hands keyframes to the
  closer's queue, and after `shutdown()` no mapper, loop-closer or GBA
  thread is alive and no thread failed.
"""

import logging
import threading
import time

import numpy as np
import pytest

from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.bow.vocabulary import train_vocabulary as jax_train_vocabulary
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.loop_closing import LoopCloser as JaxLoopCloser
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.bow.vocabulary import make_random_vocabulary, train_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.datasets.synthetic import (
    LOOP_FX,
    LOOP_H,
    LOOP_W,
    drifted_loop_scene,
    mean_reprojection_error,
    noisy_leg_scene,
)
from fasttrack_tpu_torch.loop_closing import LoopCloser
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_loop_closing import ATOL
from tests.test_torch_system import one_torch_thread

K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])
N_SYSTEM_FRAMES = 20


def loop_camera():
    return make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device="cpu")


def wait_until(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def drifted_run(run_async, jax_side=False):
    atlas, out, back, descs, drift = drifted_loop_scene(jmap if jax_side else tmap)
    corpus = np.concatenate([descs, descs])
    if jax_side:
        cam = jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H)
        voc = jax_train_vocabulary(corpus, n_words=64, iters=2)
        lc = JaxLoopCloser(atlas, voc, K, camera=cam, bf=1.0, run_gba=False,
                           min_consistency=2, run_async=run_async)
    else:
        voc = train_vocabulary(corpus, n_words=64, iters=2, device="cpu")
        lc = LoopCloser(atlas, voc, K, camera=loop_camera(), bf=1.0, run_gba=False,
                        min_consistency=2, run_async=run_async, device="cpu")
    threads, done = [], []
    inner = lc.process_keyframe

    def process_keyframe(kid):
        threads.append(threading.current_thread())
        closed = inner(kid)
        done.append((kid, closed))
        return closed

    lc.process_keyframe = process_keyframe
    for kf in out + back:
        lc.insert_keyframe(kf)
    assert wait_until(lambda: len(done) == len(out + back))
    lc.stop()
    m = atlas.current
    return dict(lc=lc, done=done, threads=threads, drift=drift(back),
                poses={k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in m.keyframes.items()},
                points={k: p.position.copy() for k, p in m.mappoints.items() if not p.bad})


@pytest.fixture(scope="module")
def drifted():
    with one_torch_thread():
        return drifted_run(False), drifted_run(True)


def test_the_async_closer_closes_the_loop_on_its_thread(drifted):
    sync, run = drifted
    lc = run["lc"]
    assert run["done"] == sync["done"] and any(c for _, c in run["done"])
    assert lc.n_loops_closed == sync["lc"].n_loops_closed == 1
    assert lc.last_loop_kf_id == sync["lc"].last_loop_kf_id
    assert all(t is lc._thread for t in run["threads"])
    assert not any(t is lc._thread for t in sync["threads"]) and sync["lc"]._thread is None
    assert not lc._thread.is_alive() and lc.n_thread_errors == 0


def test_the_async_closer_corrects_as_the_sync_one(drifted):
    sync, run = drifted
    assert sorted(run["poses"]) == sorted(sync["poses"])
    for k, (R, t) in run["poses"].items():
        np.testing.assert_allclose(R, sync["poses"][k][0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(t, sync["poses"][k][1], atol=1e-12, rtol=0)
    assert sorted(run["points"]) == sorted(sync["points"])
    for k, p in run["points"].items():
        np.testing.assert_allclose(p, sync["points"][k], atol=1e-12, rtol=0)
    assert run["drift"] == sync["drift"] < 0.01


@pytest.fixture(scope="module")
def jax_async(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")), one_torch_thread():
        return drifted_run(True, jax_side=True)


def test_the_async_closer_corrects_as_the_jax_async_one(drifted, jax_async):
    _, run = drifted
    lc, jlc = run["lc"], jax_async["lc"]
    assert run["done"] == jax_async["done"] and any(c for _, c in run["done"])
    assert lc.n_loops_closed == jlc.n_loops_closed == 1
    assert lc.last_loop_kf_id == jlc.last_loop_kf_id
    assert all(t is jlc._thread for t in jax_async["threads"]) and not jlc._thread.is_alive()
    assert sorted(run["poses"]) == sorted(jax_async["poses"])
    for k, (R, t) in run["poses"].items():
        np.testing.assert_allclose(R, jax_async["poses"][k][0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(t, jax_async["poses"][k][1], atol=ATOL, rtol=0)
    assert sorted(run["points"]) == sorted(jax_async["points"])
    for k, p in run["points"].items():
        np.testing.assert_allclose(p, jax_async["points"][k], atol=ATOL, rtol=0)
    assert abs(run["drift"] - jax_async["drift"]) < ATOL


def test_gba_off_the_critical_path():
    """tests/test_gba_merge.py::test_gba_off_critical_path: keyframes go
    into the map under its lock while the global BA's blocks sweep on their
    thread; no deadlock, and the map converges."""
    atlas, kfs, pts_w, descs = noisy_leg_scene(tmap)
    m = atlas.current
    e0 = mean_reprojection_error(m)
    assert e0 > 1.0
    lc = LoopCloser(atlas, None, K, camera=loop_camera(), bf=1.0, run_async=True,
                    run_gba=True, device="cpu")
    orig = sorted(m.keyframes)
    with one_torch_thread():
        lc._start_gba(fixed_kf_ids={kfs[0].kid})
        assert lc._gba_thread is not None and lc._gba_thread.is_alive()
        for i in range(4):
            with m.lock:
                synthetic._loop_leg(tmap, atlas, pts_w, descs, 1, kf_x0=4.0 + 0.4 * i)
            time.sleep(0.02)
        lc._gba_thread.join(timeout=300)
    assert not lc._gba_thread.is_alive(), "GBA thread hung"
    assert lc.n_gba_runs == 1 and lc.n_thread_errors == 0
    assert len(m.keyframes) == len(orig) + 4
    e1 = mean_reprojection_error(m, orig)
    assert e1 < 0.5 * e0, (e0, e1)
    lc.stop()
    assert not lc._thread.is_alive()


def test_a_newer_correction_aborts_the_running_gba():
    atlas, kfs, _, _ = noisy_leg_scene(tmap)
    lc = LoopCloser(atlas, None, K, camera=loop_camera(), bf=1.0, run_async=True,
                    device="cpu")
    with one_torch_thread():
        lc._start_gba(fixed_kf_ids={kfs[0].kid})
        first = lc._gba_thread
        lc._start_gba(fixed_kf_ids={kfs[0].kid})     # aborts and joins the first
        assert not first.is_alive() and lc._gba_thread is not first
        lc.stop()
    assert not lc._gba_thread.is_alive() and not lc._thread.is_alive()
    assert lc.n_gba_runs == 2 and lc.n_thread_errors == 0


class ShortJoin:
    """A running GBA thread whose `join` records the timeout asked for and
    waits at most 0.5 s of it."""

    def __init__(self, thread):
        self.thread, self.asked = thread, []

    def is_alive(self):
        return self.thread.is_alive()

    def join(self, timeout=None):
        self.asked.append(timeout)
        self.thread.join(timeout=0.5)


def test_a_correction_under_the_map_lock_waits_out_the_running_gba():
    """ROADMAP F19, as in the JAX package (fasttrack_tpu/loop_closing.py:
    106-109, :128): the closer's thread holds the map lock when a correction
    starts a global BA; the running GBA thread, waiting for that lock, never
    polls `abort_gba`, so the join waits out its whole timeout (30 s, cut
    here to 0.5) and the second GBA starts beside the live first one, and
    both sweep the map once the lock is free."""
    atlas, kfs, _, _ = noisy_leg_scene(tmap)
    m = atlas.current
    lc = LoopCloser(atlas, None, K, camera=loop_camera(), bf=1.0, run_async=True,
                    device="cpu")
    with one_torch_thread():
        with m.lock:                                   # the closer's thread, mid-keyframe
            lc._start_gba(fixed_kf_ids={kfs[0].kid})
            first = lc._gba_thread = ShortJoin(lc._gba_thread)
            lc._start_gba(fixed_kf_ids={kfs[0].kid})  # a second correction
            second = lc._gba_thread
            assert first.asked == [30] and first.is_alive()
            assert second is not first and second.is_alive()
            assert wait_until(lambda: lc.abort_gba is False, timeout=10)
        first.thread.join(timeout=300)
        second.join(timeout=300)
        lc.stop()
    assert not first.is_alive() and not second.is_alive() and not lc._thread.is_alive()
    assert lc.n_gba_runs == 2 and lc.n_thread_errors == 0


def test_a_failing_closer_thread_is_logged_and_counted(caplog):
    atlas, out, _, _, _ = drifted_loop_scene(tmap)
    lc = LoopCloser(atlas, None, K, run_async=True, device="cpu")

    def process_keyframe(kid):
        raise RuntimeError(f"keyframe {kid}")

    lc.process_keyframe = process_keyframe
    with caplog.at_level(logging.ERROR, logger="fasttrack_tpu_torch.loop_closing"):
        lc.insert_keyframe(out[0])
        assert wait_until(lambda: not lc._thread.is_alive(), timeout=10)
    assert lc.n_thread_errors == 1
    assert "the loop-closer thread failed" in caplog.text and "keyframe 0" in caplog.text
    lc.stop()


# ---------------------------------------------------- the async systems
def small_settings(seq, **kw):
    return Settings(
        camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, 320, 240, device="cpu"),
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=320, height=240,
        n_features=512, n_levels=4, th_depth=60.0, **kw)


@pytest.mark.parametrize("sensor", [Sensor.STEREO, Sensor.IMU_STEREO], ids=lambda s: s.name)
def test_an_async_system_hands_keyframes_to_the_closer_and_shuts_down(sensor):
    seq = synthetic.generate_sequence(n_frames=N_SYSTEM_FRAMES, h=240, w=320, seed=5)
    inertial = sensor is Sensor.IMU_STEREO
    settings = small_settings(seq, **(dict(T_b_c1=np.eye(4), imu_frequency=200.0)
                                      if inertial else {}))
    vocabulary = None if inertial else make_random_vocabulary(64)
    system = System(settings, sensor, async_mapping=True, vocabulary=vocabulary, device="cpu")
    lc, lm = system.loop_closer, system.local_mapper
    assert lc.run_async and lm.run_async and lm.loop_closer is lc
    assert lc.tracker is system.tracker and lc.local_mapper is lm
    seen = []
    inner = lc.process_keyframe

    def process_keyframe(kid):
        seen.append(kid)
        return inner(kid)

    lc.process_keyframe = process_keyframe
    t_prev = -1.0
    with one_torch_thread():
        for f in seq.frames:
            imu = None
            if inertial:
                sel = (seq.imu_t > t_prev) & (seq.imu_t <= f.timestamp)
                imu = [(float(t), seq.imu_acc[i], seq.imu_gyro[i])
                       for i, t in zip(np.where(sel)[0], seq.imu_t[sel])]
            system.track_stereo(f.left, f.right, f.timestamp, imu=imu)
            t_prev = f.timestamp
        assert wait_until(lambda: lm.is_idle() and lc._queue.empty())
        assert wait_until(lambda: len(seen) == int(sum(system.stats.series["lm_keyframes"])))
        system.shutdown()
    assert system.tracking_state.name == "OK"
    assert len(seen) >= 2 and seen == sorted(seen)
    for t in (lm._thread, lc._thread, lc._gba_thread):
        assert t is None or not t.is_alive()
    assert lc.n_thread_errors == 0
