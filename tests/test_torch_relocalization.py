"""The port's relocalization against the JAX package's, on the CPU, through
the default `System` of both (the shipped vocabulary, a LoopCloser wired
into the mapper, the keyframe database shared with the tracker).

tests/test_tracking_e2e.py's TestRelocalization at its size (320x240, 30
rendered frames, seed 3, 512 features, 4 levels): frames 0-19, three blank
frames (RECENTLY_LOST), then a view to re-acquire. Three scenarios:

- "revisit": frames 12-17 again (test_lost_then_relocalizes_with_default_vocab);
- "offset view": frames 0-5 again (test_relocalizes_from_offset_view);
- "reference keyframe gone": frames 0-5 again with the tracker's reference
  keyframe forgotten after the blank frames, so that the reference-keyframe
  match has nothing to match and the tracker goes through
  Tracking::Relocalization itself: BoW candidates from the database, the
  top-K match at K = 2, RANSAC PnP, pose optimization and the
  widening-window rebind.

A fourth, "atlas reloaded" (M9e): frames 0-19, `save_atlas`, a new System
that loads the file, then frames 12-17. The port loads its own file and the
JAX package's; the JAX package loads its own. Equal: the state after every
resumed frame, the frame of re-acquisition, the reference keyframe and the
relocalization attempts; poses within the same 2e-3. The two files of
frames 0-19 have the same schema (keys, types, dtypes; the BoW vectors of
the shipped vocabulary included), their values apart by the runs' rounding.

Equal in both packages: the state after every frame, the frame of
re-acquisition, the reference keyframe, the number of maps (re-acquired in
the original map, not reset) and `n_loops_closed`; in the third scenario
also the relocalization's candidates and its success. Poses agree within
2e-3 on every frame (f32 rounding through pose optimization and the local
BA, as tests/test_torch_system.py), and the camera centre is within the
JAX test's 0.25 m of the ground truth at the last frame (the truth taken in
the first camera's frame).
"""

import os
import pickle

import numpy as np
import pytest

from fasttrack_tpu.tracking import TrackingState as JaxTrackingState
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_system import one_torch_thread
from tests.test_torch_atlas import numpy_only_load
from tests.test_tracking_e2e import make_system as make_jax_system

H, W = 240, 320
POSE_ATOL = 2e-3
SCENARIOS = {"revisit": (12, 18, False), "offset view": (0, 6, False),
             "reference keyframe gone": (0, 6, True)}


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=30, h=H, w=W, seed=3)


def make_system(seq):
    """tests/test_tracking_e2e.py's make_system, for the port on the CPU."""
    s = Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu"),
                 bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
                 th_depth=60.0, n_features=512, n_levels=4)
    return System(s, Sensor.STEREO, device="cpu")


def watch(system):
    """Record each frame's state, reference keyframe, pose and map count,
    and each relocalization attempt with its candidates; returns the step
    function and the two logs."""
    tracker = system.tracker
    attempts = []
    reloc = tracker._relocalization
    detect = tracker.reloc_db.detect_relocalization_candidates

    def relocalization(frame):
        attempts.append({"frame": len(log)})
        attempts[-1]["ok"] = reloc(frame)
        return attempts[-1]["ok"]

    def detect_relocalization_candidates(*a, **kw):
        attempts[-1]["candidates"] = detect(*a, **kw)
        return attempts[-1]["candidates"]

    tracker._relocalization = relocalization
    tracker.reloc_db.detect_relocalization_candidates = detect_relocalization_candidates
    log = []

    def step(left, right, t):
        system.track_stereo(left, right, t)
        f = tracker.last_frame
        log.append(dict(state=system.tracking_state.name, ref=tracker.ref_kf_id,
                        R=f.R_cw.copy(), t=f.t_cw.copy(), maps=system.atlas.n_maps()))

    return step, log, attempts


def drive(system, seq, scenario, save_to=None):
    """The scenario's frames; with `save_to`, the atlas after frame 19 is
    saved there too (the same in every scenario) unless it exists."""
    first, stop, forget = SCENARIOS[scenario]
    tracker = system.tracker
    step, log, attempts = watch(system)
    for fr in seq.frames[:20]:
        step(fr.left, fr.right, fr.timestamp)
    if save_to is not None and not os.path.exists(save_to):
        system.save_atlas(save_to)
    blank = np.full_like(seq.frames[0].left, 127)
    t = seq.frames[19].timestamp
    for _ in range(3):
        t += 0.05
        step(blank, blank, t)
    if forget:
        tracker.ref_kf_id = None
    for fr in seq.frames[first:stop]:
        t += 0.05
        step(fr.left, fr.right, t)
    system.shutdown()
    R0, t0 = seq.frames[0].R_wc, seq.frames[0].t_wc
    last = log[-1]
    error = float(np.linalg.norm(-last["R"].T @ last["t"]
                                 - R0.T @ (seq.frames[stop - 1].t_wc - t0)))
    return dict(log=log, attempts=attempts, error=error,
                loops=system.loop_closer.n_loops_closed)


@pytest.fixture(scope="module")
def atlas_files(tmp_path_factory):
    """Each package's atlas after frames 0-19, saved by the first scenario
    that runs (the "atlas reloaded" scenario loads them)."""
    root = tmp_path_factory.mktemp("atlas_after_19")
    return {"jax": str(root / "jax.osa"), "torch": str(root / "torch.osa")}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def ran(request, seq, atlas_files):
    with one_torch_thread():
        jsys = make_jax_system(seq)
        tsys = make_system(seq)
        return (request.param, drive(tsys, seq, request.param, atlas_files["torch"]),
                drive(jsys, seq, request.param, atlas_files["jax"]))


def test_the_default_system_has_place_recognition(seq):
    system = make_system(seq)
    assert system.loop_closer is not None and system.local_mapper.loop_closer is system.loop_closer
    assert system.tracker.reloc_db is system.loop_closer.db is system.atlas.kf_db
    assert system.tracker.vocabulary is system.vocabulary is system.loop_closer.voc
    assert system.loop_closer.tracker is system.tracker
    system.shutdown()


def test_states_and_reacquisition_equal_jax(ran):
    scenario, t, j = ran
    states = [r["state"] for r in t["log"]]
    assert states == [r["state"] for r in j["log"]]
    assert states[19] == "OK" and states[22] == JaxTrackingState.RECENTLY_LOST.name
    back = states.index("OK", 23)
    assert back < len(states) and all(s == "OK" for s in states[back:])
    assert [r["ref"] for r in t["log"]] == [r["ref"] for r in j["log"]]
    assert [r["maps"] for r in t["log"]] == [r["maps"] for r in j["log"]] == [1] * len(states)
    assert t["loops"] == j["loops"]


def test_relocalization_attempts_equal_jax(ran):
    scenario, t, j = ran
    assert [a.get("candidates") for a in t["attempts"]] == \
        [a.get("candidates") for a in j["attempts"]]
    assert [(a["frame"], a["ok"]) for a in t["attempts"]] == \
        [(a["frame"], a["ok"]) for a in j["attempts"]]
    if scenario == "reference keyframe gone":
        # re-acquired by relocalization itself, on the first frame after
        # the blank ones
        assert t["attempts"][-1]["ok"] and t["attempts"][-1]["frame"] == 23
        assert t["attempts"][-1]["candidates"]


def test_poses_equal_jax_and_near_the_truth(ran):
    _, t, j = ran
    for k, (a, b) in enumerate(zip(t["log"], j["log"])):
        np.testing.assert_allclose(a["R"], b["R"], atol=POSE_ATOL, err_msg=f"frame {k}")
        np.testing.assert_allclose(a["t"], b["t"], atol=POSE_ATOL, err_msg=f"frame {k}")
    assert t["error"] < 0.25 and j["error"] < 0.25


# ------------------------------------------------------------ atlas reloaded
RELOADS = {"own file": ("torch", "jax"), "the JAX file": ("jax", "jax")}


@pytest.fixture(scope="module")
def reloaded(seq, atlas_files):
    """New Systems load the files of frames 0-19 and track frames 12-17,
    0.05 s apart after frame 19. The files come from the scenarios above
    when they ran first (as they do in this file's order), else from a run
    of frames 0-19 here."""
    with one_torch_thread():
        for name, make in (("jax", make_jax_system), ("torch", make_system)):
            if not os.path.exists(atlas_files[name]):
                system = make(seq)
                for fr in seq.frames[:20]:
                    system.track_stereo(fr.left, fr.right, fr.timestamp)
                system.save_atlas(atlas_files[name])
                system.shutdown()
        logs = {}
        for reader, writer in (("torch", "torch"), ("torch", "jax"), ("jax", "jax")):
            system = (make_system if reader == "torch" else make_jax_system)(seq)
            system.load_atlas(atlas_files[writer])
            step, log, attempts = watch(system)
            t = seq.frames[19].timestamp
            for fr in seq.frames[12:18]:
                t += 0.05
                step(fr.left, fr.right, t)
            system.shutdown()
            logs[reader, writer] = dict(log=log, attempts=attempts)
    return atlas_files, logs


@pytest.mark.parametrize("case", sorted(RELOADS))
def test_reloaded_states_and_reacquisition_equal_jax(reloaded, case):
    writer, jax_writer = RELOADS[case]
    _, logs = reloaded
    t, j = logs["torch", writer], logs["jax", jax_writer]
    states = [r["state"] for r in t["log"]]
    assert states == [r["state"] for r in j["log"]]
    assert "OK" in states[:3] and all(s == "OK" for s in states[states.index("OK"):])
    assert [r["ref"] for r in t["log"]] == [r["ref"] for r in j["log"]]
    assert [r["maps"] for r in t["log"]] == [1] * len(states)
    assert [(a["frame"], a["ok"], a.get("candidates")) for a in t["attempts"]] == \
        [(a["frame"], a["ok"], a.get("candidates")) for a in j["attempts"]]


@pytest.mark.parametrize("case", sorted(RELOADS))
def test_reloaded_poses_equal_jax(reloaded, case):
    writer, jax_writer = RELOADS[case]
    _, logs = reloaded
    t, j = logs["torch", writer], logs["jax", jax_writer]
    for k, (a, b) in enumerate(zip(t["log"], j["log"])):
        np.testing.assert_allclose(a["R"], b["R"], atol=POSE_ATOL, err_msg=f"frame {k}")
        np.testing.assert_allclose(a["t"], b["t"], atol=POSE_ATOL, err_msg=f"frame {k}")


def test_reloaded_files_have_the_same_schema(reloaded):
    """The files of frames 0-19 written by both packages: the same keys,
    types, dtypes and shapes all through, and the same vocabulary checksum;
    the port's unpickles with NumPy alone."""
    files, _ = reloaded
    got = numpy_only_load(files["torch"])
    with open(files["jax"], "rb") as f:
        want = pickle.load(f)

    def schema(x):
        if isinstance(x, dict):
            return ("dict", {k: schema(v) for k, v in x.items()})
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, [schema(v) for v in x])
        if isinstance(x, np.ndarray):
            return ("ndarray", str(x.dtype), x.shape)
        return type(x).__name__

    assert got["vocab_checksum"] == want["vocab_checksum"] != ""
    assert got["next_ids"] == want["next_ids"]
    assert schema(got) == schema(want)
    bows = [kd["bow_vec"] for kd in got["maps"][0]["keyframes"].values()]
    assert all(bows) and all(type(w) is int for b in bows for w in b)
