"""The port's atlas save and load (System.save_atlas / load_atlas, M9e)
against the JAX package's, on the CPU.

The scene is tests/test_inertial_loop.py's drifted loop
(datasets.synthetic.drifted_loop_scene(inertial=True): 9 keyframes over a
300-point cloud, IMU-initialized and marked inertial), built in each
package's map types with the same numbers, plus what that scene leaves
empty and a file must carry: a preintegration snapshot, an IMU bias and a
BoW vector on each keyframe, loop and merge edges, a map point with an id
past the 4,096 slots the id table starts with, and values of what the file
does not hold (ROADMAP F43). Each package's `System(vocabulary=False)`
saves it; no frame is tracked.

- the two files are equal: the same keys, types, dtypes and values, exact;
- each package loads the other's file (and its own) into every field the
  file holds, exact: keyframes, points, edge sets, preintegration dicts,
  `next_ids`, `imu_initialized`, `is_inertial`;
- a torch tensor in a field is written as its NumPy array, so the file
  unpickles with nothing but NumPy;
- a file saved under one vocabulary is refused under another
  (ValueError) in both packages;
- Settings.load_atlas loads in the constructor and Settings.save_atlas
  writes on shutdown, for every sensor;
- ROADMAP F43, as the JAX package does it: the map's full-inertial-BA
  flags, the points' visible and found counters and the keyframes' feature
  vectors are not in the file and restart (False, 1/1, None), and a loaded
  map never runs the staged full inertial BA, because the mapper of a new
  System has no IMU-init time;
- the resumed tracker: RECENTLY_LOST on the newest keyframe, and with an
  IMU the bias, velocity and last keyframe's body state equal to the JAX
  tracker's, exact, under a tilted body-camera extrinsic;
- the tracker's device mirror of the point store uploads the loaded store
  (its version is new) and holds its values;
- ROADMAP F44: a first frame after a load that does not re-acquire keeps
  no pose in the port, where the JAX tracker raises.
"""

import pickle
import types

import numpy as np
import pytest
import torch

from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.bow.vocabulary import make_random_vocabulary as jax_random_vocabulary
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.imu.preintegration import HostPreintegrated as JaxHostPreintegrated
from fasttrack_tpu.settings import Settings as JaxSettings
from fasttrack_tpu.system import Sensor as JaxSensor
from fasttrack_tpu.system import System as JaxSystem
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.bow.vocabulary import make_random_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets.synthetic import LOOP_FX, LOOP_H, LOOP_W, drifted_loop_scene
from fasttrack_tpu_torch.imu.preintegration import HostPreintegrated, ImuCalib
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.system import Sensor, System
from fasttrack_tpu_torch.tracking import TrackingState

FAR_MID = 5000                      # past the id table's first 4,096 slots
PRE_FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C")
KF_FIELDS = ("frame_id", "timestamp", "R_cw", "t_cw", "kp_uv", "kp_level", "kp_angle",
             "desc_packed", "desc_signed", "u_right", "depth", "valid", "mp_ids",
             "covisible", "parent_id", "children", "velocity", "imu_bias", "prev_kf_id",
             "next_kf_id", "bow_vec", "loop_edges", "merge_edges")
MP_FIELDS = ("position", "normal", "desc_packed", "desc_signed", "observations",
             "ref_kf_id", "first_kf_id", "min_distance", "max_distance")


# ----------------------------------------------------------------- the scene
def _preintegrations(n):
    """n host preintegration snapshots from seeded samples (the port's
    accumulator; each package's scene gets the same numbers)."""
    rng = np.random.default_rng(11)
    cal = ImuCalib.default(device="cpu")
    out = []
    for k in range(n):
        p = HostPreintegrated(rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3))
        p.integrate(rng.normal(0, 0.5, (8, 3)) + [0, 0, 9.81], rng.normal(0, 0.2, (8, 3)),
                    np.full(8, 0.005), cal)
        out.append(p)
    return out


def scene(slam_map):
    """The drifted inertial loop in `slam_map`'s types, with every field the
    file carries set (see the module docstring)."""
    atlas, out, back, descs, _ = drifted_loop_scene(slam_map, inertial=True)
    m = atlas.current
    kfs = sorted(m.keyframes.values(), key=lambda k: k.kid)
    Pre = HostPreintegrated if slam_map is tmap else JaxHostPreintegrated
    rng = np.random.default_rng(12)
    for k, (a, b) in enumerate(zip(kfs, kfs[1:])):
        a.next_kf_id, b.prev_kf_id = b.kid, a.kid
    for kf, src in zip(kfs[1:], _preintegrations(len(kfs) - 1)):
        p = Pre(src.b0.bg, src.b0.ba)
        p.dT = src.dT
        for f in PRE_FIELDS[1:] + ("avgA", "avgW"):
            setattr(p, f, getattr(src, f).copy())
        kf.preintegrated = p
    for kf in kfs:
        kf.imu_bias = (rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3))
        kf.bow_vec = {int(w): float(v) for w, v in zip(rng.choice(64, 5, replace=False),
                                                       rng.random(5))}
        kf.feat_vec = {0: [0, 1]}                      # not in the file (F43)
    kfs[-1].loop_edges = {kfs[0].kid}
    kfs[0].loop_edges = {kfs[-1].kid}
    kfs[3].merge_edges = {kfs[4].kid}
    m.iniertial_ba1 = True                             # not in the file (F43)
    first = next(iter(m.mappoints.values()))
    first.n_visible, first.n_found = 7, 3              # not in the file (F43)
    # a point with an id past the table's first 4,096 slots
    atlas._next_mp_id = FAR_MID
    far = slam_map.MapPoint(atlas.next_mp_id(), np.array([0.3, -0.2, 4.0]), kfs[0].kid,
                            kfs[0].kid)
    far.desc_signed = descs[0].astype(np.int8)
    far.desc_packed = np.packbits((descs[0] > 0).astype(np.uint8))
    m.add_mappoint(far)
    free = int(np.where(kfs[0].mp_ids < 0)[0][0]) if (kfs[0].mp_ids < 0).any() else None
    if free is not None:
        far.add_observation(kfs[0].kid, free)
        kfs[0].mp_ids[free] = far.mid
    return atlas


def settings_pair(**kw):
    base = dict(bf=LOOP_FX * 0.1, baseline=0.1, width=LOOP_W, height=LOOP_H,
                n_features=256, n_levels=4)
    base.update(kw)
    return (JaxSettings(camera1=jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2,
                                                 LOOP_W, LOOP_H), **base),
            Settings(camera1=make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2,
                                          LOOP_W, LOOP_H, device="cpu"), **base))


def systems(sensor="STEREO", vocabularies=(False, False), **kw):
    js, ts = settings_pair(**kw)
    return (JaxSystem(js, getattr(JaxSensor, sensor), vocabulary=vocabularies[0]),
            System(ts, getattr(Sensor, sensor), vocabulary=vocabularies[1], device="cpu"))


def numpy_only_load(path):
    """Unpickle a file that may name NumPy and nothing else (no torch)."""
    class Only(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] != "numpy":
                raise pickle.UnpicklingError(f"{module}.{name} in an atlas file")
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return Only(f).load()


# ----------------------------------------------------------- tree comparison
def assert_tree_equal(a, b, path="file"):
    """Equal keys, types, dtypes, shapes and values, exact (NaN equal)."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert type(k) is type(next(x for x in b if x == k)), (path, k)
            assert_tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def pre_tree(p):
    if p is None:
        return None
    d = {f: np.asarray(getattr(p, f), np.float64) for f in PRE_FIELDS}
    d["bg"], d["ba"] = np.asarray(p.b0.bg, np.float64), np.asarray(p.b0.ba, np.float64)
    return d


def atlas_tree(atlas):
    """Every field an atlas file holds, read off the live objects of either
    package, with NumPy values."""
    maps = []
    for m in atlas.maps:
        kfs = {k: {**{f: getattr(kf, f) for f in KF_FIELDS},
                   "preintegrated": pre_tree(kf.preintegrated)}
               for k, kf in m.keyframes.items()}
        mps = {mid: {f: getattr(p, f) for f in MP_FIELDS} for mid, p in m.mappoints.items()}
        maps.append(dict(map_id=m.map_id, init_kf_id=m.init_kf_id,
                         imu_initialized=m.imu_initialized, is_inertial=m.is_inertial,
                         keyframes=kfs, mappoints=mps))
    return dict(maps=maps, next_ids=(atlas._next_map_id, atlas._next_kf_id, atlas._next_mp_id))


def assert_atlases_equal(got, want):
    """Loaded against live: every field the file holds, value for value (an
    array field may come back as the array the saver wrote; a float as it
    was); each point's store row alive and found through the id table."""
    tg, tw = atlas_tree(got), atlas_tree(want)
    assert tg["next_ids"] == tw["next_ids"]
    assert len(tg["maps"]) == len(tw["maps"])
    for mg, mw in zip(tg["maps"], tw["maps"]):
        for key in ("map_id", "init_kf_id", "imu_initialized", "is_inertial"):
            assert mg[key] == mw[key], key
        assert set(mg["keyframes"]) == set(mw["keyframes"])
        assert set(mg["mappoints"]) == set(mw["mappoints"])
        for kid in mw["keyframes"]:
            for f, v in mw["keyframes"][kid].items():
                g = mg["keyframes"][kid][f]
                if isinstance(v, np.ndarray) or isinstance(g, np.ndarray):
                    np.testing.assert_array_equal(g, v, err_msg=f"keyframe {kid} {f}")
                elif isinstance(v, tuple):
                    for x, y in zip(g, v):
                        np.testing.assert_array_equal(x, y, err_msg=f"keyframe {kid} {f}")
                elif isinstance(v, dict) and f == "preintegrated":
                    for k2 in v:
                        np.testing.assert_array_equal(g[k2], v[k2], err_msg=f"{kid} {k2}")
                else:
                    assert g == v, (kid, f, g, v)
        for mid in mw["mappoints"]:
            for f, v in mw["mappoints"][mid].items():
                g = mg["mappoints"][mid][f]
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(g, v, err_msg=f"point {mid} {f}")
                else:
                    assert g == v, (mid, f, g, v)
    for m in got.maps:
        mids = np.asarray(sorted(m.mappoints))
        rows = m.rows_for(mids)
        assert (rows >= 0).all() and m.store.alive[rows].all()
        np.testing.assert_array_equal(m.store.mids[rows], mids)


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def scenes():
    return {"jax": scene(jmap), "torch": scene(tmap)}


@pytest.fixture(scope="module")
def files(scenes, tmp_path_factory):
    root = tmp_path_factory.mktemp("atlas")
    jsys, tsys = systems()
    out = {}
    for name, system in (("jax", jsys), ("torch", tsys)):
        system.atlas = scenes[name]
        out[name] = str(root / f"{name}.osa")
        system.save_atlas(out[name])
    return out


# ------------------------------------------------------------------- tests
def test_both_packages_write_the_same_file(files):
    with open(files["jax"], "rb") as f:
        want = pickle.load(f)
    got = numpy_only_load(files["torch"])
    assert set(got) == {"maps", "next_ids", "vocab_checksum"}
    assert got["vocab_checksum"] == "" and got["next_ids"] == (1, 9, FAR_MID + 1)
    assert_tree_equal(got, want)
    kd = next(iter(got["maps"][0]["keyframes"].values()))
    assert set(kd) == set(KF_FIELDS) | {"preintegrated"}


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax"),
                                            ("torch", "torch")])
def test_a_file_loads_in_either_package(scenes, files, writer, reader):
    jsys, tsys = systems()
    system = tsys if reader == "torch" else jsys
    system.load_atlas(files[writer])
    assert_atlases_equal(system.atlas, scenes[writer])
    m = system.atlas.current
    assert m.is_inertial and m.imu_initialized and FAR_MID in m.mappoints
    assert len(m._mid2row) > FAR_MID and m.rows_for(np.array([FAR_MID]))[0] >= 0
    assert system.tracker.state.name == "RECENTLY_LOST"
    assert system.tracker.ref_kf_id == max(m.keyframes)


def test_tensors_are_written_as_numpy(tmp_path):
    """A field that holds a tensor (as the card's would) is written as its
    NumPy array with its dtype: the file unpickles without torch and loads
    into the JAX package's System."""
    atlas = scene(tmap)
    kf = atlas.current.keyframes[max(atlas.current.keyframes)]
    velocity = kf.velocity.copy()
    kf.velocity = torch.from_numpy(velocity)
    kf.kp_uv = torch.from_numpy(kf.kp_uv)
    kf.imu_bias = tuple(torch.from_numpy(b) for b in kf.imu_bias)
    _, tsys = systems()
    tsys.atlas = atlas
    path = str(tmp_path / "t.osa")
    tsys.save_atlas(path)
    state = numpy_only_load(path)
    kd = state["maps"][0]["keyframes"][kf.kid]
    assert isinstance(kd["velocity"], np.ndarray) and kd["velocity"].dtype == np.float64
    np.testing.assert_array_equal(kd["velocity"], velocity)
    assert kd["kp_uv"].dtype == np.float32 and isinstance(kd["imu_bias"], tuple)
    jsys, _ = systems()
    jsys.load_atlas(path)
    np.testing.assert_array_equal(jsys.atlas.current.keyframes[kf.kid].velocity, velocity)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_different_vocabulary_is_refused(scenes, tmp_path, writer):
    """System.cc:1466-1479's MD5 guard in both packages: a file saved under
    one vocabulary loads under the same one and is refused under another."""
    vocs = {name: (jax_random_vocabulary(n_words=64, seed=seed),
                   make_random_vocabulary(n_words=64, seed=seed))
            for name, seed in (("a", 1), ("b", 2))}
    jsys, tsys = systems(vocabularies=vocs["a"])
    system = tsys if writer == "torch" else jsys
    system.atlas = scenes[writer]
    path = str(tmp_path / "v.osa")
    system.save_atlas(path)
    for same in systems(vocabularies=vocs["a"]):
        same.load_atlas(path)
        assert same.atlas.current.n_keyframes() == 9
        # each keyframe's BoW vector goes into the closer's database
        assert sorted(same.loop_closer.db.kf_bows) == sorted(same.atlas.current.keyframes)
    for other in systems(vocabularies=vocs["b"]):
        with pytest.raises(ValueError, match="different vocabulary"):
            other.load_atlas(path)
    # a file written without a vocabulary (checksum '') loads under any
    _, tsys = systems()
    tsys.atlas = scenes[writer]
    tsys.save_atlas(path)
    for other in systems(vocabularies=vocs["b"]):
        other.load_atlas(path)
        assert other.atlas.current.n_keyframes() == 9


def test_the_settings_load_in_the_constructor_and_save_on_shutdown(scenes, files, tmp_path):
    saved = str(tmp_path / "shutdown.osa")
    js, ts = settings_pair(load_atlas=files["jax"], save_atlas=saved)
    system = System(ts, Sensor.STEREO, vocabulary=False, device="cpu")
    assert ts.load_atlas == files["jax"]               # the caller's settings untouched
    assert_atlases_equal(system.atlas, scenes["jax"])
    assert system.tracker.state == TrackingState.RECENTLY_LOST
    system.shutdown()
    with open(saved, "rb") as f:
        got = pickle.load(f)
    with open(files["jax"], "rb") as f:
        want = pickle.load(f)
    assert_tree_equal(got, want)
    jsys = JaxSystem(js, JaxSensor.STEREO, vocabulary=False)
    assert_atlases_equal(jsys.atlas, scenes["jax"])


def test_f43_what_the_file_does_not_hold_restarts(scenes, files):
    """ROADMAP F43: the full-inertial-BA flags, the points' visible/found
    counters and the keyframes' feature vectors are not in the file. After
    a load they read False, 1/1 and None in both packages, and neither
    mapper runs the staged full inertial BA on a keyframe far past the
    stages' 5 s and 15 s, because a new System's mapper has no IMU-init
    time; given one, the first stage would run again."""
    m0 = scenes["torch"].current
    assert m0.iniertial_ba1 and next(iter(m0.mappoints.values())).n_visible == 7
    jsys, tsys = systems("IMU_STEREO", T_b_c1=np.eye(4))
    runs = {}
    for name, system in (("jax", jsys), ("torch", tsys)):
        system.load_atlas(files[name])
        m = system.atlas.current
        assert (m.iniertial_ba1, m.iniertial_ba2) == (False, False)
        assert all((p.n_visible, p.n_found, p.found_ratio()) == (1, 1, 1.0)
                   for p in m.mappoints.values())
        assert all(kf.feat_vec is None for kf in m.keyframes.values())
        lm = system.local_mapper
        assert lm.imu_init_time is None
        calls = []
        for step in ("_track_new_points", "_cull_recent_mappoints", "_create_new_mappoints",
                     "_search_in_neighbors", "_local_inertial_ba", "_local_ba",
                     "_cull_keyframes"):
            setattr(lm, step, lambda *a, **kw: 0)
        lm._full_inertial_ba = lambda kf, *a, **kw: calls.append(kf.kid)
        latest = m.keyframes[max(m.keyframes)]
        latest.timestamp += 20.0
        lm.process_keyframe(latest)
        before = list(calls)
        lm.imu_init_time = 0.0
        lm.process_keyframe(latest)
        runs[name] = (before, list(calls), m.iniertial_ba1, m.iniertial_ba2)
    assert runs["torch"] == runs["jax"] == ([], [max(m0.keyframes)], True, False)


def test_the_resumed_tracker_equals_jax(files):
    """The IMU anchor of the newest keyframe, restored through each
    tracker's _body_from_cam under a tilted extrinsic, exact."""
    c, s = np.cos(0.3), np.sin(0.3)
    T_b_c1 = np.array([[c, -s, 0, 0.05], [s, c, 0, -0.02], [0, 0, 1, 0.01], [0, 0, 0, 1.0]])
    jsys, tsys = systems("IMU_STEREO", T_b_c1=T_b_c1)
    jsys.load_atlas(files["jax"])
    tsys.load_atlas(files["jax"])
    jt, tt = jsys.tracker, tsys.tracker
    last = tsys.atlas.current.keyframes[max(tsys.atlas.current.keyframes)]
    assert tt.state == TrackingState.RECENTLY_LOST and tt.ref_kf_id == jt.ref_kf_id == last.kid
    assert tt.last_kf_id == jt.last_kf_id == last.kid
    for x, y in zip(tt.bias, jt.bias):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tt.bias[0], last.imu_bias[0])
    np.testing.assert_array_equal(tt.v_w, jt.v_w)
    for x, y in zip(tt.last_kf_state, jt.last_kf_state):
        np.testing.assert_array_equal(x, y)
    # without an IMU the tracker only resumes
    _, visual = systems()
    visual.load_atlas(files["jax"])
    assert visual.tracker.last_kf_state is None and visual.tracker.last_kf_id is None


def test_the_mirror_uploads_the_loaded_store(files):
    """A loaded map's PointStore has a version no store had, so the
    tracker's device mirror uploads it (once), with the loaded values; a
    second load uploads again."""
    _, tsys = systems()
    tr = tsys.tracker
    tr._store_device(tsys.atlas.current)
    n0 = sum(tr.stats.series["store_uploads"])
    old_key = tr._store_key
    for k in (1, 2):
        tsys.load_atlas(files["torch"])
        st = tsys.atlas.current.store
        assert st.version != old_key
        dev = tr._store_device(tsys.atlas.current)
        tr._store_device(tsys.atlas.current)
        assert sum(tr.stats.series["store_uploads"]) == n0 + k
        old_key = tr._store_key
        rows = np.where(st.alive)[0]
        np.testing.assert_array_equal(dev.pos.numpy()[rows], st.pos[rows].astype(np.float32))


def test_f44_a_first_frame_lost_after_a_load_keeps_no_pose(files):
    """ROADMAP F44: a load leaves no last frame. A first frame that does not
    re-acquire the map raises AttributeError in the JAX tracker's postlude
    (it copies the last frame's pose); the port's keeps no pose for it,
    stays RECENTLY_LOST and adds nothing to the trajectory."""
    jsys, tsys = systems()
    jsys.load_atlas(files["jax"])
    tsys.load_atlas(files["torch"])
    lost = types.SimpleNamespace(R_cw=None, t_cw=None, timestamp=10.0)
    with pytest.raises(AttributeError, match="R_cw"):
        jsys.tracker._post_track(lost, False)
    blank = np.full((LOOP_H, LOOP_W), 127, np.uint8)
    assert tsys.track_stereo(blank, blank, 10.0) is None
    assert tsys.tracking_state == TrackingState.RECENTLY_LOST
    assert tsys.tracker.trajectory == [] and tsys.tracker.last_frame.R_cw is None


@pytest.mark.parametrize("sensor", [s.name for s in Sensor])
def test_every_sensor_loads_and_saves_through_its_settings(files, tmp_path, sensor):
    """Every sensor's System loads the file its settings name and writes it
    back on shutdown unchanged; the inertial ones restore the IMU anchor."""
    saved = str(tmp_path / "back.osa")
    _, ts = settings_pair(load_atlas=files["torch"], save_atlas=saved, T_b_c1=np.eye(4))
    system = System(ts, Sensor[sensor], vocabulary=False, device="cpu")
    assert system.atlas.current.n_keyframes() == 9
    assert (system.tracker.last_kf_state is not None) == sensor.startswith("IMU_")
    system.shutdown()
    with open(files["torch"], "rb") as f:
        want = pickle.load(f)
    assert_tree_equal(numpy_only_load(saved), want)
