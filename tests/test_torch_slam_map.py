"""The port's map types (PointStore, Map, KeyFrame, MapPoint, Atlas) against
the JAX package's: the same script of operations, on the same numpy inputs
from a seed, runs on both packages' classes, and the resulting state must be
exactly equal (host code on float64 NumPy on both sides; no tolerance).
"""

import numpy as np
import pytest

from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.slam_map.map import PointStore as JaxPointStore
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.slam_map.map import PointStore

PACKAGES = [pytest.param(jmap, id="jax"), pytest.param(tmap, id="torch")]
N_KP = 40


def make_kf(pkg, atlas, rng, n=N_KP):
    kid = atlas.next_kf_id()
    bits = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    return pkg.KeyFrame(
        kid, kid, 0.05 * kid, R, rng.normal(size=3),
        rng.uniform(0, 300, (n, 2)).astype(np.float32), rng.integers(0, 4, n).astype(np.int32),
        rng.uniform(0, 6, n).astype(np.float32), np.packbits(bits, axis=1, bitorder="little"),
        (2 * bits.astype(np.int8) - 1), np.full(n, -1.0, np.float32),
        rng.uniform(1, 5, n).astype(np.float32), np.ones(n, bool),
    )


def add_point(pkg, atlas, m, kf, i, rng):
    mp = pkg.MapPoint(atlas.next_mp_id(), rng.normal(size=3) * 3, kf.kid, kf.kid)
    mp.add_observation(kf.kid, i)
    mp.desc_packed = kf.desc_packed[i]
    mp.desc_signed = kf.desc_signed[i]
    mp.update_normal_and_depth({kf.kid: kf.center}, kf.center, int(kf.kp_level[i]), 1.2, 4)
    kf.mp_ids[i] = mp.mid
    m.add_mappoint(mp)
    return mp


def build(pkg, seed=0):
    """Three keyframes sharing map points, then every mutation the map
    supports; returns the atlas and a log of what the calls returned."""
    rng = np.random.default_rng(seed)
    atlas = pkg.Atlas()
    m = atlas.current
    log = {}
    kfs = [make_kf(pkg, atlas, rng) for _ in range(3)]
    for kf in kfs:
        m.add_keyframe(kf)
    for i in range(N_KP):
        add_point(pkg, atlas, m, kfs[0], i, rng)
    # kf1 re-observes the first 30 points, kf2 the first 12 (under min_weight 15)
    for kf, n in ((kfs[1], 30), (kfs[2], 12)):
        for i in range(n):
            mid = int(kfs[0].mp_ids[i])
            j = N_KP - 1 - i
            m.mappoints[mid].add_observation(kf.kid, j)
            kf.mp_ids[j] = mid
    for i in range(5):   # and kf2 has points of its own
        add_point(pkg, atlas, m, kfs[2], i, rng)
    log["change_index_0"] = m.change_index
    for kf in kfs:
        m.update_connections(kf)
    log["covisible"] = {kf.kid: dict(kf.covisible) for kf in kfs}
    log["order"] = {kf.kid: kf.best_covisible(10) for kf in kfs}
    log["over"] = {kf.kid: sorted(kf.covisible_over(15)) for kf in kfs}
    log["parents"] = {kf.kid: (kf.parent_id, sorted(kf.children)) for kf in kfs}
    log["tracked"] = [kfs[0].tracked_map_points(m.mappoints, k) for k in (1, 2, 3)]

    mids = kfs[0].mp_ids.copy()
    for mid in mids[:6]:
        m.refresh_mappoint(m.mappoints[int(mid)], 1.2, 4)
    log["predict_scale"] = [
        m.mappoints[int(mid)].predict_scale(d, 1.2, 4)
        for mid in mids[:8] for d in (0.0, 0.5, 2.0, 9.0, 100.0)
    ]
    log["found_ratio"] = [m.mappoints[int(mid)].found_ratio() for mid in mids[:4]]
    m.replace_mappoint(int(mids[0]), int(mids[1]))      # both seen by kf0 and kf1
    m.replace_mappoint(int(mids[35]), int(kfs[2].mp_ids[0]))  # disjoint observers
    m.replace_mappoint(int(mids[2]), int(mids[2]))      # no-op
    m.erase_mappoint(int(mids[3]))
    m.erase_mappoint(10_000)                            # unknown id: no-op
    released = m.release_mappoint(int(mids[4]))
    log["released"] = (released.mid, released.bad, released.row, released.position.copy())
    log["rows_for"] = m.rows_for(np.concatenate([mids, [-1, 10_000, 50_000]]))
    m.info_changed()
    log["change_index_1"] = m.change_index
    m.erase_keyframe(kfs[0].kid)     # the map's first keyframe is never erased
    m.erase_keyframe(kfs[1].kid)
    log["after_erase"] = (sorted(m.keyframes), m.n_mappoints(), kfs[1].bad,
                          {k: dict(kf.covisible) for k, kf in m.keyframes.items()})
    # reuse of freed rows, then growth past the first capacity
    extra = make_kf(pkg, atlas, rng, n=4200)
    m.add_keyframe(extra)
    for i in range(4200):
        add_point(pkg, atlas, m, extra, i, rng)
    log["cap"] = (m.store.cap, m.store.n_rows, len(m.store.free), len(m._mid2row))
    m.apply_scaled_rotation(kfs[1].R_cw, 1.7)
    log["change_index_2"] = m.change_index
    return atlas, log


def assert_equal_nested(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_equal_nested(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_nested(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def built():
    return build(jmap), build(tmap)


def test_operation_log_equal(built):
    (_, log_j), (_, log_t) = built
    assert_equal_nested(log_t, log_j)
    # the script did what it was written to do
    # kf2's 12 shared points are under min_weight, but a keyframe keeps its
    # best neighbour and writes the back-link
    assert log_t["covisible"][2] == {0: 12}
    assert log_t["covisible"][0] == {1: 30, 2: 12} and log_t["order"][0] == [1, 2]
    assert log_t["parents"][1][0] == 0 and log_t["parents"][0][0] is None
    assert log_t["change_index_1"] == log_t["change_index_0"] + 1
    assert log_t["change_index_2"] == log_t["change_index_1"] + 1
    assert log_t["cap"][0] == 8192 and (log_t["rows_for"][-3:] == -1).all()
    assert (log_t["rows_for"][[0, 3, 4, 35]] == -1).all() and log_t["rows_for"][1] >= 0
    assert len(set(log_t["predict_scale"])) > 1


def test_store_arrays_equal(built):
    (aj, _), (at, _) = built
    sj, st = aj.current.store, at.current.store
    assert (st.cap, st.n_rows, st.free) == (sj.cap, sj.n_rows, sj.free)
    for f in PointStore._FIELDS:
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f), err_msg=f)
    np.testing.assert_array_equal(at.current._mid2row, aj.current._mid2row)
    assert PointStore._FIELDS == JaxPointStore._FIELDS


def test_objects_equal(built):
    (aj, _), (at, _) = built
    mj, mt = aj.current, at.current
    assert sorted(mt.mappoints) == sorted(mj.mappoints)
    for mid, mp in mt.mappoints.items():
        other = mj.mappoints[mid]
        assert (mp.row, mp.bad, mp.ref_kf_id, mp.replaced_by, mp.observations) == (
            other.row, other.bad, other.ref_kf_id, other.replaced_by, other.observations)
        assert (mp.min_distance, mp.max_distance, mp.n_visible, mp.n_found) == (
            other.min_distance, other.max_distance, other.n_visible, other.n_found)
    assert sorted(mt.keyframes) == sorted(mj.keyframes)
    for kid, kf in mt.keyframes.items():
        other = mj.keyframes[kid]
        np.testing.assert_array_equal(kf.mp_ids, other.mp_ids)
        np.testing.assert_array_equal(kf.R_cw, other.R_cw)
        np.testing.assert_array_equal(kf.t_cw, other.t_cw)
        np.testing.assert_array_equal(kf.center, other.center)
        assert (kf.parent_id, kf.children, kf.covisible) == (
            other.parent_id, other.children, other.covisible)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_take_release_grow(pkg):
    store = pkg.map.PointStore(cap=4)
    rows = [store.take_row() for _ in range(4)]
    assert rows == [0, 1, 2, 3] and store.cap == 4
    store.alive[:] = True
    store.pos[2] = 7.0
    store.release_row(1)
    store.release_row(-1)        # out of range: ignored
    store.release_row(99)
    assert store.free == [1] and not store.alive[1]
    assert store.take_row() == 1 and store.free == []
    assert store.take_row() == 4 and store.cap == 8      # grown, contents kept
    assert (store.pos[2] == 7.0).all() and store.alive[:4].tolist() == [True, False, True, True]
    assert np.isinf(store.max_dist[4:]).all() and (store.mids[4:] == -1).all()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unbound_mappoint_keeps_its_fields(pkg):
    mp = pkg.MapPoint(3, [1.0, 2.0, 3.0], 0, 0)
    assert mp.desc_signed is None and mp.row == -1 and mp.max_distance == np.inf
    mp.position = [2.0, 2.0, 1.0]
    mp.add_observation(0, 5)
    mp.update_normal_and_depth({0: np.zeros(3)}, np.zeros(3), 2, 1.2, 8)
    np.testing.assert_allclose(mp.normal, np.asarray([2.0, 2.0, 1.0]) / 3.0)
    assert mp.max_distance == 3.0 * 1.2**2 and mp.min_distance == mp.max_distance / 1.2**7
    assert mp.predict_scale(3.5, 1.2, 8) == 2 and mp.predict_scale(1e-12, 1.2, 8) == 0
    assert mp.erase_observation(0) is True and mp.bad


@pytest.mark.parametrize("pkg", PACKAGES)
def test_clear_and_atlas(pkg):
    rng = np.random.default_rng(2)
    atlas = pkg.Atlas()
    m0 = atlas.current
    kf = make_kf(pkg, atlas, rng)
    m0.add_keyframe(kf)
    mids = [add_point(pkg, atlas, m0, kf, i, rng).mid for i in range(10)]
    before = m0.change_index
    m0.clear()
    assert m0.change_index == before + 1
    assert m0.n_keyframes() == m0.n_mappoints() == 0 and m0.store.alive.sum() == 0
    assert (m0.rows_for(np.asarray(mids)) == -1).all() and len(m0.store.free) == 10
    m1 = atlas.create_new_map()
    assert atlas.current is m1 and atlas.n_maps() == 2 and m1.map_id == 1
    assert m1.init_kf_id == 1 and atlas.next_kf_id() == 1 and atlas.next_mp_id() == 10
    atlas.change_map(m0)
    assert atlas.current is m0
    atlas.remove_map(m1)
    assert atlas.maps == [m0]
    assert atlas.add_camera("cam") == "cam" and atlas.add_camera("cam") and atlas.cameras == ["cam"]


# ------------------------------------------- the store's version (ROADMAP P3)
def _versioned_map():
    """A port map of two keyframes and 12 points; kf1 sees the first 6."""
    rng = np.random.default_rng(4)
    atlas = tmap.Atlas()
    m = atlas.current
    kfs = [make_kf(tmap, atlas, rng) for _ in range(2)]
    for kf in kfs:
        m.add_keyframe(kf)
    for i in range(12):
        add_point(tmap, atlas, m, kfs[0], i, rng)
    for i in range(6):
        mid = int(kfs[0].mp_ids[i])
        m.mappoints[mid].add_observation(kfs[1].kid, i)
        kfs[1].mp_ids[i] = mid
    return atlas, m, kfs, rng


def _mid(kfs, i):
    return int(kfs[0].mp_ids[i])


def _write_back(atlas, m, kfs, rng):
    from fasttrack_tpu_torch import ba_assembly

    mids = [_mid(kfs, i) for i in range(4)]
    meta = ba_assembly.WindowMeta({kfs[0].kid: 0}, mids, np.zeros(1, bool),
                                  np.zeros((4, 1), bool))
    res = {"R": kfs[0].R_cw[None], "t": kfs[0].t_cw[None],
           "points": rng.normal(size=(4, 3)), "inlier_mask": np.ones((4, 1), bool)}
    ba_assembly.write_back(m, meta, res)


# name -> (what runs before the version is read, the write)
MAP_WRITERS = {
    "add_mappoint_new_row": (None, lambda a, m, k, r: add_point(tmap, a, m, k[1], 20, r)),
    "add_mappoint_reused_row": (
        lambda a, m, k, r: m.erase_mappoint(_mid(k, 7)),
        lambda a, m, k, r: add_point(tmap, a, m, k[1], 21, r)),
    "erase_mappoint": (None, lambda a, m, k, r: m.erase_mappoint(_mid(k, 8))),
    "replace_mappoint": (None, lambda a, m, k, r: m.replace_mappoint(_mid(k, 9), _mid(k, 10))),
    "refresh_mappoint": (None, lambda a, m, k, r: m.refresh_mappoint(
        m.mappoints[_mid(k, 0)], 1.2, 4)),
    "release_mappoint": (None, lambda a, m, k, r: m.release_mappoint(_mid(k, 11))),
    "clear": (None, lambda a, m, k, r: m.clear()),
    "apply_scaled_rotation": (None, lambda a, m, k, r: m.apply_scaled_rotation(np.eye(3), 1.5)),
    "bundle_adjustment_write_back": (None, _write_back),
    "position": (None, lambda a, m, k, r: setattr(m.mappoints[_mid(k, 1)], "position", r.normal(size=3))),
    "normal": (None, lambda a, m, k, r: setattr(m.mappoints[_mid(k, 1)], "normal", [0.0, 0.0, 1.0])),
    "desc_signed": (None, lambda a, m, k, r: setattr(
        m.mappoints[_mid(k, 1)], "desc_signed", -k[0].desc_signed[1])),
    "min_distance": (None, lambda a, m, k, r: setattr(m.mappoints[_mid(k, 1)], "min_distance", 0.5)),
    "max_distance": (None, lambda a, m, k, r: setattr(m.mappoints[_mid(k, 1)], "max_distance", 9.0)),
}


@pytest.mark.parametrize("name", sorted(MAP_WRITERS))
def test_every_write_to_a_mirrored_column_moves_the_store_version(name):
    atlas, m, kfs, rng = _versioned_map()
    prep, write = MAP_WRITERS[name]
    if prep is not None:
        prep(atlas, m, kfs, rng)
    n_rows, free = m.store.n_rows, list(m.store.free)
    before = m.store.version
    write(atlas, m, kfs, rng)
    assert m.store.version != before
    if name == "add_mappoint_reused_row":      # the case the old key missed
        assert free and m.store.n_rows == n_rows and m.change_index == 0


def test_the_counters_do_not_move_the_store_version():
    """The tracker bumps n_found and n_visible every frame; the mirror does
    not hold them, so they must not cost an upload."""
    atlas, m, kfs, rng = _versioned_map()
    before = m.store.version
    mp = m.mappoints[_mid(kfs, 2)]
    mp.n_found = mp.n_found + 3
    mp.n_visible += 5
    rows = m.rows_for(kfs[0].mp_ids)
    m.store.n_found[rows] += 1
    m.store.n_visible[rows] += 1
    m.update_connections(kfs[1])
    m.info_changed()
    assert m.store.version == before
    other = tmap.Atlas().current.store
    assert other.version != before             # versions are unique across stores
