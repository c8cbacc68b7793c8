"""The port's Atlas map merge against the JAX package's, on the CPU.

tests/test_gba_merge.py::test_merge_welds_two_maps's scene
(datasets.synthetic.two_map_scene, which chip_smoke.py's phase 20a builds
too): an old map of 8 keyframes over a 300-point cloud, then, after a
loss, a new map of 4 keyframes over the same places with their own points,
in a frame offset by a 0.15 rad yaw and (0.7, -0.4, 0.2). Both packages'
`LoopCloser` (a vocabulary of 64 words trained on the cloud's descriptors,
the default min_consistency of 3, the keyframe database wired into the
Atlas as System does it) take the old map's keyframes while it is current,
then the new map's, through `process_keyframe`, so the routing to
`_merge_maps` is what is tested; the JAX side runs its own native build.
With and without the global BA after the weld. Compared, and why the
bounds are what they are:

- per keyframe, the loop candidates and whether it merged; the merge
  keyframe, `n_maps_merged` (1), `n_loops_closed` (0) and `n_gba_runs`:
  equal;
- after the merge, the old map is current, the emptied new map has left
  the Atlas, every keyframe and point of the new map lives in the old one,
  and the keyframe database holds exactly the welded map's keyframes: the
  same in both packages;
- keyframe poses and map points within 1e-4, the bound of
  tests/test_torch_loop_closing.py (the Sim3 refinement in float32 in
  both packages; the BA windows in float32 in the JAX package, in float64
  in the port, ROADMAP P4);
- every welded camera centre within 0.15 m of its truth in the old frame
  (tests/test_gba_merge.py's bound), in both packages.

Also `Atlas.remove_map` of a map that still holds keyframes: they leave the
keyframe database, in both packages.
"""

import numpy as np
import pytest

from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu.bow.database import KeyFrameDatabase as JaxKeyFrameDatabase
from fasttrack_tpu.bow.vocabulary import train_vocabulary as jax_train_vocabulary
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.loop_closing import LoopCloser as JaxLoopCloser
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch.bow.database import KeyFrameDatabase
from fasttrack_tpu_torch.bow.vocabulary import train_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets.synthetic import LOOP_FX, LOOP_H, LOOP_W, two_map_scene
from fasttrack_tpu_torch.loop_closing import LoopCloser
from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_system import one_torch_thread

ATOL = 1e-4
TRUTH_M = 0.15


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


def merge_run(torch_side, run_gba):
    atlas, m_old, m_new, kfs_a, kfs_b, descs = two_map_scene(tmap if torch_side else jmap)
    corpus = np.concatenate([descs, descs])
    K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])
    if torch_side:
        cam = make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device="cpu")
        voc = train_vocabulary(corpus, n_words=64, iters=2, device="cpu")
        lc = LoopCloser(atlas, voc, K, camera=cam, bf=1.0, run_gba=run_gba, device="cpu")
    else:
        cam = jax_make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H)
        voc = jax_train_vocabulary(corpus, n_words=64, iters=2)
        lc = JaxLoopCloser(atlas, voc, np.asarray(cam.K()), camera=cam, bf=1.0, run_gba=run_gba)
    atlas.set_kf_database(lc.db)
    cands, merged = [], []
    detect = lc.db.detect_loop_candidates

    def detect_loop_candidates(*a, **kw):
        cands.append(detect(*a, **kw))
        return cands[-1]

    lc.db.detect_loop_candidates = detect_loop_candidates
    # the old map's keyframes while it is the active map, then the new map's
    atlas.change_map(m_old)
    for kf in kfs_a:
        merged.append(lc.process_keyframe(kf.kid))
    atlas.change_map(m_new)
    for kf in kfs_b:
        merged.append(lc.process_keyframe(kf.kid))
    m = atlas.current
    return dict(
        lc=lc, atlas=atlas, m_old=m_old, m_new=m_new, kfs_a=kfs_a, kfs_b=kfs_b,
        cands=cands, merged=merged,
        poses={k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in m.keyframes.items()},
        points={k: p.position.copy() for k, p in m.mappoints.items() if not p.bad},
    )


@pytest.fixture(scope="module", params=[False, True], ids=["graph", "gba"])
def runs(request):
    with one_torch_thread():
        return {"torch": merge_run(True, request.param), "jax": merge_run(False, request.param),
                "run_gba": request.param}


def test_the_merge_keyframe_equals_jax(runs):
    t, j = runs["torch"], runs["jax"]
    assert t["cands"] == j["cands"] and len(t["cands"]) == 12
    assert t["merged"] == j["merged"] and sum(t["merged"]) == 1
    lt, lj = t["lc"], j["lc"]
    assert lt.n_maps_merged == lj.n_maps_merged == 1
    assert lt.n_loops_closed == lj.n_loops_closed == 0
    assert lt.n_gba_runs == lj.n_gba_runs == int(runs["run_gba"])


def test_the_atlas_after_the_merge_equals_jax(runs):
    for r in (runs["torch"], runs["jax"]):
        atlas, m_old, m_new = r["atlas"], r["m_old"], r["m_new"]
        assert atlas.current is m_old and m_new not in atlas.maps and atlas.n_maps() == 1
        assert not m_new.keyframes and not m_new.mappoints
        assert all(kf.kid in m_old.keyframes for kf in r["kfs_a"] + r["kfs_b"])
        # the database holds the welded map's keyframes, none of a removed map
        assert sorted(r["lc"].db.kf_bows) == sorted(m_old.keyframes)
    t, j = runs["torch"], runs["jax"]
    assert sorted(t["poses"]) == sorted(j["poses"]) and len(t["poses"]) == 12
    assert sorted(t["points"]) == sorted(j["points"])


def test_welded_poses_and_points_equal_jax(runs):
    t, j = runs["torch"], runs["jax"]
    for k, (R, tt) in t["poses"].items():
        np.testing.assert_allclose(R, j["poses"][k][0], atol=ATOL, err_msg=f"keyframe {k}")
        np.testing.assert_allclose(tt, j["poses"][k][1], atol=ATOL, err_msg=f"keyframe {k}")
    for k, p in t["points"].items():
        np.testing.assert_allclose(p, j["points"][k], atol=ATOL, err_msg=f"point {k}")


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_welded_centres_near_the_truth(runs, package):
    """The new map's keyframes truly sit at x = 0.8 + 0.4 k in the old frame."""
    for k, kf in enumerate(runs[package]["kfs_b"]):
        c_true = np.array([0.8 + 0.4 * k, 0.0, 0.0])
        assert np.linalg.norm(kf.center - c_true) < TRUTH_M, (k, kf.center)


@pytest.mark.parametrize("torch_side", [True, False], ids=["torch", "jax"])
def test_removing_a_map_erases_its_keyframes_from_the_database(torch_side):
    atlas, m_old, m_new, kfs_a, kfs_b, _ = two_map_scene(tmap if torch_side else jmap)
    db = KeyFrameDatabase() if torch_side else JaxKeyFrameDatabase()
    atlas.set_kf_database(db)
    for kf in kfs_a + kfs_b:
        db.add(kf.kid, {kf.kid % 7: 1.0})
    atlas.remove_map(m_new)
    assert sorted(db.kf_bows) == [kf.kid for kf in kfs_a]
    assert all(kf.kid not in ids for kf in kfs_b for ids in db.inverted.values())
