"""The port's local mapper against the JAX package's, on the CPU.

The same inputs, made from a NumPy seed, go through both packages (the port
with device="cpu"; the JAX side as its own tests run it on the CPU, with the
C++ library's Hamming matrix replaced by the same integers from NumPy so that
no test depends on the library being built). Tolerances and why:

- `epipolar_match`, `epipolar_match_tri_batch`: indices and keep masks equal
  (integer Hamming distances, one tie order on both sides); triangulated
  points of kept rows within 1e-3 relative (two f32 SVDs);
- `search_by_projection_exact` against `host_search_by_projection`: integer
  for integer, the first column on ties, rows with an empty window included;
- `fuse_mappoints_into`, `assemble_window`, `write_back` on two maps built
  from the same arrays: exactly equal (host code on the same integers and
  float64 values);
- `LocalMapper.process_keyframe`, keyframe by keyframe over one rendered
  sequence behind each package's tracker: the same number of points culled,
  triangulated and fused at every keyframe, keyframe poses within 1e-3 (f32
  bundle adjustment, analytic against forward-mode Jacobians);
- the device mirror of the point store: on every fused frame, the rows the
  frame uses hold on the device what the host's store holds.
"""

import contextlib
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu import ba_assembly as jassembly
from fasttrack_tpu import local_mapping as jmapping
from fasttrack_tpu import native as jnative
from fasttrack_tpu import slam_map as jmap
from fasttrack_tpu import tracking as jtracking
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.geometry import SE3 as JaxSE3
from fasttrack_tpu.ops import host_kernels as jhost
from fasttrack_tpu.ops import project_match as jpm
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.optim.local_ba import BAResult as JaxBAResult
from fasttrack_tpu_torch import ba_assembly as tassembly
from fasttrack_tpu_torch import local_mapping as tmapping
from fasttrack_tpu_torch import slam_map as tmap
from fasttrack_tpu_torch import tracking as ttracking
from fasttrack_tpu_torch.bow.vocabulary import make_random_vocabulary
from fasttrack_tpu_torch.cameras import make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.loop_closing import LoopCloser
from fasttrack_tpu_torch.ops import host_kernels as thost
from fasttrack_tpu_torch.ops import project_match as tpm
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.parallel import make_mesh

FX, FY, CX, CY, W, H = 256.0, 256.0, 160.0, 120.0, 320, 240
SCALE, N_LEVELS = 1.2, 4
INV_SIGMA2 = 1.0 / (SCALE ** (2 * np.arange(N_LEVELS)))


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def numpy_hamming_matrix_packed(a, b):
    bits_a = np.unpackbits(np.ascontiguousarray(a, np.uint8), axis=1).astype(np.int32)
    bits_b = np.unpackbits(np.ascontiguousarray(b, np.uint8), axis=1).astype(np.int32)
    return (bits_a @ (1 - bits_b).T + (1 - bits_a) @ bits_b.T).astype(np.int32)


@pytest.fixture(autouse=True)
def hamming_from_numpy(monkeypatch):
    """The JAX package's host search takes its Hamming matrix from the C++
    library; the same integers from NumPy stand in for it here."""
    monkeypatch.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)


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


def cams():
    return (jax_make_pinhole(FX, FY, CX, CY, W, H),
            make_pinhole(FX, FY, CX, CY, W, H, device="cpu"))


def _bits(rng, n):
    return rng.integers(0, 2, (n, 256)).astype(np.uint8)


def _flip(rng, bits, n_flip):
    out = bits.copy()
    for row in out:
        row[rng.choice(256, n_flip, replace=False)] ^= 1
    return out


def _signed(bits):
    return (2 * bits.astype(np.int8) - 1)


def _packed(bits):
    return np.packbits(bits, axis=1, bitorder="little")


def _rotation(rng, angle):
    w = rng.normal(size=3)
    w *= angle / np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    return np.eye(3) + np.sin(th) / th * Kx + (1 - np.cos(th)) / th**2 * Kx @ Kx


def _project(R, t, X):
    Xc = X @ R.T + t
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], 1), Xc[:, 2]


# --------------------------------------------------------- epipolar matching
def epipolar_case(rng, B=3, C=256, n_feat=220):
    """B neighbour keyframes and one current keyframe looking at the same
    n_feat points; arrays padded to C rows as the mapper pads them."""
    X = np.stack([rng.uniform(-2.5, 2.5, n_feat), rng.uniform(-1.8, 1.8, n_feat),
                  rng.uniform(3, 8, n_feat)], 1)
    bits = _bits(rng, n_feat)
    Kmat = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    Kinv = np.linalg.inv(Kmat)
    R2, t2 = _rotation(rng, 0.03), np.array([0.3, 0.02, 0.0])
    uv2, _ = _project(R2, t2, X)
    perm2 = rng.permutation(n_feat)            # keypoint order differs per view
    u2 = np.zeros(C, np.float32)
    v2 = np.zeros(C, np.float32)
    d2 = np.zeros((C, 256), np.int8)
    f2 = np.zeros(C, bool)
    var2 = np.ones(C, np.float32)
    u2[:n_feat], v2[:n_feat] = (uv2[perm2] + rng.normal(0, 0.3, (n_feat, 2))).T
    d2[:n_feat] = _signed(_flip(rng, bits[perm2], 8))
    f2[:n_feat] = rng.random(n_feat) < 0.8
    var2[:n_feat] = (1.0 / INV_SIGMA2)[rng.integers(0, N_LEVELS, n_feat)]
    u1 = np.zeros((B, C), np.float32)
    v1 = np.zeros((B, C), np.float32)
    d1 = np.zeros((B, C, 256), np.int8)
    f1 = np.zeros((B, C), bool)
    F12 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    R21 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    t21 = np.zeros((B, 3), np.float32)
    for b in range(B - 1):                      # the last slot stays empty padding
        R1, t1 = _rotation(rng, 0.03), np.array([-0.3 * (b + 1), 0.03 * b, 0.02])
        uv1, _ = _project(R1, t1, X)
        perm1 = rng.permutation(n_feat)
        u1[b, :n_feat], v1[b, :n_feat] = (uv1[perm1] + rng.normal(0, 0.3, (n_feat, 2))).T
        d1[b, :n_feat] = _signed(_flip(rng, bits[perm1], 8))
        # two rows share one descriptor and one place: they choose one column
        d1[b, 1], u1[b, 1], v1[b, 1] = d1[b, 0], u1[b, 0], v1[b, 0]
        f1[b, :n_feat] = rng.random(n_feat) < 0.8
        f1[b, :2] = True
        R = R2 @ R1.T
        t = t2 - R @ t1
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        F12[b] = Kinv.T @ (tx @ R) @ Kinv
        R21[b], t21[b] = R, t
    return (u1, v1, d1, f1, u2, v2, d2, f2, F12, var2, R21, t21)


def test_epipolar_match_tri_batch_equals_jax(rng):
    args = epipolar_case(rng)
    scal = (FX, FY, CX, CY)
    idx_j, keep_j, X_j = jpm.epipolar_match_tri_batch(
        *(J(a) for a in args), *(jnp.float32(s) for s in scal))
    idx_t, keep_t, X_t = tpm.epipolar_match_tri_batch(*(T(a) for a in args), *scal)
    keep = np.asarray(keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep)
    np.testing.assert_array_equal(idx_t.numpy()[keep], np.asarray(idx_j)[keep])
    assert idx_t.shape == (3, 256) and X_t.shape == (3, 256, 3)
    assert keep[:2].sum() > 150 and not keep[2].any()     # the empty slot keeps nothing
    # the two rows that share a column: the first keeps it
    assert keep[0, 0] and not keep[0, 1]
    want, got = np.asarray(X_j)[keep], X_t.numpy()[keep]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    assert (got[:, 2] > 1.0).mean() > 0.95                # in front of the neighbour


def test_epipolar_match_equals_jax_and_the_batch(rng):
    u1, v1, d1, f1, u2, v2, d2, f2, F12, var2, R21, t21 = epipolar_case(rng)
    idx_j, keep_j = jpm.epipolar_match(J(u1[0]), J(v1[0]), J(d1[0]), J(f1[0]), J(u2), J(v2),
                                       J(d2), J(f2), J(F12[0]), J(var2))
    idx_t, keep_t = tpm.epipolar_match(T(u1[0]), T(v1[0]), T(d1[0]), T(f1[0]), T(u2), T(v2),
                                       T(d2), T(f2), T(F12[0]), T(var2))
    keep = np.asarray(keep_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep)
    np.testing.assert_array_equal(idx_t.numpy()[keep], np.asarray(idx_j)[keep])
    idx_b, keep_b, _ = tpm.epipolar_match_tri_batch(
        *(T(a) for a in (u1, v1, d1, f1, u2, v2, d2, f2, F12, var2, R21, t21)), FX, FY, CX, CY)
    np.testing.assert_array_equal(keep_b[0].numpy(), keep)
    np.testing.assert_array_equal(idx_b[0].numpy()[keep], idx_t.numpy()[keep])
    # only free rows match only free columns
    assert f1[0][keep].all() and f2[idx_t.numpy()[keep]].all()


# ------------------------------------------------------------ the exact search
def test_search_by_projection_exact_equals_the_host_search(rng):
    n, m = 300, 450
    kp_bits = _bits(rng, n)
    kp_bits[7] = kp_bits[3]                      # two equal keypoints, side by side
    kp_uv = rng.uniform(0, W, (n, 2)).astype(np.float32)
    kp_uv[7] = kp_uv[3]
    kp_level = rng.integers(0, N_LEVELS, n).astype(np.int32)
    kp_level[7] = kp_level[3]
    kp_valid = rng.random(n) > 0.1
    kp_valid[[3, 7]] = True
    pick = rng.integers(0, n, m)
    pick[:5] = 7                                 # these tie between columns 3 and 7
    q_bits = _flip(rng, kp_bits[pick], 12)
    q_uv = (kp_uv[pick] + rng.normal(0, 2, (m, 2))).astype(np.float32)
    q_uv[:5] = kp_uv[7]
    lvl = kp_level[pick]
    q_radius = (3.0 * SCALE ** lvl).astype(np.float32)
    q_lmin = np.maximum(lvl - 1, 0).astype(np.int32)
    q_lmax = np.minimum(lvl + 1, N_LEVELS - 1).astype(np.int32)
    q_valid = rng.random(m) > 0.15
    q_valid[:5] = True
    q_uv[5:15] += 500.0                          # nothing in their window
    for max_dist in (50, 100):
        idx_j, dist_j, ok_j = jhost.host_search_by_projection(
            q_uv, _packed(q_bits), q_radius, q_lmin, q_lmax, q_valid,
            kp_uv, _packed(kp_bits), kp_level, kp_valid, max_dist=max_dist)
        idx_t, dist_t, ok_t = thost.search_by_projection_exact(
            T(q_uv), T(_signed(q_bits)), T(q_radius), T(q_lmin), T(q_lmax), T(q_valid),
            T(kp_uv), T(_signed(kp_bits)), T(kp_level), T(kp_valid), max_dist=max_dist)
        np.testing.assert_array_equal(ok_t.numpy(), ok_j)
        np.testing.assert_array_equal(dist_t.numpy(), dist_j)
        np.testing.assert_array_equal(idx_t.numpy(), idx_j)
        assert dist_t.dtype == torch.int32
    assert ok_j[:5].all() and (idx_j[:5] == 3).all()       # the first of two equal columns
    assert not ok_j[5:15].any() and (dist_j[5:15] == 1 << 20).all()
    assert 200 < ok_j.sum() < m


# ------------------------------------------------ two maps from the same arrays
def build_scene(pkg, seed=0, n_feat=260):
    """Three keyframes over one slab of points, built with `pkg`'s map types.
    kf0 owns a point for every feature it sees. kf1 sees the same features:
    a third of its keypoints carry duplicate points of their own (some seen
    by kf2 as well, so either side of a merge can be the better observed), a
    third are unbound, the rest carry kf0's points already. Returns
    (atlas, [kf0, kf1, kf2])."""
    rng = np.random.default_rng(seed)
    atlas = pkg.Atlas()
    m = atlas.current
    X = np.stack([rng.uniform(-2.2, 2.2, n_feat), rng.uniform(-1.6, 1.6, n_feat),
                  rng.uniform(3, 6, n_feat)], 1)
    bits = _bits(rng, n_feat)
    level = rng.integers(0, N_LEVELS, n_feat).astype(np.int32)
    kfs = []
    for k in range(3):
        R, t = _rotation(rng, 0.02), np.array([0.12 * k, 0.01 * k, 0.0])
        uv, z = _project(R, t, X)
        uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
        kbits = _flip(rng, bits, 6)
        if k == 1:                     # a keypoint twice: equal place, equal bits
            uv[11], kbits[11], level[11] = uv[10], kbits[10], level[10]
        kid = atlas.next_kf_id()
        kf = pkg.KeyFrame(
            kid, 5 * kid, 0.25 * kid, R, t, uv, level.copy(),
            rng.uniform(0, 6, n_feat).astype(np.float32), _packed(kbits), _signed(kbits),
            (uv[:, 0] - FX * 0.11 / z).astype(np.float32), z.astype(np.float32),
            rng.random(n_feat) > 0.03,
        )
        m.add_keyframe(kf)
        kfs.append(kf)

    def new_point(kf, i, others=()):
        mp = pkg.MapPoint(atlas.next_mp_id(), X[i] + rng.normal(0, 0.01, 3), kf.kid, kf.kid)
        mp.add_observation(kf.kid, i)
        mp.desc_packed = kf.desc_packed[i]
        mp.desc_signed = kf.desc_signed[i]
        kf.mp_ids[i] = mp.mid
        for o in others:
            mp.add_observation(o.kid, i)
            o.mp_ids[i] = mp.mid
        m.add_mappoint(mp)
        centers = {k.kid: k.center for k in (kf, *others)}
        mp.update_normal_and_depth(centers, kf.center, int(kf.kp_level[i]), SCALE, N_LEVELS)
        return mp

    kf0, kf1, kf2 = kfs
    for i in range(n_feat):
        if not kf0.valid[i]:
            continue
        kind = i % 6
        if kind in (0, 1):             # kf1 has a duplicate point of its own
            new_point(kf0, i, others=(kf2,) if kind == 0 else ())
            if kf1.valid[i]:
                new_point(kf1, i, others=() if kind == 0 else (kf2,))
        elif kind in (2, 3):           # kf1's keypoint is unbound
            new_point(kf0, i)
        else:                          # kf1 already observes kf0's point
            new_point(kf0, i, others=(kf1,))
    for kf in kfs:
        m.update_connections(kf)
    return atlas, kfs


def map_state(m):
    return {
        "kf_mp_ids": {kid: kf.mp_ids.copy() for kid, kf in m.keyframes.items()},
        "points": {mid: (dict(mp.observations), mp.position.copy(), mp.n_visible, mp.n_found,
                         mp.bad, mp.ref_kf_id)
                   for mid, mp in m.mappoints.items()},
        "rows": {mid: mp.row for mid, mp in m.mappoints.items()},
        "change_index": m.change_index,
    }


def assert_states_equal(a, b):
    assert a["kf_mp_ids"].keys() == b["kf_mp_ids"].keys()
    for kid in a["kf_mp_ids"]:
        np.testing.assert_array_equal(a["kf_mp_ids"][kid], b["kf_mp_ids"][kid])
    assert a["points"].keys() == b["points"].keys()
    for mid, (obs, pos, nv, nf, bad, ref) in a["points"].items():
        obs_b, pos_b, nv_b, nf_b, bad_b, ref_b = b["points"][mid]
        assert obs == obs_b and (nv, nf, bad, ref) == (nv_b, nf_b, bad_b, ref_b), mid
        np.testing.assert_array_equal(pos, pos_b)
    assert a["rows"] == b["rows"] and a["change_index"] == b["change_index"]


def test_fuse_mappoints_into_equals_jax():
    jcam, tcam = cams()
    ja, jk = build_scene(jmap)
    ta, tk = build_scene(tmap)
    assert_states_equal(map_state(ja.current), map_state(ta.current))
    before = map_state(ta.current)
    totals = []
    # forward into kf1 (duplicates merge, unbound keypoints gain an
    # observation), then back into kf0, then into kf2
    for src, dst in ((0, 1), (1, 0), (0, 2)):
        mids_j = [int(x) for x in jk[src].mp_ids if x >= 0]
        mids_t = [int(x) for x in tk[src].mp_ids if x >= 0]
        assert mids_j == mids_t
        n_j = jmapping.fuse_mappoints_into(ja.current, jk[dst], mids_j, jcam, SCALE, N_LEVELS)
        n_t = tmapping.fuse_mappoints_into(ta.current, tk[dst], mids_t, tcam, SCALE, N_LEVELS,
                                           device="cpu")
        assert n_t == n_j
        totals.append(n_t)
        assert_states_equal(map_state(ja.current), map_state(ta.current))
    after = map_state(ta.current)
    assert totals[0] > 100
    assert len(after["points"]) < len(before["points"])            # duplicates were replaced
    gained = (after["kf_mp_ids"][1] >= 0).sum() - (before["kf_mp_ids"][1] >= 0).sum()
    assert gained > 30                                             # unbound keypoints were bound
    # the doubled keypoint: the point goes to the first of the two
    assert after["kf_mp_ids"][1][10] >= 0


def test_fuse_takes_a_host_camera_and_returns_early(rng):
    from fasttrack_tpu_torch.cameras import host_camera
    from fasttrack_tpu_torch.ops import hamming_kernel

    _, tcam = cams()
    ta, tk = build_scene(tmap)
    m = ta.current
    assert tmapping.fuse_mappoints_into(m, tk[1], [], tcam, SCALE, N_LEVELS, device="cpu") == 0
    # points already seen by the target are no candidates
    seen = [int(x) for x in tk[1].mp_ids if x >= 0]
    assert tmapping.fuse_mappoints_into(m, tk[1], seen, tcam, SCALE, N_LEVELS, device="cpu") == 0
    mids = [int(x) for x in tk[0].mp_ids if x >= 0]
    n = tmapping.fuse_mappoints_into(m, tk[1], mids, host_camera(tcam), SCALE, N_LEVELS,
                                     device="cpu")
    assert n > 100
    assert hamming_kernel.hamming_penalty_matrix.launches == 0     # a CPU tensor: plain version


def test_assemble_window_equals_jax():
    ja, jk = build_scene(jmap, seed=2)
    ta, tk = build_scene(tmap, seed=2)
    for local, fixed, mp_ids in (([1, 2], [0], None), ([0, 1, 2], [], None), ([2], [0, 1], "kf2")):
        if mp_ids == "kf2":
            mp_ids = [int(x) for x in tk[2].mp_ids if x >= 0][:50]
        prob_j, meta_j, drop_j = jassembly.assemble_window(
            ja.current, local, fixed, INV_SIGMA2, 4, 192, mp_ids)
        arrays, meta_t, drop_t = tassembly.assemble_window_arrays(
            ta.current, local, fixed, INV_SIGMA2, 4, 192, mp_ids)
        assert drop_t == drop_j and (mp_ids is not None or drop_t > 0)
        assert meta_t.kf_index == meta_j.kf_index and meta_t.mp_ids == meta_j.mp_ids
        np.testing.assert_array_equal(meta_t.cam_free, meta_j.cam_free)
        np.testing.assert_array_equal(meta_t.mask, meta_j.mask)
        want = {"R": prob_j.poses.R, "t": prob_j.poses.t, "points": prob_j.points,
                "obs_uv": prob_j.obs_uv, "obs_ur": prob_j.obs_ur,
                "inv_sigma2": prob_j.inv_sigma2, "mask": prob_j.mask,
                "cam_free": prob_j.cam_free, "point_free": prob_j.point_free}
        assert sorted(arrays) == sorted(want)
        for name, w in want.items():
            np.testing.assert_array_equal(arrays[name], np.asarray(w), err_msg=name)
        prob_t, meta_u, _ = tassembly.assemble_window(
            ta.current, local, fixed, INV_SIGMA2, 4, 192, mp_ids, device="cpu")
        np.testing.assert_array_equal(prob_t.obs_uv.numpy(), arrays["obs_uv"])
        assert prob_t.mask.dtype == torch.bool and meta_u.mp_ids == meta_t.mp_ids
    # with no fixed frontier the oldest keyframe is pinned
    assert not arrays["cam_free"][1:].any() and arrays["cam_free"][0]


def test_write_back_equals_jax(rng):
    from fasttrack_tpu_torch.geometry import SE3
    from fasttrack_tpu_torch.optim.local_ba import BAResult

    ja, _ = build_scene(jmap, seed=4)
    ta, _ = build_scene(tmap, seed=4)
    _, meta_j, _ = jassembly.assemble_window(ja.current, [1, 2], [0], INV_SIGMA2, 4, 256)
    arrays, meta_t, _ = tassembly.assemble_window_arrays(ta.current, [1, 2], [0], INV_SIGMA2, 4, 256)
    # a made-up solution: poses slightly off a rotation, points moved, one
    # point and one pose not finite, a fifth of the observations outliers
    R = arrays["R"] + rng.normal(0, 1e-4, arrays["R"].shape).astype(np.float32)
    t = arrays["t"] + rng.normal(0, 1e-2, arrays["t"].shape).astype(np.float32)
    pts = arrays["points"] + rng.normal(0, 1e-2, arrays["points"].shape).astype(np.float32)
    pts[3] = np.nan
    t[2] = np.inf
    inl = arrays["mask"] & (rng.random(arrays["mask"].shape) > 0.2)
    chi2 = np.zeros(inl.shape, np.float32)
    n_before = ta.current.n_mappoints()
    for drop in (True, False):
        jassembly.write_back(ja.current, meta_j,
                             JaxBAResult(JaxSE3(J(R), J(t)), J(pts), J(inl), J(chi2)), drop)
        tassembly.write_back(ta.current, meta_t,
                             BAResult(SE3(T(R), T(t)), T(pts), T(inl), T(chi2)), drop)
        sj, st = map_state(ja.current), map_state(ta.current)
        assert_states_equal(sj, st)
        for kid, kf in ta.current.keyframes.items():
            np.testing.assert_array_equal(kf.R_cw, ja.current.keyframes[kid].R_cw)
            np.testing.assert_array_equal(kf.t_cw, ja.current.keyframes[kid].t_cw)
            np.testing.assert_allclose(kf.R_cw @ kf.R_cw.T, np.eye(3), atol=1e-12)
    assert ta.current.change_index == 2
    assert len(st["points"]) < n_before                    # outliers erased points
    assert np.isfinite(ta.current.keyframes[2].t_cw).all()  # the diverged pose was not written


# ------------------------------------------- the mapper behind each tracker
N_FEATURES = 512
# 50 frames with a keyframe at least every 16: four keyframes, two bundle
# adjustments. The adjustment's LM loop accepts or rejects whole steps; in
# float32, as the JAX package solves, rounding noise in the update of points
# seen once can decide a step on a window of few, close keyframes, and the
# JAX run then parts by centimetres from any other run of the same window.
# On this sequence no step of the JAX run lies there: the keyframe poses of
# the two packages agree to about 1e-5.
N_FRAMES = 50
KF_EVERY = 16


class Recorder:
    """Per keyframe, what the mapper's steps did (either package's mapper:
    the counts come from the map, not from the steps' return values)."""

    def __init__(self, mapper):
        self.rows = []
        self.mapper = mapper
        inner = mapper.process_keyframe

        def process(kf):
            m = mapper.atlas.current
            row = {"kid": kf.kid, "frame_id": kf.frame_id}
            for name in ("_cull_recent_mappoints", "_create_new_mappoints", "_search_in_neighbors",
                         "_local_ba", "_cull_keyframes"):
                self._wrap(name, row, m)
            inner(kf)
            row["pose"] = (kf.R_cw.copy(), kf.t_cw.copy())
            self.rows.append(row)

        mapper.process_keyframe = process

    def _wrap(self, name, row, m):
        fn = getattr(type(self.mapper), name)

        def wrapped(*args, **kwargs):
            before = (m.n_mappoints(), m.n_keyframes())
            out = fn(self.mapper, *args, **kwargs)
            row[name] = (before[0] - m.n_mappoints(), before[1] - m.n_keyframes(), out)
            return out

        setattr(self.mapper, name, wrapped)


@pytest.fixture(scope="module")
def mapped():
    """Both packages' tracker + inline mapper over one rendered sequence, a
    keyframe at least every KF_EVERY frames. The port's fused frames are watched:
    `stale` collects every store row a frame used whose device copy differs
    from the host's store."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "hamming_matrix_packed", numpy_hamming_matrix_packed)
    seq = synthetic.generate_sequence(n_frames=N_FRAMES, h=H, w=W, seed=3)
    bf = seq.fx * seq.baseline
    jcam = jax_make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H)
    tcam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
    jatlas, tatlas = jmap.Atlas(), tmap.Atlas()
    jm = jmapping.LocalMapper(jatlas, jcam, bf, SCALE, N_LEVELS)
    tm = tmapping.LocalMapper(tatlas, tcam, bf, SCALE, N_LEVELS, device="cpu")
    jt = jtracking.Tracker(jcam, JaxOrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS),
                           bf, jatlas, local_mapper=jm, max_frames_between_kf=KF_EVERY)
    tt = ttracking.Tracker(tcam, OrbConfig(H, W, n_features=N_FEATURES, n_levels=N_LEVELS),
                           bf, tatlas, local_mapper=tm, max_frames_between_kf=KF_EVERY, device="cpu")
    jm.tracker, tm.tracker = jt, tt
    jrec, trec = Recorder(jm), Recorder(tm)

    stale, fused_frames = [], []
    inner_twm, inner_tlm = ttracking.twm_step, ttracking.tlm_step

    def check_rows(rows, ok, pos_d, desc_d):
        st = tatlas.current.store
        rows = rows.numpy()[ok.numpy()]
        if not st.alive[rows].all():
            stale.append(("dead row", tt.frame_id))
        if not np.array_equal(pos_d.numpy()[rows], st.pos[rows].astype(np.float32)) \
                or not np.array_equal(desc_d.numpy()[rows], st.desc_signed[rows]):
            stale.append(("stale row", tt.frame_id))

    def twm_watched(kps, u_right, cfg, bf_d, cam, T0, q7, q_rows, pos_d, desc_d):
        fused_frames.append(tt.frame_id)
        check_rows(q_rows, q7[5] > 0.5, pos_d, desc_d)
        return inner_twm(kps, u_right, cfg, bf_d, cam, T0, q7, q_rows, pos_d, desc_d)

    def tlm_watched(kps, u_right, cfg, bf_d, cam, twm, cand_rows, cand_ok, pos_d, desc_d, *rest):
        check_rows(cand_rows, cand_ok, pos_d, desc_d)
        return inner_tlm(kps, u_right, cfg, bf_d, cam, twm, cand_rows, cand_ok, pos_d, desc_d,
                         *rest)

    mp.setattr(ttracking, "twm_step", twm_watched)
    mp.setattr(ttracking, "tlm_step", tlm_watched)
    with one_torch_thread():
        for f in seq.frames:
            jt.track_stereo(f.left, f.right, f.timestamp)
            tt.track_stereo(f.left, f.right, f.timestamp)
    mp.undo()
    return dict(seq=seq, jt=jt, tt=tt, jm=jm, tm=tm, jrec=jrec, trec=trec, stale=stale,
                fused_frames=fused_frames)


def test_process_keyframe_counts_equal_jax(mapped):
    jrows, trows = mapped["jrec"].rows, mapped["trec"].rows
    assert [r["kid"] for r in trows] == [r["kid"] for r in jrows]
    assert [r["frame_id"] for r in trows] == [r["frame_id"] for r in jrows]
    assert len(trows) == 4
    for jr, tr in zip(jrows, trows):
        for name in ("_cull_recent_mappoints", "_create_new_mappoints", "_search_in_neighbors",
                     "_local_ba", "_cull_keyframes"):
            assert (name in tr) == (name in jr), (tr["kid"], name)
            if name in tr:
                # (map points gone, keyframes gone) during the step
                assert tr[name][:2] == jr[name][:2], (tr["kid"], name)
        # points triangulated and fused, as the steps report them
        assert tr["_create_new_mappoints"][2] == jr["_create_new_mappoints"][2]
        assert tr["_search_in_neighbors"][2] == jr["_search_in_neighbors"][2]
    assert sum(r["_create_new_mappoints"][2] for r in trows) > 0
    assert sum(r["_search_in_neighbors"][2] for r in trows) > 0
    assert sum("_local_ba" in r for r in trows) >= 2
    # the first two keyframes are not adjusted (Optimizer needs > 2)
    assert "_local_ba" not in trows[0] and "_local_ba" not in trows[1]


def test_process_keyframe_poses_equal_jax(mapped):
    for jr, tr in zip(mapped["jrec"].rows, mapped["trec"].rows):
        np.testing.assert_allclose(tr["pose"][0], jr["pose"][0], atol=1e-3)
        np.testing.assert_allclose(tr["pose"][1], jr["pose"][1], atol=1e-3)
    mj, mt = mapped["jt"].atlas.current, mapped["tt"].atlas.current
    assert sorted(mt.keyframes) == sorted(mj.keyframes)
    for kid, kf in mt.keyframes.items():
        np.testing.assert_allclose(kf.R_cw, mj.keyframes[kid].R_cw, atol=1e-3)
        np.testing.assert_allclose(kf.t_cw, mj.keyframes[kid].t_cw, atol=1e-3)
    assert abs(mt.n_mappoints() - mj.n_mappoints()) <= 0.02 * mj.n_mappoints()


def test_mapper_stats_agree_with_the_map(mapped):
    s = mapped["tm"].stats.series
    rows = mapped["trec"].rows
    assert sum(s["lm_keyframes"]) == len(rows)
    assert sum(s["lm_points_triangulated"]) == sum(r["_create_new_mappoints"][2] for r in rows)
    assert sum(s["lm_points_fused"]) == sum(r["_search_in_neighbors"][2] for r in rows)
    assert sum(s["lm_points_culled"]) == sum(r["_cull_recent_mappoints"][0] for r in rows)
    assert sum(s["lm_local_bas"]) == sum("_local_ba" in r for r in rows)
    # one fetch per triangulation pass, per fusion search and per adjustment
    assert sum(s["lm_device_fetches"]) == (
        sum(s["lm_triangulation_passes"]) + sum(s["lm_fuse_searches"]) + sum(s["lm_local_bas"]))
    for name in ("lm_cull_points", "lm_triangulate", "lm_fuse", "lm_total"):
        assert len(s[name]) == len(rows)


def test_no_fused_frame_reads_a_freed_or_reused_store_row(mapped):
    """The device mirror of the point store is uploaded when the store's
    version changes (ROADMAP P3). The mapper frees rows (culls,
    fusion, outliers of the adjustment), new points reuse them, the
    adjustment moves points and fusion refreshes descriptors: on every fused
    frame of this run the rows the frame used held, on the device, exactly
    what the host's store held, and none was a freed row."""
    assert len(mapped["fused_frames"]) == N_FRAMES - 2
    assert mapped["stale"] == []
    tt = mapped["tt"]
    st = tt.atlas.current.store
    assert len(st.free) > 0 or st.n_rows > tt.atlas.current.n_mappoints()  # rows were freed
    # and the mirror was uploaded only at map changes: fewer uploads than frames
    uploads = sum(tt.stats.series["store_uploads"])
    assert len(mapped["trec"].rows) - 1 <= uploads <= len(mapped["trec"].rows) + 1


def test_tracker_with_a_mapper_follows_the_jax_tracker(mapped):
    jt, tt = mapped["jt"], mapped["tt"]
    assert tt.state.name == jt.state.name == "OK"
    assert len(tt.trajectory) == len(jt.trajectory) == N_FRAMES
    for (_, Rt, tt_), (_, Rj, tj) in zip(tt.trajectory, jt.trajectory):
        np.testing.assert_allclose(Rt, Rj, atol=2e-3)
        np.testing.assert_allclose(tt_, tj, atol=2e-3)
    assert tt.ref_kf_id == jt.ref_kf_id


# -------------------------------------------------------------- what was left out
@pytest.mark.parametrize("kwargs, item", [
    (dict(mesh=make_mesh(2, device="cpu")), "M10"),
])
def test_left_out_branches_raise_with_their_item(kwargs, item):
    """No branch of the mapper is left out any more: the last one, the
    local BA over a device mesh (ROADMAP M10), is ported, so the mapper
    takes the mesh and keeps it, and its module raises NotImplementedError
    nowhere (tests/test_torch_parallel.py runs the mesh route against the
    JAX mapper's)."""
    import inspect

    _, tcam = cams()
    mapper = tmapping.LocalMapper(tmap.Atlas(), tcam, 28.0, device="cpu", **kwargs)
    for name, value in kwargs.items():
        assert getattr(mapper, name) is value, item
    assert "NotImplementedError" not in inspect.getsource(tmapping), item


def test_the_visual_monocular_mapper_builds():
    """A monocular map without an IMU (M9b) is mapped, and since M9c one
    with an IMU too; the scale refinement of a chain too short for it (here
    one keyframe) leaves the map as it was."""
    import types

    from fasttrack_tpu_torch.imu.preintegration import ImuCalib

    _, tcam = cams()
    mapper = tmapping.LocalMapper(tmap.Atlas(), tcam, 0.0, monocular=True, device="cpu")
    assert mapper.monocular and mapper.imu_calib is None
    calib = ImuCalib.default(device="cpu")
    mapper = tmapping.LocalMapper(tmap.Atlas(), tcam, 0.0, monocular=True, imu_calib=calib,
                                  device="cpu")
    assert mapper.monocular and mapper.imu_calib is calib
    lone = types.SimpleNamespace(kid=0, prev_kf_id=None, R_cw=np.eye(3), t_cw=np.ones(3),
                                 preintegrated=None)
    mapper.atlas.current.keyframes[0] = lone
    mapper._scale_refinement(lone)
    np.testing.assert_array_equal(lone.t_cw, np.ones(3))
    assert mapper.stats.series.get("lm_scale_refinement_scale", []) == []


def test_a_mapper_on_its_thread_queues_to_the_loop_closer():
    """A loop closer on the mapping thread (M7b): the mapper hands every
    keyframe it has processed to the closer's queue, as the JAX mapper does
    (fasttrack_tpu/local_mapping.py:163-164), and the closer's thread takes
    it from there."""
    _, tcam = cams()
    ta, tk = build_scene(tmap)
    lc = LoopCloser(ta, make_random_vocabulary(64), np.eye(3), run_async=True, device="cpu")
    seen = []
    inner = lc.process_keyframe
    lc.process_keyframe = lambda kid: seen.append(kid) or inner(kid)
    lm = tmapping.LocalMapper(ta, tcam, 28.0, run_async=True, loop_closer=lc, device="cpu")
    for kf in tk:
        lm.insert_keyframe(kf)
    deadline = time.monotonic() + 60
    while (not lm.is_idle() or len(seen) < len(tk)) and time.monotonic() < deadline:
        time.sleep(0.01)
    lm.stop()
    lc.stop()
    assert seen == [kf.kid for kf in tk]
    assert len(lm.stats.series["lc_keyframe"]) == len(tk)
    assert not lm._thread.is_alive() and not lc._thread.is_alive() and lc.n_thread_errors == 0


def test_mapper_constants_and_queue_protocol():
    assert (tmapping.BA_MAX_KFS, tmapping.BA_MAX_POINTS, tmapping.LocalMapper._EPI_BATCH) == (
        jmapping.BA_MAX_KFS, jmapping.BA_MAX_POINTS, jmapping.LocalMapper._EPI_BATCH)
    _, tcam = cams()
    lm = tmapping.LocalMapper(tmap.Atlas(), tcam, 28.0, run_async=True, device="cpu")
    assert lm.is_idle() and lm.queue_size() == 0
    ta, tk = build_scene(tmap)
    lm.atlas = ta
    for kf in tk:
        lm.insert_keyframe(kf)
    deadline = time.monotonic() + 60
    while not lm.is_idle() and time.monotonic() < deadline:
        time.sleep(0.01)          # stop() does not drain the queue
    lm.stop()
    assert lm.is_idle() and lm.queue_size() == 0 and not lm._thread.is_alive()
    assert sum(lm.stats.series["lm_keyframes"]) == 3
    assert lm.camera.params.device.type == "cpu" and lm._bf_dev.device.type == "cpu"


# ------------------------------------------------- the kernels' new shapes, on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_triangulation_batch_launches_one_10240_row_kernel_on_gpu(rng, cuda_device):
    """The mapper's full batch: 10 neighbour keyframes of 1024 rows against
    1024 columns is ONE top-K launch of 10240 rows; indices and keep masks
    equal the plain version's on the CPU."""
    from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_topk

    args = epipolar_case(rng, B=10, C=1024, n_feat=900)
    before = (hamming_penalty_topk.launches, hamming_penalty_topk.launches_by_rows[10240])
    idx_g, keep_g, X_g = tpm.epipolar_match_tri_batch(
        *(T(a).to(cuda_device) for a in args), FX, FY, CX, CY)
    torch.cuda.synchronize()
    assert (hamming_penalty_topk.launches, hamming_penalty_topk.launches_by_rows[10240]) == (
        before[0] + 1, before[1] + 1)
    idx_c, keep_c, X_c = tpm.epipolar_match_tri_batch(*(T(a) for a in args), FX, FY, CX, CY)
    keep = keep_c.numpy()
    np.testing.assert_array_equal(keep_g.cpu().numpy(), keep)
    np.testing.assert_array_equal(idx_g.cpu().numpy()[keep], idx_c.numpy()[keep])
    want = X_c.numpy()[keep]
    np.testing.assert_allclose(X_g.cpu().numpy()[keep], want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    assert keep[:9].sum() > 5000 and not keep[9].any()


@pytest.mark.cuda
def test_fusion_search_launches_the_matrix_kernel_on_gpu(rng, cuda_device):
    """A fusion's reverse pass: 3000 candidate points against 1024 keypoints
    is ONE launch of the matrix kernel; the result equals the plain version's
    on the CPU integer for integer."""
    from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_matrix

    n, m = 1024, 3000
    kp_bits = _bits(rng, n)
    kp_uv = rng.uniform(0, W, (n, 2)).astype(np.float32)
    kp_level = rng.integers(0, N_LEVELS, n).astype(np.int32)
    pick = rng.integers(0, n, m)
    lvl = kp_level[pick]
    args = (
        (kp_uv[pick] + rng.normal(0, 2, (m, 2))).astype(np.float32), _signed(_flip(rng, kp_bits[pick], 12)),
        (3.0 * SCALE ** lvl).astype(np.float32), np.maximum(lvl - 1, 0).astype(np.int32),
        np.minimum(lvl + 1, N_LEVELS - 1).astype(np.int32), rng.random(m) > 0.15,
        kp_uv, _signed(kp_bits), kp_level, rng.random(n) > 0.1,
    )
    before = hamming_penalty_matrix.launches
    got = thost.search_by_projection_exact(*(T(a).to(cuda_device) for a in args), max_dist=50)
    torch.cuda.synchronize()
    assert hamming_penalty_matrix.launches == before + 1
    want = thost.search_by_projection_exact(*(T(a) for a in args), max_dist=50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert 1500 < int(want[2].sum()) < m
