"""The port's fused per-frame tracker step against the JAX package.

Two synthetic stereo frames at 240x320, 4 levels, 256 features per camera.
The JAX package extracts both; a point store is built on the host from the
first frame's stereo keypoints (parity.py, as Tracker._track_fused packs
its blocks), and the SAME keypoints, store and query blocks go through both
packages' matchers and steps (state through convert.py, device="cpu").
Tolerances and why:
- masks and indices of rotation_consistency, resolve_duplicates, twm_match
  and tlm_match: equal (integer distances, the same tie rules);
- twm_step / tlm_step idx, keep, in_frustum, pred_level, inliers: equal;
- pose_R / pose_t: atol 1e-3, the hot-path test's tolerance (f32 rounding
  through 40 LM steps, analytic against forward-mode Jacobians);
- pack_fused_for_host / unpack_fused: an exact round trip.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu import frame_pipeline as jfp
from fasttrack_tpu import fused_track as jft
from fasttrack_tpu.cameras import make_pinhole as jax_make_pinhole
from fasttrack_tpu.geometry import SE3 as JaxSE3
from fasttrack_tpu.ops import project_match as jpm
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu_torch import convert, fused_track, parity
from fasttrack_tpu_torch.cameras import host_camera
from fasttrack_tpu_torch.frame_pipeline import FrameData
from fasttrack_tpu_torch.ops import project_match as tpm
from fasttrack_tpu_torch.ops.extractor import OrbConfig

H, W = 240, 320
JCFG = JaxOrbConfig(height=H, width=W, n_features=256, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())
SCALES = np.asarray([CFG.scale_factor**l for l in range(CFG.n_levels)], np.float64)
INTRINSICS = (230.0, 230.0, 160.0, 120.0)
BF, MIN_Z = np.float32(0.11 * 230.0), np.float32(0.11)
CAP, P = 1024, 512
# The view moves 5 px right and 3 px down per frame at a depth of bf / 7;
# the prediction is deliberately a little off.
T_PRED = np.asarray([-5.4, -2.7, 0.0]) * (float(BF) / 7.0) / 230.0


def to_np(nt):
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def state():
    f0, f1 = parity.stereo_frames(2, H, W, seed=13)
    bf, min_z = jnp.float32(BF), jnp.float32(MIN_Z)
    fd0 = jfp.process_stereo_frame_stacked(J(f0), JCFG, bf, min_z)
    fd1 = jfp.process_stereo_frame_stacked(J(f1), JCFG, bf, min_z)
    k0, k1 = to_np(fd0.kps), to_np(fd1.kps)
    last = dict(k0, depth=np.asarray(fd0.depth))

    cam_j = jax_make_pinhole(*INTRINSICS, W, H)
    cam_t = convert.camera_from_numpy("pinhole", np.asarray(cam_j.params), W, H, device="cpu")
    store = parity.new_store(CAP)
    sel = np.where(last["depth"] > 0)[0]
    mp_rows = np.full(len(k0["x"]), -1, np.int64)
    mp_rows[sel] = parity.store_add_points(
        store, last, sel, np.eye(3), np.zeros(3), INTRINSICS, SCALES
    )
    q7, q_rows = parity.twm_query_block(
        store, mp_rows, k0["level"], k0["angle"], host_camera(cam_t), np.eye(3), T_PRED, SCALES
    )
    cand_rows, cand_ok, live = parity.tlm_candidate_block(store, np.arange(store["n_rows"]), P)
    assert q7[5].sum() > 100 and len(live) == store["n_rows"] > 100
    return dict(
        k0=k0, k1=k1, u_right=np.asarray(fd1.u_right), depth=np.asarray(fd1.depth), store=store,
        mp_rows=mp_rows, q7=q7, q_rows=q_rows, cand_rows=cand_rows, cand_ok=cand_ok,
        cam_j=cam_j, cam_t=cam_t, kps_j=fd1.kps,
    )


def query_args(s):
    """The 14 arguments of twm_match, as numpy."""
    q7, k1 = s["q7"], s["k1"]
    return (
        q7[0], q7[1], s["store"]["desc_signed"][s["q_rows"]], q7[2],
        q7[3].astype(np.int32), q7[4].astype(np.int32), q7[5] > 0.5,
        k1["x"], k1["y"], k1["desc_signed"], k1["level"], k1["valid"], q7[6], k1["angle"],
    )


def test_rotation_consistency_and_resolve_duplicates(state):
    a = query_args(state)
    n = len(state["k1"]["x"])
    res_j = jpm.search_by_projection(*(J(x) for x in a[:12]))
    res_t = tpm.search_by_projection(*(T(x) for x in a[:12]))
    np.testing.assert_array_equal(res_t.ok.numpy(), np.asarray(res_j.ok))
    np.testing.assert_array_equal(res_t.idx.numpy(), np.asarray(res_j.idx))
    assert int(res_t.ok.sum()) > 100

    keep_j = jpm.rotation_consistency(J(a[12]), J(a[13]), res_j)
    keep_t = tpm.rotation_consistency(T(a[12]), T(a[13]), res_t)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert 0 < int(keep_t.sum()) <= int(res_t.ok.sum())

    dedup_j = jpm.resolve_duplicates(res_j, n)
    dedup_t = tpm.resolve_duplicates(res_t, n)
    np.testing.assert_array_equal(dedup_t.numpy(), np.asarray(dedup_j))
    kept = res_t.idx.numpy()[dedup_t.numpy()]
    assert len(np.unique(kept)) == len(kept)       # one query per keypoint


def test_rotation_consistency_with_several_live_bins(rng):
    """Angles spread over many bins: the top-3 rule and its 10% cut-off."""
    m = 400
    idx = rng.integers(0, 300, m)
    ok = rng.random(m) > 0.2
    q_angle = rng.choice(np.asarray([0.1, 0.1, 0.1, 1.3, 1.3, 2.9, 4.0, 5.5], np.float32), m)
    q_angle = (q_angle + rng.normal(0, 0.02, m)).astype(np.float32)
    kp_angle = rng.normal(0, 0.02, 300).astype(np.float32)
    dist = rng.integers(0, 100, m).astype(np.float32)
    keep_j = jpm.rotation_consistency(J(q_angle), J(kp_angle), jpm.MatchResult(J(idx.astype(np.int32)), J(dist), J(ok)))
    keep_t = tpm.rotation_consistency(T(q_angle), T(kp_angle), tpm.MatchResult(T(idx), T(dist), T(ok)))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert 0 < int(keep_t.sum()) < int(ok.sum())


def test_resolve_duplicates_ties_go_to_the_first_query(rng):
    m, n = 300, 40                                  # many queries per keypoint
    idx = rng.integers(0, n, m)
    dist = rng.integers(20, 24, m).astype(np.float32)  # and many equal distances
    ok = rng.random(m) > 0.3
    want = jpm.resolve_duplicates(jpm.MatchResult(J(idx.astype(np.int32)), J(dist), J(ok)), n)
    got = tpm.resolve_duplicates(tpm.MatchResult(T(idx), T(dist), T(ok)), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(idx[got.numpy()])) == int(got.sum()) > 0


def test_twm_match(state):
    a = query_args(state)
    idx_j, keep_j = jpm.twm_match(*(J(x) for x in a))
    idx_t, keep_t = tpm.twm_match(*(T(x) for x in a))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(keep_t.sum()) > 100


def test_tlm_match(rng, state):
    a = list(query_args(state)[:12])
    a[3] = a[3] * 0.5                               # a tighter window, as TrackLocalMap's
    taken = rng.random(len(state["k1"]["x"])) < 0.3
    idx_j, keep_j = jpm.tlm_match(*(J(x) for x in a), J(taken))
    idx_t, keep_t = tpm.tlm_match(*(T(x) for x in a), T(taken))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(keep_t.sum()) > 30
    assert not taken[idx_t.numpy()[keep_t.numpy()]].any()


@pytest.fixture(scope="module")
def steps(state):
    s = state
    st = s["store"]
    maxd = np.where(np.isfinite(st["max_dist"]), st["max_dist"], 1e6).astype(np.float32)
    store_j = (J(st["pos"]), J(st["desc_signed"]), J(st["normal"]), J(st["min_dist"]), J(maxd))
    T0_j = JaxSE3(jnp.eye(3, dtype=jnp.float32), J(T_PRED.astype(np.float32)))
    bf = jnp.float32(BF)
    twm_j = jft.twm_step(s["kps_j"], J(s["u_right"]), JCFG, bf, s["cam_j"], T0_j,
                         J(s["q7"]), J(s["q_rows"]), store_j[0], store_j[1])
    tlm_j = jft.tlm_step(s["kps_j"], J(s["u_right"]), JCFG, bf, s["cam_j"], twm_j,
                         J(s["cand_rows"]), J(s["cand_ok"]), *store_j)

    kps = convert.keypoints_from_numpy(**s["k1"], device="cpu")
    store_t = convert.store_from_numpy(
        st["pos"], st["desc_signed"], st["normal"], st["min_dist"], st["max_dist"], device="cpu"
    )
    qb = convert.query_block_from_numpy(
        s["q7"], s["q_rows"], s["cand_rows"], s["cand_ok"], device="cpu"
    )
    T0_t = convert.se3_from_numpy(np.eye(3), T_PRED, device="cpu")
    u_right, bf_t = T(s["u_right"]), torch.tensor(BF)
    twm_t = fused_track.twm_step(kps, u_right, CFG, bf_t, s["cam_t"], T0_t,
                                 qb.q7, qb.q_rows, store_t.pos, store_t.desc)
    tlm_t = fused_track.tlm_step(kps, u_right, CFG, bf_t, s["cam_t"], twm_t,
                                 qb.cand_rows, qb.cand_ok, *store_t)
    fd = FrameData(kps, None, u_right, T(s["depth"]), kps.valid.sum())
    return twm_j, tlm_j, twm_t, tlm_t, fd, (kps, u_right, bf_t, T0_t, qb, store_t)


def assert_pose_close(got_R, got_t, want_R, want_t):
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-3)


def test_twm_step(steps):
    twm_j, _, twm_t, _, _, _ = steps
    for f in ("idx", "keep", "inliers", "bound_kp"):
        np.testing.assert_array_equal(getattr(twm_t, f).numpy(), np.asarray(getattr(twm_j, f)), f)
    np.testing.assert_array_equal(twm_t.Xw_kp.numpy(), np.asarray(twm_j.Xw_kp))
    assert int(twm_t.n_inliers) == int(twm_j.n_inliers) > 100
    assert_pose_close(twm_t.pose_R, twm_t.pose_t, twm_j.pose_R, twm_j.pose_t)
    # the optimizer moved the pose off the (deliberately wrong) prediction
    assert np.abs(twm_t.pose_t.numpy() - T_PRED).max() > 1e-3


def test_tlm_step(steps):
    _, tlm_j, _, tlm_t, _, _ = steps
    for f in ("idx", "keep", "in_frustum", "pred_level", "inliers"):
        np.testing.assert_array_equal(getattr(tlm_t, f).numpy(), np.asarray(getattr(tlm_j, f)), f)
    assert int(tlm_t.n_inliers) == int(tlm_j.n_inliers) > 100
    assert int(tlm_t.in_frustum.sum()) > 100
    assert_pose_close(tlm_t.pose_R, tlm_t.pose_t, tlm_j.pose_R, tlm_j.pose_t)


def test_shared_launch_twm_step_equals_two_separate_searches(state, steps):
    """twm_step selects candidates once and gates them twice; the JAX
    package searches twice. Both windows, each as its own full search."""
    _, _, twm_t, _, _, _ = steps
    a = [T(x) for x in query_args(state)]
    outs = []
    for widen in (1.0, 2.0):
        b = list(a)
        b[3] = a[3] * widen
        outs.append(tpm.twm_match(*b))
    (idx1, keep1), (idx2, keep2) = outs
    narrow = int(keep1.sum()) >= 20
    assert torch.equal(twm_t.idx, idx1 if narrow else idx2)
    assert torch.equal(twm_t.keep, keep1 if narrow else keep2)
    assert not torch.equal(keep1, keep2)            # the windows do differ


def test_twm_step_widens_when_the_narrow_window_finds_too_little(state, steps):
    """A prediction 16 px off: the 1x window (7 to 12.1 px by level) loses
    the matches, and the step must return the 2x window's result, as JAX's."""
    s = state
    kps, u_right, bf_t, _, qb, store_t = steps[5]
    off = T_PRED + np.asarray([16.0, 0.0, 0.0]) * (float(BF) / 7.0) / 230.0
    q7, q_rows = parity.twm_query_block(
        s["store"], s["mp_rows"], s["k0"]["level"], s["k0"]["angle"],
        host_camera(s["cam_t"]), np.eye(3), off, SCALES,
    )
    st = s["store"]
    twm_j = jft.twm_step(s["kps_j"], J(s["u_right"]), JCFG, jnp.float32(BF), s["cam_j"],
                         JaxSE3(jnp.eye(3, dtype=jnp.float32), J(off.astype(np.float32))),
                         J(q7), J(q_rows), J(st["pos"]), J(st["desc_signed"]))
    twm_t = fused_track.twm_step(
        kps, u_right, CFG, bf_t, s["cam_t"], convert.se3_from_numpy(np.eye(3), off, device="cpu"),
        T(q7), T(q_rows), store_t.pos, store_t.desc,
    )
    np.testing.assert_array_equal(twm_t.keep.numpy(), np.asarray(twm_j.keep))
    np.testing.assert_array_equal(twm_t.idx.numpy(), np.asarray(twm_j.idx))
    a = [T(x) for x in (q7[0], q7[1], st["desc_signed"][q_rows], q7[2], q7[3].astype(np.int32),
                        q7[4].astype(np.int32), q7[5] > 0.5)]
    k1 = s["k1"]
    b = [T(k1[f]) for f in ("x", "y", "desc_signed", "level", "valid")]
    _, keep_narrow = tpm.twm_match(*a, *b, T(q7[6]), T(k1["angle"]))
    assert int(keep_narrow.sum()) < 20 <= int(twm_t.keep.sum())


def test_pack_unpack_fused_round_trip(steps):
    _, _, twm, tlm, fd, _ = steps
    N, M = fd.kps.x.shape[0], twm.idx.shape[0]
    buf = fused_track.pack_fused_for_host(fd, twm, tlm)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    f32, packed, idxA, keepA, idxB, keepB, in_frustum, tail = fused_track.unpack_fused(
        buf.numpy(), N, M, P
    )
    k = fd.kps
    want = [k.x, k.y, k.level.float(), k.angle, fd.u_right, fd.depth, k.valid.float(),
            twm.inliers.float(), tlm.inliers.float()]
    np.testing.assert_array_equal(f32, torch.stack(want).numpy())
    np.testing.assert_array_equal(packed, k.desc_packed.numpy())
    np.testing.assert_array_equal(idxA, twm.idx.numpy())
    np.testing.assert_array_equal(keepA, twm.keep.numpy())
    np.testing.assert_array_equal(idxB, tlm.idx.numpy())
    np.testing.assert_array_equal(keepB, tlm.keep.numpy())
    np.testing.assert_array_equal(in_frustum, tlm.in_frustum.numpy())
    np.testing.assert_array_equal(tail[:9].reshape(3, 3), tlm.pose_R.numpy())
    np.testing.assert_array_equal(tail[9:12], tlm.pose_t.numpy())
    assert (int(tail[12]), int(tail[13])) == (int(twm.n_inliers), int(tlm.n_inliers))
    assert buf.numel() == 9 * N * 4 + 14 * 4 + (M + P) * 4 + N * 32 + M + 2 * P


def test_bind_fused_frame(state, steps):
    """The host bookkeeping after the fetch: every bound keypoint is a final
    inlier, no map point is bound twice, and TWM bindings win."""
    s = state
    _, _, twm, tlm, fd, _ = steps
    N = fd.kps.x.shape[0]
    mp = parity.bind_fused_frame(
        N, s["mp_rows"], twm.idx.numpy(), twm.keep.numpy(), s["cand_rows"].astype(np.int64),
        s["cand_ok"], tlm.idx.numpy(), tlm.keep.numpy(), tlm.inliers.numpy(),
    )
    bound = mp >= 0
    assert bound.sum() > 100
    assert tlm.inliers.numpy()[bound].all()
    assert len(np.unique(mp[bound])) == bound.sum()
    a = twm.keep.numpy() & tlm.inliers.numpy()[twm.idx.numpy()]
    np.testing.assert_array_equal(mp[twm.idx.numpy()[a]], s["mp_rows"][a])
