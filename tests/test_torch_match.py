"""The port's matchers against the JAX package on the same keypoints.

The JAX package's keypoints and raw pyramids (240x320, 4 levels, 256
features per camera) are fed to both match_rectified and both
search_by_projection, so only the matchers differ. Tolerances and why:
- `ok` / stereo validity: equal;
- best distance: equal where a match is accepted (exact integers); a
  rejected row's distance is a sum of 1e6-scaled window penalties, held
  to 1e-6 relative (f32 rounding of that sum);
- `idx`: equal where the best in-window distance is unique (with ties,
  either candidate is a correct answer);
- `u_right`: within 1e-3 px — the SAD sums of the refinement may run in
  another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked as jax_extract
from fasttrack_tpu.ops.project_match import search_by_projection as jax_search
from fasttrack_tpu.ops.stereo_match import match_rectified as jax_match_rectified
from fasttrack_tpu_torch import parity
from fasttrack_tpu_torch.ops.project_match import search_by_projection
from fasttrack_tpu_torch.ops.stereo_match import match_rectified

H, W = 240, 320
CFG = JaxOrbConfig(height=H, width=W, n_features=256, n_levels=4)
SCALES = np.asarray([CFG.scale_factor**l for l in range(CFG.n_levels)], np.float32)
BF, MIN_Z = np.float32(0.11 * 230.0), np.float32(0.11)


def to_np(k):
    return {f: np.asarray(v) for f, v in k._asdict().items()}


@pytest.fixture(scope="module")
def frames():
    out = []
    for img in parity.stereo_frames(2, H, W, seed=5):
        kl, kr, pl, pr = jax_extract(jnp.asarray(img), CFG)
        out.append((to_np(kl), to_np(kr), np.asarray(pl.raw), np.asarray(pr.raw)))
    return out


def T(a):
    return torch.from_numpy(np.array(a))


def test_match_rectified(frames):
    kl, kr, pl, pr = frames[0]
    args = (
        kl["x"], kl["y"], kl["level"], kl["desc_signed"], kl["valid"],
        kr["x"], kr["y"], kr["level"], kr["desc_signed"], kr["valid"],
        pl, pr, kl["xl"], kl["yl"], SCALES, BF, MIN_Z,
    )
    want = jax_match_rectified(*(jnp.asarray(a) for a in args))
    got = match_rectified(*(T(a) for a in args))
    valid = np.asarray(want.valid)
    assert valid.sum() > 50
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(
        got.u_right.numpy()[valid], np.asarray(want.u_right)[valid], rtol=0, atol=1e-3
    )
    np.testing.assert_array_equal(got.u_right.numpy()[~valid], -1.0)


def make_queries(rng, frames, m=300):
    """Map queries from frame 0's left keypoints, searched in frame 1 (the
    view moves 5 px left and 3 px up between the two)."""
    k0 = frames[0][0]
    idx = rng.choice(k0["x"].shape[0], m)
    lvl = k0["level"][idx]
    return dict(
        q_u=(k0["x"][idx] - 5.0).astype(np.float32), q_v=(k0["y"][idx] - 3.0).astype(np.float32),
        q_desc=k0["desc_signed"][idx], q_radius=np.full(m, 6.0, np.float32),
        q_level_min=np.maximum(lvl - 1, 0).astype(np.int32),
        q_level_max=np.minimum(lvl + 1, CFG.n_levels - 1).astype(np.int32),
        q_valid=k0["valid"][idx] & (rng.random(m) > 0.05),
    )


@pytest.mark.parametrize("ratio", [None, 0.8])
@pytest.mark.parametrize("with_taken", [False, True])
def test_search_by_projection(rng, frames, ratio, with_taken):
    q = make_queries(rng, frames)
    k1 = frames[1][0]
    n = k1["x"].shape[0]
    kp = dict(kp_x=k1["x"], kp_y=k1["y"], kp_desc=k1["desc_signed"],
              kp_level=k1["level"], kp_valid=k1["valid"])
    taken = rng.random(n) < 0.1
    extra = dict(kp_taken=taken) if with_taken else {}
    if not with_taken:
        taken = np.zeros(n, bool)
    want = jax_search(**{k: jnp.asarray(v) for k, v in {**q, **kp, **extra}.items()}, ratio=ratio)
    got = search_by_projection(**{k: T(v) for k, v in {**q, **kp, **extra}.items()}, ratio=ratio)

    ok = np.asarray(want.ok)
    assert ok.sum() > 50
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    dist_w, dist_g = np.asarray(want.dist), got.dist.numpy()
    np.testing.assert_array_equal(dist_g[ok], dist_w[ok])
    np.testing.assert_allclose(dist_g[~ok], dist_w[~ok], rtol=1e-6)

    # uniqueness of the best in-window candidate, from the full matrix
    ham = (q["q_desc"][:, None, :] != kp["kp_desc"][None, :, :]).sum(-1)
    gate = (
        (np.abs(kp["kp_x"][None] - q["q_u"][:, None]) <= q["q_radius"][:, None])
        & (np.abs(kp["kp_y"][None] - q["q_v"][:, None]) <= q["q_radius"][:, None])
        & (kp["kp_level"][None] >= q["q_level_min"][:, None])
        & (kp["kp_level"][None] <= q["q_level_max"][:, None])
        & kp["kp_valid"][None] & ~taken[None]
    )
    n_best = ((ham == dist_w[:, None]) & gate).sum(1)
    unique = ok & (n_best == 1)
    assert unique.sum() > 0.8 * ok.sum()
    np.testing.assert_array_equal(got.idx.numpy()[unique], np.asarray(want.idx)[unique])
