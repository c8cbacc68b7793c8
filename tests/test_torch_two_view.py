"""The port's two-view reconstruction (optim/two_view.py) against the JAX
package's on the four scenes of tests/test_bow_twoview.py (its generator
copied): a general scene, a planar one, one with 40 outliers, and one with
too few valid matches.

Both packages solve the same 256 + 256 minimal sets (drawn on the host from
the same seed), in float32. Tolerances and why:
- `success` and `used_homography` equal: the model choice and the gates;
- R within 0.05 deg and the t direction to cos > 0.9999: float32 rounding
  of the SVDs may pick another hypothesis of near-equal score, which the
  least-squares refit over the inliers then brings back;
- `good_mask` equal on >= 99% of the points.
Also: the H and F that both packages solve from one minimal set agree up to
sign and scale.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from fasttrack_tpu.optim import two_view as jtv
from fasttrack_tpu_torch.optim import two_view as ttv


def make_pair(rng, n=200, planar=False, noise=0.3):
    """tests/test_bow_twoview.py TestTwoView.make_pair."""
    K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]])
    if planar:
        X = np.stack(
            [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), np.full(n, 6.0)], -1
        )
    else:
        X = np.stack(
            [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1
        )
    R = Rotation.from_rotvec([0.02, -0.05, 0.01]).as_matrix()
    t = np.array([0.3, 0.05, 0.02])
    X2 = X @ R.T + t
    p1 = (X @ K.T)
    p1 = p1[:, :2] / p1[:, 2:]
    p2 = (X2 @ K.T)
    p2 = p2[:, :2] / p2[:, 2:]
    p1 += rng.normal(size=p1.shape) * noise
    p2 += rng.normal(size=p2.shape) * noise
    return p1.astype(np.float32), p2.astype(np.float32), K, R, t, X


def scene(name):
    """The four scenes, each from the default_rng(0) the JAX tests' `rng`
    fixture gives."""
    rng = np.random.default_rng(0)
    if name == "general":
        p1, p2, K, *_ = make_pair(rng, planar=False)
        return p1, p2, K, None
    if name == "planar":
        p1, p2, K, *_ = make_pair(rng, planar=True)
        return p1, p2, K, None
    if name == "outliers":
        p1, p2, K, *_ = make_pair(rng)
        idx = rng.choice(len(p1), 40, replace=False)
        p2[idx] += rng.uniform(30, 80, size=(40, 2)).astype(np.float32)
        return p1, p2, K, None
    p1, p2, K, *_ = make_pair(rng, n=200)
    valid = np.zeros(len(p1), bool)
    valid[:10] = True
    return p1, p2, K, valid


def rot_deg(A, B):
    return float(np.degrees(np.arccos(np.clip((np.trace(A.T @ B) - 1) / 2, -1, 1))))


@pytest.mark.parametrize("name", ["general", "planar", "outliers", "too_few"])
def test_matches_the_jax_package(name):
    p1, p2, K, valid = scene(name)
    j = jtv.reconstruct_two_view(p1, p2, K, valid=valid)
    t = ttv.reconstruct_two_view(p1, p2, K, valid=valid, device="cpu")
    assert (t.success, t.used_homography) == (j.success, j.used_homography)
    if name == "too_few":
        assert not t.success
        return
    assert t.success
    assert rot_deg(np.asarray(t.R), np.asarray(j.R)) < 0.05
    assert float(np.asarray(t.t) @ np.asarray(j.t)) > 0.9999
    assert np.mean(np.asarray(t.good_mask) == np.asarray(j.good_mask)) >= 0.99
    assert t.parallax_deg > 1.0


def test_hypotheses_agree_up_to_sign_and_scale():
    """One batch of minimal sets through both packages' solvers: every H
    and F equal up to sign and scale (the null vector's sign is arbitrary
    in both)."""
    import jax.numpy as jnp
    import torch

    p1, p2, _, _ = scene("general")
    rng = np.random.default_rng(1)
    # distinct points in each set: a repeated point leaves a null space of
    # two dimensions, whose vector each SVD may pick differently
    sets_h = np.stack([rng.choice(len(p1), 4, replace=False) for _ in range(32)])
    sets_f = np.stack([rng.choice(len(p1), 8, replace=False) for _ in range(32)])
    q1 = (p1 - p1.mean(0)) / 200.0
    q2 = (p2 - p2.mean(0)) / 200.0
    for jfn, tfn, sets in ((jtv._solve_h_batch, ttv._solve_h_batch, sets_h),
                           (jtv._solve_f_batch, ttv._solve_f_batch, sets_f)):
        a = np.asarray(jfn(jnp.asarray(q1[sets]), jnp.asarray(q2[sets]))).reshape(-1, 9)
        b = tfn(torch.from_numpy(q1[sets]), torch.from_numpy(q2[sets])).numpy().reshape(-1, 9)
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        cos = np.abs(np.sum(a * b, axis=1))
        assert cos.min() > 0.9999, cos.min()


def test_a_set_that_repeats_a_point_defines_no_model(monkeypatch):
    """ROADMAP F32: the JAX package draws each minimal set's points with
    replacement, and a set with a repeated point leaves a null space of two
    dimensions, whose vector the SVD routine picks (LAPACK and cuSOLVER pick
    differently, and such a pick can fit the scene best). The port scores
    such sets out: here, on a pool of 25 valid points where many sets repeat
    a point, every such set's hypothesis is made to score best, and the
    result does not change."""
    import torch

    assert ttv._repeats_a_point(np.array([[1, 2, 3, 1], [1, 2, 3, 4]])).tolist() == [True, False]
    p1, p2, K, _ = scene("general")
    valid = np.zeros(len(p1), bool)
    valid[:25] = True
    want = ttv.reconstruct_two_view(p1, p2, K, valid=valid, device="cpu")
    draws = np.random.default_rng(0)       # reconstruct_two_view's seed, its order of draws
    repeats_h = ttv._repeats_a_point(draws.integers(0, 25, size=(256, 4)))
    repeats_f = ttv._repeats_a_point(draws.integers(0, 25, size=(256, 8)))
    assert repeats_h.any() and repeats_f.any() and not repeats_f.all()

    def winning(score_fn, repeats):
        def fn(models, a, b, sigma2):
            score, ok = score_fn(models, a, b, sigma2)
            if len(score) == len(repeats):       # the hypotheses, not a refit
                score = score + 1e6 * torch.from_numpy(repeats)
            return score, ok
        return fn

    monkeypatch.setattr(ttv, "_score_h", winning(ttv._score_h, repeats_h))
    monkeypatch.setattr(ttv, "_score_f", winning(ttv._score_f, repeats_f))
    got = ttv.reconstruct_two_view(p1, p2, K, valid=valid, device="cpu")
    assert (got.success, got.used_homography, got.scores) == (
        want.success, want.used_homography, want.scores)
    np.testing.assert_array_equal(got.good_mask, want.good_mask)
    np.testing.assert_array_equal(got.R, want.R)
