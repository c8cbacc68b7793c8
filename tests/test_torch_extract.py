"""The port's ORB extraction against the JAX package at 240x320, 4 levels,
256 features per camera.

Tolerances and why:
- pyramid: max-abs 1e-3 gray levels — the same operator products, but
  the sums may run in another order;
- FAST score, the cell threshold and NMS: exact — min/max/compare and
  differences of the same f32 inputs;
- keypoints: (x, y, level) set overlap >= 0.97 and mean descriptor bit
  difference <= 4 on co-detected keypoints (tools/tpu_golden_check.py's
  thresholds), since tie order and last-bit differences in the pyramid may
  move a keypoint or flip a near-equal BRIEF pair.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fasttrack_tpu.ops.descriptor as jdesc
import fasttrack_tpu.ops.fast as jfast
from fasttrack_tpu.ops.extractor import OrbConfig as JaxOrbConfig
from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked as jax_extract
from fasttrack_tpu.ops.pyramid import build_pyramid_pair as jax_pyramid_pair
import fasttrack_tpu_torch.ops.descriptor as tdesc
import fasttrack_tpu_torch.ops.fast as tfast
from fasttrack_tpu_torch import parity
from fasttrack_tpu_torch.ops.extractor import OrbConfig, extract_orb_pair_stacked
from fasttrack_tpu_torch.ops.pyramid import build_pyramid_pair

H, W = 240, 320
JCFG = JaxOrbConfig(height=H, width=W, n_features=256, n_levels=4)
CFG = OrbConfig(**JCFG._asdict())


@pytest.fixture(scope="module")
def images():
    return parity.stereo_frames(1, H, W, seed=3)[0]


@pytest.fixture(scope="module")
def extracted(images):
    return jax_extract(jnp.asarray(images), JCFG), extract_orb_pair_stacked(
        torch.from_numpy(images), CFG
    )


def kp_dict(k):
    return {f: np.asarray(getattr(k, f)) for f in ("x", "y", "level", "valid", "desc_packed")}


def test_pyramid(images):
    raw_j, blur_j = jax_pyramid_pair(jnp.asarray(images[0]), jnp.asarray(images[1]), JCFG.pyramid)
    raw_t, blur_t = build_pyramid_pair(
        torch.from_numpy(images[0]), torch.from_numpy(images[1]), CFG.pyramid
    )
    assert raw_t.shape == (8, H, W)
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(blur_t.numpy(), np.asarray(blur_j), rtol=0, atol=1e-3)


def test_fast_score_exact(images):
    levels = images.astype(np.float32)
    np.testing.assert_array_equal(
        tfast.fast_score(torch.from_numpy(levels)).numpy(),
        np.asarray(jfast.fast_score(jnp.asarray(levels))),
    )


def test_cell_threshold_offset_cells_exact(rng):
    """Strong responses placed on both sides of every 32-px boundary and of
    the offset (SAME-padded) boundaries, on a weak background: every pixel
    must get the JAX package's threshold. At H = 240 the pooling pads 8 px
    on the low side, so pooled cells are offset from the pixels they are
    broadcast to."""
    score = rng.uniform(0.0, 15.0, size=(2, H, W)).astype(np.float32)
    for c in range(0, max(H, W), 32):
        for off in (-9, -8, -1, 0, 7, 8, 23, 24):
            p = c + off
            if 0 <= p < H:
                score[0, p, rng.integers(0, W)] = 25.0
            if 0 <= p < W:
                score[1, rng.integers(0, H), p] = 25.0
    cfg_j, cfg_t = jfast.FastConfig(), tfast.FastConfig()
    want = np.asarray(jfast._cell_threshold(jnp.asarray(score), cfg_j))
    got = tfast._cell_threshold(torch.from_numpy(score), cfg_t).numpy()
    assert (want == 20.0).any() and (want == 7.0).any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfast._nms3(torch.from_numpy(score)).numpy(), np.asarray(jfast._nms3(jnp.asarray(score)))
    )


def test_fast_detect_crafted_corners_exact(rng):
    """Bright and faint squares whose corners sit next to 32-px cell edges:
    the faint ones are corners only where their cell falls back to minTh."""
    img = np.full((H, W), 128.0, np.float32)
    for y0 in (28, 36, 60, 92, 124, 156, 188):
        for x0 in range(24, W - 40, 24):
            img[y0:y0 + 6, x0:x0 + 6] += 60.0 if (x0 // 24 + y0) % 3 else 12.0
    img += rng.uniform(0, 1, size=img.shape).astype(np.float32)
    levels = np.stack([img, img[:, ::-1].copy()])
    sizes, per_level = ((H, W), (H, W)), (64, 64)
    want = jfast.fast_detect(jnp.asarray(levels), sizes, per_level, jfast.FastConfig())
    got = tfast.fast_detect(torch.from_numpy(levels), sizes, per_level, tfast.FastConfig())
    assert np.asarray(want.valid).sum() > 20
    for f in ("x", "y", "score", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_extract_orb_pair_stacked(extracted):
    (jl, jr, _, _), (tl, tr, _, _) = extracted
    for jk, tk in ((jl, tl), (jr, tr)):
        a, b = kp_dict(jk), kp_dict(tk)
        assert b["valid"].sum() > 100
        assert parity.keypoint_overlap(a, b) >= parity.MIN_KP_OVERLAP
        ia, ib = parity.codetected(a, b)
        bits = np.unpackbits(a["desc_packed"][ia] ^ b["desc_packed"][ib], axis=1).sum(1)
        assert bits.mean() <= parity.MAX_DESC_BITS


def test_keypoint_fields_and_layout(extracted):
    (_, _, _, _), (tl, tr, pl, pr) = extracted
    n = CFG.total_features
    for k in (tl, tr):
        assert k.x.shape == (n,) and k.x.dtype == torch.float32
        assert k.desc_signed.shape == (n, 256) and k.desc_signed.dtype == torch.int8
        assert k.desc_packed.shape == (n, 32) and k.desc_packed.dtype == torch.uint8
        assert set(torch.unique(k.desc_signed).tolist()) <= {-1, 1}
        assert k.level.dtype == torch.int32 and int(k.level.max()) < CFG.n_levels
    assert pl.raw.shape == (CFG.n_levels, H, W) and pr.blurred.shape == (CFG.n_levels, H, W)


def test_brief_and_bit_packing_exact(rng):
    """Same patches and angles in: the same bits (bf16 rounding included)."""
    patches = rng.uniform(0, 255, size=(96, 41, 41)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, size=96).astype(np.float32)
    want = np.asarray(jdesc.brief_from_patches(jnp.asarray(patches), jnp.asarray(angle)))
    got = tdesc.brief_from_patches(torch.from_numpy(patches), torch.from_numpy(angle)).numpy()
    np.testing.assert_array_equal(got, want)
    packed = tdesc.pack_bits(torch.from_numpy(got))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdesc.pack_bits(jnp.asarray(want))))
    np.testing.assert_array_equal(tdesc.unpack_bits(packed).numpy(), got)
