"""The port's place-recognition vocabulary and keyframe database against the
JAX package's, on the CPU.

- The shipped vocabularies: the port's copies are byte-equal to the JAX
  package's files, the port loads them from its own directory, and
  `vocabulary_checksum` is equal.
- Flat quantization (`_assign`, ROADMAP K14): word ids exactly equal to the
  JAX package's XLA argmin, on random and rendered descriptors (the
  rendered ones from the host extractor on a 320x240 frame), with validity
  masks and with ties (duplicated words: the lowest index wins on both
  sides); the bow dicts equal to 1e-12. On the card `_assign` is one launch
  of the top-K kernel at K = 1 (tests/test_torch_topk_kernel.py, marked
  `cuda`); a vocabulary wider than the kernel's MAX_N raises there.
- Tree quantization: word ids and bow dicts exactly equal, the port's
  native library and its unpackbits branch each against the JAX package's
  own native build (`jax_native_library`) and against its unpackbits
  branch.
- Training: `train_vocabulary` (64 words, 2 iterations) and a small
  `train_tree_vocabulary` are exactly equal (integer k-majority; the idf is
  the same float32 expression).
- `KeyFrameDatabase`: candidates for loop and relocalization queries are
  equal, with dict and callable covisibility and with a score floor; and
  the hygiene of tests/test_kfdb_hygiene.py holds for the port's map and
  atlas: an erased keyframe, a cleared map and a removed map leave the
  inverted index.
"""

import os

import numpy as np
import pytest
import torch

from fasttrack_tpu import native as jnative
from fasttrack_tpu.bow import database as jdb
from fasttrack_tpu.bow import vocabulary as jvoc
from fasttrack_tpu_torch import native as tnative
from fasttrack_tpu_torch.bow import database as tdb
from fasttrack_tpu_torch.bow import vocabulary as tvoc
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops import host_kernels as thk
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame, Map
from tests.test_torch_host_kernels import jax_native_library

JAX_BOW = os.path.dirname(jvoc.__file__)


@pytest.fixture(scope="module", autouse=True)
def jax_own_native(tmp_path_factory):
    with jax_native_library(tmp_path_factory.mktemp("jax_native")):
        yield


def random_descs(rng, n):
    return (2 * rng.integers(0, 2, size=(n, 256)) - 1).astype(np.int8)


def clustered(rng, n_protos, copies, flips=8):
    """Perturbed copies of a few prototypes (the JAX package's test corpus)."""
    descs = np.repeat(random_descs(rng, n_protos), copies, axis=0)
    for i, f in enumerate(rng.integers(0, 256, size=(len(descs), flips))):
        descs[i, f] *= -1
    return descs


@pytest.fixture(scope="module")
def rendered_descs():
    seq = synthetic.generate_sequence(n_frames=1, h=240, w=320, seed=3)
    kps = thk.host_extract_orb(np.asarray(seq.frames[0].left, np.float32),
                               OrbConfig(240, 320, n_features=512, n_levels=4))
    return kps.desc_signed, kps.valid


def assert_bow_equal(got, want):
    assert set(got) == set(want)
    for w, x in want.items():
        assert got[w] == pytest.approx(x, abs=1e-12)


# ------------------------------------------------------------- the artifacts
@pytest.mark.parametrize("name", ["orb_vocab_32k.npz", "orb_vocab.npz"])
def test_shipped_vocabulary_is_a_byte_equal_copy(name):
    with open(os.path.join(JAX_BOW, name), "rb") as f:
        want = f.read()
    path = os.path.join(os.path.dirname(tvoc.__file__), name)
    with open(path, "rb") as f:
        assert f.read() == want
    assert os.path.abspath(path) in (tvoc.DEFAULT_TREE, tvoc.DEFAULT_FLAT)


def test_default_vocabulary_is_the_ports_tree_with_the_jax_checksum():
    got, want = tvoc.load_default_vocabulary(), jvoc.load_default_vocabulary()
    assert isinstance(got, tvoc.TreeVocabulary) and got.n_words == 64 * 512
    assert tvoc.load_default_vocabulary() is got                 # cached per process
    assert tvoc.vocabulary_checksum(got) == jvoc.vocabulary_checksum(want) != ""
    flat_t, flat_j = tvoc.Vocabulary.load(tvoc.DEFAULT_FLAT), jvoc.load_vocabulary(
        os.path.join(JAX_BOW, "orb_vocab.npz"))
    assert flat_t.n_words == 4096 == hamming_kernel.MAX_N
    assert tvoc.vocabulary_checksum(flat_t) == jvoc.vocabulary_checksum(flat_j)
    assert tvoc.vocabulary_checksum(None) == tvoc.vocabulary_checksum(False) == ""
    assert isinstance(tvoc.load_vocabulary(tvoc.DEFAULT_FLAT), tvoc.Vocabulary)


# --------------------------------------------------------- flat quantization
def _flat(rng, kind):
    if kind == "shipped":
        return tvoc.Vocabulary.load(tvoc.DEFAULT_FLAT)
    if kind == "ties":   # every word twice: the lower index must win
        words = random_descs(rng, 48)
        return tvoc.Vocabulary(np.concatenate([words, words]), np.ones(96, np.float32))
    return tvoc.make_random_vocabulary(256, seed=3)


@pytest.mark.parametrize("kind", ["shipped", "ties", "random"])
@pytest.mark.parametrize("source", ["random", "rendered"])
def test_flat_quantize_equals_jax(rng, rendered_descs, kind, source):
    voc = _flat(rng, kind)
    if source == "rendered":
        descs, valid = rendered_descs
    else:
        descs = random_descs(rng, 300)
        descs[::7] = voc.words_signed[rng.integers(0, voc.n_words, len(descs[::7]))]
        valid = rng.random(len(descs)) > 0.2
    jv = jvoc.Vocabulary(voc.words_signed, voc.idf)
    for mask in (None, valid):
        wid, bow = tvoc.quantize(voc, descs, mask, device="cpu")
        jwid, jbow = jvoc.quantize(jv, descs, mask)
        assert wid.dtype == np.int32
        np.testing.assert_array_equal(wid, np.asarray(jwid))
        assert_bow_equal(bow, jbow)
    if kind == "ties":
        assert (wid < 48).all()
    empty, ebow = tvoc.quantize(voc, descs[:0], device="cpu")
    assert empty.shape == (0,) and ebow == {}


def test_assign_raises_beyond_the_kernels_width(rng):
    """A tensor off the CPU takes the kernel or raises: 4,097 words do not fit
    its shared memory (MAX_N), and nothing falls back to the plain version.
    (A `meta` tensor stands in for a CUDA one: no card is needed to see the
    check, and the wrapper refuses a meta tensor before any launch.)"""
    q = torch.empty((8, 256), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="MAX_N"):
        tvoc._assign(q, torch.empty((hamming_kernel.MAX_N + 1, 256), dtype=torch.int8,
                                    device="meta"))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tvoc._assign(q, torch.empty((hamming_kernel.MAX_N, 256), dtype=torch.int8,
                                    device="meta"))
    descs = torch.from_numpy(random_descs(rng, 20))
    words = torch.from_numpy(random_descs(rng, hamming_kernel.MAX_N + 5))
    assert tvoc._assign(descs, words).shape == (20,)        # the CPU takes any width


# --------------------------------------------------------- tree quantization
@pytest.fixture(scope="module")
def tree_pair():
    voc = tvoc.load_default_vocabulary()
    return voc, jvoc.TreeVocabulary(voc.nodes_packed, voc.leaves_packed, voc.idf)


@pytest.mark.parametrize("port_branch", ["native", "unpackbits"])
@pytest.mark.parametrize("jax_branch", ["native", "unpackbits"])
def test_tree_quantize_equals_jax(rng, rendered_descs, tree_pair, monkeypatch,
                                  port_branch, jax_branch):
    voc, jv = tree_pair
    descs, valid = rendered_descs
    descs = np.concatenate([descs, random_descs(rng, 64)])
    valid = np.concatenate([valid, rng.random(64) > 0.3])
    assert tnative.available() and jnative.available()   # the JAX side: its own build
    if port_branch == "unpackbits":
        monkeypatch.setattr(tnative, "available", lambda: False)
    if jax_branch == "unpackbits":
        monkeypatch.setattr(jnative, "available", lambda: False)
    for mask in (None, valid):
        wid, bow = tvoc.quantize(voc, descs, mask)
        jwid, jbow = jvoc.quantize(jv, descs, mask)
        np.testing.assert_array_equal(wid, jwid)
        assert_bow_equal(bow, jbow)
    assert len(np.unique(wid)) > 50


def test_host_hamming_branches_agree(rng):
    a = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    want = jvoc._host_hamming(a, b)
    np.testing.assert_array_equal(tvoc._host_hamming(a, b), want)
    np.testing.assert_array_equal(tvoc._pack_signed(random_descs(rng, 5) * 0 + 1),
                                  np.full((5, 32), 255, np.uint8))


# ------------------------------------------------------------------ training
def test_train_vocabulary_equals_jax(rng):
    descs = clustered(rng, 32, 12)
    got = tvoc.train_vocabulary(descs, n_words=64, iters=2, device="cpu")
    want = jvoc.train_vocabulary(descs, n_words=64, iters=2)
    np.testing.assert_array_equal(got.words_signed, want.words_signed)
    np.testing.assert_array_equal(got.idf, want.idf)
    with pytest.raises(ValueError, match="need >= 64"):
        tvoc.train_vocabulary(descs[:10], n_words=64, device="cpu")


def test_train_tree_vocabulary_equals_jax(rng):
    descs = clustered(rng, 48, 20)
    got = tvoc.train_tree_vocabulary(descs, branches=8, children=16, iters=3, device="cpu")
    want = jvoc.train_tree_vocabulary(descs, branches=8, children=16, iters=3)
    assert got.n_words == 128
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    wid, _ = tvoc.quantize(got, descs)
    np.testing.assert_array_equal(wid, jvoc.quantize(want, descs)[0])


def test_l1_score_and_random_vocabulary_equal_jax(rng):
    voc, jv = tvoc.make_random_vocabulary(256), jvoc.make_random_vocabulary(256)
    np.testing.assert_array_equal(voc.words_signed, jv.words_signed)
    _, b1 = tvoc.quantize(voc, random_descs(rng, 100), device="cpu")
    _, b2 = tvoc.quantize(voc, random_descs(rng, 100), device="cpu")
    assert tvoc.l1_score(b1, b2) == jvoc.l1_score(b1, b2)
    assert tvoc.l1_score(b1, b1) == pytest.approx(1.0) and tvoc.l1_score(b1, {}) == 0.0


def test_save_load_roundtrip(rng, tmp_path):
    flat = tvoc.make_random_vocabulary(64)
    flat.save(str(tmp_path / "flat.npz"))
    back = tvoc.load_vocabulary(str(tmp_path / "flat.npz"))
    np.testing.assert_array_equal(back.words_signed, flat.words_signed)
    tree = tvoc.train_tree_vocabulary(clustered(rng, 16, 20), branches=4, children=8, iters=2,
                                      device="cpu")
    tree.save(str(tmp_path / "tree.npz"))
    back = tvoc.load_vocabulary(str(tmp_path / "tree.npz"))
    assert isinstance(back, tvoc.TreeVocabulary)
    assert jvoc.vocabulary_checksum(jvoc.load_vocabulary(str(tmp_path / "tree.npz"))) \
        == tvoc.vocabulary_checksum(tree)


# ------------------------------------------------------------------ database
@pytest.fixture(scope="module")
def databases():
    """Both databases filled with the same 40 keyframes' bow vectors (the
    shipped tree vocabulary over groups of related descriptors)."""
    rng = np.random.default_rng(5)
    voc = tvoc.load_default_vocabulary()
    places = [random_descs(rng, 200) for _ in range(8)]
    bows = {}
    for kid in range(40):
        d = places[kid % 8].copy()
        flip = rng.random(d.shape) < 0.04
        d[flip] *= -1
        _, bows[kid] = tvoc.quantize(voc, d[rng.random(200) > 0.3])
    covis = {k: [j for j in range(40) if j != k and abs(j - k) <= 2] for k in range(40)}
    t, j = tdb.KeyFrameDatabase(), jdb.KeyFrameDatabase()
    for kid, bow in bows.items():
        t.add(kid, bow)
        j.add(kid, bow)
    return t, j, bows, covis


@pytest.mark.parametrize("covis_kind", ["none", "dict", "callable"])
def test_database_candidates_equal_jax(databases, covis_kind):
    t, j, bows, covis = databases
    cov = {"none": None, "dict": covis, "callable": lambda k: covis.get(k)}[covis_kind]
    for q in (3, 11, 22, 39):
        bow = bows[q]
        assert t.detect_relocalization_candidates(bow, covisible=cov) == \
            j.detect_relocalization_candidates(bow, covisible=cov)
        connected = set(covis[q])
        for min_score in (0.0, 0.05):
            got = t.detect_loop_candidates(bow, q, connected, covisible=cov, min_score=min_score)
            assert got == j.detect_loop_candidates(bow, q, connected, covisible=cov,
                                                   min_score=min_score)
            assert not (set(got) & (connected | {q}))
    assert t.detect_relocalization_candidates({}) == []


def _mini_kf(kid, n=8):
    rng = np.random.default_rng(kid)
    return KeyFrame(
        kid, kid, float(kid), np.eye(3), np.zeros(3),
        rng.uniform(0, 100, (n, 2)), np.zeros(n, np.int32), np.zeros(n, np.float32),
        rng.integers(0, 256, (n, 32), dtype=np.uint8),
        rng.integers(0, 2, (n, 256)).astype(np.int8) * 2 - 1,
        np.full(n, -1.0), np.full(n, -1.0), np.ones(n, bool),
    )


def test_database_follows_the_ports_map_and_atlas():
    """tests/test_kfdb_hygiene.py's three cases on the port's map types."""
    m, db = Map(0), tdb.KeyFrameDatabase()
    m.kf_db = db
    for kid, bow in {1: {3: 0.5, 7: 0.5}, 2: {3: 0.6, 9: 0.4}}.items():
        m.add_keyframe(_mini_kf(kid))
        db.add(kid, bow)
    assert 2 in db.detect_relocalization_candidates({3: 1.0})
    m.erase_keyframe(2)
    assert 2 not in db.kf_bows and all(2 not in k for k in db.inverted.values())
    assert 1 in db.kf_bows
    m.clear()
    assert not db.kf_bows and all(not k for k in db.inverted.values())

    atlas, db = Atlas(), tdb.KeyFrameDatabase()
    atlas.set_kf_database(db)
    first = atlas.current
    for kid in range(3):
        first.add_keyframe(_mini_kf(kid))
        db.add(kid, {kid: 1.0})
    assert atlas.create_new_map().kf_db is db
    atlas.remove_map(first)
    assert not db.kf_bows
    db.add(7, {1: 1.0})
    db.erase(7)
    db.erase(7)                                          # erasing twice is harmless
    db.add(8, {1: 1.0})
    db.clear()
    assert not db.kf_bows and not db.inverted
