"""Binary visual vocabulary: flat word centroids or a two-level tree.

Port of fasttrack_tpu/bow/vocabulary.py. Replaces DBoW2::TemplatedVocabulary
(Thirdparty/DBoW2). Training is k-majority (binary k-means: Hamming
assignment, then a per-bit majority vote); tf-idf weighting and L1 scoring
follow DBoW2 (the TF_IDF / L1_NORM defaults of ORBVocabulary).

Quantization against the flat vocabulary is `_assign`, the nearest word by
Hamming distance (ROADMAP K14). On a CUDA tensor it is one launch of the
fused Hamming + top-K kernel (ops/hamming_kernel.py) at K = 1 with zero
penalties: the kernel orders equal distances by ascending column, so its
K = 1 is argmin's first index. One launch holds at most
`hamming_kernel.MAX_N` key rows (the shipped flat vocabulary's 4,096
words); `hamming_penalty_topk` quantizes a wider vocabulary in chunks of
MAX_N words, one launch each, and merges their minima on the device in word
order. On a CPU
tensor `_assign` computes the plain version at any size. The tree vocabulary is
quantized on the host (the port's native popcount library), as in the JAX
package.

The shipped vocabularies are the port's own byte-equal copies of the JAX
package's files, `orb_vocab_32k.npz` (the tree) and `orb_vocab.npz` (flat),
loaded from this directory.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch import native
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops.hamming import hamming_matrix_f32

DEFAULT_TREE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orb_vocab_32k.npz")
DEFAULT_FLAT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orb_vocab.npz")


class Vocabulary(NamedTuple):
    words_signed: np.ndarray  # (W, 256) int8 +-1 centroids
    idf: np.ndarray           # (W,) float32

    @property
    def n_words(self) -> int:
        return len(self.words_signed)

    def save(self, path: str):
        np.savez_compressed(path, words=self.words_signed, idf=self.idf)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        d = np.load(path)
        return Vocabulary(d["words"], d["idf"])


class TreeVocabulary(NamedTuple):
    """Two-level hierarchical vocabulary: B level-1 nodes, C children per
    node, B*C leaf words. Quantization is a staged Hamming argmin, one small
    matrix against the nodes, then one against the chosen node's children,
    on the host through the native popcount kernel grouped by node.
    Descriptors are stored packed (32 bytes), so a 32k-leaf vocabulary
    ships at ~1 MB."""

    nodes_packed: np.ndarray   # (B, 32) uint8
    leaves_packed: np.ndarray  # (B, C, 32) uint8
    idf: np.ndarray            # (B*C,) float32

    @property
    def n_words(self) -> int:
        return self.leaves_packed.shape[0] * self.leaves_packed.shape[1]

    def save(self, path: str):
        np.savez_compressed(
            path, nodes=self.nodes_packed, leaves=self.leaves_packed, idf=self.idf,
        )

    @staticmethod
    def load(path: str) -> "TreeVocabulary":
        d = np.load(path)
        return TreeVocabulary(d["nodes"], d["leaves"], d["idf"])


def vocabulary_checksum(vocab) -> str:
    """Stable content hash of a vocabulary's arrays: the analog of the MD5
    guard the reference writes next to a saved atlas, so that a map built
    with one vocabulary is never loaded under another (System.cc:1424-1464,
    System::CalculateCheckSum). '' for vocab None/False (no place
    recognition)."""
    if vocab is None or vocab is False:
        return ""
    h = hashlib.md5()
    if isinstance(vocab, TreeVocabulary):
        h.update(vocab.nodes_packed.tobytes())
        h.update(vocab.leaves_packed.tobytes())
    else:
        h.update(np.ascontiguousarray(vocab.words_signed).tobytes())
    return h.hexdigest()


def load_vocabulary(path: str):
    """Load either vocabulary flavor by file content."""
    d = np.load(path)
    if "nodes" in d:
        return TreeVocabulary(d["nodes"], d["leaves"], d["idf"])
    return Vocabulary(d["words"], d["idf"])


_DEFAULT_VOCAB = None


def load_default_vocabulary():
    """The shipped vocabulary (the reference always loads
    Vocabulary/ORBvoc.txt, System.cc:130-146): the 32k-leaf tree, or the
    flat 4k vocabulary where the tree's file is missing. Cached per
    process."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        if os.path.exists(DEFAULT_TREE):
            _DEFAULT_VOCAB = TreeVocabulary.load(DEFAULT_TREE)
        else:
            _DEFAULT_VOCAB = Vocabulary.load(DEFAULT_FLAT)
    return _DEFAULT_VOCAB


def _assign_reference(descs: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Plain version: argmin of the exact f32 Hamming matrix, the first
    index among equal distances. (N,) int32."""
    return torch.argmin(hamming_matrix_f32(descs, words), dim=1).to(torch.int32)


def _assign(descs: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The nearest word of every descriptor: (N, 256) and (W, 256) int8 +-1
    on one device -> (N,) int32, the lowest word index among equal
    distances. CPU tensors: the plain version. CUDA tensors: the top-K
    kernel at K = 1 with zero penalties, one launch per chunk of at most
    MAX_N words merged on the card in word order (`hamming_penalty_topk`),
    so the result is argmin's first index at any width."""
    if descs.device.type == "cpu":
        return _assign_reference(descs, words)
    descs, words = descs.contiguous(), words.contiguous()
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=descs.device)
    _, idx = hamming_kernel.hamming_penalty_topk(
        descs, words, zeros(descs.shape[0]), zeros(words.shape[0]), 1)
    return idx[:, 0].to(torch.int32)


def _assign_np(descs: np.ndarray, words: np.ndarray, device) -> np.ndarray:
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int8)).to(device)

    return _assign(up(descs), up(words)).cpu().numpy()


def train_vocabulary(
    descs_signed: np.ndarray, n_words: int = 2048, iters: int = 8, seed: int = 0,
    device=None,            # None: the card (device.resolve); "cpu" for the CPU
) -> Vocabulary:
    """k-majority clustering of +-1 descriptors; every assignment is one
    `_assign` on `device`."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    n = len(descs_signed)
    if n < n_words:
        raise ValueError(f"need >= {n_words} descriptors, got {n}")
    centers = descs_signed[rng.choice(n, n_words, replace=False)].copy()
    for _ in range(iters):
        assign = _assign_np(descs_signed, centers, device)
        # per-cluster per-bit majority vote
        sums = np.zeros((n_words, descs_signed.shape[1]), np.int32)
        np.add.at(sums, assign, descs_signed.astype(np.int32))
        counts = np.bincount(assign, minlength=n_words)
        new = np.where(sums >= 0, 1, -1).astype(np.int8)
        # keep the old center of an empty cluster
        empty = counts == 0
        new[empty] = centers[empty]
        centers = new
    # idf over the training corpus, one document per descriptor
    assign = _assign_np(descs_signed, centers, device)
    df = np.bincount(assign, minlength=n_words).astype(np.float64)
    idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32)
    return Vocabulary(centers, idf)


def _bow_from_wids(wid, valid, idf, n_words):
    sel = wid[valid] if valid is not None else wid
    if len(sel) == 0:
        return {}
    counts = np.bincount(sel, minlength=n_words).astype(np.float64)
    w = counts * idf
    s = w.sum()
    if s > 0:
        w /= s
    nz = np.nonzero(w)[0]
    return {int(i): float(w[i]) for i in nz}


def _pack_signed(descs_signed: np.ndarray) -> np.ndarray:
    return np.packbits((np.asarray(descs_signed) > 0).astype(np.uint8), axis=1)


def _host_hamming(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Packed Hamming matrix on the host: the native popcount kernel where
    the C++ library builds and loads, unpackbits otherwise (the JAX
    package's two host branches)."""
    if native.available():
        return native.hamming_matrix_packed(a_packed, b_packed)
    a = np.unpackbits(a_packed, axis=1).astype(np.int32)
    b = np.unpackbits(b_packed, axis=1).astype(np.int32)
    return (a[:, None, :] != b[None, :, :]).sum(-1)


def quantize_tree(voc: TreeVocabulary, descs_signed: np.ndarray,
                  valid: np.ndarray | None = None):
    """Staged argmin quantization: nodes first, then the winning node's
    children (grouped by node, so each group is one small Hamming matrix)."""
    if len(descs_signed) == 0:
        return np.empty(0, np.int32), {}
    packed = _pack_signed(descs_signed)
    d1 = _host_hamming(packed, voc.nodes_packed)     # (N, B)
    nid = d1.argmin(1)
    C = voc.leaves_packed.shape[1]
    wid = np.empty(len(packed), np.int32)
    for b in np.unique(nid):
        sel = nid == b
        d2 = _host_hamming(packed[sel], voc.leaves_packed[b])
        wid[sel] = b * C + d2.argmin(1).astype(np.int32)
    return wid, _bow_from_wids(wid, valid, voc.idf, voc.n_words)


def quantize(voc, descs_signed: np.ndarray, valid: np.ndarray | None = None,
             device=None):
    """Descriptors -> (word_ids (N,), bow dict word -> tf-idf weight).

    The bow vector is L1-normalized (DBoW2 L1_NORM). A tree vocabulary is
    quantized on the host, a flat one by `_assign` on `device` (None: the
    card)."""
    if isinstance(voc, TreeVocabulary):
        return quantize_tree(voc, descs_signed, valid)
    if len(descs_signed) == 0:
        return np.empty(0, np.int32), {}
    wid = _assign_np(descs_signed, voc.words_signed, resolve(device))
    return wid, _bow_from_wids(wid, valid, voc.idf, voc.n_words)


def train_tree_vocabulary(
    descs_signed: np.ndarray, branches: int = 64, children: int = 512,
    iters: int = 8, seed: int = 0,
    device=None,            # None: the card (device.resolve); "cpu" for the CPU
) -> TreeVocabulary:
    """Hierarchical k-majority: coarse clustering into `branches` nodes,
    then an independent k-majority per node over its assigned descriptors
    (the same recursive construction as DBoW2's k-means++ tree)."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    coarse = train_vocabulary(descs_signed, n_words=branches, iters=iters, seed=seed,
                              device=device)
    nid = _assign_np(descs_signed, coarse.words_signed, device)
    leaves = np.empty((branches, children, descs_signed.shape[1]), np.int8)
    for b in range(branches):
        sub = descs_signed[nid == b]
        if len(sub) >= children:
            leaves[b] = train_vocabulary(
                sub, n_words=children, iters=iters, seed=seed + b + 1, device=device,
            ).words_signed
        else:
            # thin node: its descriptors become leaves; the rest of the
            # block is filled with random words (never closest in practice)
            fill = (2 * rng.integers(0, 2, (children - len(sub), descs_signed.shape[1])) - 1)
            leaves[b] = np.concatenate([sub, fill.astype(np.int8)])
    voc = TreeVocabulary(
        _pack_signed(coarse.words_signed),
        _pack_signed(leaves.reshape(-1, leaves.shape[-1])).reshape(branches, children, 32),
        np.ones(branches * children, np.float32),
    )
    # idf over the training corpus through the tree itself
    wid, _ = quantize_tree(voc, descs_signed)
    df = np.bincount(wid, minlength=voc.n_words).astype(np.float64)
    idf = np.log(len(descs_signed) / np.maximum(df, 1.0)).astype(np.float32)
    return TreeVocabulary(voc.nodes_packed, voc.leaves_packed, idf)


def l1_score(v1: dict, v2: dict) -> float:
    """DBoW2 L1 score between L1-normalized bow vectors:
    s = 1 - 0.5 * |v1 - v2|_1 in [0, 1]; computed sparsely."""
    if not v1 or not v2:
        return 0.0
    score = 0.0
    for w, x in v1.items():
        y = v2.get(w)
        if y is not None:
            score += abs(x) + abs(y) - abs(x - y)
    return 0.5 * score


def make_random_vocabulary(n_words: int = 2048, seed: int = 7) -> Vocabulary:
    """A deterministic random vocabulary for bootstrapping (usable before
    any training data exists; words are random +-1 vectors, uniform idf)."""
    rng = np.random.default_rng(seed)
    words = (2 * rng.integers(0, 2, size=(n_words, 256)) - 1).astype(np.int8)
    return Vocabulary(words, np.ones(n_words, np.float32))
