"""The port's fused Hamming+penalty+top-K against the JAX package.

What the kernel replaces is `lax.top_k(-hamming_penalty_matrix(...), 64)`.
The plain version is held against exactly that, with the Pallas kernel in
interpret mode on the CPU (tile-aligned shapes, zero rows among them) or
the XLA expression (ragged shapes, N < K). Distances are exact integers in
f32 and the penalties are added in the same order, so values AND indices
must be equal: ties go to the lower column on both sides. The CUDA kernel
itself runs only on a GPU (the `cuda` tests below), where it must equal the
plain version bit for bit; on the CPU its launch plan is checked against
the card's limits and against the source's constants, and a NumPy model of
its selection order (a row's columns 32 at a time, the threshold filter,
the buffer's merges, the merge of split parts, the K <= 2 path) against
the plain version.
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke

from fasttrack_tpu.ops.hamming import hamming_matrix_f32 as jax_hamming_f32
from fasttrack_tpu.ops.pallas_kernels import hamming_penalty_matrix as jax_pallas
from fasttrack_tpu_torch.ops import cuda_build
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops.hamming_kernel import (
    MAX_K,
    MAX_N,
    PATH_LIST,
    hamming_penalty_topk,
    hamming_penalty_topk_reference,
    topk_launch_plan,
    topk_plan,
)

TOP_K = 64
BIG = np.float32(1e9)


def descriptors(rng, n, distinct=None):
    """(n, 256) +-1 int8; with `distinct`, rows drawn from that few
    descriptors, so that most distances tie."""
    if distinct is None:
        return (2 * rng.integers(0, 2, (n, 256)) - 1).astype(np.int8)
    base = (2 * rng.integers(0, 2, (distinct, 256)) - 1).astype(np.int8)
    return base[rng.integers(0, distinct, n)]


def make_case(rng, name):
    """(q, k, q_pen, k_pen) of one named case."""
    zeros = lambda n: np.zeros(n, np.float32)
    if name == "128x128":
        return descriptors(rng, 128), descriptors(rng, 128), zeros(128), zeros(128)
    if name == "256x384":
        return descriptors(rng, 256), descriptors(rng, 384), zeros(256), zeros(384)
    if name == "ties":
        return descriptors(rng, 128, 3), descriptors(rng, 256, 3), zeros(128), zeros(256)
    if name == "penalties":  # 1e9 rounds the sum: the add order is part of the result
        pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
        return (descriptors(rng, 128, 5), descriptors(rng, 256, 5),
                rng.choice(pens, 128).astype(np.float32), rng.choice(pens, 256).astype(np.float32))
    if name == "taken":      # the matchers' penalties: validity, and validity + taken
        q_valid, k_valid = rng.random(256) > 0.1, rng.random(128) > 0.1
        taken = rng.random(128) < 0.3
        return (descriptors(rng, 256), descriptors(rng, 128),
                ((1 - q_valid) * BIG).astype(np.float32),
                ((1 - k_valid) * BIG + taken * BIG).astype(np.float32))
    raise ValueError(name)


def torch_args(q, k, qp, kp, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (q, k, qp, kp))


def assert_equals_lax_top_k(dm_jax, args, k=TOP_K):
    neg, idx = jax.lax.top_k(-dm_jax, min(k, dm_jax.shape[1]))
    values, indices = hamming_penalty_topk_reference(*torch_args(*args), k)
    assert indices.dtype == torch.int64 and values.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(idx))


@pytest.mark.parametrize("case", ["128x128", "256x384", "ties", "penalties", "taken"])
def test_reference_equals_top_k_of_pallas_kernel(rng, case):
    args = make_case(rng, case)
    q, k, qp, kp = (jnp.asarray(a) for a in args)
    assert_equals_lax_top_k(jax_pallas(q, k, qp, kp, interpret=True), args)


@pytest.mark.parametrize("shape", [(200, 136), (50, 40)], ids=["ragged", "n_below_k"])
def test_reference_equals_top_k_of_xla_expression(rng, shape):
    M, N = shape
    pens = np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32)
    args = (descriptors(rng, M, 7), descriptors(rng, N, 7),
            rng.choice(pens, M).astype(np.float32), rng.choice(pens, N).astype(np.float32))
    q, k, qp, kp = (jnp.asarray(a) for a in args)
    assert_equals_lax_top_k(jax_hamming_f32(q, k) + qp[:, None] + kp[None, :], args)
    values, indices = hamming_penalty_topk_reference(*torch_args(*args), TOP_K)
    assert values.shape == indices.shape == (M, min(TOP_K, N))


def test_values_ascend_and_ties_take_the_lower_column(rng):
    args = torch_args(*make_case(rng, "ties"))
    values, indices = hamming_penalty_topk_reference(*args, TOP_K)
    v, i = values.numpy(), indices.numpy()
    assert (np.diff(v, axis=1) >= 0).all()
    tied = np.diff(v, axis=1) == 0
    assert tied.mean() > 0.5                      # the case does tie
    assert (np.diff(i, axis=1)[tied] > 0).all()


def test_cpu_tensor_takes_plain_path(rng):
    args = torch_args(*make_case(rng, "penalties"))
    before = hamming_penalty_topk.launches
    values, indices = hamming_penalty_topk(*args, TOP_K)
    assert hamming_penalty_topk.launches == before  # no kernel launched
    want_v, want_i = hamming_penalty_topk_reference(*args, TOP_K)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.parametrize("bad", ["q_dtype", "k_width", "pen_length", "pen_dtype", "k_zero"])
def test_wrapper_rejects_malformed_inputs(rng, bad):
    q, k, qp, kp = torch_args(*make_case(rng, "128x128"))
    top = TOP_K
    if bad == "q_dtype":
        q = q.float()
    elif bad == "k_width":
        k = k[:, :128]
    elif bad == "pen_length":
        qp = qp[:-1]
    elif bad == "pen_dtype":
        kp = kp.double()
    else:
        top = 0
    with pytest.raises(ValueError):
        hamming_penalty_topk(q, k, qp, kp, top)


def test_kernel_limits_and_source():
    assert (MAX_K, MAX_N) == (64, 4096)  # the tracker's K, and 4x its widest key side
    source = cuda_build.CSRC_DIR / "hamming_topk.cu"
    assert source.is_file()
    assert cuda_build.library_path(source).stem.startswith("hamming_topk-")


# The launch plans that run: every shape phase 3 of chip_smoke.py holds, and
# the callers' (the matchers' 1024 x 1024 and 4096 x 1024 at K = 64,
# match_fisheye's K = 2, _assign's 4,096 words and the 904 of a 5,000-word
# vocabulary's second chunk at K = 1, the triangulation's 10240 x 1024, and
# KITTI's widths), plus both CTA sizes at the widest key side.
PLAN_SHAPES = sorted({(M, N, min(K, N)) for M, N, _, K in chip_smoke.TOPK_CASES}
                     | {(1024, 904, 1), (10240, 1024, 64), (20480, 2048, 64), (1, 1, 1)})


def paths_of(K):
    """The paths a K can take: the list path takes any K, and K <= 2 has
    its own."""
    return (PATH_LIST,) if K > 2 else (K - 1, PATH_LIST)


def plans_of(M, N, K):
    return [topk_launch_plan(M, N, K)] + [topk_plan(M, N, K, path, 8) for path in paths_of(K)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_fits_the_card(shape):
    """Shared memory within a block's 232,448 B and two CTAs to an SM,
    bounded whatever N is; the grid covers every row and tile, the strips
    every tile of a part; the K path."""
    M, N, K = shape
    n_tiles = -(-N // hamming_kernel.TOPK_TILE_KEYS)
    for plan in plans_of(M, N, K):
        assert plan.shared_bytes <= hamming_kernel.BLOCK_SHARED_LIMIT
        assert plan.ctas_per_sm >= 2
        assert plan.grid_x * plan.rows >= M > (plan.grid_x - 1) * plan.rows
        assert plan.split * plan.part_tiles >= n_tiles
        widest = topk_plan(1, MAX_N, 1 if plan.path == 0 else 2, plan.path, 1)
        assert plan.shared_bytes <= widest.shared_bytes
        if plan.path == PATH_LIST:
            strips = -(-plan.part_tiles // plan.strip_tiles)
            assert 0 < plan.strip_tiles <= hamming_kernel.TOPK_MAX_STRIP_TILES
            assert (strips - 1) * plan.strip_tiles < plan.part_tiles
        else:
            assert plan.strip_tiles == 0
    plan = topk_launch_plan(M, N, K)   # its own split leaves no part empty
    assert plan.path == {1: 0, 2: 1}.get(K, PATH_LIST)
    assert (plan.split - 1) * plan.part_tiles < n_tiles


def test_launch_plan_mirrors_the_source():
    """The constants the wrapper plans with are the kernel's, and so is its
    shared-memory size for every path and CTA size (the kernel refuses a
    plan whose bytes differ)."""
    src = (cuda_build.CSRC_DIR / "hamming_topk.cu").read_text()
    const = {name: int(value) for name, value in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kTileKeys"] == hamming_kernel.TOPK_TILE_KEYS
    assert const["kStages"] == hamming_kernel.TOPK_STAGES
    assert const["kListWarps"] == hamming_kernel.TOPK_LIST_WARPS == hamming_kernel.TOPK_LIST_ROWS
    assert const["kPairWarps"] == hamming_kernel.TOPK_PAIR_WARPS
    assert 16 * const["kPairWarps"] == hamming_kernel.TOPK_PAIR_ROWS
    assert const["kMaxStripTiles"] == hamming_kernel.TOPK_MAX_STRIP_TILES
    assert const["kStripPad"] == hamming_kernel.TOPK_STRIP_PAD
    assert const["kQueryStride"] == hamming_kernel.TOPK_QUERY_STRIDE
    assert const["kList"] == MAX_K and const["kMaxN"] == MAX_N
    assert const["kMaxSplit"] == hamming_kernel.TOPK_MAX_SPLIT
    assert (const["kPathK1"], const["kPathK2"], const["kPathList"]) == (0, 1, 2)
    rows = const["kListWarps"]
    for strip_tiles in range(1, const["kMaxStripTiles"] + 1):
        strip = rows * (strip_tiles * const["kTileKeys"] + const["kStripPad"]) * 4
        assert hamming_kernel.topk_shared_bytes(PATH_LIST, strip_tiles) == (
            strip + rows * (const["kList"] * 8 + const["kQueryStride"]))
    keys = const["kStages"] * const["kTileKeys"] * (256 + 4)
    for path in (0, 1):
        assert hamming_kernel.topk_shared_bytes(path) == keys + 16 * const["kPairWarps"] * 2 * 8


SENTINEL = np.uint64(2**64 - 1)


def model_keys(q, k, qp, kp):
    """(M, N) uint64 keys: the order-preserving image of each f32 value
    (computed as the plain version does) << 32 | column."""
    dot = q.astype(np.int64) @ k.astype(np.int64).T
    values = ((256 - dot).astype(np.float32) * np.float32(0.5) + qp[:, None]) + kp[None, :]
    u = values.astype(np.float32).view(np.uint32).astype(np.uint64)
    order = np.where(u >> np.uint64(31) == 1, u ^ np.uint64(0xFFFFFFFF), u ^ np.uint64(0x80000000))
    return (order << np.uint64(32)) | np.arange(k.shape[0], dtype=np.uint64)[None, :]


def kernel_model(q, k, qp, kp, top, plan):
    """The kernel's selection, step for step, on NumPy keys, per row and
    part of the key side. The list path, strip by strip: while the row's
    list holds fewer than K keys, the largest of the lanes' second best
    values of the strip bounds the threshold; then 32 columns at a time, keys
    before the threshold go to the row's buffer, and each 32 buffered keys
    merge into its 64-key list (the rest at the part's end), the threshold
    then the list's K-th key. K <= 2: each quad lane keeps the best of its
    own columns, the quad merges them. Then the parts merge pairwise in
    the cluster's tree. Returns (values, indices, merges)."""
    M, N = q.shape[0], k.shape[0]
    K = min(top, N)
    keys = model_keys(q, k, qp, kp)
    tile = hamming_kernel.TOPK_TILE_KEYS
    out = np.empty((M, K), np.uint64)
    merges = 0
    for r in range(M):
        parts = []
        for part in range(plan.split):
            c_begin, c_end = part * plan.part_tiles * tile, min((part + 1) * plan.part_tiles * tile, N)
            cols = np.arange(c_begin, max(c_begin, c_end))
            if plan.path == PATH_LIST:
                lst, buf = np.array([], np.uint64), []
                thr = SENTINEL

                def merge(n):
                    nonlocal lst, buf, merges
                    lst = np.sort(np.concatenate([lst, np.array(buf[:n], np.uint64)]))[:MAX_K]
                    buf, merges = buf[n:], merges + 1

                for s0 in range(c_begin, c_end, plan.strip_tiles * tile):
                    strip = keys[r, s0:min(s0 + plan.strip_tiles * tile, c_end)]
                    if thr == SENTINEL:   # the lanes' second best values bound it
                        second = [np.sort(strip[lane::32] >> np.uint64(32))[1]
                                  if len(strip[lane::32]) > 1 else None for lane in range(32)]
                        if None not in second:
                            thr = (max(second) + np.uint64(1)) << np.uint64(32)
                    for c0 in range(0, len(strip), 32):
                        chunk = strip[c0:c0 + 32]
                        buf.extend(chunk[chunk < thr])
                        assert len(buf) <= MAX_K
                        if len(buf) >= 32:
                            merge(32)
                            thr = min(thr, lst[K - 1] if len(lst) >= K else SENTINEL)
                if buf:
                    merge(len(buf))
                parts.append(lst)
            else:
                lane_best = [np.sort(keys[r, cols[(cols % 8) // 2 == lane]])[:K]
                             for lane in range(4)]
                parts.append(np.sort(np.concatenate(lane_best))[:K])
        step = 1
        while step < plan.split:
            for rank in range(0, plan.split - step, 2 * step):
                parts[rank] = np.sort(np.concatenate([parts[rank], parts[rank + step]]))[:MAX_K]
            step *= 2
        out[r] = parts[0][:K]
    hi = (out >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi >> np.uint32(31) == 1, hi ^ np.uint32(0x80000000), hi ^ np.uint32(0xFFFFFFFF))
    return u.view(np.float32), (out & np.uint64(0xFFFFFFFF)).astype(np.int64), merges


def model_case(rng, kind, M=70, N=300):
    """Small inputs of phase 3's kinds: ragged (N not a multiple of the
    tile), tied, validity (1e9 penalties), zeros (zero rows under 1e9
    penalties, fewer than 64 valid keys)."""
    if kind == "zeros":
        return tuple(t.numpy() for t in chip_smoke.kernel_inputs(rng, M, N, "cpu", "zeros"))
    name = {"ragged": "random"}.get(kind, kind)
    return tuple(t.numpy() for t in chip_smoke.kernel_inputs(rng, M, N, "cpu", name))


@pytest.mark.parametrize("top", [1, 2, 3, 64])
@pytest.mark.parametrize("kind", ["ragged", "tied", "validity", "zeros"])
def test_kernel_model_equals_plain(rng, kind, top):
    """The kernel's selection order gives the plain version's values and
    indices, with its own plan and on each path that takes K with the key
    side split 2 and 8 ways (at 70 x 300: 5 tiles, the last parts empty)."""
    args = model_case(rng, kind)
    want_v, want_i = hamming_penalty_topk_reference(*(torch.from_numpy(a) for a in args), top)
    M, N = args[0].shape[0], args[1].shape[0]
    K = min(top, N)
    plans = [topk_launch_plan(M, N, K)] + [topk_plan(M, N, K, path, split)
                                          for path in paths_of(K) for split in (2, 8)]
    for plan in plans:
        values, indices, merges = kernel_model(*args, top, plan)
        np.testing.assert_array_equal(values, want_v.numpy())
        np.testing.assert_array_equal(indices, want_i.numpy())
        if plan.path == PATH_LIST:   # every row merges in every part with keys
            parts = -(-(-(-N // hamming_kernel.TOPK_TILE_KEYS)) // plan.part_tiles)
            assert merges >= M * parts


def test_reference_equals_top_k_of_pallas_kernel_on_zero_rows(rng):
    """Zero rows on both sides under 1e9 penalties and fewer valid keys
    than K: the plain version (which the kernel equals) puts a zero row at
    distance 128, as the Pallas kernel does, so the penalised slots that
    reach the output read 1e9 + 128 (a kernel reading signs saw 1e9 + 64)."""
    args = model_case(rng, "zeros", M=128, N=256)
    q, k, qp, kp = (jnp.asarray(a) for a in args)
    assert_equals_lax_top_k(jax_pallas(q, k, qp, kp, interpret=True), args)
    values, _ = hamming_penalty_topk_reference(*torch_args(*args), TOP_K)
    assert (values == 1e9 + 128).any()
    assert not (values == 1e9 + 64).any()


@pytest.mark.parametrize("top", [64, 2, 1])
@pytest.mark.parametrize("N", [5000, 4100])
def test_chunk_merge_equals_plain_past_max_n(rng, N, top):
    """ROADMAP F46: past MAX_N keys the card launches once per chunk of at
    most MAX_N keys, at K_c = min(K, chunk width), and merges the chunks'
    lists (`merge_topk_chunks`). Fed the plain version's per-chunk lists it
    equals the plain version over the whole key side, values and indices,
    with rows drawn from 5 descriptors (ties inside both chunks), 32 queries
    whose exact keys lie past MAX_N only, 8 of them also in the first chunk
    (ties across the chunks), zero query rows and zero keys under 1e9
    penalties; at N = 4,100 the last chunk (4 keys) is narrower than
    K = 64."""
    pens = np.asarray([0.0, 0.5, BIG], np.float32)
    q, k = descriptors(rng, 300, 5), descriptors(rng, N, 5)
    q[:32] = descriptors(rng, 32)
    k[MAX_N:MAX_N + 32] = q[:32][:N - MAX_N]
    k[100:108] = q[:8]
    q[40:70] = 0
    k[200:240] = 0
    args = torch_args(q, k, rng.choice(pens, 300).astype(np.float32),
                      rng.choice(pens, N).astype(np.float32))
    qd, kd, qp, kp = args
    parts = [(*hamming_penalty_topk_reference(qd, kd[c0:c0 + MAX_N], qp, kp[c0:c0 + MAX_N],
                                              min(top, N - c0, MAX_N)), c0)
             for c0 in range(0, N, MAX_N)]
    assert len(parts) == 2 and parts[-1][0].shape[1] == min(top, N - MAX_N)
    values, indices = hamming_kernel.merge_topk_chunks(parts, top)
    want_v, want_i = hamming_penalty_topk_reference(*args, top)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)
    assert (want_i >= MAX_N).any() and (want_v == 128).any()
    # the wrapper on CPU tensors takes any N (the plain version)
    got_v, got_i = hamming_penalty_topk(*args, top)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(1024, 1024), (2048, 1024), (4096, 1024), (1200, 1000), (33, 40), (64, 4096)]
)
def test_kernel_equals_plain_on_gpu(rng, cuda_device, shape):
    M, N = shape
    pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
    args = torch_args(descriptors(rng, M, 9), descriptors(rng, N, 9),
                      rng.choice(pens, M).astype(np.float32),
                      rng.choice(pens, N).astype(np.float32), device=cuda_device)
    before = hamming_penalty_topk.launches
    values, indices = hamming_penalty_topk(*args, TOP_K)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches == before + 1
    want_v, want_i = hamming_penalty_topk_reference(*args, TOP_K)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 900)])
def test_match_fisheye_launches_the_kernel_with_k_2_on_gpu(rng, cuda_device, shape):
    """K = 2 with validity penalties, as match_fisheye calls the kernel: rows
    whose query is invalid tie at 1e9 across all columns."""
    from fasttrack_tpu_torch.ops.stereo_match import match_fisheye

    M, N = shape
    l_desc, r_desc = descriptors(rng, M, 9), descriptors(rng, N, 9)
    l_valid, r_valid = rng.random(M) > 0.2, rng.random(N) > 0.2
    on = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (l_desc, l_valid, r_desc, r_valid)]
    before = hamming_penalty_topk.launches_by_k[2]
    got = match_fisheye(*on)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[2] == before + 1
    want = match_fisheye(*(t.cpu() for t in on))      # the plain version, on the CPU
    assert torch.equal(got.idx_right.cpu(), want.idx_right)
    assert torch.equal(got.valid.cpu(), want.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 4096), (700, 64)])
def test_vocabulary_assign_launches_the_kernel_with_k_1_on_gpu(rng, cuda_device, shape):
    """K = 1 with zero penalties, as the flat vocabulary's `_assign` calls the
    kernel (4096 words at most, MAX_N): the word of every descriptor equals
    the plain argmin's first index, and so does the distance, with rows
    drawn from few descriptors so that most of them tie."""
    from fasttrack_tpu_torch.bow.vocabulary import _assign, _assign_reference

    M, N = shape
    descs = torch.from_numpy(descriptors(rng, M, 7)).to(cuda_device)
    words = torch.from_numpy(descriptors(rng, N, 5)).to(cuda_device)
    before = hamming_penalty_topk.launches_by_k[1]
    got = _assign(descs, words)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[1] == before + 1
    assert torch.equal(got.cpu(), _assign_reference(descs.cpu(), words.cpu()))
    zeros_q, zeros_k = torch.zeros(M, device=cuda_device), torch.zeros(N, device=cuda_device)
    values, indices = hamming_penalty_topk(descs, words, zeros_q, zeros_k, 1)
    want_v, want_i = hamming_penalty_topk_reference(descs, words, zeros_q, zeros_k, 1)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.cuda
def test_vocabulary_assign_chunks_a_wide_vocabulary_on_gpu(rng, cuda_device):
    """5,000 words, wider than the kernel's MAX_N: one K = 1 launch per chunk
    of at most 4,096 words, merged on the card; the words equal the plain
    argmin's first index, with rows tied inside and across the chunks and
    exact words only in the second chunk."""
    from fasttrack_tpu_torch.bow.vocabulary import _assign, _assign_reference
    from fasttrack_tpu_torch.ops.hamming_kernel import MAX_N

    M, N = 1024, 5000
    descs = descriptors(rng, M, 7)
    words = descriptors(rng, N, 5)
    words[MAX_N:MAX_N + 8] = descs[:8]
    words[4800:4808] = descs[:8]
    descs_t, words_t = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                        for a in (descs, words))
    before = hamming_penalty_topk.launches_by_k[1]
    got = _assign(descs_t, words_t)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[1] == before + 2
    want = _assign_reference(descs_t.cpu(), words_t.cpu())
    assert torch.equal(got.cpu(), want) and (want >= MAX_N).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1024, 4096, "tied", 64), (1024, 4096, "validity", 2),
                                  (1024, 1024, "zeros", 64), (300, 1000, "zeros", 2),
                                  (70, 300, "random", 3)])
def test_kernel_equals_plain_at_the_new_cases_on_gpu(rng, cuda_device, case):
    """Ties across strips at the widest N, the K <= 2 path at the widest
    N, zero rows, with the default plan and on every path that takes K with
    every split (the launch plan swapped for the call)."""
    M, N, kind, K = case
    args = chip_smoke.kernel_inputs(rng, M, N, cuda_device, kind)
    want_v, want_i = hamming_penalty_topk_reference(*args, K)
    plans = [None] + [topk_plan(M, N, min(K, N), path, split)
                      for path in paths_of(K) for split in (1, 2, 4, 8)]
    default = hamming_kernel.topk_launch_plan
    try:
        for plan in plans:
            if plan is not None:
                hamming_kernel.topk_launch_plan = lambda *_, plan=plan: plan
            values, indices = hamming_penalty_topk(*args, K)
            torch.cuda.synchronize()
            assert torch.equal(values, want_v) and torch.equal(indices, want_i), plan
    finally:
        hamming_kernel.topk_launch_plan = default


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1024, 5000, "random", 64), (1024, 5000, "random", 2),
                                  (1024, 5000, "tied", 64), (300, 4100, "zeros", 64)])
def test_kernel_takes_a_key_side_past_max_n_on_gpu(rng, cuda_device, case):
    """F46 on the card: one launch per chunk of MAX_N keys, merged on the
    card, equal to the plain version."""
    M, N, kind, K = case
    args = chip_smoke.kernel_inputs(rng, M, N, cuda_device, kind)
    before = hamming_penalty_topk.launches
    values, indices = hamming_penalty_topk(*args, K)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches == before + 2
    want_v, want_i = hamming_penalty_topk_reference(*args, K)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)
