// Hamming distance plus rank-1 penalties, reduced to the K best columns of
// every row, in one kernel.
//
// Replaces fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix (the
// Pallas TPU kernel) together with the jax.lax.top_k that every matcher of
// the tracker applies to its result: for q (M, 256) and k (N, 256) int8,
// q_pen (M,) and k_pen (N,) float32, and K <= 64, K <= N <= 4096,
//
//     d[i, j]        = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]
//     values[i, :]   = the K smallest d[i, :], ascending
//     indices[i, :]  = their columns; equal values by ascending column
//
// which is lax.top_k(-d, K) with the sign folded back, bit for bit, for any
// int8 entries: like the Pallas kernel it multiplies values, so a zero row
// is at distance 128 from everything (for +-1 entries the first term is the
// Hamming distance). The (M, N) matrix never reaches device memory.
//
// What bounds it on an H100: not bytes. It reads (M + N) * 256 B and writes
// M * K * 12 B. Its M * N * 256 int8 products are tensor-core work, and the
// selection is integer work whose serial part, a 64-key list's merges, is a
// chain of dependent warp shuffles per row. Selection is exact and stable:
// a candidate is the 64-bit key (order-preserving integer image of the f32
// value) << 32 | column, so all keys of a row differ and "the K smallest
// keys, ascending" is the stable order. One launch, nothing packed, no
// scratch; the shared-memory attribute is set once per process and device.
// Two paths, by K (the wrapper's launch plan picks one):
//   - K > 2, the list path. A CTA is 16 warps and owns 16 query rows, one
//     per warp, so that as many rows are in flight as the first version
//     had, and twice as many per SM. Its part of the key side goes through
//     a shared-memory strip of up to 1,024 columns: every warp computes
//     8-column tiles of the 16 x strip distances with int8 mma.sync
//     (m16n8k32, s32 accumulators, exact; query rows from shared memory,
//     key fragments as 16-byte loads straight from L2, in the matrix
//     kernel's order of positions) and writes the f32 values there; then
//     each warp selects its row from the strip, much as the first version
//     did: lanes take 32 consecutive columns, a key passes only below the
//     row's threshold, passing keys are appended by ballot to a 64-slot
//     buffer, and every 32 buffered keys merge into the row's sorted 64-key
//     list, two keys a lane (a bitonic sort of the 32 and a bitonic merge,
//     by warp shuffles), after which the list's K-th key is the threshold.
//     The merges are the serial part, so two things cut their number: the
//     first threshold is a bound from the strip itself (each lane's second
//     best value; 64 keys lie at or below the largest of these), so that
//     the first 64 columns no longer all pass; and a merge takes 32 keys,
//     not up to 64, so the threshold follows sooner. Where the rows alone
//     cannot fill the card the key side is split over a cluster of 2, 4 or
//     8 CTAs (grid y), and the parts' lists merge through distributed shared
//     memory, a bitonic merge of two sorted lists per level;
//   - K <= 2 keeps no list. A CTA is one warpgroup of 64 query rows whose
//     A fragments stay in registers; 64 x 64 distance tiles are eight
//     wgmma m64n64k32 s8 products over key tiles streamed through shared
//     memory (the no-swizzle K-major layout of 8 x 16-byte core matrices,
//     cp.async, double buffered). In the accumulator a row's 8 columns of
//     an n-chunk lie in one quad of lanes: each lane keeps its best one or
//     two (value, column) pairs of each of its two rows in registers, then
//     a quad reduction and the cluster's merge, as on the list path;
//   - a value is exact f32 arithmetic (the accumulator goes to float by a
//     magic-number add), added to q_pen first, then k_pen, in the Pallas
//     and XLA order (with 1e9 penalties the sum rounds, so the order is
//     part of the result); ragged M and N are masked here.
// The launch plan (the path, the split of the key side, its part and strip
// lengths in tiles of 64 keys, the shared-memory bytes) is computed by the
// Python wrapper (ops/hamming_kernel.py:topk_launch_plan) and checked here.
//
// The first version of this kernel (two launches) packed both operands to
// sign bits in a pre-pass into a scratch buffer, counted distances with
// XOR + POPC (a quarter-rate instruction, 8 per pair), gave each query row
// one warp with the whole key side copied into every block's shared memory
// (144 KiB at N = 4096, so one block of 8 warps an SM), and merged every 32
// passing keys into a 64-key list, also at K = 1. Reading only signs, it
// put a zero row at Hamming 0 from +1 entries, where the Pallas kernel puts
// it at 128. Its one-warp-a-row selection is kept here: a redesign that
// fed wgmma tiles to lists spread over quads of lanes, flushed by the whole
// CTA at once, was slower at every K = 64 shape. NaN penalties are outside
// the contract, as for the sort they replace.

#include <cooperative_groups.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowWords = 64;          // an int8 descriptor row is 64 x uint32
constexpr int kRowChunks = 16;         // and 16 chunks of 16 bytes
constexpr int kTileKeys = 64;          // the plan's unit of the key side
constexpr int kList = 64;              // keys kept per row (MAX_K), and a buffer's slots
constexpr int kMaxN = 4096;
constexpr int kMaxSplit = 8;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kSentinel = ~0ull;  // above every real key

// The K paths, as the wrapper numbers them.
constexpr int kPathK1 = 0;
constexpr int kPathK2 = 1;
constexpr int kPathList = 2;

// The list path: 16 warps, one query row each (one mma m-tile), and a
// strip of up to 16 tiles of distances, a row's stride 8 words more than
// the strip so that the fragments' 8-byte writes spread over all banks;
// query rows 320 bytes apart, so that a quarter warp's 16-byte reads of
// two rows fall in different banks.
constexpr int kListWarps = 16;
constexpr int kListThreads = 32 * kListWarps;
constexpr int kListRows = kListWarps;
constexpr int kMaxStripTiles = 16;
constexpr int kStripPad = 8;
constexpr int kQueryStride = 320;
__host__ __device__ constexpr int list_strip_words(int strip_tiles) {
  return kListRows * (strip_tiles * kTileKeys + kStripPad);
}
__host__ __device__ constexpr int list_shared_bytes(int strip_tiles) {
  return list_strip_words(strip_tiles) * 4 + kListRows * (kList * 8 + kQueryStride);
}

// The K <= 2 paths: one warpgroup, 64 query rows (rows g and g + 8 of each
// warp's 16), key tiles of 64 keys, two in flight; then per row a best pair.
constexpr int kPairWarps = 4;
constexpr int kPairThreads = 32 * kPairWarps;
constexpr int kPairRows = 16 * kPairWarps;
constexpr int kStages = 2;
constexpr int kStepKeys = 16;          // keys of one selection step: two n-chunks
constexpr int kKeyTileBytes = kTileKeys * 256;
constexpr int kKeyBytes = kStages * kKeyTileBytes;
constexpr int kPenBytes = kStages * kTileKeys * 4;
constexpr int kPairsOff = kKeyBytes + kPenBytes;
constexpr int kPairSharedBytes = kPairsOff + kPairRows * 2 * 8;

typedef unsigned long long Key;

extern __shared__ __align__(128) unsigned char topk_smem[];

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory writes of this thread (cp.async included) become visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of a K-major, unswizzled wgmma operand at `p`: 8 x 16-byte
// core matrices of 128 contiguous bytes, the next along K 128 bytes on (the
// leading byte offset), the next 8 rows 2048 bytes on (the stride byte
// offset: 16 core matrices of one row block's 256 bytes).
__device__ __forceinline__ uint64_t tile_descriptor(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(2048 >> 4) << 32);
}

// d (64 x 64 per warpgroup, s32) = or += A (registers) * B (descriptor).
__device__ __forceinline__ void wgmma_64x64x32(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (16x8, s32) += A (16x32, s8, row) * B (32x8, s8, col).
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// f32 -> uint32 with the same order (and back).
__device__ __forceinline__ uint32_t orderable(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_orderable(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// (256 - dot) * 0.5 + qp + kp as the plain version computes it. |dot| <=
// 2^22, so 1.5 * 2^23 + dot is exact in f32 and its bits are those of the
// integer 0x4B400000 + dot: float(dot) without a conversion instruction;
// the half and the 128 are exact too.
__device__ __forceinline__ float distance(int dot, float qp, float kp) {
  const float f = __fsub_rn(__int_as_float(0x4B400000 + dot), 12582912.0f);
  return __fadd_rn(__fadd_rn(fmaf(f, -0.5f, 128.0f), qp), kp);
}

__device__ __forceinline__ Key make_key(float v, int col) {
  return (static_cast<Key>(orderable(v)) << 32) | static_cast<Key>(static_cast<uint32_t>(col));
}

// (v, c) before (bv, bc) in the order of the keys (values are never -0).
__device__ __forceinline__ bool before(float v, int c, float bv, int bc) {
  return v < bv || (v == bv && c < bc);
}

__device__ __forceinline__ Key key_min(Key a, Key b) { return a < b ? a : b; }
__device__ __forceinline__ Key key_max(Key a, Key b) { return a < b ? b : a; }

__device__ __forceinline__ void write_key(float* values, long long* indices, size_t at, Key key) {
  values[at] = from_orderable(static_cast<uint32_t>(key >> 32));
  indices[at] = static_cast<long long>(key & 0xffffffffull);
}

// ---- the list path ----

// One compare-exchange step of a bitonic network over 64 keys held two per
// lane (key i in lane i % 32, slot i / 32), for a stride j < 32: the partner
// is the same slot of lane ^ j. `up` says whether this key's pair sorts
// ascending.
__device__ __forceinline__ Key exchange(Key v, int j, int lane, bool up) {
  const Key other = __shfl_xor_sync(kFullMask, v, j);
  const bool keep_min = ((lane & j) == 0) == up;
  return (v < other) == keep_min ? v : other;
}

// (t0, t1) <- the 64 smallest of the sorted list (t0, t1) and the sorted
// 64 keys (b0, b1), ascending: min(t[i], b[63 - i]) holds them and is
// bitonic, and half-cleaners sort it. Every lane of the warp calls it.
__device__ __forceinline__ void merge_sorted(Key& t0, Key& t1, Key b0, Key b1, int lane) {
  const Key r0 = __shfl_sync(kFullMask, b1, 31 - lane);  // b[63 - lane]
  const Key r1 = __shfl_sync(kFullMask, b0, 31 - lane);  // b[31 - lane]
  t0 = key_min(t0, r0);
  t1 = key_min(t1, r1);
  if (t0 > t1) {
    const Key x = t0;
    t0 = t1;
    t1 = x;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    t0 = exchange(t0, j, lane, true);
    t1 = exchange(t1, j, lane, true);
  }
}

// Merges 32 keys, one a lane in any order, into the sorted list (t0, t1):
// a bitonic sort of the 32, then, as 64 keys whose last 32 are sentinels,
// min(t[i], b[63 - i]) leaves the list's first half as it is.
__device__ __forceinline__ void merge32(Key& t0, Key& t1, Key b, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) b = exchange(b, j, lane, (lane & k) == 0);
  }
  t1 = key_min(t1, __shfl_sync(kFullMask, b, 31 - lane));  // b[31 - lane]
  if (t0 > t1) {
    const Key x = t0;
    t0 = t1;
    t1 = x;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    t0 = exchange(t0, j, lane, true);
    t1 = exchange(t1, j, lane, true);
  }
}

// The list's key K - 1: the row's threshold.
__device__ __forceinline__ Key kth_key(Key t0, Key t1, int K) {
  return __shfl_sync(kFullMask, K <= 32 ? t0 : t1, (K - 1) & 31);
}

// A row's selection state: its best keys so far, ascending (key i in lane
// i % 32, slot i / 32), the threshold a key must be below, and the keys in
// its buffer.
struct RowList {
  Key t0 = kSentinel, t1 = kSentinel, threshold = kSentinel;
  int count = 0;
};

// One row's pass over a strip: `row` holds the values of columns s0 ..
// s0 + s_len - 1 (orderable images), `buf` is its 64-key buffer.
__device__ __forceinline__ void select_strip(RowList& r, const uint32_t* row, Key* buf, int s0,
                                             int s_len, int K, int lane) {
  // the key in lane l of step c0, at column s0 + c0 + l
  auto strip_key = [&](int c) {
    return c < s_len ? (static_cast<Key>(row[c]) << 32) |
                           static_cast<Key>(static_cast<uint32_t>(s0 + c))
                     : kSentinel;
  };
  // Before the list holds K keys, a bound: each lane's second best value of
  // the strip; at least 64 keys have a value at or below the largest of
  // them, so no key above it is among the row's K best. (A value's image is
  // never ~0: that is NaN's.)
  if (r.threshold == kSentinel) {
    uint32_t m1 = ~0u, m2 = ~0u;
    for (int c0 = 0; c0 < s_len; c0 += 32) {
      const uint32_t v = c0 + lane < s_len ? row[c0 + lane] : ~0u;
      m2 = min(m2, max(m1, v));
      m1 = min(m1, v);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) m2 = max(m2, __shfl_xor_sync(kFullMask, m2, x));
    if (m2 != ~0u) r.threshold = static_cast<Key>(m2 + 1) << 32;
  }
  // lanes take 32 consecutive columns; keys before the threshold go to the
  // buffer, and each 32 buffered keys merge into the list
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int c0 = 0; c0 < s_len; c0 += 32) {
    const Key key = strip_key(c0 + lane);
    const bool pass = key < r.threshold;
    const unsigned mask = __ballot_sync(kFullMask, pass);
    if (mask == 0) continue;
    if (pass) buf[r.count + __popc(mask & lanes_below)] = key;
    r.count += __popc(mask);
    if (r.count >= 32) {
      __syncwarp();
      const Key b = buf[lane];
      const Key rest = lane + 32 < r.count ? buf[lane + 32] : kSentinel;
      __syncwarp();
      if (lane + 32 < r.count) buf[lane] = rest;
      merge32(r.t0, r.t1, b, lane);
      r.threshold = key_min(r.threshold, kth_key(r.t0, r.t1, K));
      r.count -= 32;
    }
  }
}

// One CTA: 16 warps, 16 query rows (warp w selects row w), part `blockIdx.y`
// of the key side (`part_tiles` tiles of 64 keys) through strips of
// `strip_tiles` tiles; grid y is one cluster.
__global__ void __launch_bounds__(kListThreads, 2)
    hamming_topk_list_kernel(const uint4* __restrict__ q, const uint4* __restrict__ k,
                             const float* __restrict__ q_pen, const float* __restrict__ k_pen,
                             float* __restrict__ values, long long* __restrict__ indices, int M,
                             int N, int K, int part_tiles, int strip_tiles) {
  const int stride = strip_tiles * kTileKeys + kStripPad;
  uint32_t* strip = reinterpret_cast<uint32_t*>(topk_smem);                  // [16][stride]
  Key* bufs = reinterpret_cast<Key*>(strip + list_strip_words(strip_tiles));  // [16][64]
  unsigned char* rows = reinterpret_cast<unsigned char*>(bufs + kListRows * kList);  // [16][320]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(gridDim.y);
  const int rank = static_cast<int>(blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the mma "group": a row of A and C, a column of B
  const int t = lane & 3;   // the thread in its group: which 16 bytes of 64
  const int row_base = blockIdx.x * kListRows;

  // the CTA's query rows (the last one again past M)
  for (int i = threadIdx.x; i < kListRows * kRowChunks; i += kListThreads) {
    const int r = i / kRowChunks;
    const int c = i % kRowChunks;
    *reinterpret_cast<uint4*>(rows + r * kQueryStride + 16 * c) =
        __ldg(q + static_cast<size_t>(min(row_base + r, M - 1)) * kRowChunks + c);
  }
  const float qp_lo = __ldg(q_pen + min(row_base + g, M - 1));
  const float qp_hi = __ldg(q_pen + min(row_base + g + 8, M - 1));
  __syncthreads();

  const int part_begin = rank * part_tiles * kTileKeys;
  const int part_end = min(part_begin + part_tiles * kTileKeys, N);
  const int strip_cols = strip_tiles * kTileKeys;
  Key* buf = bufs + warp * kList;
  RowList list;

  for (int s0 = part_begin; s0 < part_end; s0 += strip_cols) {
    const int s_len = min(strip_cols, part_end - s0);
    // the strip's distances, 8 columns a step: a thread takes rows g and
    // g + 8, columns 2t and 2t + 1; key fragments are 16-byte chunks t,
    // t + 4, t + 8, t + 12 of key g, the query rows' the same chunks
#pragma unroll 2
    for (int nt = warp; 8 * nt < s_len; nt += kListWarps) {
      const uint4* kb = k + static_cast<size_t>(min(s0 + 8 * nt + g, N - 1)) * kRowChunks + t;
      uint4 b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = __ldg(kb + 4 * c);
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 lo = *reinterpret_cast<const uint4*>(rows + g * kQueryStride + 16 * (4 * c + t));
        const uint4 hi =
            *reinterpret_cast<const uint4*>(rows + (g + 8) * kQueryStride + 16 * (4 * c + t));
        mma_s8(acc, lo.x, hi.x, lo.y, hi.y, b[c].x, b[c].y);
        mma_s8(acc, lo.z, hi.z, lo.w, hi.w, b[c].z, b[c].w);
      }
      const int col = s0 + 8 * nt + 2 * t;
      const float kp0 = __ldg(k_pen + min(col, N - 1));
      const float kp1 = __ldg(k_pen + min(col + 1, N - 1));
      *reinterpret_cast<uint2*>(strip + g * stride + 8 * nt + 2 * t) =
          make_uint2(orderable(distance(acc[0], qp_lo, kp0)),
                     orderable(distance(acc[1], qp_lo, kp1)));
      *reinterpret_cast<uint2*>(strip + (g + 8) * stride + 8 * nt + 2 * t) =
          make_uint2(orderable(distance(acc[2], qp_hi, kp0)),
                     orderable(distance(acc[3], qp_hi, kp1)));
    }
    __syncthreads();
    select_strip(list, strip + warp * stride, buf, s0, s_len, K, lane);
    __syncthreads();  // the strip is read before the next one is written
  }
  if (list.count > 0) {
    __syncwarp();
    merge32(list.t0, list.t1, lane < list.count ? buf[lane] : kSentinel, lane);
  }

  // the cluster's parts merge into rank 0, pairwise: at each level the lower
  // rank takes the higher's lists; a list waits in its row's buffer
  if (split > 1) {
    __syncwarp();
    buf[lane] = list.t0;
    buf[lane + 32] = list.t1;
    for (int step = 1; step < split; step <<= 1) {
      cluster.sync();
      if ((rank & (2 * step - 1)) == 0 && rank + step < split) {
        const Key* other = cluster.map_shared_rank(buf, rank + step);
        merge_sorted(list.t0, list.t1, other[lane], other[lane + 32], lane);
        buf[lane] = list.t0;
        buf[lane + 32] = list.t1;
      }
    }
    cluster.sync();  // no CTA leaves while its lists are read
  }
  const int out_row = row_base + warp;
  if (rank == 0 && out_row < M) {
    const size_t at = static_cast<size_t>(out_row) * K;
    if (lane < K) write_key(values, indices, at + lane, list.t0);
    if (lane + 32 < K) write_key(values, indices, at + lane + 32, list.t1);
  }
}

// ---- the K <= 2 paths ----

// Of two sorted pairs from disjoint columns, the best two.
__device__ __forceinline__ void merge_pair(Key& a0, Key& a1, Key b0, Key b1) {
  const Key lo = key_min(a0, b0);
  a1 = key_min(key_max(a0, b0), key_min(a1, b1));
  a0 = lo;
}

// A (value, column) pair as a key; a pair never set is the sentinel.
__device__ __forceinline__ Key pair_key(float v, int c) {
  return c == INT_MAX ? kSentinel : make_key(v, c);
}

// One CTA: a warpgroup, 64 query rows, part `blockIdx.y` of the key side
// (`part_tiles` tiles of 64 keys); grid y is one cluster.
template <int kPath>
__global__ void __launch_bounds__(kPairThreads, 2)
    hamming_topk_pair_kernel(const uint32_t* __restrict__ q, const uint4* __restrict__ k,
                             const float* __restrict__ q_pen, const float* __restrict__ k_pen,
                             float* __restrict__ values, long long* __restrict__ indices, int M,
                             int N, int K, int part_tiles) {
  unsigned char* key_tiles = topk_smem;                                // [2][64 keys x 256 B]
  float* pens = reinterpret_cast<float*>(topk_smem + kKeyBytes);       // [2][64]
  Key* pairs = reinterpret_cast<Key*>(topk_smem + kPairsOff);          // [64 rows][2]

  // the cluster spans grid y: its rank is the CTA's part of the key side
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(gridDim.y);
  const int rank = static_cast<int>(blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the accumulator's row (and row + 8) in the warp's 16
  const int t = lane & 3;   // the thread in its quad: columns 2t, 2t + 1 of each n-chunk
  const int row_base = blockIdx.x * kPairRows;
  const int m0 = 16 * warp + g;  // the lane's rows in the CTA: m0 and m0 + 8

  // this CTA's part of the key side, in tiles
  const int n_tiles = (N + kTileKeys - 1) / kTileKeys;
  const int tile_begin = rank * part_tiles;
  const int tile_end = min(tile_begin + part_tiles, n_tiles);
  const int n_local = max(tile_end - tile_begin, 0);
  const int col_end = min(tile_end * kTileKeys, N);

  // The warpgroup's A fragments: for k-step s, words 8 s + t and 8 s + 4 + t
  // of rows m0 and m0 + 8.
  const int r0 = min(row_base + m0, M - 1);
  const int r1 = min(row_base + m0 + 8, M - 1);
  uint32_t a[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s][0] = __ldg(q + static_cast<size_t>(r0) * kRowWords + 8 * s + t);
    a[s][1] = __ldg(q + static_cast<size_t>(r1) * kRowWords + 8 * s + t);
    a[s][2] = __ldg(q + static_cast<size_t>(r0) * kRowWords + 8 * s + 4 + t);
    a[s][3] = __ldg(q + static_cast<size_t>(r1) * kRowWords + 8 * s + 4 + t);
  }
  const float qp0 = q_pen[r0];
  const float qp1 = q_pen[r1];

  // per row (0: m0, 1: m0 + 8) the best two, as (value, column); INT_MAX is none
  const float inf = __int_as_float(0x7f800000);
  float bv00 = inf, bv01 = inf, bv10 = inf, bv11 = inf;
  int bc00 = INT_MAX, bc01 = INT_MAX, bc10 = INT_MAX, bc11 = INT_MAX;

  // a tile of 64 keys, as core matrices: key r's chunk c at
  // ((r / 8) * 16 + c) * 128 + (r % 8) * 16
  auto issue_tile = [&](int tile, int stage) {
    const int c0 = tile * kTileKeys;
    unsigned char* dst = key_tiles + stage * kKeyTileBytes;
#pragma unroll
    for (int i = 0; i < kTileKeys * kRowChunks / kPairThreads; ++i) {
      const int chunk = threadIdx.x + i * kPairThreads;
      const int r = chunk / kRowChunks;
      const int c = chunk % kRowChunks;
      const bool in = c0 + r < N;
      const uint4* src = k + (in ? static_cast<size_t>(c0 + r) * kRowChunks + c : 0);
      cp_async16(dst + ((r >> 3) * kRowChunks + c) * 128 + (r & 7) * 16, src, in ? 16 : 0);
    }
    if (threadIdx.x < kTileKeys) {
      const int col = c0 + threadIdx.x;
      cp_async4(pens + stage * kTileKeys + threadIdx.x, k_pen + min(col, N - 1), col < N ? 4 : 0);
    }
  };

  if (n_local > 0) issue_tile(tile_begin, 0);
  cp_async_commit();
  for (int it = 0; it < n_local; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_local) issue_tile(tile_begin + it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    fence_async_shared();
    __syncthreads();

    // 64 rows x 64 keys: d[4 i + e] is row m0 (e < 2) or m0 + 8, column
    // 8 i + 2 t + (e & 1) of the tile
    int d[32] = {};
    {
      const uint64_t desc = tile_descriptor(key_tiles + stage * kKeyTileBytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < 8; ++s) wgmma_64x64x32(d, a[s], desc + 16 * s, s > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }

    const float* pen = pens + stage * kTileKeys;
    const int c0 = (tile_begin + it) * kTileKeys;
    const bool full = c0 + kTileKeys <= col_end;  // no column of the tile is masked
#pragma unroll
    for (int step = 0; step < kTileKeys / kStepKeys; ++step) {
      // the step's 16 columns: n-chunks 2 step + j; per thread v[j][e]
      float v[2][4];
      int col[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int lc = 8 * (2 * step + j) + 2 * t;
        const float2 kp = *reinterpret_cast<const float2*>(pen + lc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = distance(d[4 * (2 * step + j) + e], e < 2 ? qp0 : qp1, (e & 1) ? kp.y : kp.x);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          col[j][e] = c0 + lc + e;
          if (!full && col[j][e] >= col_end) {  // masked: never before anything
            v[j][e] = inf;
            v[j][2 + e] = inf;
            col[j][e] = INT_MAX;
          }
        }
      }

#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = v[j][e];
          const int c = col[j][e & 1];
          float& b0v = e < 2 ? bv00 : bv10;
          int& b0c = e < 2 ? bc00 : bc10;
          float& b1v = e < 2 ? bv01 : bv11;
          int& b1c = e < 2 ? bc01 : bc11;
          if (kPath == kPathK1) {
            const bool lt = before(x, c, b0v, b0c);
            b0v = lt ? x : b0v;
            b0c = lt ? c : b0c;
          } else {
            const bool lt0 = before(x, c, b0v, b0c);
            const bool lt1 = before(x, c, b1v, b1c);
            b1v = lt0 ? b0v : (lt1 ? x : b1v);
            b1c = lt0 ? b0c : (lt1 ? c : b1c);
            b0v = lt0 ? x : b0v;
            b0c = lt0 ? c : b0c;
          }
        }
      }
    }
    __syncthreads();  // the stage is read by all warps before it is loaded again
  }

  // the quad's best two of each row, one pair per row in shared memory;
  // the cluster's parts merge into rank 0
  Key k00 = pair_key(bv00, bc00), k01 = pair_key(bv01, bc01);
  Key k10 = pair_key(bv10, bc10), k11 = pair_key(bv11, bc11);
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    merge_pair(k00, k01, __shfl_xor_sync(kFullMask, k00, x), __shfl_xor_sync(kFullMask, k01, x));
    merge_pair(k10, k11, __shfl_xor_sync(kFullMask, k10, x), __shfl_xor_sync(kFullMask, k11, x));
  }
  if (t == 0) {
    pairs[2 * m0] = k00;
    pairs[2 * m0 + 1] = k01;
    pairs[2 * (m0 + 8)] = k10;
    pairs[2 * (m0 + 8) + 1] = k11;
  }
  __syncthreads();
  const int row = threadIdx.x;  // < kPairRows: one thread per row of the CTA
  for (int step = 1; step < split; step <<= 1) {
    cluster.sync();
    if ((rank & (2 * step - 1)) == 0 && rank + step < split && row < kPairRows) {
      const Key* other = cluster.map_shared_rank(pairs, rank + step);
      Key a0 = pairs[2 * row], a1 = pairs[2 * row + 1];
      merge_pair(a0, a1, other[2 * row], other[2 * row + 1]);
      pairs[2 * row] = a0;
      pairs[2 * row + 1] = a1;
    }
  }
  if (split > 1) cluster.sync();
  const int out_row = row_base + row;
  if (rank == 0 && row < kPairRows && out_row < M) {
    for (int i = 0; i < K; ++i) {
      write_key(values, indices, static_cast<size_t>(out_row) * K + i, pairs[2 * row + i]);
    }
  }
}

bool g_prepared[kMaxDevices];

// Once per process and device: allow each kernel its largest dynamic
// shared memory.
cudaError_t prepare() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_prepared[device]) return cudaSuccess;
  const cudaError_t all[] = {
      cudaFuncSetAttribute(hamming_topk_pair_kernel<kPathK1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kPairSharedBytes),
      cudaFuncSetAttribute(hamming_topk_pair_kernel<kPathK2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kPairSharedBytes),
      cudaFuncSetAttribute(hamming_topk_list_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           list_shared_bytes(kMaxStripTiles)),
  };
  for (const cudaError_t e : all) {
    if (e != cudaSuccess) err = e;
  }
  if (err == cudaSuccess) g_prepared[device] = true;
  return err;
}

}  // namespace

// Selects on `stream` without synchronising; returns the first CUDA error
// (0 = none). q and k must be 16-byte aligned and contiguous; M > 0,
// 0 < N <= 4096, 0 < K <= min(64, N). The plan comes from the wrapper's
// topk_launch_plan: `path` 0 (K = 1), 1 (K = 2) or 2 (a list, any K);
// `split` CTAs of a cluster share a row block's key side, each
// `part_tiles` tiles of 64 keys of it; the list path goes through strips of
// `strip_tiles` tiles (1 to 16; 0 on the other paths); `shared_bytes` of
// dynamic shared memory. A plan that does not fit these checks is refused.
extern "C" int hamming_topk_launch(const void* q, const void* k, const void* q_pen,
                                   const void* k_pen, void* values, void* indices, int M, int N,
                                   int K, int path, int split, int part_tiles, int strip_tiles,
                                   int shared_bytes, void* stream) {
  const int n_tiles = (N + kTileKeys - 1) / kTileKeys;
  const bool list = path == kPathList;
  if (M <= 0 || N <= 0 || N > kMaxN || K <= 0 || K > kList || K > N ||
      path < kPathK1 || path > kPathList || (path == kPathK1 && K != 1) ||
      (path == kPathK2 && K != 2) || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) || part_tiles < 1 ||
      static_cast<long long>(split) * part_tiles < n_tiles ||
      (list ? strip_tiles < 1 || strip_tiles > kMaxStripTiles ||
                  shared_bytes != list_shared_bytes(strip_tiles)
            : strip_tiles != 0 || shared_bytes != kPairSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t config = {};
  const int rows = list ? kListRows : kPairRows;
  config.gridDim = dim3((M + rows - 1) / rows, split, 1);
  config.blockDim = dim3(list ? kListThreads : kPairThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = 1;
  attribute[0].val.clusterDim.y = static_cast<unsigned>(split);
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = split > 1 ? 1 : 0;

  const uint4* kv = static_cast<const uint4*>(k);
  const float* qp = static_cast<const float*>(q_pen);
  const float* kp = static_cast<const float*>(k_pen);
  float* out_v = static_cast<float*>(values);
  long long* out_i = static_cast<long long*>(indices);
  if (list) {
    err = cudaLaunchKernelEx(&config, hamming_topk_list_kernel, static_cast<const uint4*>(q), kv,
                             qp, kp, out_v, out_i, M, N, K, part_tiles, strip_tiles);
  } else {
    const uint32_t* qw = static_cast<const uint32_t*>(q);
    err = path == kPathK1
              ? cudaLaunchKernelEx(&config, hamming_topk_pair_kernel<kPathK1>, qw, kv, qp, kp,
                                   out_v, out_i, M, N, K, part_tiles)
              : cudaLaunchKernelEx(&config, hamming_topk_pair_kernel<kPathK2>, qw, kv, qp, kp,
                                   out_v, out_i, M, N, K, part_tiles);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
