// Hamming distance plus rank-1 penalties, reduced to the K best columns of
// every row, for signed (+-1 int8) descriptors.
//
// Replaces fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix
// together with the jax.lax.top_k that every matcher of the tracker applies
// to its result: for q (M, 256) and k (N, 256) int8 in {-1, +1}, q_pen (M,)
// and k_pen (N,) float32, and K <= 64, K <= N,
//
//     d[i, j]        = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]
//     values[i, :]   = the K smallest d[i, :], ascending
//     indices[i, :]  = their columns; equal values by ascending column
//
// which is lax.top_k(-d, K) with the sign folded back, bit for bit. The
// (M, N) matrix never reaches device memory.
//
// What bounds it on an H100: neither bytes nor tensor-core work. It reads
// (M + N) * 256 B and writes M * K * 12 B (1.25 MiB at 1024 x 1024, under a
// microsecond of memory time); its time is integer arithmetic: 8 XOR + POPC
// per pair and the selection. So the design spends its effort there:
//   - operands are packed to 8 x uint32 of sign bits ONCE, by a pre-pass
//     kernel into a scratch buffer (Hamming = sum of popc(a ^ b), which is
//     (256 - dot) / 2 exactly for +-1 entries). The key side is stored
//     word-major, so a block copies it into shared memory with linear
//     16-byte loads (32 KiB at N = 1024, 128 KiB at N = 4096) and a warp
//     reading 32 consecutive columns of one word touches 32 banks;
//   - a warp owns a query row: its 8 words sit in registers, each lane takes
//     every 32nd column, and penalties are added in f32 in the Pallas and
//     XLA order, q_pen first, then k_pen (with 1e9 penalties the sum
//     rounds, so the order is part of the result);
//   - selection is exact and stable: a candidate is the 64-bit key
//     (order-preserving integer image of the f32 value) << 32 | column, so
//     all keys of a row differ and "the K smallest keys, ascending" is the
//     stable order. The warp keeps its 64 best keys sorted in registers,
//     two per lane, and the largest of them as a threshold; a column passes
//     only below the threshold (after the first 64, few do: about
//     64 * ln(N / 64) on unordered data), passing keys are appended by
//     ballot to a 64-slot buffer in shared memory, and a buffer more than
//     half full is merged: a bitonic sort of the buffer, an elementwise min
//     against the reversed list, and a bitonic merge, 28 compare-exchange
//     steps by warp shuffle with no trip through shared memory (the first
//     version kept both lists in shared memory with a barrier a step, and
//     its latency was most of the kernel's time);
//   - any M (a grid-stride loop over rows), N up to 4096 (shared memory),
//     ragged N masked per lane.
// NaN penalties are outside the contract, as for the sort they replace.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;    // 256 bits as 8 x uint32
constexpr int kRowVec = 16;  // an int8 descriptor row is 16 x uint4
constexpr int kWarps = 8;    // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kList = 64;    // best keys kept per row, and the buffer's size
constexpr int kMaxN = 4096;
constexpr int kMaxBlocks = 132 * 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kSentinel = ~0ull;  // above every real key

// Bit 7 of each byte is the sign of one int8 lane: -1 -> 1, +1 -> 0. The
// multiply gathers bits 0, 8, 16, 24 into bits 24..27 without a carry.
__device__ __forceinline__ uint32_t sign_nibble(uint32_t x) {
  return (((x >> 7) & 0x01010101u) * 0x01020408u) >> 24;
}

// One thread per (row, word): 32 bytes in, one word of sign bits out.
// q_bits is row-major (M, 8); k_bits is word-major (8, n_pad).
__global__ void pack_sign_bits_kernel(const uint4* __restrict__ q,
                                      const uint4* __restrict__ k,
                                      uint32_t* __restrict__ q_bits,
                                      uint32_t* __restrict__ k_bits, int M, int N,
                                      int n_pad) {
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (M + N) * kWords) return;
  const int r = item / kWords;
  const int w = item % kWords;
  const uint4* p = (r < M ? q + static_cast<size_t>(r) * kRowVec
                          : k + static_cast<size_t>(r - M) * kRowVec) + 2 * w;
  const uint4 a = __ldg(p);
  const uint4 b = __ldg(p + 1);
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) word |= sign_nibble(v[i]) << (4 * i);
  if (r < M) {
    q_bits[static_cast<size_t>(r) * kWords + w] = word;
  } else {
    k_bits[static_cast<size_t>(w) * n_pad + (r - M)] = word;
  }
}

// f32 -> uint32 with the same order (and back).
__device__ __forceinline__ uint32_t orderable(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_orderable(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// One compare-exchange step of a bitonic network over 64 keys held two per
// lane (key i in lane i % 32, slot i / 32), for a stride j < 32: the partner
// is the same slot of lane ^ j. `up` says whether this key's pair sorts
// ascending.
__device__ __forceinline__ unsigned long long exchange(unsigned long long v, int j, int lane,
                                                       bool up) {
  const unsigned long long other = __shfl_xor_sync(kFullMask, v, j);
  const bool keep_min = ((lane & j) == 0) == up;
  return (v < other) == keep_min ? v : other;
}

// Merges the 64 keys (b0, b1) into the sorted list (t0, t1): afterwards the
// list holds the 64 smallest of both, ascending. All in registers; every
// lane of the warp calls it.
__device__ __forceinline__ void merge_keys(unsigned long long& t0, unsigned long long& t1,
                                           unsigned long long b0, unsigned long long b1,
                                           int lane) {
  // bitonic sort of b, ascending: runs of k keys alternate direction until
  // the last pass (k = 64) sorts everything upward
  for (int k = 2; k <= 32; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      // bit k of the key's index: of the lane for k < 32, the slot for k = 32
      b0 = exchange(b0, j, lane, k == 32 || (lane & k) == 0);
      b1 = exchange(b1, j, lane, k != 32 && (lane & k) == 0);
    }
  }
  if (b0 > b1) {  // k = 64, j = 32: the two slots of a lane
    const unsigned long long x = b0;
    b0 = b1;
    b1 = x;
  }
  for (int j = 16; j > 0; j >>= 1) {
    b0 = exchange(b0, j, lane, true);
    b1 = exchange(b1, j, lane, true);
  }
  // min(t[i], b[63 - i]) holds the 64 smallest of the 128 and is bitonic
  const unsigned long long r0 = __shfl_sync(kFullMask, b1, 31 - lane);  // b[63 - lane]
  const unsigned long long r1 = __shfl_sync(kFullMask, b0, 31 - lane);  // b[31 - lane]
  t0 = t0 < r0 ? t0 : r0;
  t1 = t1 < r1 ? t1 : r1;
  if (t0 > t1) {
    const unsigned long long x = t0;
    t0 = t1;
    t1 = x;
  }
  for (int j = 16; j > 0; j >>= 1) {
    t0 = exchange(t0, j, lane, true);
    t1 = exchange(t1, j, lane, true);
  }
}

__global__ void __launch_bounds__(kThreads)
    hamming_topk_kernel(const uint32_t* __restrict__ q_bits,
                        const uint32_t* __restrict__ k_bits_global,
                        const float* __restrict__ q_pen, const float* __restrict__ k_pen,
                        float* __restrict__ values, long long* __restrict__ indices,
                        int M, int N, int n_pad, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* k_bits = reinterpret_cast<uint32_t*>(smem);            // [8][n_pad]
  float* kp = reinterpret_cast<float*>(k_bits + kWords * n_pad);    // [n_pad]
  unsigned long long* buffers =
      reinterpret_cast<unsigned long long*>(kp + n_pad);            // [kWarps][64]

  const uint4* src = reinterpret_cast<const uint4*>(k_bits_global);
  uint4* dst = reinterpret_cast<uint4*>(k_bits);
  for (int i = threadIdx.x; i < kWords * n_pad / 4; i += kThreads) dst[i] = src[i];
  for (int i = threadIdx.x; i < n_pad; i += kThreads) kp[i] = i < N ? k_pen[i] : 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* buf = buffers + warp * kList;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int row = blockIdx.x * kWarps + warp; row < M; row += gridDim.x * kWarps) {
    uint32_t qw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) qw[w] = __ldg(q_bits + static_cast<size_t>(row) * kWords + w);
    const float qp = q_pen[row];
    // the row's 64 best keys so far, ascending: key i in lane i % 32, slot i / 32
    unsigned long long t0 = kSentinel, t1 = kSentinel;
    unsigned long long threshold = kSentinel;
    int count = 0;

    for (int c0 = 0; c0 < N; c0 += 32) {
      const int col = c0 + lane;
      unsigned long long key = kSentinel;
      if (col < N) {
        int h = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) h += __popc(qw[w] ^ k_bits[w * n_pad + col]);
        const float v = __fadd_rn(__fadd_rn(static_cast<float>(h), qp), kp[col]);
        key = (static_cast<unsigned long long>(orderable(v)) << 32) |
              static_cast<unsigned long long>(col);
      }
      const bool pass = key < threshold;
      const unsigned mask = __ballot_sync(kFullMask, pass);
      if (mask == 0) continue;
      if (pass) buf[count + __popc(mask & lanes_below)] = key;
      count += __popc(mask);
      if (count > 32 || c0 + 32 >= N) {  // the next 32 columns might not fit, or none are left
        __syncwarp();
        const unsigned long long b0 = lane < count ? buf[lane] : kSentinel;
        const unsigned long long b1 = lane + 32 < count ? buf[lane + 32] : kSentinel;
        merge_keys(t0, t1, b0, b1, lane);  // its shuffles order these reads before later writes
        threshold = __shfl_sync(kFullMask, t1, 31);
        count = 0;
      }
    }
    if (count > 0) {  // keys appended before a last chunk that passed none
      __syncwarp();
      const unsigned long long b0 = lane < count ? buf[lane] : kSentinel;
      const unsigned long long b1 = lane + 32 < count ? buf[lane + 32] : kSentinel;
      merge_keys(t0, t1, b0, b1, lane);
    }
    float* out_v = values + static_cast<size_t>(row) * K;
    long long* out_i = indices + static_cast<size_t>(row) * K;
    if (lane < K) {
      out_v[lane] = from_orderable(static_cast<uint32_t>(t0 >> 32));
      out_i[lane] = static_cast<long long>(t0 & 0xffffffffull);
    }
    if (lane + 32 < K) {
      out_v[lane + 32] = from_orderable(static_cast<uint32_t>(t1 >> 32));
      out_i[lane + 32] = static_cast<long long>(t1 & 0xffffffffull);
    }
  }
}

}  // namespace

// Shared memory of one block of the selection kernel at this N.
static size_t topk_shared_bytes(int n_pad) {
  return static_cast<size_t>(n_pad) * (kWords + 1) * 4 +
         static_cast<size_t>(kWarps) * kList * sizeof(unsigned long long);
}

// Packs both operands into `scratch` and selects, on `stream`, without
// synchronising; returns the first CUDA error (0 = none). `scratch` holds
// 8 * (n_pad + M) uint32 with n_pad = N rounded up to 32: the key bits
// word-major first, the query bits after. q, k and scratch must be 16-byte
// aligned and contiguous; 0 < N <= 4096, 0 < K <= min(64, N), M > 0 (the
// wrapper checks all of this).
extern "C" int hamming_topk_launch(const void* q, const void* k, const void* q_pen,
                                   const void* k_pen, void* scratch, void* values,
                                   void* indices, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || N > kMaxN || K <= 0 || K > kList || K > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = (N + 31) / 32 * 32;
  uint32_t* k_bits = static_cast<uint32_t*>(scratch);
  uint32_t* q_bits = k_bits + static_cast<size_t>(kWords) * n_pad;

  const int items = (M + N) * kWords;
  pack_sign_bits_kernel<<<(items + 255) / 256, 256, 0, s>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k), q_bits, k_bits, M, N, n_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t shared = topk_shared_bytes(n_pad);
  err = cudaFuncSetAttribute(hamming_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = (M + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hamming_topk_kernel<<<blocks, kThreads, shared, s>>>(
      q_bits, k_bits, static_cast<const float*>(q_pen), static_cast<const float*>(k_pen),
      static_cast<float*>(values), static_cast<long long*>(indices), M, N, n_pad, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
