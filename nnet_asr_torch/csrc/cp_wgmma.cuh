// The bf16 GEMM main loops for rows that no TMA map can describe: wgmma fed
// by cp.async. matmul_act.cu's bf16 forward uses `mainloop` for products
// whose row pitches and base pointers are whole 4-byte units but not the
// 16-byte multiples TMA needs (ops/kernels/tile_plan.py's CP_WGMMA route):
// MLP3's x at 598 columns (1,196-byte rows), TIMIT's W and y at 500
// (1,000-byte rows). Rows of 2-byte pitch (K = 135) keep tile_gemm.cuh's
// mma.sync loop, since cp.async has no 2-byte size. sgd_fused.cu's bf16
// weight gradient uses `wgrad_mainloop` (its section at the end: g = x^T e
// with In on wgmma's M, Out on its N), which takes e's rows of 135 too:
// one tile spans them, so a stage of whole rows is one run of memory.
//
// What bounds these products on an H100 is neither operations nor device
// memory (960x598->1024 is 1.2 GFLOP, 1.2 us at 989 TFLOP/s, over 4.3 MB,
// 1.3 us at 3.35 TB/s) but latency and the operand feed from L2: every
// block reads its whole K extent of x and W (153 KB for a 64x64 tile at
// K = 598), and the SM needs several blocks' copies in flight. The design:
//
//   - wgmma (bf16 in, f32 accumulator; m64nBNk16, one per warpgroup and k16
//     step) in place of mma.sync m16n8k16 and its ldmatrix fragment loads:
//     the tensor cores read both operands straight from shared memory, so
//     the threads spend their issue slots on the copies;
//   - warpgroups of 64 rows each (one on the planned 64x64 tile) that both
//     copy and multiply (no producer warp: cp.async needs every thread's
//     issue slots anyway); a short ring (3 stages, 48 KB) so that several
//     blocks share an SM: more blocks' copies in flight measured faster
//     than one block's deeper ring or a wider tile (tools/gemm_ceiling.py
//     --small);
//   - the copies write the 128-byte-swizzled layout that wgmma's
//     descriptors read (wgmma_gemm.cuh's, for TMA): a K-major A (x) as rows
//     of 64 k, 128 bytes each, whose 16-byte unit u of row r lies at u ^ (r
//     % 8); an N-major B (W) as boxes of 64 k-lines of 64 n (8 KB), unit u
//     of line k at u ^ (k % 8). Each thread's copy lands inside one unit,
//     so copies of 4, 8 or 16 bytes (the widest the pitch and base allow;
//     tile_plan.copy_bytes) all fit the layout;
//   - a ring of STAGES stages of BK = 64, STAGES - 2 of them in flight
//     ahead of the one being multiplied: a stage is overwritten two
//     iterations after its wgmma group was issued, once every warpgroup's
//     wgmma.wait_group<1> has retired it and a barrier has passed, so one
//     barrier an iteration suffices;
//   - cp.async lands as generic-proxy writes, wgmma reads through the async
//     proxy: each thread fences (fence.proxy.async) after its copies of a
//     stage have landed, before the barrier that hands the stage over;
//   - ragged edges by zero fill: rows past M, k past the split's end (K =
//     598 is no multiple of 16: the tail of the last k16 slice reads 0),
//     columns past N. The copy width divides the pitch, so a run is wholly
//     inside or outside the matrix;
//   - split-K where the tiles alone leave SMs idle (one tmpe utterance's
//     284 rows: 80 tiles of 64x64): each split stores its f32 accumulators
//     in fragment order to scratch, and the block that draws the last
//     ticket of its tile sums all partials in split order, in registers,
//     in the same launch (the protocol of tile_gemm.cuh reduce_splits; no
//     float atomics, so two launches give the same bits);
//   - the epilogue takes the fragments (the bias upcast and added in f32,
//     the sigmoid in f32, y rounded once to bf16), stages the bf16 tile in
//     the drained ring and writes whole rows, 16 bytes a thread: stores
//     straight from the fragments (16 bytes of each of 8 rows a warp
//     store) took longer on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace nnet_cpw {

using bf16 = __nv_bfloat16;
namespace W = nnet_wgmma;

constexpr int BK = 64;          // bf16 a stage: one 128-byte swizzle line
constexpr int LINE = 128;       // bytes of a swizzled row (A) or k-line (B)
constexpr int BOX = 64 * LINE;  // 64 lines: an A half of 64 rows, a B box of 64 n

// WG warpgroups of 64 rows each, BN columns, a ring of STAGES stages
template <int WG_, int BN_, int STAGES_>
struct CpTile {
  static constexpr int WG = WG_, BM = 64 * WG_, BN = BN_, STAGES = STAGES_;
  static constexpr int THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * LINE;            // BM rows of 64 k
  static constexpr int B_BYTES = (BN / 64) * BOX;      // BN / 64 boxes of 64 k-lines
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = RING_BYTES + 1024;   // slack to align the ring to 1024
  static constexpr int NACC = BN / 2;                   // f32 accumulators a thread
  static_assert(BN == 64 || BN == 128, "wgmma widths");
  static_assert(STAGES >= 3 && SMEM_BYTES <= 227 * 1024, "ring");
};

// d (64 x 64, f32) += A (64 x 16, K-major: TA = 0, or M-major: TA = 1) * B
// (16 x 64, N-major); the fragment layout of wgmma_gemm.cuh's m64n256k16
// with 8 column groups
template <int TA = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
#define NNET_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
#undef NNET_D8
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                          int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64k16(d, da, db, scale_d);
  else
    W::wgmma_m64n128k16<0>(d, da, db, scale_d);
}

// Copies of A's stage: rows m0.. of x (pitch K), k from k0, in runs of
// BYTES; run c of row r is bytes c * BYTES of the row's 128, in unit
// (c * BYTES / 16) ^ (r % 8)
template <class T, int BYTES>
__device__ __forceinline__ void load_a(uint8_t* sa, const bf16* __restrict__ x, int K, int M,
                                       int m0, int k0, int k_end) {
  constexpr int RUNS = LINE / BYTES, N = T::BM * RUNS / T::THREADS;
  static_assert((T::BM * RUNS) % T::THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int idx = threadIdx.x + l * T::THREADS;
    const int r = idx / RUNS, c = idx % RUNS, byte = c * BYTES;
    const int k = k0 + byte / 2;
    const bool ok = m0 + r < M && k < k_end;
    nnet_tile::cp_async<BYTES>(sa + r * LINE + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15),
                               ok ? x + (size_t)(m0 + r) * K + k : x, ok);
  }
}

// Copies of an MN-major stage: k-lines k0.. of w (pitch N), columns n0 ..
// n0 + WIDTH, by THREADS threads; byte b of a line's 2 * WIDTH lies in box
// b / 128, unit ((b % 128) / 16) ^ (k % 8)
template <int WIDTH, int THREADS, int BYTES>
__device__ __forceinline__ void load_mn(uint8_t* sb, const bf16* __restrict__ w, int N, int n0,
                                        int k0, int k_end) {
  constexpr int RUNS = 2 * WIDTH / BYTES, NN = BK * RUNS / THREADS;
  static_assert((BK * RUNS) % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int l = 0; l < NN; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / RUNS, c = idx % RUNS, byte = c * BYTES;
    const int n = n0 + byte / 2, in_box = byte & (LINE - 1);
    const bool ok = k0 + r < k_end && n < N;
    nnet_tile::cp_async<BYTES>(
        sb + (byte / LINE) * BOX + r * LINE + (((in_box >> 4) ^ (r & 7)) << 4) + (in_box & 15),
        ok ? w + (size_t)(k0 + r) * N + n : w, ok);
  }
}

// One stage's copies at the widths the host planned (16, 8 or 4 bytes)
template <class T>
__device__ __forceinline__ void load_stage(uint8_t* st, const bf16* x, const bf16* w, int M,
                                           int N, int K, int m0, int n0, int k0, int k_end,
                                           int x_bytes, int w_bytes) {
  if (x_bytes == 16)
    load_a<T, 16>(st, x, K, M, m0, k0, k_end);
  else if (x_bytes == 8)
    load_a<T, 8>(st, x, K, M, m0, k0, k_end);
  else
    load_a<T, 4>(st, x, K, M, m0, k0, k_end);
  uint8_t* sb = st + T::A_BYTES;
  if (w_bytes == 16)
    load_mn<T::BN, T::THREADS, 16>(sb, w, N, n0, k0, k_end);
  else if (w_bytes == 8)
    load_mn<T::BN, T::THREADS, 8>(sb, w, N, n0, k0, k_end);
  else
    load_mn<T::BN, T::THREADS, 4>(sb, w, N, n0, k0, k_end);
}

// acc = x[m0 + 64 wg .., k_begin:k_end] @ W[k_begin:k_end, n0 ..] for
// warpgroup wg's 64 rows, through the ring at `ring` (1024-byte aligned)
template <class T>
__device__ __forceinline__ void mainloop(uint8_t* ring, const bf16* __restrict__ x,
                                         const bf16* __restrict__ w, int M, int N, int K,
                                         int m0, int n0, int k_begin, int k_end, int x_bytes,
                                         int w_bytes, float (&acc)[T::NACC]) {
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.0f;
  const int ktiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 2; ++s) {
    if (s < ktiles)
      load_stage<T>(ring + s * T::STAGE_BYTES, x, w, M, N, K, m0, n0, k_begin + s * BK, k_end,
                    x_bytes, w_bytes);
    nnet_tile::cp_async_commit();   // one group a stage, empty or not, keeps the count
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    nnet_tile::cp_async_wait<T::STAGES - 3>();   // this thread's copies of stage kt landed
    W::fence_proxy_async();                      // ... and are visible to wgmma
    __syncthreads();   // everyone's; and every warpgroup has retired the wgmma of kt - 2
    const int next = kt + T::STAGES - 2;          // into the slot of stage kt - 2
    if (next < ktiles)
      load_stage<T>(ring + (next % T::STAGES) * T::STAGE_BYTES, x, w, M, N, K, m0, n0,
                    k_begin + next * BK, k_end, x_bytes, w_bytes);
    nnet_tile::cp_async_commit();
    const uint32_t a = W::smem_u32(ring + (kt % T::STAGES) * T::STAGE_BYTES) + wg * BOX;
    const uint32_t b = W::smem_u32(ring + (kt % T::STAGES) * T::STAGE_BYTES + T::A_BYTES);
    W::fence_acc(acc);
    W::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_k16<T::BN>(acc, W::smem_desc(a + kk * 32, 16, 1024),
                       W::smem_desc(b + kk * 16 * LINE, BOX, 1024), kt > 0 || kk > 0);
    W::wgmma_commit();
    W::wgmma_wait<1>();   // the group of stage kt - 1 has read its stage
    W::fence_acc(acc);
  }
  W::wgmma_wait<0>();
  W::fence_acc(acc);
  nnet_tile::cp_async_wait<0>();
}

// Split-K in one launch, on the fragments. Block (x, y, z) holds split z
// of tile y * gridDim.x + x. Each split stores its accumulators, float4 j
// of thread t at ((tile * splits + z) * NACC / 4 + j) * THREADS + t, and
// takes a ticket as tile_gemm.cuh reduce_splits does (a barrier, one
// thread's cumulative __threadfence, an atomicAdd on the tile's counter).
// The block that draws the last ticket reads every split's partial back
// through L2 (its own too) and sums them in split order 0, 1, ..., S-1,
// each sum rounded on its own (__fadd_rn), resets the counter and returns
// true; the others return false. With one split it returns true at once.
template <class T>
__device__ __forceinline__ bool reduce_acc(float (&acc)[T::NACC], float* __restrict__ part,
                                           int* __restrict__ counters) {
  const int splits = gridDim.z;
  if (splits == 1) return true;
  constexpr int J = T::NACC / 4;
  __shared__ int last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float4* base = reinterpret_cast<float4*>(part) + (size_t)tile * splits * J * T::THREADS +
                 threadIdx.x;
#pragma unroll
  for (int j = 0; j < J; ++j)
    __stcg(base + ((size_t)blockIdx.z * J + j) * T::THREADS,
           make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
  __syncthreads();   // every thread's partial is issued
  if (threadIdx.x == 0) {
    __threadfence();   // cumulative: the block's partial is visible before its ticket
    last = atomicAdd(counters + tile, 1) == splits - 1;
    if (last) __threadfence();   // and the other partials before the reads below
  }
  __syncthreads();
  if (!last) return false;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float4 q = __ldcg(base + (size_t)j * T::THREADS);
    acc[4 * j] = q.x;
    acc[4 * j + 1] = q.y;
    acc[4 * j + 2] = q.z;
    acc[4 * j + 3] = q.w;
  }
  for (int s = 1; s < splits; ++s) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 q = __ldcg(base + ((size_t)s * J + j) * T::THREADS);
      acc[4 * j] = __fadd_rn(acc[4 * j], q.x);
      acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], q.y);
      acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], q.z);
      acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], q.w);
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
  return true;
}

// The epilogue of warpgroup wg's fragments (thread t = threadIdx.x % 128,
// warp q = t / 32, lane l: acc[4i + 2h + e] at row 64 wg + 16q + l/4 + 8h,
// column 8i + 2(l % 4) + e): the bias upcast and added in f32, the sigmoid
// in f32 (__expf, __fdividef, as on the TMA route), y rounded once to bf16
// into a BM x BN tile staged in the drained ring (rows of 2 BN + 16 bytes:
// a warp's bf16 pairs fall in 32 distinct banks), then written in whole
// rows, 16 bytes a thread, in stores of the widest size y's pitch and base
// allow (16, 8 or 4 bytes; N is even on this route), masked at M and N.
template <class T>
__device__ __forceinline__ void store_y(uint8_t* ring, const float (&acc)[T::NACC],
                                        const bf16* __restrict__ b, bf16* __restrict__ y, int M,
                                        int N, int m0, int n0, int act) {
  constexpr int SP = 2 * T::BN + 16, CHUNKS = T::BN / 8;   // 16-byte chunks a row
  static_assert(T::BM * SP <= T::RING_BYTES, "the staged tile fits the ring");
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 64 * (threadIdx.x / 128) + 16 * (t / 32) + lane / 4;
  __syncthreads();   // every warpgroup's wgmma is done with the ring
#pragma unroll
  for (int i = 0; i < T::BN / 8; ++i) {
    const int c = 8 * i + 2 * (lane % 4);
    const bool in = n0 + c < N;   // N is even: n0 + c + 1 < N too
    const float b0 = in ? __bfloat162float(b[n0 + c]) : 0.0f;
    const float b1 = in ? __bfloat162float(b[n0 + c + 1]) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float z0 = acc[4 * i + 2 * h] + b0, z1 = acc[4 * i + 2 * h + 1] + b1;
      if (act == 1) {
        z0 = __fdividef(1.0f, 1.0f + __expf(-z0));
        z1 = __fdividef(1.0f, 1.0f + __expf(-z1));
      }
      *reinterpret_cast<__nv_bfloat162*>(ring + (r0 + 8 * h) * SP + 2 * c) =
          __floats2bfloat162_rn(z0, z1);
    }
  }
  __syncthreads();
  const uintptr_t pitch = 2 * (uintptr_t)N, base = reinterpret_cast<uintptr_t>(y);
  const int y_bytes = (pitch | base) % 16 == 0 ? 16 : (pitch | base) % 8 == 0 ? 8 : 4;
  for (int idx = threadIdx.x; idx < T::BM * CHUNKS; idx += T::THREADS) {
    const int r = idx / CHUNKS, col = n0 + 8 * (idx % CHUNKS);
    if (m0 + r >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ring + r * SP + 16 * (idx % CHUNKS));
    bf16* dst = y + (size_t)(m0 + r) * N + col;
    if (y_bytes == 16) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else if (y_bytes == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
      if (col + 4 < N) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(v.z, v.w);
    } else {
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (col + 2 * p < N) *reinterpret_cast<uint32_t*>(dst + 2 * p) = u[p];
    }
  }
}


// ---------------------------------------------------------------------------
// the weight gradient: g = x^T e, In on wgmma's M, Out on its N
// ---------------------------------------------------------------------------

// the most splits of a tile reduced across a cluster (tile_plan.py
// CP_WGRAD_MAX_CLUSTER): 16 clusters of 8 blocks of the ROWS tile are not
// one wave on 132 SMs
constexpr int MAX_CLUSTER = 6;

// One warpgroup on 64 rows of g (In) by BN columns (Out), a ring of STAGES
// stages of BK bunch rows. x's stage is M-major (trans-a): 64 k-lines of
// 64 In, load_mn's box; e's is N-major (trans-b), boxes of 64 Out. BN 64:
// a column tile, e's stage as load_mn copies it. BN 136 (ROWS): one tile
// spans every column of an Out <= 136 (wgmma's N in steps of 8: 135 rounds
// up to 136, the third box's first 8 columns), so e's stage is BK whole
// rows, one run of memory, copied raw into one of RAW_SLOTS slots and
// realigned by the block into the boxes (realign_rows) one stage ahead of
// its wgmma. Split-K: a cluster of the tile's splits summing the partials
// through distributed shared memory (cluster_sum4).
template <int BN_, int STAGES_>
struct CpWgradTile {
  static constexpr int BN = BN_, STAGES = STAGES_, BM = 64, THREADS = 128;
  static constexpr bool ROWS = BN_ == 136;
  static constexpr int NACC = BN / 2;                       // f32 accumulators a thread
  static constexpr int A_BYTES = BOX;                       // 64 k-lines of 64 In
  static constexpr int B_BYTES = (BN + 63) / 64 * BOX;     // e: boxes of 64 Out
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int D = STAGES - 2;                      // stages of copies in flight
  static constexpr int RAW_SLOTS = ROWS ? D : 0;
  static constexpr int RAW_BYTES = BK * BN * 2;             // BK rows of e, Out <= BN
  static constexpr int RAW_OFF = STAGES * STAGE_BYTES;
  static constexpr int RING_BYTES = RAW_OFF + RAW_SLOTS * RAW_BYTES;
  static constexpr int SP = BN + 8;                         // a column tile's stash pitch, floats
  static constexpr int SMEM_BYTES = RING_BYTES + 1024;      // slack to align the ring to 1024
  static constexpr int MIN_BLOCKS = 228 * 1024 / (SMEM_BYTES + 1024);   // blocks an SM holds
  static_assert(BN == 64 || BN == 136, "wgmma widths");
  static_assert(STAGES >= (ROWS ? 4 : 3) && SMEM_BYTES <= 227 * 1024, "ring");
  static_assert(STAGE_BYTES % 1024 == 0 && BM * SP * 4 <= RING_BYTES, "layout");
};

// d (64 x 136, f32) += A (64 x 16, M-major) * B (16 x 136, N-major: three
// boxes, the third's first 8 columns read); the fragment layout above, 17
// column groups
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[68], uint64_t da, uint64_t db,
                                                 int scale_d) {
#define NNET_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 1, 1;\n}\n"
      : NNET_D4(0), NNET_D4(4), NNET_D4(8), NNET_D4(12), NNET_D4(16), NNET_D4(20), NNET_D4(24),
        NNET_D4(28), NNET_D4(32), NNET_D4(36), NNET_D4(40), NNET_D4(44), NNET_D4(48),
        NNET_D4(52), NNET_D4(56), NNET_D4(60), NNET_D4(64)
      : "l"(da), "l"(db), "r"(scale_d));
#undef NNET_D4
}

// one k16 step of the weight gradient's tile: x M-major, e N-major
template <class T>
__device__ __forceinline__ void wgmma_wgrad_k16(float (&d)[T::NACC], uint32_t a, uint32_t b,
                                                int kk, int scale_d) {
  const uint64_t da = W::smem_desc(a + kk * 16 * LINE, BOX, 1024);
  const uint64_t db = W::smem_desc(b + kk * 16 * LINE, BOX, 1024);
  if constexpr (T::ROWS)
    wgmma_m64n136k16(d, da, db, scale_d);
  else
    wgmma_m64n64k16<1>(d, da, db, scale_d);
}

// e's stage of BK whole rows (k-lines k0.. of an (B, Out) matrix, Out <=
// BN) into sr as it lies: one run of 2 Out BK bytes from a 16-byte aligned
// start (k0 a multiple of BK, e's base 16-byte aligned), copied by 16-byte
// cp.async, zero past k_end
template <class T>
__device__ __forceinline__ void load_run(uint8_t* sr, const bf16* __restrict__ e, int Out, int k0,
                                         int k_end) {
  const int units = BK * Out / 8;                             // 16-byte units of the run
  const int run = (min(k_end, k0 + BK) - k0) * Out * 2;       // bytes of real rows
  const uint8_t* g = reinterpret_cast<const uint8_t*>(e + (size_t)k0 * Out);
  for (int u = threadIdx.x; u < units; u += T::THREADS) {
    const int off = 16 * u, valid = max(0, min(16, run - off));
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(sr + off));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(valid ? g + off : g), "r"(valid));
  }
}

// The raw stage sr (BK k-lines of Out bf16, no padding) realigned into B,
// N-major: unit c (columns 8c .. 8c + 7) of k-line r at box c / 8, line r,
// unit (c % 8) ^ (r % 8), load_mn's layout (the third box holds 8 of its 64
// columns); columns n >= Out zero. A k-line starts 2 Out r bytes in, so a
// unit is 4 words of raw, or 5 shifted by a half where it starts mid-word.
// Unit idx of a thread: r = idx / 17, c = idx % 17, so a warp reads 32
// neighbouring units of one or two k-lines.
template <class T>
__device__ __forceinline__ void realign_rows(uint8_t* sb, const uint8_t* sr, int Out) {
  constexpr int CU = T::BN / 8, UNITS = BK * CU, N = (UNITS + T::THREADS - 1) / T::THREADS;
  constexpr int G = 3;   // units a thread holds at once: their loads before their stores
  const uint32_t* raw = reinterpret_cast<const uint32_t*>(sr);
#pragma unroll
  for (int l0 = 0; l0 < N; l0 += G) {
    uint32_t w[G][4];
    int off[G];
#pragma unroll
    for (int l = 0; l < G; ++l) {
      const int idx = threadIdx.x + (l0 + l) * T::THREADS;
      off[l] = -1;
      if (l0 + l >= N || idx >= UNITS) continue;
      const int r = idx / CU, c = idx % CU, h0 = r * Out + 8 * c;
      off[l] = (c / 8) * BOX + r * LINE + (((c % 8) ^ (r & 7)) << 4);
      const uint32_t* q = raw + h0 / 2;
      uint32_t v[5];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = q[j];
      v[4] = (h0 & 1) ? q[4] : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[l][j] = (h0 & 1) ? __funnelshift_r(v[j], v[j + 1], 16) : v[j];
      const int valid = Out - 8 * c;   // columns of the unit inside Out
      if (valid < 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[l][j] &= (2 * j < valid ? 0xFFFFu : 0u) | (2 * j + 1 < valid ? 0xFFFF0000u : 0u);
      }
    }
#pragma unroll
    for (int l = 0; l < G; ++l)
      if (off[l] >= 0)
        *reinterpret_cast<uint4*>(sb + off[l]) = make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
  }
}

// acc = g[m0.., n0..] over the bunch rows k_begin .. k_end, through the
// ring at `ring` (1024-byte aligned). x's copies (x_bytes: 16, 8 or 4) and
// column tiles' e copies (e_bytes) land in their stage's swizzled boxes;
// the ROWS tile's e stage lands raw and is realigned (realign_rows) one
// stage ahead of its wgmma, after the barrier that shows every thread's
// copies of it landed, and fenced (fence.proxy.async) before the barrier
// that hands it over. A stage is refilled two iterations after its wgmma
// (wgmma_wait<1>, one barrier an iteration), a raw slot once its stage is
// realigned.
template <class T>
__device__ __forceinline__ void wgrad_mainloop(uint8_t* ring, const bf16* __restrict__ x,
                                               const bf16* __restrict__ e, int In, int Out,
                                               int m0, int n0, int k_begin, int k_end,
                                               int x_bytes, int e_bytes, float (&acc)[T::NACC]) {
  constexpr int D = T::D, AHEAD = T::ROWS ? 1 : 0;   // stages landed before a stage's wgmma
  auto stage = [&](int s) { return ring + (s % T::STAGES) * T::STAGE_BYTES; };
  auto raw = [&](int s) {
    return ring + T::RAW_OFF + (s % (T::RAW_SLOTS ? T::RAW_SLOTS : 1)) * T::RAW_BYTES;
  };
  auto copy = [&](int s) {
    const int k0 = k_begin + s * BK;
    uint8_t* st = stage(s);
    if (x_bytes == 16)
      load_mn<64, T::THREADS, 16>(st, x, In, m0, k0, k_end);
    else if (x_bytes == 8)
      load_mn<64, T::THREADS, 8>(st, x, In, m0, k0, k_end);
    else
      load_mn<64, T::THREADS, 4>(st, x, In, m0, k0, k_end);
    if constexpr (T::ROWS) {
      load_run<T>(raw(s), e, Out, k0, k_end);
    } else {
      if (e_bytes == 16)
        load_mn<T::BN, T::THREADS, 16>(st + T::A_BYTES, e, Out, n0, k0, k_end);
      else if (e_bytes == 8)
        load_mn<T::BN, T::THREADS, 8>(st + T::A_BYTES, e, Out, n0, k0, k_end);
      else
        load_mn<T::BN, T::THREADS, 4>(st + T::A_BYTES, e, Out, n0, k0, k_end);
    }
  };
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.0f;
  const int ktiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < ktiles) copy(s);
    nnet_tile::cp_async_commit();   // one group a stage, empty or not, keeps the count
  }
  if constexpr (T::ROWS) {          // stage 0's realignment
    nnet_tile::cp_async_wait<D - 1>();
    __syncthreads();
    realign_rows<T>(stage(0) + T::A_BYTES, raw(0), Out);
    W::fence_proxy_async();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    nnet_tile::cp_async_wait<D - 1 - AHEAD>();   // this thread's copies of stage kt + AHEAD
    W::fence_proxy_async();                      // ... visible to wgmma
    __syncthreads();   // everyone's; stage kt realigned; the wgmma of kt - 2 retired
    if (kt + D < ktiles) copy(kt + D);   // into the stage of kt - 2, the raw slot of kt
    nnet_tile::cp_async_commit();
    const uint32_t a = W::smem_u32(stage(kt)), b = a + T::A_BYTES;
    W::fence_acc(acc);
    W::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_wgrad_k16<T>(acc, a, b, kk, kt > 0 || kk > 0);
    W::wgmma_commit();
    W::wgmma_wait<1>();   // the group of stage kt - 1 has read its stage
    W::fence_acc(acc);
    if constexpr (T::ROWS) {
      if (kt + 1 < ktiles) {   // stage kt + 1's copies landed for everyone at the barrier
        realign_rows<T>(stage(kt + 1) + T::A_BYTES, raw(kt + 1), Out);
        W::fence_proxy_async();
      }
    }
  }
  W::wgmma_wait<0>();
  W::fence_acc(acc);
  nnet_tile::cp_async_wait<0>();
}

// The fragments (acc[4i + 2h + e] at row 16 q + l/4 + 8h, column 8i + 2(l %
// 4) + e of thread 32 q + l) as f32 into st, once every thread is done with
// the ring: a column tile row-major at pitch SP (a warp's float2 stores
// fall in distinct banks), the ROWS tile's Out columns flat, row r at r
// Out, the padded columns dropped.
template <class T>
__device__ __forceinline__ void stash_acc(float* st, const float (&acc)[T::NACC], int Out) {
  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32) + lane / 4;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::NACC / 4; ++i) {
    const int c = 8 * i + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if constexpr (T::ROWS) {
        if (c < Out) st[r * Out + c] = acc[4 * i + 2 * h];
        if (c + 1 < Out) st[r * Out + c + 1] = acc[4 * i + 2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(st + r * T::SP + c) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ const float* cluster_ptr(const float* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

// the cluster's barrier: every block's shared-memory writes before it
// (release) seen by every block after it (acquire)
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The float4 at float offset off of the f32 stash st (16-byte aligned),
// summed over the stashes of the cluster's blocks 0, 1, ..., n - 1 (n <=
// MAX) in that order, each sum rounded on its own (two launches give the
// same bits); every block's load issued before the first add
template <int MAX>
__device__ __forceinline__ float4 cluster_sum4(const float* st, int off, int n) {
  float4 q[MAX];
#pragma unroll
  for (int r = 0; r < MAX; ++r)
    q[r] = r < n ? *reinterpret_cast<const float4*>(cluster_ptr(st, r) + off)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 sum = q[0];
#pragma unroll
  for (int r = 1; r < MAX; ++r)
    if (r < n) {
      sum.x = __fadd_rn(sum.x, q[r].x);
      sum.y = __fadd_rn(sum.y, q[r].y);
      sum.z = __fadd_rn(sum.z, q[r].z);
      sum.w = __fadd_rn(sum.w, q[r].w);
    }
  return sum;
}

}  // namespace nnet_cpw
