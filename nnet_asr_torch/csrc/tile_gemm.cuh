// The GEMM main loops shared by matmul_act.cu and sgd_fused.cu: products on
// Hopper's tensor cores into an f32 accumulator, fed by a cp.async ring.
// Two operand types, one ring:
//
// f32 operands, 3xTF32. mma.sync m16n8k8 multiplies TF32 (10 explicit
// mantissa bits) into an f32 accumulator. Each f32 operand element is split
// in registers into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and the
// product is accumulated as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the small
// terms first, into the one f32 accumulator). Only lo*lo is dropped, about
// 2^-22 of each product: the order of f32's own rounding over K = 4096, so
// the result agrees with an f32 FFMA GEMM to f32 accuracy. One pass of TF32
// keeps about three decimal digits and is not used.
//
// bf16 operands (the bf16 compute mode). mma.sync m16n8k16 multiplies bf16
// into the f32 accumulator in one pass: a bf16 product is exact in f32, so
// the result is the f32-accumulated sum that JAX's
// preferred_element_type=float32 asks for. Fragments come from shared
// memory by ldmatrix, .trans for an operand stored MN-major (W and e, and
// the x of x^T e), so the shared tiles keep the global row layout here too.
//
// Which shapes this loop serves: those the wgmma routes leave. On an H100
// mma.sync issues TF32 at about half of wgmma's rate, so the 3xTF32 loop
// here stays under half of its bound (tools/gemm_ceiling.py times it with
// the split taken out). f32 operands that TMA can describe (pitches of
// 16-byte multiples) in products whose 128x128 tiles fill the card (the
// production stack's) run on tf32_wgmma.cuh instead, which puts the
// MN-major operand that TF32 wgmma cannot read from shared memory in
// registers and the other through a split pre-pass; bf16 ones that TMA can
// describe run on wgmma_gemm.cuh, whose 16-bit wgmma reads MN-major tiles
// (its transpose bits), and the bf16 forward at rows of whole 4-byte units
// that TMA cannot describe (MLP3's x at 598 columns, TIMIT's W at 500) on
// cp_wgmma.cuh; f32 ones whose 128x128 tiles would not fill the card (the
// recipes' f32 products) on cp_tf32_wgmma.cuh (3xTF32 wgmma fed by
// cp.async, x split in the block). This loop serves every other shape:
// MLP3's f32 weight gradient of 135 outputs (an odd Out, which the card
// ran faster here), f32 products of the BIG tile's size that TMA cannot
// read, the bf16 weight gradients off TMA and bf16 rows of odd pitch (135
// elements).
// mma.sync fragments are loaded by each
// thread from a shared tile of either layout, and the hi/lo split happens
// in those registers.
//
// Tiles. A block computes a BM x BN output tile with WARPS_M x WARPS_N
// warps, each a WM x WN sub-tile of (WM/16) x (WN/8) mma tiles. The
// contraction runs BK at a time through a ring of STAGES shared-memory
// stages filled by cp.async: tile kt+STAGES-1 is in flight while tile kt is
// multiplied, with one cp.async.wait_group and one barrier per BK step.
// Shared tiles keep the global row layout, so every copy is a contiguous
// run of a row (pitches in elements, Ring below):
//   A K-major (x of x @ W):    As[m][k], pitch BK + 4 (f32), BK + 8 (bf16)
//   A M-major (x of x^T e):    As[k][m], pitch BM + 8
//   B N-major (W, and e):      Bs[k][n], pitch BN + 8
// With those pads the fragment loads of a warp hit 32 distinct banks: an
// f32 K-major fragment reads (row g, col t) at g*(BK+4) + t = 4g + t (mod
// 32), an MN-major one reads (k t, m g) at t*(BM+8) + g = 8t + g (mod 32),
// for g = lane/4 and t = lane%4; the 8 rows of 16 bytes that one ldmatrix
// phase reads lie an odd number of 16-byte units apart (80, 144 or 272
// bytes), so they fall in 8 distinct groups of 4 banks.
//
// Copies. Where a matrix's row pitch is a multiple of 16 bytes and its base
// is 16-byte aligned, each copy moves 16 bytes (cp.async.cg); otherwise 8
// or 4 bytes (cp.async.ca), the widest the pitch and base allow. The main
// path needs all three: x at 598 columns has f32 rows of 2,392 bytes (8-byte
// copies) and e at 135 rows of 540 (4-byte), which no 16-byte copy (nor
// TMA) can describe. A bf16 row of 135 elements (270 bytes) has an odd pitch
// in 4-byte words, and cp.async has no 2-byte size: that operand is read by
// plain loads into registers and stored to shared memory, which the barrier
// ahead of the tile's use makes visible. Elements outside the matrix, or
// past the end of this block's K range (split-K), are zero-filled. The host
// picks the copy width per operand (ops/kernels/tile_plan.py).
//
// Split-K. Where the SMALL tiles alone leave the card's warp slots empty
// (the plan aims at two blocks an SM), gridDim.z blocks share a tile, each
// over k_chunk rows of the contraction, and the block that arrives last sums
// their f32 partials in split order before the epilogue, in the same launch
// (reduce_splits): one launch a call, no float atomics, the same bits from
// two launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nnet_tile {

using bf16 = __nv_bfloat16;

// SMALL_: the SMALL route's two additions, split-K reduced in the launch
// and (for f32 operands) 8-byte copies, compiled into its tiles only: the
// BIG tile's kernels keep the code and registers they had without them,
// and the bf16 ones, whose main-path rows take 4-byte copies, skip the
// 8-byte path, which cost them 4% (tools/gemm_ceiling.py --small).
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_, bool SMALL_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr bool SMALL = SMALL_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp sub-tile
  static constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles per warp
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma tiling");
};

// The two tiles of ops/kernels/tile_plan.py (BIG = 0, SMALL = 1): 128x128
// with 8 warps of 64x32 where the grid fills the card, else 64x64 with a
// 4-stage ring (72 KB for f32 operands) and 4 warps of 32x32 (SmallTile:
// the weight gradients and the bf16 forward, up to three blocks an SM) or,
// for the f32 forward, 8 warps of 32x16 (SmallTile8: two blocks an SM by
// registers), so that a grid of one block an SM (TIMIT's 1024x368->500:
// 128 tiles, which no split evens out) still gives each scheduler two
// warps.
using BigTile = Tile<128, 128, 32, 2, 4, 3>;
using SmallTile = Tile<64, 64, 32, 2, 2, 4, true>;
using SmallTile8 = Tile<64, 64, 32, 2, 4, 4, true>;

// The ring's layout for operand type E (float or bf16): row pitches and
// stage sizes in elements of E.
template <class T, class E>
struct Ring {
  static constexpr int A_KMAJ_PITCH = T::BK + (sizeof(E) == 4 ? 4 : 8);   // As[m][k]
  static constexpr int A_MMAJ_PITCH = T::BM + 8;                          // As[k][m]
  static constexpr int B_PITCH = T::BN + 8;                               // Bs[k][n]
  static constexpr int A_KMAJ_STAGE = T::BM * A_KMAJ_PITCH;
  static constexpr int A_MMAJ_STAGE = T::BK * A_MMAJ_PITCH;
  static constexpr int B_STAGE = T::BK * B_PITCH;
};

// Dynamic shared memory of a kernel: the ring, or the epilogue's staged
// BM x (BN + 8) f32 output tile where that is larger (the bf16 ring is).
template <class T, class E, bool A_KMAJOR>
constexpr size_t smem_bytes() {
  using R = Ring<T, E>;
  constexpr size_t ring =
      sizeof(E) * T::STAGES * ((A_KMAJOR ? R::A_KMAJ_STAGE : R::A_MMAJ_STAGE) + R::B_STAGE);
  constexpr size_t out = sizeof(float) * T::BM * (T::BN + 8);
  return ring > out ? ring : out;
}

// ---------------------------------------------------------------------------
// element conversions of the epilogues
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_rn(float* p, float v) { *p = v; }
// round to nearest even, as JAX's astype
__device__ __forceinline__ void store_rn(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// cp.async of BYTES (16, 8 or 4) bytes, zero-filled where !ok; 16-byte
// copies bypass L1 (.cg), the smaller sizes exist only as .ca
template <int BYTES>
__device__ __forceinline__ void cp_async(void* s, const void* g, bool ok) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sa), "l"(g),
                 "n"(BYTES), "r"(ok ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero: half of the 13
// dropped bits added to the magnitude, then cleared. For finite x this is
// cvt.rna.tf32.f32 bit for bit, but it runs on the integer pipe instead of
// the conversion unit, which issues a quarter as many results per clock;
// with cvt the splits, not the tensor cores, set the main loop's time.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lanes 8q..8q+7 give the row
// addresses of matrix q, whose element (row l/4, cols 2(l%4), +1) lands in
// r[q] of lane l; .trans delivers (rows 2(l%4), +1; col l/4) instead.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---------------------------------------------------------------------------
// global -> shared
// ---------------------------------------------------------------------------

// The copies of load_tile below in runs of BYTES bytes (BYTES / sizeof(E)
// elements), each run wholly inside or outside the matrix.
template <int BYTES, class E, int ROWS, int COLS, int SP, int THREADS>
__device__ __forceinline__ void copy_runs(E* s, const E* __restrict__ g, int ld, int r0, int c0,
                                          int rows_end, int cols_end) {
  constexpr int V = BYTES / sizeof(E), RUNS = COLS / V;
  static_assert((ROWS * RUNS) % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int l = 0; l < ROWS * RUNS / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int r = idx / RUNS, c = (idx % RUNS) * V;
    const bool ok = r0 + r < rows_end && c0 + c < cols_end;
    cp_async<BYTES>(s + r * SP + c, ok ? g + (size_t)(r0 + r) * ld + (c0 + c) : g, ok);
  }
}

// Start the copy of the ROWS x COLS tile at (r0, c0) of a row-major matrix g
// (row pitch ld elements) into s (row pitch SP), zero-filling rows >=
// rows_end and columns >= cols_end, in copies of `bytes` (16, 8 (COPY8
// only: f32 operands on the SMALL tiles), 4 or 2). A width of 16, 8 or 4 bytes needs ld and
// g's base aligned to it (then cols_end, the matrix width or a multiple of
// BK, holds whole runs: a run is wholly inside or outside).
template <class E, int ROWS, int COLS, int SP, int THREADS, bool COPY8>
__device__ __forceinline__ void load_tile(E* s, const E* __restrict__ g, int ld, int r0, int c0,
                                          int rows_end, int cols_end, int bytes) {
  if (bytes == 16) {
    copy_runs<16, E, ROWS, COLS, SP, THREADS>(s, g, ld, r0, c0, rows_end, cols_end);
  } else if (COPY8 && bytes == 8) {
    if constexpr (COPY8)
      copy_runs<8, E, ROWS, COLS, SP, THREADS>(s, g, ld, r0, c0, rows_end, cols_end);
  } else if (sizeof(E) == 4 || bytes == 4) {
    copy_runs<4, E, ROWS, COLS, SP, THREADS>(s, g, ld, r0, c0, rows_end, cols_end);
  } else {
    // 2-byte elements on an odd pitch: every load, then every store
    constexpr int N = ROWS * COLS / THREADS;
    static_assert((ROWS * COLS) % THREADS == 0, "2-byte copies per thread");
    const uint16_t* gb = reinterpret_cast<const uint16_t*>(g);
    uint16_t* sb = reinterpret_cast<uint16_t*>(s);
    uint16_t v[N];
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int idx = threadIdx.x + l * THREADS;
      const int r = idx / COLS, c = idx % COLS;
      v[l] = r0 + r < rows_end && c0 + c < cols_end ? gb[(size_t)(r0 + r) * ld + (c0 + c)] : 0;
    }
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int idx = threadIdx.x + l * THREADS;
      sb[(idx / COLS) * SP + idx % COLS] = v[l];
    }
  }
}

// A K-major: a is (M, K) with pitch lda; A M-major: a is (K, M), the
// product uses its transpose. b is (K, N) with pitch ldb.
template <class T, class E, bool A_KMAJOR>
__device__ __forceinline__ void load_stage(E* sa, E* sb, const E* a, int lda, int a_bytes,
                                           const E* b, int ldb, int b_bytes, int M, int N, int m0,
                                           int n0, int k0, int k_end) {
  using R = Ring<T, E>;
  // 8-byte copies: f32 operands on the SMALL tile (f32 rows of 598)
  constexpr bool COPY8 = T::SMALL && sizeof(E) == 4;
  if constexpr (A_KMAJOR) {
    load_tile<E, T::BM, T::BK, R::A_KMAJ_PITCH, T::THREADS, COPY8>(sa, a, lda, m0, k0, M, k_end,
                                                                   a_bytes);
  } else {
    load_tile<E, T::BK, T::BM, R::A_MMAJ_PITCH, T::THREADS, COPY8>(sa, a, lda, k0, m0, k_end, M,
                                                                   a_bytes);
  }
  load_tile<E, T::BK, T::BN, R::B_PITCH, T::THREADS, COPY8>(sb, b, ldb, k0, n0, k_end, N, b_bytes);
}

// ---------------------------------------------------------------------------
// shared -> tensor cores
// ---------------------------------------------------------------------------

// acc += the warp's WM x WN sub-tile of (A stage) x (B stage), 3xTF32.
// Fragment layouts of m16n8k8 (g = lane/4, t = lane%4): a0 (g, t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g).
template <class T, bool A_KMAJOR>
__device__ __forceinline__ void mma_stage(const float* sa, const float* sb, int wm0, int wn0,
                                          float (&acc)[T::MT][T::NT][4]) {
  using R = Ring<T, float>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 8) {
    uint32_t ahi[T::MT][4], alo[T::MT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int r = wm0 + i * 16 + g;
      float v[4];
      if constexpr (A_KMAJOR) {
        const float* q = sa + r * R::A_KMAJ_PITCH + kk + t;
        v[0] = q[0];
        v[1] = q[8 * R::A_KMAJ_PITCH];
        v[2] = q[4];
        v[3] = q[8 * R::A_KMAJ_PITCH + 4];
      } else {
        const float* q = sa + (kk + t) * R::A_MMAJ_PITCH + r;
        v[0] = q[0];
        v[1] = q[8];
        v[2] = q[4 * R::A_MMAJ_PITCH];
        v[3] = q[4 * R::A_MMAJ_PITCH + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], ahi[i][e], alo[i][e]);
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const float* q = sb + (kk + t) * R::B_PITCH + wn0 + j * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(q[0], bhi[0], blo[0]);
      split_tf32(q[4 * R::B_PITCH], bhi[1], blo[1]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma_tf32(acc[i][j], alo[i], bhi);
        mma_tf32(acc[i][j], ahi[i], blo);
        mma_tf32(acc[i][j], ahi[i], bhi);
      }
    }
  }
}

// acc += the warp's WM x WN sub-tile of (A stage) x (B stage), bf16.
// Fragments of m16n8k16 (g = lane/4, t = lane%4, pairs of bf16 per
// register): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g). One ldmatrix.x4 gives
// an A fragment (the four 8x8 quarters of the 16x16 tile, q = lane/8 at
// rows +8(q&1), columns +8(q>>1)), or the B fragments of two neighbouring
// 8-column tiles (k +8(q&1), n +8(q>>1)).
template <class T, bool A_KMAJOR>
__device__ __forceinline__ void mma_stage(const bf16* sa, const bf16* sb, int wm0, int wn0,
                                          float (&acc)[T::MT][T::NT][4]) {
  using R = Ring<T, bf16>;
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 16) {
    uint32_t a[T::MT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int m = wm0 + i * 16 + (q & 1) * 8;
      if constexpr (A_KMAJOR)
        ldmatrix_x4(a[i], sa + (m + r8) * R::A_KMAJ_PITCH + kk + (q >> 1) * 8);
      else
        ldmatrix_x4_trans(a[i], sa + (kk + (q >> 1) * 8 + r8) * R::A_MMAJ_PITCH + m);
    }
#pragma unroll
    for (int j = 0; j < T::NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + (kk + (q & 1) * 8 + r8) * R::B_PITCH + wn0 + j * 8 +
                               (q >> 1) * 8);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// acc = A[m0:m0+BM, k_begin:k_end] @ B[k_begin:k_end, n0:n0+BN] for this
// thread's fragments, through the cp.async ring in dynamic shared memory
// (E = float: 3xTF32; E = bf16: one bf16 pass). a_bytes, b_bytes: the copy
// width of each operand (16, 4 or, for bf16, 2).
template <class T, class E, bool A_KMAJOR>
__device__ __forceinline__ void gemm_mainloop(E* smem, const E* a, int lda, int a_bytes,
                                              const E* b, int ldb, int b_bytes, int M, int N,
                                              int m0, int n0, int k_begin, int k_end,
                                              float (&acc)[T::MT][T::NT][4]) {
  using R = Ring<T, E>;
  constexpr int AS = A_KMAJOR ? R::A_KMAJ_STAGE : R::A_MMAJ_STAGE;
  constexpr int STAGE = AS + R::B_STAGE;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / T::WARPS_N) * T::WM, wn0 = (warp % T::WARPS_N) * T::WN;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ktiles = (k_end - k_begin + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage<T, E, A_KMAJOR>(smem + s * STAGE, smem + s * STAGE + AS, a, lda, a_bytes, b, ldb,
                                 b_bytes, M, N, m0, n0, k_begin + s * T::BK, k_end);
    cp_async_commit();   // one group per stage, empty or not, keeps the count
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();                  // everyone's did; and tile kt-1 is consumed
    const int next = kt + T::STAGES - 1;
    if (next < ktiles) {
      E* st = smem + (next % T::STAGES) * STAGE;   // the slot of tile kt-1
      load_stage<T, E, A_KMAJOR>(st, st + AS, a, lda, a_bytes, b, ldb, b_bytes, M, N, m0, n0,
                                 k_begin + next * T::BK, k_end);
    }
    cp_async_commit();
    const E* st = smem + (kt % T::STAGES) * STAGE;
    mma_stage<T, A_KMAJOR>(st, st + AS, wm0, wn0, acc);
  }
  cp_async_wait<0>();
}

// The accumulator fragments (c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1) of each mma tile, the same for m16n8k8 and m16n8k16)
// staged in shared memory, reusing the ring (smem_bytes makes room): a
// BM x BN f32 tile of pitch BN + 8, written as float2, free of bank
// conflicts per half-warp (8g + 2t).
template <class T>
__device__ __forceinline__ void stage_acc(float* smem, const float (&acc)[T::MT][T::NT][4]) {
  constexpr int CP = T::BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / T::WARPS_N) * T::WM + (lane >> 2);
  const int c0 = (warp % T::WARPS_N) * T::WN + 2 * (lane & 3);
  __syncthreads();   // every warp is done with the ring's last stage
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(smem + (r0 + i * 16 + 8 * h) * CP + c0 + j * 8) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
}

// The staged tile's float4 number threadIdx.x + l * THREADS (row-major, 16
// a row of 64): its offset in floats (tile pitch BN + 8).
template <class T>
__device__ __forceinline__ int own_at(int l) {
  const int idx = threadIdx.x + l * T::THREADS;
  return (idx / (T::BN / 4)) * (T::BN + 8) + 4 * (idx % (T::BN / 4));
}

// Split-K in one launch. Block (x, y, z) of a grid of gridDim.z splits holds
// split z of the tile y * gridDim.x + x, staged by stage_acc. Each split
// writes its f32 tile whole (no bounds: scratch) to part[tile][z] and
// takes a ticket: after a barrier, one thread's __threadfence (cumulative
// over the writes the barrier ordered before it, the pattern of CUTLASS's
// split-K semaphore) makes the partial visible device-wide before its
// atomicAdd on the tile's int counter. The block that draws the last ticket
// fences again, reads the other partials through L2 (__ldcg, never a stale
// L1 line) and sums all of them in split order 0, 1, ..., S-1
// (its own from shared memory), each sum rounded on its own (__fadd_rn), so
// the result does not depend on which split arrives last; it leaves the sum
// in the staged tile, resets the counter to 0 for the next launch, and
// returns true: it runs the epilogue. The others return false and exit. No
// float atomics, so two launches on the same inputs give the same bits.
// With one split, or on a BIG tile (never split), it returns true at once.
template <class T>
__device__ __forceinline__ bool reduce_splits(float* smem, float* __restrict__ part,
                                              int* __restrict__ counters) {
  if constexpr (!T::SMALL) {
    return true;
  } else {
    const int splits = gridDim.z, split = blockIdx.z;
    if (splits == 1) return true;
    constexpr int TILE4 = T::BM * T::BN / 4, N = TILE4 / T::THREADS;   // float4s
    static_assert(TILE4 % T::THREADS == 0, "whole float4s per thread");
    __shared__ int last;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    // this thread's float4s of split 0 of the tile; split s at + s * TILE4
    float4* base = reinterpret_cast<float4*>(part) + (size_t)tile * splits * TILE4 + threadIdx.x;
#pragma unroll
    for (int l = 0; l < N; ++l)
      __stcg(base + (size_t)split * TILE4 + l * T::THREADS,
             *reinterpret_cast<const float4*>(smem + own_at<T>(l)));
    __syncthreads();   // every thread's partial is issued
    if (threadIdx.x == 0) {
      __threadfence();   // cumulative: the block's partial is visible before its ticket
      last = atomicAdd(counters + tile, 1) == splits - 1;
      if (last) __threadfence();   // and the other partials before the reads below
    }
    __syncthreads();
    if (!last) return false;
    // the sum in split order, this block's own partial from shared memory;
    // two splits' loads in flight at a time
    float4 g[N];
#pragma unroll
    for (int l = 0; l < N; ++l)
      g[l] = split == 0 ? *reinterpret_cast<const float4*>(smem + own_at<T>(l))
                        : __ldcg(base + l * T::THREADS);
#pragma unroll 2
    for (int s = 1; s < splits; ++s) {
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const float4 q = s == split ? *reinterpret_cast<const float4*>(smem + own_at<T>(l))
                                    : __ldcg(base + (size_t)s * TILE4 + l * T::THREADS);
        g[l] = make_float4(__fadd_rn(g[l].x, q.x), __fadd_rn(g[l].y, q.y),
                           __fadd_rn(g[l].z, q.z), __fadd_rn(g[l].w, q.w));
      }
    }
#pragma unroll
    for (int l = 0; l < N; ++l) *reinterpret_cast<float4*>(smem + own_at<T>(l)) = g[l];
    if (threadIdx.x == 0) counters[tile] = 0;
    __syncthreads();
    return true;
  }
}

// The epilogue: f(row, col, value) over the staged output tile, U elements
// per call (arrays of U), with consecutive threads on consecutive columns,
// so each warp's reads and writes around f (bias, p, v, y) are whole
// 128-byte rows, and f can issue all U elements' loads before any store (a
// store through one pointer would otherwise hold back every later load
// through another that might alias it). f checks the matrix bounds itself.
template <class T, int U, class F>
__device__ __forceinline__ void epilogue(const float* smem, int m0, int n0, F&& f) {
  constexpr int CP = T::BN + 8;
  constexpr int ELEMS = T::BM * T::BN / T::THREADS;   // per thread
  static_assert(ELEMS % U == 0, "whole calls");
#pragma unroll 1
  for (int l0 = 0; l0 < ELEMS; l0 += U) {
    int r[U], c[U];
    float val[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = threadIdx.x + (l0 + u) * T::THREADS;
      r[u] = idx / T::BN;
      c[u] = idx % T::BN;
      val[u] = smem[r[u] * CP + c[u]];
      r[u] += m0;
      c[u] += n0;
    }
    f(r, c, val);
  }
}

// Raise the kernel's dynamic shared-memory limit to what it uses (needed
// above 48 KB). Returns the CUDA error code.
template <class K>
inline int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace nnet_tile
