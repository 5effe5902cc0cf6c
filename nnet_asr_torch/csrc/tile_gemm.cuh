// The GEMM main loop shared by matmul_act.cu and sgd_fused.cu: f32-accurate
// products on Hopper's tensor cores by 3xTF32, fed by a cp.async ring.
//
// 3xTF32. mma.sync m16n8k8 multiplies TF32 (10 explicit mantissa bits)
// into an f32 accumulator. Each f32 operand element is split in registers
// into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and the product is
// accumulated as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the small terms first,
// into the one f32 accumulator). Only lo*lo is dropped, about 2^-22 of each
// product: the order of f32's own rounding over K = 4096, so the result
// agrees with an f32 FFMA GEMM to f32 accuracy. One pass of TF32 keeps
// about three decimal digits and is not used.
//
// Why mma.sync and not wgmma: TF32 wgmma takes both operands K-major from
// shared memory, but affine_sigmoid's W (K x N) is N-major and both x and e
// of the wgrad product x^T e are M/N-major. mma.sync fragments are loaded by
// each thread from an f32 shared tile of either layout, and the hi/lo split
// happens in those registers. The price: on an H100, mma.sync issues TF32
// at about half of wgmma's rate, so this loop stays under half of the
// 3xTF32 bound (tools/gemm_ceiling.py times it with the split taken out).
//
// Tiles. A block computes a BM x BN output tile with WARPS_M x WARPS_N
// warps, each a WM x WN sub-tile of (WM/16) x (WN/8) mma tiles. The
// contraction runs BK at a time through a ring of STAGES shared-memory
// stages filled by cp.async: tile kt+STAGES-1 is in flight while tile kt is
// multiplied, with one cp.async.wait_group and one barrier per BK step.
// Shared tiles keep the global row layout, so every copy is a contiguous
// run of a row:
//   A K-major (x of x @ W):    As[m][k], pitch BK + 4
//   A M-major (x of x^T e):    As[k][m], pitch BM + 8
//   B N-major (W, and e):      Bs[k][n], pitch BN + 8
// With those pads the fragment loads of a warp hit 32 distinct banks: a
// K-major fragment reads (row g, col t) at g*(BK+4) + t = 4g + t (mod 32),
// an MN-major one reads (k t, m g) at t*(BM+8) + g = 8t + g (mod 32), for
// g = lane/4 and t = lane%4.
//
// Copies. Where a matrix's row pitch is a multiple of 4 floats and its base
// is 16-byte aligned, each copy moves 16 bytes (cp.async.cg); otherwise 4
// bytes (cp.async.ca). The main path needs both: x at 598 columns and e at
// 135 have rows of 2,392 and 540 bytes, which no 16-byte copy (nor TMA) can
// describe. Elements outside the matrix, or past the end of this block's
// K range (split-K), are zero-filled by a source size of 0. The host picks
// the copy path per operand (ops/kernels/tile_plan.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nnet_tile {

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp sub-tile
  static constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles per warp
  static constexpr int A_KMAJ_PITCH = BK + 4;                  // As[m][k]
  static constexpr int A_MMAJ_PITCH = BM + 8;                  // As[k][m]
  static constexpr int B_PITCH = BN + 8;                       // Bs[k][n]
  static constexpr int A_KMAJ_STAGE = BM * A_KMAJ_PITCH;       // floats per stage
  static constexpr int A_MMAJ_STAGE = BK * A_MMAJ_PITCH;
  static constexpr int B_STAGE = BK * B_PITCH;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 8 == 0, "mma tiling");
};

// The two tiles of ops/kernels/tile_plan.py (BIG = 0, SMALL = 1): 128x128
// with 8 warps of 64x32 where the grid fills the card, else 64x64 with 4
// warps of 32x32.
using BigTile = Tile<128, 128, 32, 2, 4, 3>;
using SmallTile = Tile<64, 64, 32, 2, 2, 4>;

template <class T, bool A_KMAJOR>
constexpr size_t smem_bytes() {
  return sizeof(float) * T::STAGES *
         ((A_KMAJOR ? T::A_KMAJ_STAGE : T::A_MMAJ_STAGE) + T::B_STAGE);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* s, const float* g, bool ok) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g, bool ok) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa), "l"(g),
               "r"(ok ? 4 : 0));
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

// ---------------------------------------------------------------------------
// global -> shared
// ---------------------------------------------------------------------------

// Start the copy of the ROWS x COLS tile at (r0, c0) of a row-major matrix g
// (row pitch ld) into s (row pitch SP), zero-filling rows >= rows_end and
// columns >= cols_end. vec: 16-byte copies, which needs ld % 4 == 0 and g
// 16-byte aligned (then cols_end, the matrix width or a multiple of BK, is
// a multiple of 4 and a 4-wide run is wholly inside or outside).
template <int ROWS, int COLS, int SP, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g, int ld,
                                          int r0, int c0, int rows_end, int cols_end,
                                          bool vec) {
  if (vec) {
    constexpr int RUNS = COLS / 4;
    static_assert((ROWS * RUNS) % THREADS == 0, "16-byte copies per thread");
#pragma unroll
    for (int l = 0; l < ROWS * RUNS / THREADS; ++l) {
      const int idx = threadIdx.x + l * THREADS;
      const int r = idx / RUNS, c = (idx % RUNS) * 4;
      const bool ok = r0 + r < rows_end && c0 + c < cols_end;
      cp_async16(s + r * SP + c, ok ? g + (size_t)(r0 + r) * ld + (c0 + c) : g, ok);
    }
  } else {
    static_assert((ROWS * COLS) % THREADS == 0, "4-byte copies per thread");
#pragma unroll
    for (int l = 0; l < ROWS * COLS / THREADS; ++l) {
      const int idx = threadIdx.x + l * THREADS;
      const int r = idx / COLS, c = idx % COLS;
      const bool ok = r0 + r < rows_end && c0 + c < cols_end;
      cp_async4(s + r * SP + c, ok ? g + (size_t)(r0 + r) * ld + (c0 + c) : g, ok);
    }
  }
}

// A K-major: a is (M, K) with pitch lda; A M-major: a is (K, M), the
// product uses its transpose. b is (K, N) with pitch ldb.
template <class T, bool A_KMAJOR>
__device__ __forceinline__ void load_stage(float* sa, float* sb, const float* a, int lda,
                                           bool a_vec, const float* b, int ldb, bool b_vec,
                                           int M, int N, int m0, int n0, int k0, int k_end) {
  if constexpr (A_KMAJOR) {
    load_tile<T::BM, T::BK, T::A_KMAJ_PITCH, T::THREADS>(sa, a, lda, m0, k0, M, k_end, a_vec);
  } else {
    load_tile<T::BK, T::BM, T::A_MMAJ_PITCH, T::THREADS>(sa, a, lda, k0, m0, k_end, M, a_vec);
  }
  load_tile<T::BK, T::BN, T::B_PITCH, T::THREADS>(sb, b, ldb, k0, n0, k_end, N, b_vec);
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
        const float* q = sa + r * T::A_KMAJ_PITCH + kk + t;
        v[0] = q[0];
        v[1] = q[8 * T::A_KMAJ_PITCH];
        v[2] = q[4];
        v[3] = q[8 * T::A_KMAJ_PITCH + 4];
      } else {
        const float* q = sa + (kk + t) * T::A_MMAJ_PITCH + r;
        v[0] = q[0];
        v[1] = q[8];
        v[2] = q[4 * T::A_MMAJ_PITCH];
        v[3] = q[4 * T::A_MMAJ_PITCH + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], ahi[i][e], alo[i][e]);
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const float* q = sb + (kk + t) * T::B_PITCH + wn0 + j * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(q[0], bhi[0], blo[0]);
      split_tf32(q[4 * T::B_PITCH], bhi[1], blo[1]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma_tf32(acc[i][j], alo[i], bhi);
        mma_tf32(acc[i][j], ahi[i], blo);
        mma_tf32(acc[i][j], ahi[i], bhi);
      }
    }
  }
}

// acc = A[m0:m0+BM, k_begin:k_end] @ B[k_begin:k_end, n0:n0+BN] for this
// thread's fragments, through the cp.async ring in dynamic shared memory.
template <class T, bool A_KMAJOR>
__device__ __forceinline__ void gemm_mainloop(float* smem, const float* a, int lda, bool a_vec,
                                              const float* b, int ldb, bool b_vec, int M, int N,
                                              int m0, int n0, int k_begin, int k_end,
                                              float (&acc)[T::MT][T::NT][4]) {
  constexpr int AS = A_KMAJOR ? T::A_KMAJ_STAGE : T::A_MMAJ_STAGE;
  constexpr int STAGE = AS + T::B_STAGE;
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
      load_stage<T, A_KMAJOR>(smem + s * STAGE, smem + s * STAGE + AS, a, lda, a_vec, b, ldb,
                              b_vec, M, N, m0, n0, k_begin + s * T::BK, k_end);
    cp_async_commit();   // one group per stage, empty or not, keeps the count
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();                  // everyone's did; and tile kt-1 is consumed
    const int next = kt + T::STAGES - 1;
    if (next < ktiles) {
      float* st = smem + (next % T::STAGES) * STAGE;   // the slot of tile kt-1
      load_stage<T, A_KMAJOR>(st, st + AS, a, lda, a_vec, b, ldb, b_vec, M, N, m0, n0,
                              k_begin + next * T::BK, k_end);
    }
    cp_async_commit();
    const float* st = smem + (kt % T::STAGES) * STAGE;
    mma_stage<T, A_KMAJOR>(st, st + AS, wm0, wn0, acc);
  }
  cp_async_wait<0>();
}

// The epilogue: f(row, col, value) for the block's output tile, U elements
// per call (arrays of U), with consecutive threads on consecutive columns,
// so each warp's reads and writes around f (bias, p, v, y) are whole
// 128-byte rows, and f can issue all U elements' loads before any store (a
// store through one pointer would otherwise hold back every later load
// through another that might alias it). The fragments (c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1) of each mma tile) go through
// shared memory first, reusing the ring: a BM x BN tile of pitch BN + 8,
// written as float2, free of bank conflicts per half-warp (8g + 2t). f
// checks the matrix bounds itself.
template <class T, int U, class F>
__device__ __forceinline__ void epilogue(float* smem, int m0, int n0,
                                         const float (&acc)[T::MT][T::NT][4], F&& f) {
  constexpr int CP = T::BN + 8;
  constexpr int ELEMS = T::BM * T::BN / T::THREADS;   // per thread
  static_assert(ELEMS % U == 0, "whole calls");
  static_assert(T::BM * CP <= T::STAGES * (T::A_MMAJ_STAGE + T::B_STAGE) &&
                    T::BM * CP <= T::STAGES * (T::A_KMAJ_STAGE + T::B_STAGE),
                "the output tile fits in the ring");
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
