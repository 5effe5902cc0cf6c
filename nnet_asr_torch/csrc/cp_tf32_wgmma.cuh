// The f32 GEMM main loops of the recipes' widths: 3xTF32 on wgmma, fed by
// cp.async. matmul_act.cu (y = act(x @ W + b)) and sgd_fused.cu (g = x^T e,
// then the momentum update) run f32 products whose 128x128 tiles do not
// fill the card on them, whatever their pitches (ops/kernels/tile_plan.py
// picks the route: CP_WGMMA, mainloop below, or WS_WGMMA, the
// warp-specialised ring at the end, for the weight gradient of an odd
// Out). They replace tile_gemm.cuh's mma.sync
// loop, which issues TF32 at about half of wgmma's rate, for the TPU
// kernels nnet_asr_tpu/ops/pallas/matmul_act.py (matmul_act /
// affine_sigmoid) and nnet_asr_tpu/ops/pallas/sgd_fused.py
// (wgrad_momentum_update).
//
// Arithmetic: tile_gemm.cuh's and tf32_wgmma.cuh's, f32-accurate. Each f32
// element is split into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and
// every k8 step accumulates a_lo*b_hi, a_hi*b_lo, then a_hi*b_hi into one
// f32 accumulator. The tensor core reads the low 13 bits of an f32 as zero
// and does not round, so the split happens before an operand reaches wgmma.
// TF32 wgmma has no transpose bits: its shared-memory operand B must be
// K-major and split already; A, held in registers (the RS form), is the
// MN-major operand, brought raw by cp.async, each thread splitting its own
// fragment.
//
// What bounds these products on an H100 is neither operations nor device
// memory (960x598->1024 is 1.2 GFLOP, 7.1 us at the 165 TFLOP/s of 3xTF32,
// over 6.4 MB, 1.9 us at 3.35 TB/s) but latency: tools/gemm_ceiling.py
// --small --f32 took mainloop apart at 960x598->1024 (NVIDIA H100 80GB
// HBM3, 700 W): 27 us alone, 5.5 us less with one TF32 pass in place of
// three, 5 us less with no split of x, so neither the tensor cores nor the
// split sets its pace but the chain of each stage.
//
// mainloop (CP_WGMMA): out^T = A B with A = W (the forward: y^T = W^T x^T)
// or e (the weight gradient: g^T = e^T x) and B = x. The block's own
// warpgroups copy, split and multiply:
//   - x split in shared memory by the block, no pre-pass: the forward's raw
//     x lands K-major and swizzled in the hi buffer and is split in place,
//     16 bytes a thread; the weight gradient's raw x (32 k-lines of NB
//     columns) is transposed on the way, a thread reading 4 k of one column
//     and writing one 16-byte unit of hi and of lo (neither side conflicts
//     on the banks);
//   - the split runs one stage ahead of the stage being multiplied, fenced
//     (fence.proxy.async: generic writes, read by wgmma through the async
//     proxy) before the one barrier an iteration that hands it over; the
//     copies run STAGES - 2 stages ahead;
//   - 64 x rows by 128 A columns on two warpgroups (each wgmma.m64n64k8 over
//     its 64 A rows, both over the same split B), a 4-stage ring; 64x64 on
//     one warpgroup, 128x64, deeper rings, a pre-pass and two accumulator
//     chains were measured slower;
//   - A's raw k-lines of 64 floats in 16-byte units, unit u of k-line k at
//     u ^ 2 (k % 4): a thread's fragment is two neighbouring columns (its A
//     rows g and g + 8 dealt to columns 2g and 2g + 1), one 8-byte load at
//     k-lines t and t + 4;
//   - ragged edges by zero fill; copies of 16, 8 or 4 bytes, the widest the
//     pitch and base allow (tile_plan.copy_bytes), so a run is wholly inside
//     or outside;
//   - split-K where the tiles leave SMs idle (tile_plan.cp_f32_splits) by
//     cp_wgmma.cuh's reduce_acc: each split's fragments to scratch, the last
//     ticket of a tile summing them in split order in the same launch (no
//     float atomics: two launches give the same bits);
//   - epilogues from the fragments (store_y, update_pv).
//
// The warp-specialised ring (WS_WGMMA; the WS note at its section) runs
// the weight gradient of an odd Out the other way round, g = x^T e with Out
// on wgmma's N (A = x, B = e, N the 136 columns of MLP3's 135 outputs
// rounded up to 8): one producer warpgroup issues every copy and transposes
// and splits e, a consumer warpgroup only splits its x fragments and issues
// wgmma, full and empty mbarriers a slot in place of a barrier an
// iteration; split-K is reduced across a cluster of the tile's splits
// through distributed shared memory. What the card measured of it, against
// mma.sync and cuBLAS, is in tile_plan.ws_f32_takes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_wgmma.cuh"
#include "tf32_wgmma.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace nnet_cpf {

namespace W = nnet_wgmma;

constexpr int BK = 32;                // f32 a stage: one 128-byte line of a K-major row
constexpr int A_LINE = 256;           // bytes of an A k-line of one warpgroup: 64 floats
constexpr int A_SUB = BK * A_LINE;    // 8 KB: one warpgroup's A columns of a stage
constexpr int B_ROW = 128;            // bytes of a K-major B row: 32 floats

// How B (x) arrives: raw K-major, split in place (the forward); raw
// MN-major, transposed and split (the weight gradient); or split already
// by a pre-pass into K-major hi and lo copies (the candidate
// tools/gemm_ceiling.py times against the in-block split)
enum { FWD = 0, WGRAD = 1, PRESPLIT = 2 };

// accumulator chains a warpgroup keeps: 1, or 2 (odd k8 steps into a second
// accumulator, added to the first after the loop; tools/gemm_ceiling.py's
// cp_f32_acc2 build, which ran slower: the kernels keep 1 and the
// arithmetic above)
constexpr int CHAINS = 1;

// WG warpgroups of 64 A rows each (out's BN = 64 WG columns), NB B columns
// (out's BM rows), a ring of STAGES stages, B by MODE. The slots each
// buffer needs: A STAGES - 2 (its fragments are loaded a stage ahead, so a
// slot is free once the stage before has been prepared); (FWD, PRESPLIT)
// hi STAGES (x lands there STAGES - 2 stages ahead and stays until its
// wgmma has retired); the split's lo (and WGRAD's hi) 3, the one being
// split, the one being multiplied and the one whose wgmma may still run;
// WGRAD's raw x STAGES - 2, the stages in flight.
template <int WG_, int NB_, int STAGES_, int MODE_>
struct CpF32Tile {
  static constexpr int WG = WG_, NB = NB_, STAGES = STAGES_, MODE = MODE_;
  static constexpr int MIN_BLOCKS = 1;          // __launch_bounds__'s blocks an SM
  static constexpr int THREADS = 128 * WG;
  static constexpr int BM = NB, BN = 64 * WG;   // out's rows (M or In) and columns (N or Out)
  static constexpr int NACC = NB / 2;           // f32 accumulators a thread
  static constexpr int A_SLOT = WG * A_SUB;
  static constexpr int A_SLOTS = STAGES - 2;    // a stage's fragments load a stage ahead
  static constexpr int B_SLOT = NB * B_ROW;     // NB rows of 32 k; a raw MN-major stage too
  static constexpr int HI_SLOTS = MODE == WGRAD ? 3 : STAGES;
  static constexpr int LO_SLOTS = MODE == PRESPLIT ? STAGES : 3;
  static constexpr int RAW_SLOTS = MODE == WGRAD ? STAGES - 2 : 0;
  static constexpr int HI_OFF = A_SLOTS * A_SLOT;
  static constexpr int LO_OFF = HI_OFF + HI_SLOTS * B_SLOT;
  static constexpr int RAW_OFF = LO_OFF + LO_SLOTS * B_SLOT;
  static constexpr int RING_BYTES = RAW_OFF + RAW_SLOTS * B_SLOT;
  static constexpr int SMEM_BYTES = RING_BYTES + 1024;   // slack to align the ring to 1024
  static_assert(NB == 64 || NB == 128, "wgmma widths");
  static_assert(STAGES >= 4 && SMEM_BYTES <= 227 * 1024, "ring");
};

// ---------------------------------------------------------------------------
// wgmma, TF32, A from registers
// ---------------------------------------------------------------------------

// d (64 x 64, f32) += A (64 x 8, TF32 from registers) * B (8 x 64, TF32,
// K-major in shared memory); d[4i + 2h + e] at row 16w + g + 8h, column
// 8i + 2t + e (w the warp, g = lane / 4, t = lane % 4)
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
#define NNET_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#undef NNET_D8
}

template <int NB>
__device__ __forceinline__ void wgmma_k8(float (&d)[NB / 2], const uint32_t* a, uint64_t db) {
  if constexpr (NB == 64)
    wgmma_m64n64k8_rs(d, a, db);
  else
    nnet_tf32::wgmma_m64n128k8_rs(d, a, db);
}

// keeps the compiler from reusing the registers of an A fragment that an
// issued wgmma may still read
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(f[i])::"memory");
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// global -> shared
// ---------------------------------------------------------------------------

// A's copies: k-lines k0.. of src (pitch lda, ncols columns), columns a0 ..
// a0 + 64 WG; warpgroup s's 64 columns of k-line r at s * A_SUB + r *
// A_LINE, 16-byte unit u at u ^ 2 (r % 4); by NT threads, this one tid
template <class T, int BYTES, int NT = T::THREADS>
__device__ __forceinline__ void load_a(uint8_t* sa, const float* __restrict__ src, int lda,
                                       int ncols, int a0, int k0, int k_end, int tid) {
  constexpr int RUNS = 4 * T::BN / BYTES, N = BK * RUNS / NT;
  static_assert((BK * RUNS) % NT == 0, "whole copies a thread");
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int idx = tid + l * NT;
    const int r = idx / RUNS, byte = (idx % RUNS) * BYTES;
    const int in = byte % A_LINE, col = a0 + byte / 4;
    const bool ok = k0 + r < k_end && col < ncols;
    const int unit = (in >> 4) ^ ((r & 3) << 1);
    nnet_tile::cp_async<BYTES>(sa + (byte / A_LINE) * A_SUB + r * A_LINE + ((unit << 4) | (in & 15)),
                               ok ? src + (size_t)(k0 + r) * lda + col : src, ok);
  }
}

// K-major B copies: rows b0.. of src (pitch ldb, nrows rows), k from k0;
// row r's 16-byte unit u at r * B_ROW + (u ^ (r % 8)) * 16, the layout the
// descriptors read; by NT threads, this one tid
template <class T, int BYTES, int NT = T::THREADS>
__device__ __forceinline__ void load_b_kmajor(uint8_t* sb, const float* __restrict__ src,
                                              int ldb, int nrows, int b0, int k0, int k_end,
                                              int tid) {
  constexpr int RUNS = B_ROW / BYTES, N = T::NB * RUNS / NT;
  static_assert((T::NB * RUNS) % NT == 0, "whole copies a thread");
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int idx = tid + l * NT;
    const int r = idx / RUNS, byte = (idx % RUNS) * BYTES;
    const int k = k0 + byte / 4;
    const bool ok = b0 + r < nrows && k < k_end;
    nnet_tile::cp_async<BYTES>(sb + r * B_ROW + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15)),
                               ok ? src + (size_t)(b0 + r) * ldb + k : src, ok);
  }
}

// MN-major raw B copies: k-lines k0.. of src (pitch ldb, ncols columns),
// columns b0 .. b0 + NB, as they are (k-line r at r * 4 NB)
template <class T, int BYTES>
__device__ __forceinline__ void load_b_raw(uint8_t* sr, const float* __restrict__ src, int ldb,
                                           int ncols, int b0, int k0, int k_end) {
  constexpr int RUNS = 4 * T::NB / BYTES, N = BK * RUNS / T::THREADS;
  static_assert((BK * RUNS) % T::THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int idx = threadIdx.x + l * T::THREADS;
    const int r = idx / RUNS, byte = (idx % RUNS) * BYTES;
    const int col = b0 + byte / 4;
    const bool ok = k0 + r < k_end && col < ncols;
    nnet_tile::cp_async<BYTES>(sr + r * 4 * T::NB + byte,
                               ok ? src + (size_t)(k0 + r) * ldb + col : src, ok);
  }
}

// The operands of a product out^T (MA x NB, K deep) = A B: A the (K, MA)
// row-major matrix a (pitch lda), B the K-major (NB, K) matrix b (pitch
// ldb; MODE PRESPLIT: b its hi and b_lo its lo copy) or, in MODE WGRAD, the
// MN-major (K, NB) one; copy widths a_bytes, b_bytes (16, 8 or 4)
struct Operands {
  const float* a;
  int lda, ma;
  const float* b;
  const float* b_lo;
  int ldb, nb;
  int a_bytes, b_bytes;
};

template <class T, int BYTES>
__device__ __forceinline__ void load_b(uint8_t* dst, uint8_t* dst_lo, const Operands& o, int b0,
                                       int k0, int k_end) {
  if constexpr (T::MODE == WGRAD) {
    load_b_raw<T, BYTES>(dst, o.b, o.ldb, o.nb, b0, k0, k_end);
  } else {
    load_b_kmajor<T, BYTES>(dst, o.b, o.ldb, o.nb, b0, k0, k_end, threadIdx.x);
    if constexpr (T::MODE == PRESPLIT)
      load_b_kmajor<T, BYTES>(dst_lo, o.b_lo, o.ldb, o.nb, b0, k0, k_end, threadIdx.x);
  }
}

// ---------------------------------------------------------------------------
// the split in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 split4(float4 v, uint4& lo) {
  uint4 hi;
  nnet_tile::split_tf32(v.x, hi.x, lo.x);
  nnet_tile::split_tf32(v.y, hi.y, lo.y);
  nnet_tile::split_tf32(v.z, hi.z, lo.z);
  nnet_tile::split_tf32(v.w, hi.w, lo.w);
  return hi;
}

// FWD: the raw stage in sh (K-major, swizzled) split in place, hi into sh
// and lo into sl at the same offsets, a 16-byte unit a thread at a time.
// WGRAD: the raw stage sr (32 k-lines of NB floats) transposed: the unit u
// of B row j (k 4u .. 4u + 3 of column j) into sh and sl at j * B_ROW +
// (u ^ (j % 8)) * 16; thread idx takes column j = idx % NB, so a warp's
// reads are 32 neighbouring words of a k-line.
template <class T>
__device__ __forceinline__ void split_stage(uint8_t* sh, uint8_t* sl, const uint8_t* sr) {
  constexpr int N = T::B_SLOT / 16 / T::THREADS;
  static_assert((T::B_SLOT / 16) % T::THREADS == 0, "whole units a thread");
  float4 v[N];   // every load before the first store
  int off[N];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int idx = threadIdx.x + l * T::THREADS;
    if constexpr (T::MODE == FWD) {
      off[l] = 16 * idx;
      v[l] = *reinterpret_cast<const float4*>(sh + off[l]);
    } else {
      const int j = idx % T::NB, u = idx / T::NB;
      const float* raw = reinterpret_cast<const float*>(sr) + 4 * u * T::NB + j;
      off[l] = j * B_ROW + ((u ^ (j & 7)) << 4);
      v[l] = make_float4(raw[0], raw[T::NB], raw[2 * T::NB], raw[3 * T::NB]);
    }
  }
#pragma unroll
  for (int l = 0; l < N; ++l) {
    uint4 lo;
    const uint4 hi = split4(v[l], lo);
    *reinterpret_cast<uint4*>(sh + off[l]) = hi;
    *reinterpret_cast<uint4*>(sl + off[l]) = lo;
  }
}

// This thread's A fragments of a stage, split: f[8kk + i] = hi of a_i of
// k8 step kk, f[8kk + 4 + i] = its lo. a_i of wgmma's m64 x k8 fragment is
// (row g + 8 (i % 2), k t + 4 (i / 2)) of the warp's 16 rows; A row 16w +
// g + 8h is column 16w + 2g + h of the warpgroup's 64, so (a0, a1) and
// (a2, a3) are one 8-byte load each, at k-lines t and t + 4. off: the
// thread's offset of k-line t in the stage.
__device__ __forceinline__ void load_frags(uint32_t a, uint32_t off, uint32_t (&f)[32]) {
  float2 v[BK / 4];   // every load before the first split
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) v[i] = lds2(a + off + 4 * i * A_LINE);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const float2 v0 = v[2 * kk], v4 = v[2 * kk + 1];
    nnet_tile::split_tf32(v0.x, f[8 * kk], f[8 * kk + 4]);
    nnet_tile::split_tf32(v0.y, f[8 * kk + 1], f[8 * kk + 5]);
    nnet_tile::split_tf32(v4.x, f[8 * kk + 2], f[8 * kk + 6]);
    nnet_tile::split_tf32(v4.y, f[8 * kk + 3], f[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// the main loop
// ---------------------------------------------------------------------------

// acc = out^T[a0 + 64 wg .., b0 ..] over k_begin .. k_end for warpgroup wg,
// through the ring at `ring` (1024-byte aligned); see the top
template <class T>
__device__ __forceinline__ void mainloop(uint8_t* ring, const Operands& o, int a0, int b0,
                                         int k_begin, int k_end, float (&acc)[T::NACC]) {
  constexpr int D = T::STAGES - 2;   // stages of copies in flight
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t frag_off =
      wg * A_SUB + t * A_LINE + ((((4 * w + (g >> 1)) ^ (t << 1)) << 4) | ((g & 1) << 3));
  auto a_slot = [&](int s) { return ring + (s % T::A_SLOTS) * T::A_SLOT; };
  auto hi_slot = [&](int s) { return ring + T::HI_OFF + (s % T::HI_SLOTS) * T::B_SLOT; };
  auto lo_slot = [&](int s) { return ring + T::LO_OFF + (s % T::LO_SLOTS) * T::B_SLOT; };
  auto raw_slot = [&](int s) {
    return T::RAW_SLOTS ? ring + T::RAW_OFF + (s % (T::RAW_SLOTS ? T::RAW_SLOTS : 1)) * T::B_SLOT
                        : ring;
  };
  const int ktiles = (k_end - k_begin + BK - 1) / BK;
  float acc2[CHAINS == 2 ? T::NACC : 1];   // the second chain's accumulators
  auto copy = [&](int s) {
    const int k0 = k_begin + s * BK;
    uint8_t* sa = a_slot(s);
    if (o.a_bytes == 16)
      load_a<T, 16>(sa, o.a, o.lda, o.ma, a0, k0, k_end, threadIdx.x);
    else if (o.a_bytes == 8)
      load_a<T, 8>(sa, o.a, o.lda, o.ma, a0, k0, k_end, threadIdx.x);
    else
      load_a<T, 4>(sa, o.a, o.lda, o.ma, a0, k0, k_end, threadIdx.x);
    uint8_t* sb = T::MODE == WGRAD ? raw_slot(s) : hi_slot(s);
    if (o.b_bytes == 16)
      load_b<T, 16>(sb, lo_slot(s), o, b0, k0, k_end);
    else if (o.b_bytes == 8)
      load_b<T, 8>(sb, lo_slot(s), o, b0, k0, k_end);
    else
      load_b<T, 4>(sb, lo_slot(s), o, b0, k0, k_end);
  };
  // stage s's split (none for PRESPLIT) and this thread's A fragments of it
  auto prepare = [&](int s, uint32_t (&f)[32]) {
    if constexpr (T::MODE != PRESPLIT) split_stage<T>(hi_slot(s), lo_slot(s), raw_slot(s));
    W::fence_proxy_async();   // the split's writes, visible to wgmma after the next barrier
    load_frags(W::smem_u32(a_slot(s)), frag_off, f);
  };
  // stage kt's wgmma group with fragments cur, then stage kt + 1 prepared
  // into nxt, whose registers the group of stage kt - 1 read
  auto step = [&](int kt, uint32_t (&cur)[32], uint32_t (&nxt)[32]) {
    nnet_tile::cp_async_wait<D - 2>();   // this thread's copies of stage kt + 1 landed
    W::fence_proxy_async();
    __syncthreads();   // everyone's; stage kt is split; the wgmma of kt - 2 has retired
    if (kt + D < ktiles) copy(kt + D);   // into the slots of stage kt - 2
    nnet_tile::cp_async_commit();        // one group a stage, empty or not, keeps the count
    const uint32_t bh = W::smem_u32(hi_slot(kt)), bl = W::smem_u32(lo_slot(kt));
    W::fence_acc(acc);
    W::fence_acc(acc2);
    W::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = W::smem_desc(bh + kk * 32, 16, 1024);
      const uint64_t dl = W::smem_desc(bl + kk * 32, 16, 1024);
      auto terms = [&](auto& d) {
        wgmma_k8<T::NB>(d, cur + 8 * kk + 4, dh);   // lo * hi
        wgmma_k8<T::NB>(d, cur + 8 * kk, dl);       // hi * lo
        wgmma_k8<T::NB>(d, cur + 8 * kk, dh);       // hi * hi
      };
      if constexpr (CHAINS == 2) {
        if (kk & 1)
          terms(acc2);
        else
          terms(acc);
      } else {
        terms(acc);
      }
    }
    W::wgmma_commit();
    W::wgmma_wait<1>();   // the group of stage kt - 1 is done with nxt's registers
    W::fence_acc(acc);
    W::fence_acc(acc2);
    fence_regs(nxt);
    if (kt + 1 < ktiles) prepare(kt + 1, nxt);
  };
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (CHAINS == 2 ? T::NACC : 1); ++i) acc2[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < ktiles) copy(s);
    nnet_tile::cp_async_commit();
  }
  uint32_t f0[32] = {}, f1[32] = {};
  nnet_tile::cp_async_wait<D - 1>();   // stage 0
  __syncthreads();
  prepare(0, f0);
  for (int kt = 0; kt < ktiles; kt += 2) {
    step(kt, f0, f1);
    if (kt + 1 < ktiles) step(kt + 1, f1, f0);
  }
  W::wgmma_wait<0>();
  W::fence_acc(acc);
  W::fence_acc(acc2);
  fence_regs(f0);
  fence_regs(f1);
  nnet_tile::cp_async_wait<0>();
  if constexpr (CHAINS == 2) {
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = __fadd_rn(acc[i], acc2[i]);
  }
}

// ---------------------------------------------------------------------------
// epilogues, from the fragments
// ---------------------------------------------------------------------------

// A thread's two columns of out: c0 = a0 + 64 wg + 16 w + 2 g (and c0 + 1,
// acc[4i + 2 + e]); its rows r = b0 + 8i + 2t + e (acc[4i + e]).
__device__ __forceinline__ int col_of(int a0) {
  const int lane = threadIdx.x & 31;
  return a0 + 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x >> 5) & 3) + 2 * (lane >> 2);
}
__device__ __forceinline__ int row_of(int b0, int i, int e) {
  return b0 + 8 * i + 2 * (threadIdx.x & 3) + e;
}

// y = act(z + b) at rows m0.., columns n0.. (y (M, N) row-major; bias: the
// thread's two columns of b, bias_of, fetched before the main loop) added in f32, the sigmoid as tile_gemm.cuh's epilogue takes it (expf and
// an IEEE divide); the two columns as one 8-byte store where N is even and
// y 8-byte aligned
__device__ __forceinline__ float2 bias_of(const float* __restrict__ b, int N, int n0) {
  const int n = col_of(n0);
  return make_float2(n < N ? b[n] : 0.0f, n + 1 < N ? b[n + 1] : 0.0f);
}

template <class T>
__device__ __forceinline__ void store_y(const float (&acc)[T::NACC], float2 bias,
                                        float* __restrict__ y, int M, int N, int m0, int n0,
                                        int act) {
  const int n = col_of(n0);
  if (n >= N) return;
  const bool two = n + 1 < N;
  const bool pair = N % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  const float b0 = bias.x, b1 = bias.y;
#pragma unroll
  for (int i = 0; i < T::NB / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = row_of(m0, i, e);
      if (m >= M) continue;
      float z0 = acc[4 * i + e] + b0, z1 = acc[4 * i + 2 + e] + b1;
      if (act == 1) {
        z0 = 1.0f / (1.0f + expf(-z0));
        z1 = 1.0f / (1.0f + expf(-z1));
      }
      float* q = y + (size_t)m * N + n;
      if (pair) {
        *reinterpret_cast<float2*>(q) = make_float2(z0, z1);
      } else {
        q[0] = z0;
        if (two) q[1] = z1;
      }
    }
}

__device__ __forceinline__ float2 load2(const float* q) {
  return *reinterpret_cast<const float2*>(q);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* q) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
}
__device__ __forceinline__ void store2(float* q, float2 v) {
  *reinterpret_cast<float2*>(q) = v;
}
// round to nearest even, as JAX's astype
__device__ __forceinline__ void store2(__nv_bfloat16* q, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v.x, v.y);
}

// v <- g + m v; p <- p - a v for one element, in f32 with no contraction
// (p takes v before its rounding to v's type)
__device__ __forceinline__ void momentum(float g, float& p, float& v, float a, float m) {
  v = __fadd_rn(g, __fmul_rn(v, m));
  p = __fsub_rn(p, __fmul_rn(v, a));
}

// The weight gradient's update at rows in0.., columns out0.. of p and v
// (In, Out) from g^T's fragments, 8 rows of p and v loaded before the first
// store, with sgd_fused.cu's arithmetic; the two columns as 8-byte p and
// v pairs (4-byte for bf16 v) where Out is even and p and v aligned to them
template <class T, class V>
__device__ __forceinline__ void update_pv(const float (&acc)[T::NACC], float* __restrict__ p,
                                          V* __restrict__ v, float a, float m, int In, int Out,
                                          int in0, int out0) {
  const int o = col_of(out0);
  if (o >= Out) return;
  const bool two = o + 1 < Out;
  const bool pair = Out % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % (2 * sizeof(V)) == 0;
#pragma unroll
  for (int i0 = 0; i0 < T::NB / 8; i0 += 4) {
    float2 pv[8], vv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = row_of(in0, i0 + j / 2, j % 2);
      const size_t off = (size_t)r * Out + o;
      pv[j] = vv[j] = make_float2(0.0f, 0.0f);
      if (r >= In) continue;
      if (pair) {
        pv[j] = load2(p + off);
        vv[j] = load2(v + off);
      } else {
        pv[j].x = p[off];
        vv[j].x = nnet_tile::to_f32(v[off]);
        if (two) {
          pv[j].y = p[off + 1];
          vv[j].y = nnet_tile::to_f32(v[off + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j / 2, e = j % 2;
      const int r = row_of(in0, i, e);
      if (r >= In) continue;
      const size_t off = (size_t)r * Out + o;
      momentum(acc[4 * i + e], pv[j].x, vv[j].x, a, m);
      momentum(acc[4 * i + 2 + e], pv[j].y, vv[j].y, a, m);
      if (pair) {
        store2(v + off, vv[j]);
        store2(p + off, pv[j]);
      } else {
        nnet_tile::store_rn(v + off, vv[j].x);
        p[off] = pv[j].x;
        if (two) {
          nnet_tile::store_rn(v + off + 1, vv[j].y);
          p[off + 1] = pv[j].y;
        }
      }
    }
  }
}

// The tile both kernels are built with (tile_plan.CP_F32_TILE and
// CP_F32_STAGES): 64 rows of x by 128 columns of W or e on two warpgroups
// of 64 columns each, sharing x's split, a 4-stage ring, two blocks an SM
// (tools/gemm_ceiling.py --small --f32: its cp_f32_* builds swap this line)
template <int MODE>
using CpF32Planned = CpF32Tile<2, 64, 4, MODE>;

// the ring of a kernel's dynamic shared memory, aligned to 1024 bytes
__device__ __forceinline__ uint8_t* ring_of(uint8_t* smem) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
}


// ---------------------------------------------------------------------------
// the warp-specialised ring
// ---------------------------------------------------------------------------

// A block of one consumer warpgroup (threads 0 .. 127) and one producer
// warpgroup (threads 128 .. 255), 255 registers a thread for both, one
// block an SM, for the weight gradient g = x^T e with Out (at most NB) on
// wgmma's N. The producer issues every cp.async: A, x's raw k-lines, and
// e's stage, BK whole rows of e (one tile spans every column), one
// contiguous run of memory copied as such into a raw slot; it then
// transposes and splits that stage into B's K-major hi and lo buffers and
// hands it over through a full mbarrier. The consumers only load and split
// their A fragments and issue wgmma, and give each stage back through an
// empty mbarrier once its wgmma group has retired.

// named barriers: the producer warpgroup's own, and the consumers' (split-K)
constexpr int WS_PRODUCER_BAR = 1, WS_CONSUMER_BAR = 2;

// 64 A rows, NB B columns, STAGES slots of A's raw k-lines and B's hi and
// lo, the copies STAGES - 2 stages ahead of the split (the producer refills
// the slot of stage s - 2 while it hands over stage s, so its wait never
// waits on itself), and STAGES - 1 raw slots of e, the stages whose copies
// are in flight and the one being split
template <int NB_, int STAGES_>
struct WsF32Tile {
  static constexpr int NB = NB_, STAGES = STAGES_;
  static constexpr int CONSUMERS = 128;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int BM = NB, BN = 64;   // out's rows and columns, as CpF32Tile's
  static constexpr int NACC = NB / 2;
  static constexpr int D = STAGES - 2;          // stages of copies ahead of the split
  static constexpr int A_SLOT = A_SUB;
  static constexpr int B_SLOT = NB * B_ROW;     // hi or lo; a raw stage of e too
  static constexpr int STAGE = A_SLOT + 2 * B_SLOT;
  static constexpr int RAW_SLOTS = D + 1;
  static constexpr int RAW_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + RAW_SLOTS * B_SLOT;
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * 8 * STAGES + 1024;   // + barriers, slack
  static_assert(NB == 136, "the wgmma width compiled");
  static_assert(STAGES >= 3 && SMEM_BYTES <= 227 * 1024, "ring");
};

// d (64 x 136, f32) += A (64 x 8, TF32 from registers) * B (8 x 136, TF32,
// K-major in shared memory); the fragment of wgmma_m64n64k8_rs, 17 groups
// of 8 columns
__device__ __forceinline__ void wgmma_m64n136k8_rs(float (&d)[68], const uint32_t* a,
                                                   uint64_t db) {
#define NNET_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      : NNET_D4(0), NNET_D4(4), NNET_D4(8), NNET_D4(12), NNET_D4(16), NNET_D4(20), NNET_D4(24),
        NNET_D4(28), NNET_D4(32), NNET_D4(36), NNET_D4(40), NNET_D4(44), NNET_D4(48),
        NNET_D4(52), NNET_D4(56), NNET_D4(60), NNET_D4(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#undef NNET_D4
}

// cp.async of BYTES (16, 8 or 4) bytes of which the first `valid` come
// from g and the rest are zero
template <int BYTES>
__device__ __forceinline__ void cp_async_part(void* s, const void* g, int valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(g),
                 "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sa), "l"(g),
                 "n"(BYTES), "r"(valid));
}

// The stage of k-lines k0 .. k0 + BK of src (nb floats a row, no
// padding) as one run of bytes into sr, in units of BYTES (the widest src's
// base allows: the run starts at a multiple of 128 bytes), zero past
// k_end; by the producer's 128 threads, this one pt
template <int BYTES>
__device__ __forceinline__ void load_b_rows(uint8_t* sr, const float* __restrict__ src, int nb,
                                            int k0, int k_end, int pt) {
  const int units = BK * nb * 4 / BYTES;
  const int run = (min(k_end, k0 + BK) - k0) * nb * 4;   // bytes of the stage's rows
  const uint8_t* g = reinterpret_cast<const uint8_t*>(src + (size_t)k0 * nb);
  for (int u = pt; u < units; u += 128) {
    const int off = u * BYTES;
    const int valid = max(0, min(BYTES, run - off));
    cp_async_part<BYTES>(sr + off, valid ? g + off : g, valid);
  }
}

// The producer's split of stage s, the raw rows sr (pitch floats a
// k-line) transposed: unit u of B row j (k 4u .. 4u + 3 of column j) into
// sh and sl at j * B_ROW + (u ^ (j % 8)) * 16, a warp's reads 32
// neighbouring words of a k-line (split_stage's mapping)
template <class T>
__device__ __forceinline__ void ws_split(uint8_t* sh, uint8_t* sl, const uint8_t* sr, int pitch,
                                         int pt) {
  constexpr int UNITS = T::NB * (B_ROW / 16), N = (UNITS + 127) / 128;
  constexpr int G = 4;   // units a producer thread holds at once
#pragma unroll
  for (int l0 = 0; l0 < N; l0 += G) {
    float4 v[G];   // G units' loads before their first store
    int off[G];
#pragma unroll
    for (int l = 0; l < G; ++l) {
      const int idx = pt + (l0 + l) * 128;
      off[l] = -1;
      if (l0 + l >= N || idx >= UNITS) continue;
      const int j = idx % T::NB, u = idx / T::NB;
      const float* raw = reinterpret_cast<const float*>(sr) + 4 * u * pitch + j;
      off[l] = j * B_ROW + ((u ^ (j & 7)) << 4);
      v[l] = make_float4(raw[0], raw[pitch], raw[2 * pitch], raw[3 * pitch]);
    }
#pragma unroll
    for (int l = 0; l < G; ++l) {
      if (off[l] < 0) continue;
      uint4 lo;
      const uint4 hi = split4(v[l], lo);
      *reinterpret_cast<uint4*>(sh + off[l]) = hi;
      *reinterpret_cast<uint4*>(sl + off[l]) = lo;
    }
  }
}

__device__ __forceinline__ uint64_t* ws_bars(uint8_t* ring, int off) {
  return reinterpret_cast<uint64_t*>(ring + off);
}

// Before the roles part: thread 0 sets up the full barriers (the
// producer's 128 threads arrive) and the empty ones (a lane of each
// consumer warp), then the whole block meets once.
template <class T>
__device__ __forceinline__ void ws_init(uint8_t* ring) {
  uint64_t* full = ws_bars(ring, T::BAR_OFF);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      W::mbar_init(W::smem_u32(full + i), 128);
      W::mbar_init(W::smem_u32(full + T::STAGES + i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: stages 0 .. ktiles - 1 of the contraction
// k_begin .. k_end of g[a0.., every column]; see the WS note at the top
template <class T>
__device__ __forceinline__ void ws_produce(uint8_t* ring, const Operands& o, int a0, int k_begin,
                                           int k_end) {
  constexpr int D = T::D;
  const int pt = threadIdx.x - T::CONSUMERS;
  const int ktiles = (k_end - k_begin + BK - 1) / BK;
  uint64_t* full = ws_bars(ring, T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;
  auto slot = [&](int s) { return ring + (s % T::STAGES) * T::STAGE; };
  auto raw = [&](int s) { return ring + T::RAW_OFF + (s % T::RAW_SLOTS) * T::B_SLOT; };
  auto copy = [&](int s) {
    const int k0 = k_begin + s * BK;
    uint8_t* st = slot(s);
    if (o.a_bytes == 16)
      load_a<T, 16, 128>(st, o.a, o.lda, o.ma, a0, k0, k_end, pt);
    else if (o.a_bytes == 8)
      load_a<T, 8, 128>(st, o.a, o.lda, o.ma, a0, k0, k_end, pt);
    else
      load_a<T, 4, 128>(st, o.a, o.lda, o.ma, a0, k0, k_end, pt);
    if (o.b_bytes == 16)
      load_b_rows<16>(raw(s), o.b, o.nb, k0, k_end, pt);
    else if (o.b_bytes == 8)
      load_b_rows<8>(raw(s), o.b, o.nb, k0, k_end, pt);
    else
      load_b_rows<4>(raw(s), o.b, o.nb, k0, k_end, pt);
  };
#pragma unroll
  for (int s = 0; s < D; ++s) {   // the slots' first round: empty from the start
    if (s < ktiles) copy(s);
    nnet_tile::cp_async_commit();
  }
  for (int s = 0; s < ktiles; ++s) {
    nnet_tile::cp_async_wait<D - 1>();   // this thread's copies of stage s landed
    // everyone's; and everyone's split of stage s - 1 is done (its raw slot
    // is the one stage s + D refills)
    W::named_sync(WS_PRODUCER_BAR, 128);
    uint8_t* st = slot(s);
    ws_split<T>(st + T::A_SLOT, st + T::A_SLOT + T::B_SLOT, raw(s), o.nb, pt);
    W::fence_proxy_async();   // the split's writes, for wgmma's reads
    W::mbar_arrive(W::smem_u32(full + s % T::STAGES));
    const int n = s + D;
    if (n < ktiles) {
      if (n >= T::STAGES)   // the consumers gave back stage n - STAGES (<= s - 2)
        W::mbar_wait(W::smem_u32(empty + n % T::STAGES), (n / T::STAGES - 1) & 1);
      copy(n);
    }
    nnet_tile::cp_async_commit();   // one group a stage, empty or not, keeps the count
  }
  nnet_tile::cp_async_wait<0>();
}

// The consumers: acc = out^T[a0 .., b0 ..] over the producer's stages 0 ..
// ktiles - 1
template <class T>
__device__ __forceinline__ void ws_consume(uint8_t* ring, int ktiles, float (&acc)[T::NACC]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t frag_off =
      t * A_LINE + ((((4 * w + (g >> 1)) ^ (t << 1)) << 4) | ((g & 1) << 3));
  uint64_t* full = ws_bars(ring, T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;
  auto slot = [&](int s) { return ring + (s % T::STAGES) * T::STAGE; };
  auto ready = [&](int s, uint32_t (&f)[32]) {   // stage s handed over; its A fragments
    W::mbar_wait(W::smem_u32(full + s % T::STAGES), (s / T::STAGES) & 1);
    load_frags(W::smem_u32(slot(s)), frag_off, f);
  };
  // stage kt's wgmma group with fragments cur; stage kt - 1 given back once
  // its group has retired, then stage kt + 1's fragments into nxt
  auto step = [&](int kt, uint32_t (&cur)[32], uint32_t (&nxt)[32]) {
    const uint32_t bh = W::smem_u32(slot(kt) + T::A_SLOT), bl = bh + T::B_SLOT;
    W::fence_acc(acc);
    W::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t dh = W::smem_desc(bh + kk * 32, 16, 1024);
      const uint64_t dl = W::smem_desc(bl + kk * 32, 16, 1024);
      wgmma_m64n136k8_rs(acc, cur + 8 * kk + 4, dh);   // lo * hi
      wgmma_m64n136k8_rs(acc, cur + 8 * kk, dl);       // hi * lo
      wgmma_m64n136k8_rs(acc, cur + 8 * kk, dh);       // hi * hi
    }
    W::wgmma_commit();
    W::wgmma_wait<1>();   // the group of stage kt - 1 is done with its stage and nxt
    W::fence_acc(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) W::mbar_arrive(W::smem_u32(empty + (kt - 1) % T::STAGES));
    }
    fence_regs(nxt);
    if (kt + 1 < ktiles) ready(kt + 1, nxt);
  };
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.0f;
  uint32_t f0[32] = {}, f1[32] = {};
  ready(0, f0);
  for (int kt = 0; kt < ktiles; kt += 2) {
    step(kt, f0, f1);
    if (kt + 1 < ktiles) step(kt + 1, f1, f0);
  }
  W::wgmma_wait<0>();
  W::fence_acc(acc);
  fence_regs(f0);
  fence_regs(f1);
}

// ---------------------------------------------------------------------------
// the WS kernel's split-K and epilogue, across a cluster
// ---------------------------------------------------------------------------

// The S splits of a tile are one cluster of S blocks (cluster rank =
// blockIdx.z). Each block stashes its consumers' fragments in its own ring,
// the cluster meets, and each block then takes 1/S of the tile's output
// lines: it sums every split's partial of an element, read through
// distributed shared memory, in split order 0, 1, ..., S - 1 (each sum
// rounded on its own: two launches give the same bits), and writes the
// element, neighbouring threads on neighbouring elements of a line. The
// cluster meets again before any block exits, since the others read its
// stash. No partial goes through device memory, and the epilogue's writes
// spread over all S blocks. With S = 1, the block's own barrier. Both
// roles meet there, each from its own branch.
constexpr int WS_BLOCK_BAR = 3;

__device__ __forceinline__ void ws_sync(int splits) {
  if (splits > 1)
    nnet_cpw::cluster_barrier();
  else
    W::named_sync(WS_BLOCK_BAR, blockDim.x);
}

// the consumers' fragments into the ring: float4 j of thread t at j *
// CONSUMERS + t, once every warpgroup's wgmma is done with the ring
template <class T>
__device__ __forceinline__ void ws_stash(uint8_t* ring, const float (&acc)[T::NACC]) {
  static_assert(T::CONSUMERS * T::NACC * 4 <= T::STAGES * T::STAGE, "the stash fits the ring");
  W::named_sync(WS_CONSUMER_BAR, T::CONSUMERS);
  float4* q = reinterpret_cast<float4*>(ring) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < T::NACC / 4; ++j)
    q[j * T::CONSUMERS] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

// The stash's float4 of a pair of A rows and a pair of B columns: slot
// (i, t) of consumer thread 32 w + 4 g + t holds out^T at A rows (as the
// epilogues number them, col_of's) 2 q + h, q = 8 w + g, and B columns 8 i
// + 2 t + e, as component 2 h + e; summed over the splits, in split order,
// every split's load issued before the first add
__device__ __forceinline__ float4 ws_sum(const float4* stash, int q, int i, int t, int splits) {
  constexpr int MAX = 8;   // the largest portable cluster
  const int idx = i * 128 + 4 * q + t;
  if (splits == 1) return stash[idx];
  return nnet_cpw::cluster_sum4<MAX>(reinterpret_cast<const float*>(stash), 4 * idx, splits);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

constexpr int WS_BATCH = 4;   // slots a thread has in flight in the epilogue

// The weight gradient's update for this block's share of p's and v's row
// pairs in0 + 2 q (+ h), each across the tile's column pairs 8 i + 2 t (+
// e), neighbouring threads on neighbouring column pairs;
// the columns past Out (NB rounds Out up to a multiple of 8) dropped;
// update_pv's arithmetic, a batch's p and v loaded before its first store
template <class T, class V>
__device__ __forceinline__ void ws_update_pv(const uint8_t* ring, float* __restrict__ p,
                                             V* __restrict__ v, float a, float m, int In, int Out,
                                             int in0) {
  constexpr int PAIRS = T::BN / 2, SLOTS = T::NB / 2;
  const int splits = gridDim.z, per = (PAIRS + splits - 1) / splits;
  const int lo = blockIdx.z * per, count = max(0, min(PAIRS, lo + per) - lo) * SLOTS;
  const float4* stash = reinterpret_cast<const float4*>(ring);
  for (int k0 = threadIdx.x; k0 < count; k0 += WS_BATCH * T::CONSUMERS) {
    float4 g[WS_BATCH];
    float pv[WS_BATCH][4], vv[WS_BATCH][4];
    int r0[WS_BATCH], c0[WS_BATCH];
#pragma unroll
    for (int u = 0; u < WS_BATCH; ++u) {
      const int k = k0 + u * T::CONSUMERS, q = lo + k / SLOTS, slot = k % SLOTS;
      r0[u] = in0 + 2 * q;
      c0[u] = 2 * slot;   // 8 i + 2 t, slot = 4 i + t
      if (k >= count) {
        r0[u] = In;
        continue;
      }
      g[u] = ws_sum(stash, q, slot / 4, slot % 4, splits);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0[u] + c / 2, col = c0[u] + c % 2;
        if (r < In && col < Out) {
          pv[u][c] = p[(size_t)r * Out + col];
          vv[u][c] = nnet_tile::to_f32(v[(size_t)r * Out + col]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < WS_BATCH; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0[u] + c / 2, col = c0[u] + c % 2;
        if (r >= In || col >= Out) continue;
        const size_t off = (size_t)r * Out + col;
        momentum(comp(g[u], c), pv[u][c], vv[u][c], a, m);
        nnet_tile::store_rn(v + off, vv[u][c]);
        p[off] = pv[u][c];
      }
  }
}

// Launch the WS kernel with its splits as clusters of blockIdx.z (grid.z =
// splits <= 8); returns the CUDA error code
template <class... P, class... A>
inline int launch_ws(void (*kernel)(P...), dim3 grid, int threads, int smem, cudaStream_t stream,
                     A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The tile the WS kernel is built with (tile_plan.WS_ROWS_WIDTHS and
// WS_ROWS_STAGES; tools/gemm_ceiling.py --small --f32's ws_* builds swap
// this line): 64 rows of p (In) by 136 columns (Out), 4 stages and 3 raw
// slots
using WsF32Rows = WsF32Tile<136, 4>;

}  // namespace nnet_cpf
