// The f32 GEMM main loop on Hopper's warpgroup tensor cores: 3xTF32 on
// wgmma, fed by TMA through wgmma_gemm.cuh's warp-specialised ring.
// matmul_act.cu (x @ W) and sgd_fused.cu (x^T e) use it for f32 operands
// whose row pitches are multiples of 16 bytes and whose bases (and the
// outputs') are 16-byte aligned, at the shapes where the 128 x 128 tile
// fills the card (the f32 WGMMA route of ops/kernels/tile_plan.py: the
// production stack's 1024 x {1024, 4096} -> 4096 forward and its weight
// gradients). dgrad.cu (dz W^T, the input gradient of the same layers)
// builds its own schedule from the pieces here. Every other f32 shape keeps
// the other routes of tile_plan.py.
//
// Arithmetic: tile_gemm.cuh's, f32-accurate. Each f32 element is split
// into hi = rna_tf32(a) and lo = rna_tf32(a - hi), and every k8 step
// accumulates a_lo*b_hi, a_hi*b_lo, then a_hi*b_hi (small terms first)
// into one f32 accumulator. The tensor core reads an f32 bit pattern as
// TF32 by ignoring its low 13 bits, so the rounding must happen before the
// operand reaches wgmma. It adds into the accumulator by truncation, so
// these sums land low by about 8e-8 of their size a k8 step (4.3e-5 at K =
// 4096 of positive operands); dgrad.cu adds short partial sums by FADD
// instead (its promotion).
//
// What holds TF32 wgmma back here: it has no transpose bits, so an operand
// read from shared memory must be K-major, and these products have
// MN-major operands (W of x @ W; x and e of x^T e, whose contraction runs
// over the bunch). The design puts the large MN-major operand in registers
// and gives the other a pre-pass:
//   A (registers, the RS form of wgmma): a row-major (K, MA) matrix read
//     M-major: W of the forward (its N columns), e of the weight gradient
//     (its Out columns). TMA brings the raw f32 tile; each thread loads its
//     fragment from shared memory and splits it in registers, as mma.sync
//     does.
//   B (shared memory, K-major): an (NB, K) matrix as pre-split hi and lo
//     copies, written by a pre-pass kernel of the caller into scratch the
//     wrapper allocates: x itself for the forward (x is K-major; only the
//     split is written), x transposed for the weight gradient (the smaller
//     operand: 16 MB at bunch 1024 and 4096 inputs). The pre-pass moves
//     12 bytes an element of x: 48 MB at 1024 x 4096, 15 us at 3.35 TB/s,
//     against 208-416 us of bound.
// So both kernels compute out^T: the accumulator's rows are A's columns
// (y's N, or p's Out), its columns B's rows (y's M, or p's In), and the
// epilogues write out = (NB, MA) row-major from the fragments.
//
// Schedule: the bf16 weight gradient's PingPong (wgmma_gemm.cuh), for both
// kernels. A persistent grid of min(tiles, SMs) blocks walks the 128 x 128
// tiles of out^T in a fixed order; block k's consumer c takes its tiles c,
// c + 2, ..., the two consumers' main loops in turn, so that one's
// epilogue (the weight gradient's p and v update: 4 x 64 KB of f32 a tile,
// ~38% of the product's bound at 4096 x 8192) overlaps the other's main
// loop. A consumer owns a whole tile: two m64 wgmma over its 128 A columns
// (acc0, acc1: 64 f32 each; the columns dealt as below), each k8 step six
// wgmma.m64n128k8 (three terms for each, the two interleaved). (The bf16
// forward's Cooperative schedule, both consumers on one 256 x 128 tile,
// made ptxas spill in this main loop and serialize its wgmma; the
// ping-pong consumer compiles without either.)
//
// Ring (BK = 32 f32 a stage: one 128-byte swizzle line): A 32 x 128 raw
// (16 KB, four 32 x 32 boxes) + B hi and lo 128 x 32 (2 x 16 KB) = 48 KB a
// stage, 4 stages: 192 KB of the 227 KB. The epilogues need no shared
// memory: they read and write p, v and y from the accumulator fragments.
//
// A fragments. The A fragment of wgmma.m64nNk8 .tf32 is that of mma.sync
// m16n8k8 in each warp's 16 rows: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) for g = lane / 4, t = lane % 4. The A tile's 128
// columns are dealt to the two m64 wgmma (acc0, acc1) so that a thread's
// four rows are neighbouring columns: warp w's lanes g take columns 32w +
// 4g .. 32w + 4g + 3, the first two to acc0's rows g and g + 8, the last
// two to acc1's. A k row's fragments of both wgmma are then one 16-byte
// shared load (a warp's 32 columns are one TMA box, 128B-swizzled: 16-byte
// unit u of k row r at u ^ (r % 8), so a warp's load reads 4 whole rows of
// 128 bytes, free of bank conflicts), and a thread's accumulators at a B
// row are four neighbouring columns of out: one 16-byte load or store of
// y, p and v, a warp's 8 lane groups covering 128 contiguous bytes.
//
// Pipelining. A consumer keeps one k8 group of wgmma in flight: it issues
// group j with fragments f[j % 2], waits for group j - 1, then loads and
// splits group j + 1's fragments into the registers group j - 1 read while
// group j runs. A stage is released once the group of the next stage's
// first k8 step is issued and the group before it has completed.
//
// B descriptors: K-major, 128-byte rows of 32 k, SBO = 1024 (the next 8
// rows), LBO unused (16); the k8 step advances the start by 32 bytes inside
// the swizzled line. Stage buffers start on 1024-byte boundaries.

#pragma once

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace nnet_tf32 {

namespace W = nnet_wgmma;

constexpr int BK = 32;                          // f32 a stage: one 128-byte line
constexpr int ROWS = 128;                       // A rows and B rows of a consumer
constexpr int A_BOX = 32;                       // A columns a TMA box
constexpr int A_BOX_BYTES = A_BOX * BK * 4;     // 4 KB
constexpr int B_BYTES = ROWS * BK * 4;          // 16 KB: hi or lo of a stage

// the schedule: its ring, who reads a stage (the four warps of the
// consumer that owns the tile), and the shared memory of a block
struct PingPong {
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = ROWS * BK * 4;               // 16 KB
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;   // 48 KB
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int READERS = 4;
  // the ring, its barriers, and slack to align the ring to 1024 bytes
  static constexpr size_t SMEM_BYTES = RING_BYTES + 128 + 1024;
  static_assert(2 * STAGES * sizeof(uint64_t) <= 128 && SMEM_BYTES <= 227 * 1024, "smem");
};
using S = PingPong;

// d (64 x 128, f32) += A (64 x 8, TF32 from registers) * B (8 x 128, TF32,
// K-major in shared memory); scale_d = 0: d = A * B. Fragment of d as in
// wgmma_gemm.cuh: d[4i + 2h + e] at row 16w + g + 8h, column 8i + 2t + e.
#define NNET_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t* a,
                                                   uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24), NNET_D8(32), NNET_D8(40), NNET_D8(48),
        NNET_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef NNET_D8

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Producer (one thread): the stages of the tile at A columns a0.. and B
// rows b0.. (128 each), K in steps of BK. ta: the (K, MA) map, boxes {32
// columns, 32 k}; tbh, tbl: the (NB, K) maps of B's hi and lo, boxes {32 k,
// 128 rows}.
__device__ __forceinline__ void produce_tile(const W::Smem& s, const CUtensorMap* ta,
                                             const CUtensorMap* tbh, const CUtensorMap* tbl,
                                             int a0, int b0, int ktiles, W::RingPos<S>& pos) {
  for (int kt = 0; kt < ktiles; ++kt) {
    W::mbar_wait(W::smem_u32(&s.empty[pos.stage]), pos.phase ^ 1);
    const uint32_t full = W::smem_u32(&s.full[pos.stage]);
    W::mbar_expect_tx(full, S::STAGE_BYTES);
    const uint32_t a = W::smem_u32(s.ring + pos.stage * S::STAGE_BYTES);
    const uint32_t bh = a + S::A_BYTES;
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < ROWS / A_BOX; ++j)
      W::tma_load(a + j * A_BOX_BYTES, ta, full, a0 + j * A_BOX, k0);
    W::tma_load(bh, tbh, full, k0, b0);
    W::tma_load(bh + B_BYTES, tbl, full, k0, b0);
    pos.advance();
  }
}

// This thread's A fragments of k8 step kk, split: f[8h + i] = hi of a_i of
// wgmma h (acc0, acc1), f[8h + 4 + i] = its lo. a: the stage's A tile;
// off0, off4: the thread's byte offsets of k rows t and t + 4 of step 0,
// columns 4g .. 4g + 3 of its warp's box.
__device__ __forceinline__ void load_frags(uint32_t a, int kk, uint32_t off0, uint32_t off4,
                                           uint32_t (&f)[16]) {
  const float4 v0 = lds4(a + kk * 8 * 128 + off0), v4 = lds4(a + kk * 8 * 128 + off4);
  nnet_tile::split_tf32(v0.x, f[0], f[4]);
  nnet_tile::split_tf32(v0.y, f[1], f[5]);
  nnet_tile::split_tf32(v4.x, f[2], f[6]);
  nnet_tile::split_tf32(v4.y, f[3], f[7]);
  nnet_tile::split_tf32(v0.z, f[8], f[12]);
  nnet_tile::split_tf32(v0.w, f[9], f[13]);
  nnet_tile::split_tf32(v4.z, f[10], f[14]);
  nnet_tile::split_tf32(v4.w, f[11], f[15]);
}

// One consumer warpgroup: acc0, acc1 = out^T at the stage's A columns (as
// dealt at the top) by its 128 B rows, over ktiles stages (one k8 group in
// flight, fragments double-buffered, each stage released once its last
// group has completed).
__device__ __forceinline__ void consume_tile(const W::Smem& s, int ktiles, W::RingPos<S>& pos,
                                             float (&acc0)[64], float (&acc1)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = lane == 0;
  // the 16-byte unit g of k rows t and t + 4 in the warp's box
  const uint32_t off0 = w * A_BOX_BYTES + t * 128 + ((g ^ t) << 4);
  const uint32_t off4 = w * A_BOX_BYTES + (t + 4) * 128 + ((g ^ t ^ 4) << 4);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
  uint32_t f[2][16];
  W::mbar_wait(W::smem_u32(&s.full[pos.stage]), pos.phase);
  uint32_t a = W::smem_u32(s.ring + pos.stage * S::STAGE_BYTES);
  load_frags(a, 0, off0, off4, f[0]);
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = pos.stage;
    const uint32_t bh = a + S::A_BYTES, bl = bh + B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t* fh0 = f[kk & 1];
      const uint64_t dh = W::smem_desc(bh + kk * 32, 16, 1024);
      const uint64_t dl = W::smem_desc(bl + kk * 32, 16, 1024);
      W::fence_acc(acc0);
      W::fence_acc(acc1);
      W::wgmma_fence();
      wgmma_m64n128k8_rs(acc0, fh0 + 4, dh);    // lo * hi
      wgmma_m64n128k8_rs(acc1, fh0 + 12, dh);
      wgmma_m64n128k8_rs(acc0, fh0, dl);        // hi * lo
      wgmma_m64n128k8_rs(acc1, fh0 + 8, dl);
      wgmma_m64n128k8_rs(acc0, fh0, dh);        // hi * hi
      wgmma_m64n128k8_rs(acc1, fh0 + 8, dh);
      W::wgmma_commit();
      W::wgmma_wait<1>();
      W::fence_acc(acc0);
      W::fence_acc(acc1);
      if (kk == 0 && prev >= 0 && leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
      if (kk + 1 < BK / 8) {
        load_frags(a, kk + 1, off0, off4, f[(kk + 1) & 1]);
      } else if (kt + 1 < ktiles) {
        pos.advance();
        W::mbar_wait(W::smem_u32(&s.full[pos.stage]), pos.phase);
        a = W::smem_u32(s.ring + pos.stage * S::STAGE_BYTES);
        load_frags(a, 0, off0, off4, f[0]);
      }
    }
    prev = cur;
  }
  pos.advance();
  W::wgmma_wait<0>();
  W::fence_acc(acc0);
  W::fence_acc(acc1);
  if (leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
}

// A thread's accumulators of fragment element (i, e): out^T rows (A
// columns) 32w + 4g .. 32w + 4g + 3 of the tile at its B row 8i + 2t + e
__device__ __forceinline__ float4 acc_quad(const float (&acc0)[64], const float (&acc1)[64],
                                           int i, int e) {
  return make_float4(acc0[4 * i + e], acc0[4 * i + 2 + e], acc1[4 * i + e], acc1[4 * i + 2 + e]);
}

// The order the persistent grid walks the tiles: groups of GROUP_B rows of
// tiles along B (the last group may be shorter), B fastest inside a group,
// so that the tiles in flight at once read a few A and B strips each
// (GROUP_B = 1: A fastest, all of A's columns in flight)
constexpr int GROUP_B = 8;

// tile t's first A column and B row
__device__ __forceinline__ int2 tile_at(int t, int a_tiles, int b_tiles) {
  const int group = t / (GROUP_B * a_tiles), first = group * GROUP_B;
  const int rows = min(GROUP_B, b_tiles - first), in = t - group * GROUP_B * a_tiles;
  return make_int2((in / rows) * ROWS, (first + in % rows) * ROWS);
}

// The kernel body of both f32 WGMMA kernels, for out = (NB, MA), K deep
// (see the top; the block's threads: W::THREADS): the producer warpgroup
// loads, the consumers compute and call epilogue(a0, b0, acc0, acc1) for
// each of their tiles (A columns a0.. a0 + 127 by B rows b0.. b0 + 127, in
// tile_at's order; acc_quad reads the accumulators).
template <class Epilogue>
__device__ __forceinline__ void pingpong_gemm(const CUtensorMap* ta, const CUtensorMap* tbh,
                                              const CUtensorMap* tbl, int MA, int NB, int K,
                                              Epilogue&& epilogue) {
  extern __shared__ uint8_t wg_smem[];
  const W::Smem s = W::setup_smem<S>(wg_smem);
  const int a_tiles = (MA + ROWS - 1) / ROWS, b_tiles = (NB + ROWS - 1) / ROWS;
  const int tiles = a_tiles * b_tiles;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    W::setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      W::RingPos<S> pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int2 at = tile_at(tile, a_tiles, b_tiles);
        produce_tile(s, ta, tbh, tbl, at.x, at.y, ktiles, pos);
      }
    }
  } else {
    W::setmaxnreg_inc<W::CONSUMER_REGS>();
    const int c = wg - 1;
    float acc0[64], acc1[64];
    W::RingPos<S> pos;
    pos.skip(c * ktiles);
    for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
      // main loops in turn (wgmma_gemm.cuh): consumer c waits at barrier
      // 1 + c for the other's main loop of the tile before
      if (tile >= gridDim.x) W::named_sync(1 + c, 256);
      consume_tile(s, ktiles, pos, acc0, acc1);
      if (tile + gridDim.x < tiles) W::named_arrive(2 - c, 256);
      pos.skip(ktiles);
      const int2 at = tile_at(tile, a_tiles, b_tiles);
      epilogue(at.x, at.y, acc0, acc1);
    }
  }
}

}  // namespace nnet_tf32
