// The bf16 GEMM main loop on Hopper's warpgroup tensor cores: wgmma fed by
// TMA through a warp-specialised ring. matmul_act.cu (x @ W) and
// sgd_fused.cu (x^T e) use it for bf16 operands whose row pitches are
// multiples of 16 bytes and whose bases (and the outputs') are 16-byte
// aligned: the WGMMA route of ops/kernels/tile_plan.py. The bf16 forward
// and weight gradient at rows TMA cannot describe but whole 4-byte units
// (MLP3's 598 columns; for the weight gradient e's 135 too, a stage of
// whole rows copied as one run) take cp_wgmma.cuh's loops; the rest (rows
// of 135 elements in the forward) keeps tile_gemm.cuh's mma.sync loop.
//
// The f32 operands take wgmma too, at the shapes where the 128 x 128 tile
// fills the card (tf32_wgmma.cuh: 3xTF32, the A operand split in
// registers, the B operand split by a pre-pass); this header's ring,
// barriers, descriptors and tensor maps serve both. The bf16 loop below
// reads every layout straight from row-major memory: for 16-bit types
// wgmma.mma_async has the imm-trans-a / imm-trans-b bits and reads
// MN-major tiles as well (TF32 wgmma has none and reads K-major only):
//   x of x @ W     (M, K)  K-major   trans-a = 0
//   W of x @ W     (K, N)  N-major   trans-b = 1
//   x, e of x^T e  (B, In), (B, Out): M-major and N-major, trans = 1
//
// Block: 3 warpgroups (384 threads), split by one if/else on the
// warpgroup index so that setmaxnreg holds (the paths never reconverge):
// warpgroup 0 is the producer (setmaxnreg.dec to 40; one thread issues
// every TMA load), warpgroups 1 and 2 the consumers (setmaxnreg.inc to
// 232), 128 f32 accumulators a thread. Two schedules of the consumers:
//
//   Cooperative (x @ W): both consumers on every 128 x 256 tile, each
//     owning 64 rows and issuing one wgmma.mma_async.m64n256k16 a 16-deep
//     step. 128 x 256 is the widest tile one wgmma reaches, so each byte
//     brought into shared memory feeds the most products (a 64-deep stage:
//     48 KB for 4.2 MFLOP); at 1024 x 4096 -> 4096 it gives 128 tiles, one
//     wave on 132 SMs, so there is no later tile to overlap the epilogue
//     with, and the tile is as wide as it goes.
//   PingPong (x^T e): the consumers take turns on 128 x 128 tiles (tile j
//     of a block to consumer j % 2), each owning all 128 rows by two
//     m64n128k16 a step. The weight gradient's epilogue (256 KB of f32 p
//     and v read and written per 128 x 128 tile) takes longer than the
//     tile's wgmma, so while one consumer updates p and v the other runs
//     its tile's wgmma; with both on one tile the tensor cores would idle
//     through every epilogue. The narrower tile costs main-loop rate (a
//     stage is 32 KB for 2.1 MFLOP, against 48 KB for 4.2), which the
//     overlap more than repays (tools/gemm_ceiling.py).
//
// Ring: BK = 64 bf16 a stage, one 128-byte swizzle row; 4 stages of A
// 128 x 64 (16 KB) + B 64 x 256 (32 KB), 192 KB of the 227 KB, or of A + B
// 64 x 128 (16 KB), 128 KB beside the ping-pong epilogue's 68 KB. Each
// stage has a full mbarrier (the producer's arrive.expect_tx of the
// stage's bytes; TMA completes them) and an empty one (one arrival per
// consumer warp that reads the stage: 8 or 4). A consumer keeps one wgmma
// group in flight: after committing stage s it waits for the group of
// stage s-1 and only then releases s-1. Producer and consumers walk the
// ring in the same order across tiles; a ping-pong consumer skips the
// other's stages, and the two consumers' main loops take turns (a
// named-barrier handshake): a wait on a barrier's phase parity cannot tell
// phases two apart, so no consumer may wait on a stage before the other
// has passed that stage's earlier phases.
//
// TMA: boxes 64 elements (128 bytes) along the contiguous axis, swizzled
// 128B (16-byte unit u of a 128-byte line at row r lands at u ^ (r % 8)).
// Elements outside the matrix read as zero, so ragged M, N and K tails need
// no masking in the loop. The maps are made on the host by
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda), kept in a small cache keyed on every argument of the encode
// (a hit describes exactly the same memory), and passed as
// __grid_constant__ kernel parameters.
//
// Shared-memory matrix descriptors (start >> 4, LBO, SBO, layout 128B),
// for the canonical layouts of CUTLASS's make_gmma_desc:
//   K-major (x of x @ W): rows of 64 k, 128 bytes each; SBO = 1024 (the
//     next 8 rows); LBO unused (16); the k16 step advances the start by 32
//     bytes inside the swizzled line.
//   MN-major (W, e, and x of x^T e): a box is 64 k-lines of 64 MN elements
//     (8 KB); SBO = 1024 (the next 8 k), LBO = 8192 (the next 64 MN
//     elements, the next box); the k16 step advances the start by 16 lines,
//     2048 bytes.
// Stage buffers start on 1024-byte boundaries, so the swizzle phase is the
// same for TMA and wgmma (descriptor base offset 0).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace nnet_wgmma {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;                    // producer + 2 consumer warpgroups
constexpr int BOX = 64;                         // elements along a box's contiguous axis
constexpr int BOX_BYTES = BOX * BK * 2;         // a 64 x 64 box: 8 KB
constexpr int A_BYTES = BM * BK * 2;            // 16 KB: two boxes, one a 64-row half
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// a schedule: the tile's width, the ring's depth and who reads a stage
// (see the top); EXTRA bytes of shared memory follow the ring and its
// barriers, 128-byte aligned, for the kernel's epilogue
template <int BN_, bool PINGPONG_, int STAGES_, int EXTRA_>
struct Schedule {
  static constexpr int BN = BN_;
  static constexpr bool PINGPONG = PINGPONG_;
  static constexpr int STAGES = STAGES_;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int READERS = PINGPONG ? 4 : 8;   // consumer warps that read a stage
  static constexpr int EXTRA = EXTRA_;
  // the ring, the barriers, the extra bytes, and slack to align the ring to
  // 1024 bytes
  static constexpr size_t SMEM_BYTES = RING_BYTES + 128 + EXTRA + 1024;
  static_assert(2 * STAGES * sizeof(uint64_t) <= 128 && SMEM_BYTES <= 227 * 1024, "smem");
};
// the staged rows of g in the ping-pong epilogue: 128 rows of 128 bf16 and
// 8 of padding (272 bytes: a warp's fragment writes hit 32 distinct banks)
constexpr int G_PITCH = 128 + 8;
constexpr int G_BYTES = BM * G_PITCH * 2;
using Cooperative = Schedule<256, false, 4, 0>;            // 4 x 48 KB
using PingPong = Schedule<128, true, 4, 2 * G_BYTES>;      // 4 x 32 KB + 2 x 34 KB

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed. A wait of more than
// ~10^10 clocks (seconds; a lost transaction or a miscounted barrier)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 10000000000LL) __trap();
}

// the box at (c0 along the contiguous axis, c1 along rows) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until every committed store has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads only (id 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive at a barrier of `count` threads without waiting for it
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma that reads and writes them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// eight accumulator operands of the wgmma below
#define NNET_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, f32) = A (64 x 16) * B (16 x 256) + (scale_d ? d : 0); A
// K-major (TA = 0) or M-major (TA = 1), B N-major. Fragment of d in thread
// t of the warpgroup (warp w = t / 32, lane l): d[4i + 2h + e] at row
// 16w + l/4 + 8h, column 8i + 2(l % 4) + e.
template <int TA>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24), NNET_D8(32), NNET_D8(40), NNET_D8(48),
        NNET_D8(56), NNET_D8(64), NNET_D8(72), NNET_D8(80), NNET_D8(88), NNET_D8(96),
        NNET_D8(104), NNET_D8(112), NNET_D8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// the same, d 64 x 128 (64 accumulators), B 16 x 128
template <int TA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24), NNET_D8(32), NNET_D8(40), NNET_D8(48),
        NNET_D8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

#undef NNET_D8

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// Shared memory of a kernel: the ring (1024-byte aligned), its barriers,
// then the schedule's EXTRA bytes. Thread 0 initialises the barriers;
// every thread must call this before the warpgroups split.
struct Smem {
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  uint8_t* extra;
};

template <class S>
__device__ __forceinline__ Smem setup_smem(uint8_t* raw) {
  Smem s;
  s.ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.full = reinterpret_cast<uint64_t*>(s.ring + S::RING_BYTES);
  s.empty = s.full + S::STAGES;
  s.extra = s.ring + S::RING_BYTES + 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(smem_u32(&s.full[i]), 1);
      mbar_init(smem_u32(&s.empty[i]), S::READERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// A thread's place in the ring; producer and consumers walk it in the same
// order, across tiles.
template <class S>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == S::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // past n stages that another consumer reads
  __device__ __forceinline__ void skip(int n) {
    stage += n;
    phase ^= (stage / S::STAGES) & 1;
    stage %= S::STAGES;
  }
};

// Producer (one thread): the stages of the output tile at (m0, n0), K in
// steps of BK. A K-major: one box {64 k, 128 m} of a (M, K) map; A M-major:
// two boxes {64 m, 64 k} of a (K, M) map. B: BN / 64 boxes {64 n, 64 k} of a
// (K, N) map. Either way A's 64-row half h starts h * BOX_BYTES in.
template <class S, bool A_KMAJOR>
__device__ __forceinline__ void produce_tile(const Smem& s, const CUtensorMap* ta,
                                             const CUtensorMap* tb, int m0, int n0, int ktiles,
                                             RingPos<S>& pos) {
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(smem_u32(&s.empty[pos.stage]), pos.phase ^ 1);
    const uint32_t full = smem_u32(&s.full[pos.stage]);
    mbar_expect_tx(full, S::STAGE_BYTES);
    const uint32_t a = smem_u32(s.ring + pos.stage * S::STAGE_BYTES), b = a + A_BYTES;
    const int k0 = kt * BK;
    if constexpr (A_KMAJOR) {
      tma_load(a, ta, full, k0, m0);
    } else {
      tma_load(a, ta, full, m0, k0);
      tma_load(a + BOX_BYTES, ta, full, m0 + BOX, k0);
    }
#pragma unroll
    for (int j = 0; j < S::BN / BOX; ++j) tma_load(b + j * BOX_BYTES, tb, full, n0 + j * BOX, k0);
    pos.advance();
  }
}

// the descriptor of A's 64-row half at a (16 k from kk * 16 on)
template <bool A_KMAJOR>
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int kk) {
  return A_KMAJOR ? smem_desc(a + kk * 32, 16, 1024)
                  : smem_desc(a + kk * 16 * 128, BOX_BYTES, 1024);
}

// Cooperative consumer warpgroup c (0 or 1): acc = rows 64c..64c+63 of the
// 128 x 256 tile's product over all ktiles stages, one wgmma group kept in
// flight; each stage is released once the group that read it has
// completed.
template <bool A_KMAJOR>
__device__ __forceinline__ void consume_tile(const Smem& s, int c, int ktiles,
                                             RingPos<Cooperative>& pos, float (&acc)[128]) {
  using S = Cooperative;
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(smem_u32(&s.full[pos.stage]), pos.phase);
    const uint32_t a = smem_u32(s.ring + pos.stage * S::STAGE_BYTES) + c * BOX_BYTES;
    const uint32_t b = smem_u32(s.ring + pos.stage * S::STAGE_BYTES + A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16<A_KMAJOR ? 0 : 1>(acc, a_desc<A_KMAJOR>(a, kk),
                                         smem_desc(b + kk * 16 * 128, BOX_BYTES, 1024),
                                         kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0 && leader) mbar_arrive(smem_u32(&s.empty[prev]));
    prev = pos.stage;
    pos.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader) mbar_arrive(smem_u32(&s.empty[prev]));
}

// Ping-pong consumer: the whole 128 x 128 tile, acc0 rows 0..63 and acc1
// rows 64..127, over its ktiles stages; released as above.
template <bool A_KMAJOR>
__device__ __forceinline__ void consume_tile(const Smem& s, int ktiles, RingPos<PingPong>& pos,
                                             float (&acc0)[64], float (&acc1)[64]) {
  using S = PingPong;
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(smem_u32(&s.full[pos.stage]), pos.phase);
    const uint32_t a = smem_u32(s.ring + pos.stage * S::STAGE_BYTES);
    const uint32_t b = a + A_BYTES;
    fence_acc(acc0);
    fence_acc(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = smem_desc(b + kk * 16 * 128, BOX_BYTES, 1024);
      wgmma_m64n128k16<A_KMAJOR ? 0 : 1>(acc0, a_desc<A_KMAJOR>(a, kk), db, kt > 0 || kk > 0);
      wgmma_m64n128k16<A_KMAJOR ? 0 : 1>(acc1, a_desc<A_KMAJOR>(a + BOX_BYTES, kk), db,
                                         kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (prev >= 0 && leader) mbar_arrive(smem_u32(&s.empty[prev]));
    prev = pos.stage;
    pos.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc0);
  fence_acc(acc1);
  if (leader) mbar_arrive(smem_u32(&s.empty[prev]));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// every argument of the encode that varies
struct MapKey {
  const void* base;
  uint64_t rows, cols, pitch;
  uint32_t box_cols, box_rows;
  int swizzle, elem;
};

struct MapCache {
  static constexpr int SIZE = 32;
  std::mutex lock;
  EncodeTiled encode = nullptr;
  MapKey keys[SIZE];
  CUtensorMap maps[SIZE];
  int used = 0, next = 0;
};

inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// The 2-D map of a row-major (rows, cols) matrix at base (row pitch cols
// elements) of bf16 (elem 2) or f32 (elem 4) elements, boxes of box_cols x
// box_rows, 128-byte swizzle, zero fill out of bounds. Returns a CUDA error
// code.
inline int tensor_map(CUtensorMap* out, const void* base, int rows, int cols, int box_cols,
                      int box_rows, int elem = 2) {
  MapKey key;
  memset(&key, 0, sizeof key);
  key.base = base;
  key.rows = static_cast<uint64_t>(rows);
  key.cols = static_cast<uint64_t>(cols);
  key.pitch = static_cast<uint64_t>(cols) * elem;
  key.box_cols = static_cast<uint32_t>(box_cols);
  key.box_rows = static_cast<uint32_t>(box_rows);
  key.swizzle = static_cast<int>(CU_TENSOR_MAP_SWIZZLE_128B);
  key.elem = elem;
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> guard(c.lock);
  for (int i = 0; i < c.used; ++i) {
    if (memcmp(&c.keys[i], &key, sizeof key) == 0) {
      *out = c.maps[i];
      return 0;
    }
  }
  if (c.encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    c.encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {key.cols, key.rows};
  const cuuint64_t strides[1] = {key.pitch};
  const cuuint32_t box[2] = {key.box_cols, key.box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = c.encode(out,
                              elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int slot = c.used < MapCache::SIZE ? c.used++ : c.next;
  c.next = (slot + 1) % MapCache::SIZE;
  c.keys[slot] = key;
  c.maps[slot] = *out;
  return 0;
}

}  // namespace nnet_wgmma
