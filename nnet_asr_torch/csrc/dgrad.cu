// The input gradient of an f32 affine layer: dx = dz W^T, with dz the
// pre-activation error (bunch, Out) and W the weight (In, Out), both
// row-major, dx (bunch, In) row-major. The f32 autograd backward
// (ops/kernels/matmul_act.py dgrad) launches it for every layer whose input
// needs a gradient where tile_plan.py's dgrad_plan takes the shape: f32
// operands that TMA reads (pitches of 16-byte multiples, 16-byte aligned
// bases) and 128 x 128 tiles of dx^T that fill the card or all but 1/16 of
// one wave (tile_plan.ONE_WAVE_MIN), i.e. the production stack's 1024 x
// 4096 -> 4096 layers and its 4096 -> 8192 output layer (256 tiles), and
// the one-wave grids of 128 tiles, a block each: the SWB CD-DNN's 1024 x
// 2048 -> 2048 layers and its 2048 -> 9304 output layer (K: 290 stages of
// 32 and a tail of 24), a 2 x 2 mesh rank's 512 rows of the production
// stack. Every other shape stays with torch.matmul (cuBLAS). The JAX
// package leaves this product to XLA (ops/pallas/matmul_act.py _bwd).
//
// What bounds it: operations. At 1024 x 4096 -> 4096 the product is 34
// GFLOP, 208 us at the 165 TFLOP/s of 3xTF32, over 100 MB of f32 operands
// and output (30 us at 3.35 TB/s). cuBLAS forms it with FFMA on the CUDA
// cores (TF32 is off), near the card's non-tensor f32 rate.
//
// Design: 3xTF32 wgmma on tf32_wgmma.cuh's ring. Both operands contract
// over Out, their contiguous axis, so TF32 wgmma (which has no transpose
// bits) reads them as stored: dx^T = W dz^T on 128 x 128 tiles of a
// persistent grid (tf32_wgmma.cuh tile_at's order), A = W, a raw TMA box of
// 128 rows of 32 k a stage, loaded by ldmatrix and split into hi and lo in
// registers (the RS form), B = dz, split into hi and lo copies by a
// pre-pass kernel (dgrad_f32_split_kernel, 12 bytes an element of dz: 48
// MB, ~16 us at 1024 x 4096) into scratch the wrapper allocates. Each k8
// step accumulates lo*hi, hi*lo, then hi*hi, small terms first (the
// route's arithmetic, rna_tf32 split).
//
// Promotion. The tensor cores add each wgmma's products into its f32
// accumulator by truncation, not rounding: over K = 4096 of positive
// operands the route's sums land 4.3e-5 below float64 (8.6e-5 at 8192,
// 1.0e-5 at 1024; cuBLAS's FFMA 1e-9), the same on every 3xTF32 route of
// the port (PERF.md). So every PROMOTE k8 steps' wgmma accumulate into a
// fresh register tile (the first with scale-d 0), which is then added to
// the tile's sum by FADD, rounded to nearest: each truncation is taken
// against a 128-deep partial sum, not the whole (1.1e-6 low at every K).
// That takes 64 more registers a thread, so the two consumer warpgroups
// share each tile (the Cooperative schedule: 64 rows of W each, one
// m64n128k8 wgmma a term), where the weight gradient's ping-pong gives
// each a whole tile to overlap its long epilogue; this epilogue is a store
// of dx.
//
// A fragments. A stage's A tile is 128 rows of 32 k, 128-byte rows
// swizzled (16-byte unit u of row r at u ^ (r % 8)). A warp's four
// registers of its wgmma are four 8 x 4 tf32 matrices (rows g and g + 8
// at k t and t + 4 of its 16 rows), which is what ldmatrix.x4 of four
// 8 x 8 b16 matrices hands each lane: lane l gives the address of row
// l % 8 of matrix l / 8 and receives word l % 4 of row l / 4 of each. A
// matrix's 8 rows lie in 8 distinct 16-byte units: no bank conflicts.
//
// Names: dgrad_f32_*, so that the profiler's groups of the forward
// (matmul_act) and of the library (gemm) do not take its time.

#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace nnet_tile;
namespace W = nnet_wgmma;
namespace T = nnet_tf32;

// The ring: tf32_wgmma.cuh's stages (A 128 x 32 raw, B hi and lo 128 x 32),
// each read by the 8 warps of both consumers
struct Coop {
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = T::ROWS * T::BK * 4;            // 16 KB
  static constexpr int STAGE_BYTES = A_BYTES + 2 * T::B_BYTES;   // 48 KB
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int READERS = 8;
  static constexpr size_t SMEM_BYTES = RING_BYTES + 128 + 1024;
  static_assert(2 * STAGES * sizeof(uint64_t) <= 128 && SMEM_BYTES <= 227 * 1024, "smem");
};

// The pre-pass: dz's hi and lo halves (tile_gemm.cuh split_tf32), n4
// float4s of each
__global__ void __launch_bounds__(256)
dgrad_f32_split_kernel(const float4* __restrict__ dz, uint4* __restrict__ hi,
                       uint4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = dz[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// Producer (one thread): the stages of the tile at W rows a0.. and dz rows
// b0.. (128 each). tw: W's (In, Out) map; tzh, tzl: dz's hi and lo (M,
// Out) maps; all boxes {32 k, 128 rows}.
__device__ __forceinline__ void produce_tile(const W::Smem& s, const CUtensorMap* tw,
                                             const CUtensorMap* tzh, const CUtensorMap* tzl,
                                             int a0, int b0, int ktiles,
                                             W::RingPos<Coop>& pos) {
  for (int kt = 0; kt < ktiles; ++kt) {
    W::mbar_wait(W::smem_u32(&s.empty[pos.stage]), pos.phase ^ 1);
    const uint32_t full = W::smem_u32(&s.full[pos.stage]);
    W::mbar_expect_tx(full, Coop::STAGE_BYTES);
    const uint32_t a = W::smem_u32(s.ring + pos.stage * Coop::STAGE_BYTES);
    const uint32_t bh = a + Coop::A_BYTES;
    const int k0 = kt * T::BK;
    W::tma_load(a, tw, full, k0, a0);
    W::tma_load(bh, tzh, full, k0, b0);
    W::tma_load(bh + T::B_BYTES, tzl, full, k0, b0);
    pos.advance();
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// keeps the compiler from reusing the registers of an A fragment that an
// issued wgmma may still read (cp_tf32_wgmma.cuh)
__device__ __forceinline__ void fence_regs(uint32_t (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(f[i])::"memory");
}

// This thread's A fragment of k8 step kk, split: f[i] = hi of a_i, f[4 + i]
// its lo. row: the byte offset of this lane's ldmatrix row; sw: the XOR of
// its 16-byte unit, (l / 16) ^ (row % 8) (unit 2 kk, + 1 for matrices 2
// and 3)
__device__ __forceinline__ void load_frags(uint32_t a, int kk, uint32_t row, uint32_t sw,
                                           uint32_t (&f)[8]) {
  uint32_t r[4];
  ldsm_x4(a + row + (((2 * kk) ^ sw) << 4), r);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), f[i], f[4 + i]);
}

// k8 groups between promotions (four stages, 128 deep). Each promotion
// drains the consumer's wgmma pipe; against the schedule without them
// (the ping-pong of tf32_wgmma.cuh, 233.8-239.4 us at 1024 x 4096 -> 4096,
// sums 4.3e-5 low) they cost (NVIDIA H100 80GB HBM3, 700 W) at 8 groups
// 247.8 us (4.8e-7 low), at 16 243.5 (1.07e-6), at 32 244.4 (2.3e-6;
// cuBLAS's max error 1.7e-6), at 4 264-268; the two consumers' promotions
// offset by half the interval, 330-333.
constexpr int PROMOTE = 16;

// One consumer warpgroup c: sum = its 64 rows of W (64c..) of the tile's
// dx^T by the tile's 128 dz rows, over ktiles stages: each group of three
// wgmma (one k8 step) into acc, one group in flight, fragments
// double-buffered; acc added to sum once every PROMOTE groups (and at the
// tile's end), after its last group has completed; a stage released once
// the group of the next stage's first k8 step is issued and the one before
// it has completed.
__device__ __forceinline__ void consume_tile(const W::Smem& s, int c, int ktiles,
                                             W::RingPos<Coop>& pos, float (&acc)[64],
                                             float (&sum)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const bool leader = lane == 0;
  const uint32_t row = (64 * c + 16 * w + (lane & 7) + (lane & 8)) * 128;
  const uint32_t sw = (lane >> 4) ^ (lane & 7);
  const int last = ktiles * (T::BK / 8) - 1;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
  uint32_t f[2][8];
  W::mbar_wait(W::smem_u32(&s.full[pos.stage]), pos.phase);
  uint32_t a = W::smem_u32(s.ring + pos.stage * Coop::STAGE_BYTES);
  load_frags(a, 0, row, sw, f[0]);
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = pos.stage;
    const uint32_t bh = a + Coop::A_BYTES, bl = bh + T::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::BK / 8; ++kk) {
      const int j = kt * (T::BK / 8) + kk;
      const bool fresh = j % PROMOTE == 0;
      const bool promote = j == last || (j + 1) % PROMOTE == 0;
      const uint32_t* fh = f[kk & 1];
      const uint64_t dh = W::smem_desc(bh + kk * 32, 16, 1024);
      const uint64_t dl = W::smem_desc(bl + kk * 32, 16, 1024);
      W::fence_acc(acc);
      W::wgmma_fence();
      T::wgmma_m64n128k8_rs(acc, fh + 4, dh, !fresh);   // lo * hi (fresh: acc =)
      T::wgmma_m64n128k8_rs(acc, fh, dl);               // hi * lo
      T::wgmma_m64n128k8_rs(acc, fh, dh);               // hi * hi
      W::wgmma_commit();
      if (promote) {
        W::wgmma_wait<0>();
        W::fence_acc(acc);
        fence_regs(f[0]);
        fence_regs(f[1]);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      } else {
        W::wgmma_wait<1>();   // the group before is done with f[(kk + 1) & 1]
        W::fence_acc(acc);
        fence_regs(f[(kk + 1) & 1]);
      }
      if (kk == 0 && prev >= 0 && leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
      if (kk + 1 < T::BK / 8) {
        load_frags(a, kk + 1, row, sw, f[(kk + 1) & 1]);
      } else if (kt + 1 < ktiles) {
        pos.advance();
        W::mbar_wait(W::smem_u32(&s.full[pos.stage]), pos.phase);
        a = W::smem_u32(s.ring + pos.stage * Coop::STAGE_BYTES);
        load_frags(a, 0, row, sw, f[0]);
      }
    }
    prev = cur;
  }
  pos.advance();
  if (leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
}

// Consumer c's part of one tile of dx^T: W rows from a0 + 64c on, dz rows
// from b0 on. sum[4i + 2h + e] is dx[m][n + 8h] for m = b0 + 8i + 2t + e
// and n = a0 + 64c + 16w + g; masked at M and In. A warp's store covers 4
// runs of 32 bytes.
__device__ __forceinline__ void store_dx(float* __restrict__ dx, int M, int In, int a0, int b0,
                                         int c, const float (&sum)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int n = a0 + 64 * c + 16 * w + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = b0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      float* out = dx + (size_t)m * In;
      if (n < In) out[n] = sum[4 * i + e];
      if (n + 8 < In) out[n + 8] = sum[4 * i + 2 + e];
    }
}

// dx = dz W^T as dx^T = W dz^T by 3xTF32 wgmma on a persistent grid of
// 128 x 128 tiles; tw: W's (In, Out) map; tzh, tzl: the (M, Out) maps of
// dz's split copies. Warpgroup 0 loads, warpgroups 1 and 2 both compute
// every tile of the block.
__global__ void __launch_bounds__(W::THREADS, 1)
dgrad_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tzh,
                       const __grid_constant__ CUtensorMap tzl, float* __restrict__ dx, int M,
                       int In, int Out) {
  extern __shared__ uint8_t wg_smem[];
  const W::Smem s = W::setup_smem<Coop>(wg_smem);
  const int a_tiles = (In + T::ROWS - 1) / T::ROWS, b_tiles = (M + T::ROWS - 1) / T::ROWS;
  const int tiles = a_tiles * b_tiles, ktiles = (Out + T::BK - 1) / T::BK;
  const int wg = threadIdx.x / 128;
  W::RingPos<Coop> pos;
  if (wg == 0) {
    W::setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int2 at = T::tile_at(tile, a_tiles, b_tiles);
        produce_tile(s, &tw, &tzh, &tzl, at.x, at.y, ktiles, pos);
      }
    }
  } else {
    W::setmaxnreg_inc<W::CONSUMER_REGS>();
    float acc[64], sum[64];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      consume_tile(s, wg - 1, ktiles, pos, acc, sum);
      const int2 at = T::tile_at(tile, a_tiles, b_tiles);
      store_dx(dx, M, In, at.x, at.y, wg - 1, sum);
    }
  }
}

}  // namespace

// dx (M, In) = dz (M, Out) @ w (In, Out)^T, f32, all row-major contiguous,
// with pitches of 16-byte multiples and 16-byte aligned bases
// (tile_plan.dgrad_plan). dzhi, dzlo: scratch of M * Out floats each,
// 16-byte aligned, for dz's split copies (the pre-pass writes them, the
// GEMM reads them); blocks: the persistent grid, min(tiles, SMs). Returns
// the CUDA error code of the tensor-map encodes and the two launches.
extern "C" int dgrad_f32_wgmma(const float* dz, const float* w, float* dx, float* dzhi,
                               float* dzlo, int M, int In, int Out, int blocks, void* stream) {
  int err = allow_smem(dgrad_f32_wgmma_kernel, Coop::SMEM_BYTES);
  CUtensorMap tw, tzh, tzl;
  if (err == 0) err = W::tensor_map(&tw, w, In, Out, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&tzh, dzhi, M, Out, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&tzl, dzlo, M, Out, T::BK, T::ROWS, 4);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n4 = static_cast<size_t>(M) * Out / 4;
  const int split_blocks = static_cast<int>(n4 < 132 * 64 * 256 ? (n4 + 255) / 256 : 132 * 64);
  dgrad_f32_split_kernel<<<split_blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(dz),
                                                      reinterpret_cast<uint4*>(dzhi),
                                                      reinterpret_cast<uint4*>(dzlo), n4);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dgrad_f32_wgmma_kernel<<<blocks, W::THREADS, Coop::SMEM_BYTES, s>>>(tw, tzh, tzl, dx, M, In,
                                                                      Out);
  return static_cast<int>(cudaGetLastError());
}
