// Fused affine + activation: y = act(x @ W + b), with f32 operands
// (f32-accurate) or bf16 operands (f32 accumulation, y rounded to bf16).
//
// Replaces the TPU kernel nnet_asr_tpu/ops/pallas/matmul_act.py (_kernel,
// called by matmul_act and the custom-VJP affine_sigmoid): a K-blocked
// GEMM into an f32 accumulator with the bias + sigmoid epilogue applied in
// registers, so the pre-activation never reaches device memory. The TPU
// kernel takes x, W and b at f32 or bf16 and writes y at x's dtype; both
// are ported (matmul_act_f32, matmul_act_bf16).
//
// What bounds it on an H100: operations, not bytes. At the production
// shape (1024 x 4096 -> 4096) the GEMM does 2*M*N*K = 34 GFLOP over
// 101 MB of f32 operands and output; in 3xTF32 (three TF32 products per f32
// product) the card's 495 TFLOP/s of TF32 give 165 TFLOP/s of f32-accurate
// work, a bound of 208 us, against 30 us for the bytes. The mma.sync issue
// rate of TF32 (half of wgmma's, tile_gemm.cuh) caps that loop near half of
// the bound, so the production shapes take 3xTF32 wgmma (below). In bf16
// the same product is bounded at 34.7 us by the 989 TFLOP/s of dense bf16
// (15 us of bytes); one mma.sync m16n8k16 pass replaces the three TF32
// ones.
// At the recipes' widths (960x598->1024 on MLP3, 1024x368->500 on TIMIT,
// an utterance's ~284 rows in tmpe) it is bound by latency instead: 80 to
// 240 64x64 tiles for 132 SMs, one warp per scheduler, a few BK steps each.
// The design: the tensor-core main loop of tile_gemm.cuh (3xTF32 or bf16
// mma.sync, cp.async ring, 128x128 or 64x64 tiles chosen by
// ops/kernels/tile_plan.py), with x K-major and W N-major in shared memory;
// with f32 operands the 64x64 tile takes 8 warps (SmallTile8), so that one
// block an SM still gives each scheduler two warps. Where a split of K
// evens the SMs' load (one tmpe utterance: 80 tiles for 132 SMs), the plan
// splits it and the last split to reach a tile sums the f32 partials in
// split order (tile_gemm.cuh reduce_splits), in the same launch, before the
// epilogue, which needs the whole sum. The epilogue adds the
// bias (a bf16 bias read and upcast) and applies the sigmoid in f32 to the
// output tile, staged through shared memory so that y is written in whole
// rows (bf16 y rounded to nearest even once, after the sigmoid, as JAX's
// astype), masked at the ragged edges (598, 500, 368, 135, 284 and 960 are
// not tile multiples; loads outside the matrix or the split's K range read
// 0).
//
// bf16 operands whose rows TMA can describe (pitches of 16-byte multiples,
// 16-byte aligned bases: every production shape) take the WGMMA route
// instead: wgmma_gemm.cuh's warp-specialised TMA ring and m64n256k16 wgmma
// on 128x256 tiles (matmul_act_wgmma_kernel). Its epilogue works on the
// accumulator fragments with the same order of operations (the tile's bias
// upcast into shared memory before the main loop and added in f32, the
// sigmoid in f32, one rounding of y). Its sigmoid takes __expf and
// __fdividef: a few f32 ulps (~1e-6 relative) from expf and an IEEE divide,
// far under the bf16 step (2^-8) that y is rounded to, as the summation
// order already is; the IEEE form made the sigmoid a seventh of the
// kernel's time (tools/gemm_ceiling.py, wgmma_ieee_sigmoid). It stages y
// in the drained ring one 64-column box at a time and writes each box by a
// TMA store as soon as it is staged, so the stores overlap the next box's
// sigmoids; the stores clip the ragged edge.
//
// f32 operands on the same route (pitches of 16-byte multiples, 16-byte
// aligned bases, and the 128x128 tiles filling the card: 1024 x 1024 and
// 1024 x 4096 -> 4096 of the production stack) take tf32_wgmma.cuh's
// 3xTF32 wgmma instead of mma.sync, whose TF32 issue rate held the BIG tile
// at about a third of the 3xTF32 bound (588 us against 208 at 1024 x
// 4096 -> 4096). TF32 wgmma reads shared-memory operands K-major only, and
// W is N-major, so the kernel computes y^T = W^T x^T: W is the A operand,
// its raw tile brought by TMA and each thread's fragment split in
// registers; x, already K-major, is the B operand, split into hi and lo
// copies by a pre-pass kernel (matmul_act_f32_split_kernel, 12 bytes an
// element of x: ~15 us at 1024 x 4096) into scratch the wrapper allocates.
// The schedule is the weight gradient's (matmul_act_f32_wgmma_kernel: a
// persistent grid walking 128 x 128 tiles of y^T, the two consumer
// warpgroups taking turns), and the epilogue writes y from the accumulator
// fragments: the bias of each fragment row pair, the sigmoid
// in f32 as the mma.sync kernel takes it (expf and an IEEE divide), y as
// 16-byte quads of neighbouring columns, masked at M and N.
//
// bf16 operands whose rows no TMA map describes but whose pitches and bases
// are whole 4-byte units (MLP3's x at 598 columns, TIMIT's W and y at 500;
// tile_plan.py's CP_WGMMA route) take cp_wgmma.cuh's loop: wgmma fed by
// cp.async copies of 4, 8 or 16 bytes that write the swizzled layout the
// descriptors read, on 64x64 tiles with split-K where the tiles leave SMs
// idle (matmul_act_cp_wgmma_kernel). Its epilogue
// takes the fragments in the order of operations above (the bias upcast
// and added in f32, the sigmoid in f32 by __expf and __fdividef as on the
// TMA route, y rounded once), stages the bf16 tile in shared memory and
// writes whole rows. Rows of 2-byte pitch (K = 135) stay on mma.sync.
//
// f32 operands at every shape the f32 WGMMA route leaves but the BIG
// mma.sync tile would fill the card (the recipes' widths: MLP3's
// 960x598->1024, TIMIT's 1024x368->500, the RBM recipe's 960x1024->1024,
// one tmpe utterance's and a mesh rank's rows; tile_plan.py's CP_WGMMA
// route at 4 bytes an element) take cp_tf32_wgmma.cuh's loop
// (matmul_act_f32_cp_wgmma_kernel): y^T = W^T x^T by 3xTF32 wgmma, W
// brought raw by cp.async and split in registers, x brought raw by cp.async
// and split in place in shared memory by the block itself (no pre-pass, one
// launch), on tiles of 64 rows of x by 128 columns of W (two warpgroups
// sharing x's split), split-K reduced in the launch where the tiles leave
// SMs idle. What bounds it there is latency and the L2 feed (0.3 MB a 64x64
// tile at K = 598), not operations or device memory; the ring is kept small
// enough for two blocks an SM. Its epilogue writes y from the
// fragments: the bias added in f32, the sigmoid as matmul_act_kernel takes
// it (expf and an IEEE divide), two neighbouring columns a store.
//
// Layout: x (M, K), W (K, N), b (N,), y (M, N), all row-major contiguous.

#include <cuda_runtime.h>

#include <type_traits>

#include "cp_tf32_wgmma.cuh"
#include "cp_wgmma.cuh"
#include "tf32_wgmma.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace nnet_tile;
namespace W = nnet_wgmma;
namespace T = nnet_tf32;
using Coop = W::Cooperative;

// y = act(x @ w + b) for one BM x BN tile; with gridDim.z > 1, split
// blockIdx.z of it over k_chunk rows of K, the last split to arrive summing
// the partials (part, counters: reduce_splits) before the epilogue.
template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
matmul_act_kernel(const E* __restrict__ x, const E* __restrict__ w, const E* __restrict__ b,
                  E* __restrict__ y, float* __restrict__ part, int* __restrict__ counters, int M,
                  int N, int K, int act, int k_chunk, int x_bytes, int w_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  float acc[T::MT][T::NT][4];
  gemm_mainloop<T, E, true>(reinterpret_cast<E*>(smem), x, K, x_bytes, w, N, w_bytes, M, N, m0,
                            n0, k_begin, min(K, k_begin + k_chunk), acc);
  stage_acc<T>(smem, acc);
  if (!reduce_splits<T>(smem, part, counters)) return;
  constexpr int U = 16;
  epilogue<T, U>(smem, m0, n0, [&](const int (&r)[U], const int (&c)[U], float (&z)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] >= M || c[u] >= N) continue;
      z[u] += to_f32(b[c[u]]);
      if (act == 1) z[u] = 1.0f / (1.0f + expf(-z[u]));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r[u] < M && c[u] < N) store_rn(y + (size_t)r[u] * N + c[u], z[u]);
  });
}

template <class T, class E>
int launch(const E* x, const E* w, const E* b, E* y, float* part, int* counters, int M, int N,
           int K, int act, int splits, int k_chunk, int x_bytes, int w_bytes,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, E, true>();
  const int err = allow_smem(matmul_act_kernel<T, E>, smem);
  if (err != 0) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  matmul_act_kernel<T, E><<<grid, T::THREADS, smem, stream>>>(x, w, b, y, part, counters, M, N,
                                                              K, act, k_chunk, x_bytes, w_bytes);
  return static_cast<int>(cudaGetLastError());
}

// tile 0: BigTile; 1: the 64x64 tile, with 8 warps for f32 operands
// (tile_gemm.cuh SmallTile8), 4 for bf16 ones
template <class E>
int dispatch(const E* x, const E* w, const E* b, E* y, int M, int N, int K, int act, int tile,
             int x_bytes, int w_bytes, int splits, int k_chunk, float* part, int* counters,
             void* stream) {
  using Small = std::conditional_t<std::is_same<E, float>::value, SmallTile8, SmallTile>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 0 ? launch<BigTile>(x, w, b, y, part, counters, M, N, K, act, splits, k_chunk,
                                     x_bytes, w_bytes, s)
                   : launch<Small>(x, w, b, y, part, counters, M, N, K, act, splits, k_chunk,
                                   x_bytes, w_bytes, s);
}

// The WGMMA route's epilogue for consumer warpgroup c (rows 64c..64c+63 of
// the tile): the bias (the tile's 256 values, upcast to f32 in shared
// memory) added in f32, the sigmoid in f32 (__expf, __fdividef; see the
// note at the top), y rounded once to bf16 (nearest even). The warpgroup
// stages its 64 x 256 rows in the ring as four 64 x 64 boxes,
// 128B-swizzled as TMA expects (a warp's bf16 pairs then fall in 32
// distinct banks); one thread writes each box by a TMA store once it is
// staged. The stores clip at M and N.
__device__ __forceinline__ void store_y_tile(const W::Smem& s, const CUtensorMap* ty,
                                             const float* bias, int c, int m0, int n0, int act,
                                             const float (&acc)[128]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4;   // the fragment's first row of the 64
  uint8_t* stage = s.ring + c * (Coop::BN / W::BOX) * W::BOX_BYTES;
  W::named_sync(1, 256);   // both consumer warpgroups are done with the ring
#pragma unroll
  for (int j = 0; j < Coop::BN / W::BOX; ++j) {
#pragma unroll
    for (int i = 8 * j; i < 8 * j + 8; ++i) {
      const float b0 = bias[8 * i + 2 * (lane % 4)], b1 = bias[8 * i + 2 * (lane % 4) + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z0 = acc[4 * i + 2 * h] + b0, z1 = acc[4 * i + 2 * h + 1] + b1;
        if (act == 1) {
          z0 = __fdividef(1.0f, 1.0f + __expf(-z0));
          z1 = __fdividef(1.0f, 1.0f + __expf(-z1));
        }
        const int row = r + 8 * h, unit = (i % 8) ^ (row % 8);
        *reinterpret_cast<__nv_bfloat162*>(stage + j * W::BOX_BYTES + row * 128 + unit * 16 +
                                           (lane % 4) * 4) = __floats2bfloat162_rn(z0, z1);
      }
    }
    W::fence_proxy_async();
    W::named_sync(2 + c, 128);
    if (t == 0) {
      W::tma_store(ty, W::smem_u32(stage + j * W::BOX_BYTES), n0 + j * W::BOX,
                   m0 + c * W::BM / 2);
      W::tma_store_commit();
    }
  }
  if (t == 0) W::tma_store_wait_read();
}

// y = act(x @ W + b), bf16, one 128 x 256 tile a block (wgmma_gemm.cuh)
__global__ void __launch_bounds__(W::THREADS, 1)
matmul_act_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap ty, const bf16* __restrict__ b, int N,
                        int K, int act) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ float bias[Coop::BN];
  const W::Smem s = W::setup_smem<Coop>(wg_smem);
  const int m0 = blockIdx.y * W::BM, n0 = blockIdx.x * Coop::BN;
  const int ktiles = (K + W::BK - 1) / W::BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    W::setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      W::RingPos<Coop> pos;
      W::produce_tile<Coop, true>(s, &tx, &tw, m0, n0, ktiles, pos);
    }
  } else {
    W::setmaxnreg_inc<W::CONSUMER_REGS>();
    const int col = threadIdx.x - 128;   // one of the tile's 256 columns
    bias[col] = n0 + col < N ? __bfloat162float(b[n0 + col]) : 0.0f;
    float acc[128];
    W::RingPos<Coop> pos;
    W::consume_tile<true>(s, wg - 1, ktiles, pos, acc);
    store_y_tile(s, &ty, bias, wg - 1, m0, n0, act, acc);
  }
}

// y = act(x @ W + b), bf16, on the CP_WGMMA route (cp_wgmma.cuh): one
// T::BM x T::BN tile a block; with gridDim.z > 1, split blockIdx.z of it
// over k_chunk rows of K, the last split to arrive summing the partials
// (part, counters: reduce_acc) before the epilogue
template <class T>
__global__ void __launch_bounds__(T::THREADS)
matmul_act_cp_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const bf16* __restrict__ b, bf16* __restrict__ y,
                           float* __restrict__ part, int* __restrict__ counters, int M, int N,
                           int K, int act, int k_chunk, int x_bytes, int w_bytes) {
  extern __shared__ uint8_t cp_smem[];
  uint8_t* ring =
      reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(cp_smem) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  float acc[T::NACC];
  nnet_cpw::mainloop<T>(ring, x, w, M, N, K, m0, n0, k_begin, min(K, k_begin + k_chunk), x_bytes,
                        w_bytes, acc);
  if (!nnet_cpw::reduce_acc<T>(acc, part, counters)) return;
  nnet_cpw::store_y<T>(ring, acc, b, y, M, N, m0, n0, act);
}

// The CP_WGMMA route's tile (tile_plan.CP_STAGES): 64x64 on one warpgroup,
// a 3-stage ring of 48 KB, so that four blocks fit an SM. At the recipes'
// four shapes it beat 128x64 and 128x128 tiles on two warpgroups and
// 64x128 on one, and 4- and 6-stage rings (tools/gemm_ceiling.py --small:
// its cp_* builds swap this line)
using CpPlanned = nnet_cpw::CpTile<1, 64, 3>;

// y = act(x @ W + b), f32, on the CP_WGMMA route (cp_tf32_wgmma.cuh): y^T
// = W^T x^T a T::BN x T::BM tile a block (W the register operand, x split
// in the block); with gridDim.z > 1, split blockIdx.z of it over k_chunk
// rows of K, the last split to arrive summing the partials (part, counters:
// cp_wgmma.cuh reduce_acc) before the epilogue
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
matmul_act_f32_cp_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                               const float* __restrict__ b, float* __restrict__ y,
                               float* __restrict__ part, int* __restrict__ counters, int M, int N,
                               int K, int act, int k_chunk, int x_bytes, int w_bytes) {
  extern __shared__ uint8_t cpf_smem[];
  uint8_t* ring = nnet_cpf::ring_of(cpf_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const nnet_cpf::Operands o{w, N, N, x, nullptr, K, M, w_bytes, x_bytes};
  const float2 bias = nnet_cpf::bias_of(b, N, n0);
  float acc[T::NACC];
  nnet_cpf::mainloop<T>(ring, o, n0, m0, k_begin, min(K, k_begin + k_chunk), acc);
  if (!nnet_cpw::reduce_acc<T>(acc, part, counters)) return;
  nnet_cpf::store_y<T>(acc, bias, y, M, N, m0, n0, act);
}

// The pre-pass of the f32 WGMMA route: x's hi and lo halves (tile_gemm.cuh
// split_tf32), n4 float4s of each
__global__ void __launch_bounds__(256)
matmul_act_f32_split_kernel(const float4* __restrict__ x, uint4* __restrict__ hi,
                            uint4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// The f32 WGMMA route's epilogue for one tile of y^T: its A columns (y's)
// from n0 on, B rows (y's) from m0 on. A thread's accumulators are y[m][n
// .. n + 3] for n = n0 + 32w + 4g and m = m0 + 8i + 2t + e (tf32_wgmma.cuh
// acc_quad): bias added in f32, then the sigmoid as matmul_act_kernel
// takes it, stored as one float4. N is a multiple of 4 on this route, so
// the four are wholly inside or outside.
__device__ __forceinline__ void store_y_f32(const float* __restrict__ b, float* __restrict__ y,
                                            int M, int N, int n0, int m0, int act,
                                            const float (&acc0)[64], const float (&acc1)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int n = n0 + 32 * w + 4 * (lane >> 2), t = lane & 3;
  if (n >= N) return;
  const float4 bias = make_float4(b[n], b[n + 1], b[n + 2], b[n + 3]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      float4 z = T::acc_quad(acc0, acc1, i, e);
      z = make_float4(z.x + bias.x, z.y + bias.y, z.z + bias.z, z.w + bias.w);
      if (act == 1)
        z = make_float4(1.0f / (1.0f + expf(-z.x)), 1.0f / (1.0f + expf(-z.y)),
                        1.0f / (1.0f + expf(-z.z)), 1.0f / (1.0f + expf(-z.w)));
      *reinterpret_cast<float4*>(y + (size_t)m * N + n) = z;
    }
}

// y = act(x @ W + b), f32, as y^T = W^T x^T by 3xTF32 wgmma
// (tf32_wgmma.cuh, PingPong: a persistent grid of 128 x 128 tiles of y^T);
// tw: W's (K, N) map; txh, txl: the (M, K) maps of x's split copies
__global__ void __launch_bounds__(W::THREADS, 1)
matmul_act_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap txh,
                            const __grid_constant__ CUtensorMap txl, const float* __restrict__ b,
                            float* __restrict__ y, int M, int N, int K, int act) {
  T::pingpong_gemm(&tw, &txh, &txl, N, M, K,
                   [&](int n0, int m0, const float (&acc0)[64], const float (&acc1)[64]) {
                     store_y_f32(b, y, M, N, n0, m0, act, acc0, acc1);
                   });
}

}  // namespace

// act: 0 = none, 1 = sigmoid. tile: 0 = 128x128, 1 = 64x64. x_bytes,
// w_bytes: the copy width of that operand, 16, 8 or 4 (tile_plan.plan).
// splits > 1 (64x64 only): K is cut into chunks of k_chunk rows (a multiple
// of BK), part is an f32 scratch of (tiles * splits * 64 * 64) elements and
// counters holds an int per tile, zero, which the launch leaves at zero;
// else both are unused. Returns the CUDA error code of the launch.
extern "C" int matmul_act_f32(const float* x, const float* w, const float* b, float* y,
                              int M, int N, int K, int act, int tile, int x_bytes, int w_bytes,
                              int splits, int k_chunk, float* part, int* counters,
                              void* stream) {
  return dispatch(x, w, b, y, M, N, K, act, tile, x_bytes, w_bytes, splits, k_chunk, part,
                  counters, stream);
}

// The same with bf16 x, w, b and y (f32 accumulation, the split-K sum, bias
// and sigmoid in f32, y rounded to nearest even once). x_bytes, w_bytes:
// 16, 8, 4 or 2 (tile_plan.plan with elem=2).
extern "C" int matmul_act_bf16(const void* x, const void* w, const void* b, void* y, int M,
                               int N, int K, int act, int tile, int x_bytes, int w_bytes,
                               int splits, int k_chunk, float* part, int* counters,
                               void* stream) {
  return dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                  static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K, act, tile,
                  x_bytes, w_bytes, splits, k_chunk, part, counters, stream);
}

// The CP_WGMMA route of matmul_act_bf16: x, w and y with row pitches and
// bases in whole 4-byte units (tile_plan.plan's route), 64x64 tiles.
// x_bytes, w_bytes: the copy width of that operand, 16, 8 or 4; splits >
// 1: K cut into chunks of k_chunk rows (a multiple of 64), part an f32
// scratch of tiles * splits * 64 * 64 elements and counters an int a
// tile, zero, which the launch leaves at zero. Returns the CUDA error code
// of the launch.
extern "C" int matmul_act_bf16_cp_wgmma(const void* x, const void* w, const void* b, void* y,
                                        int M, int N, int K, int act, int x_bytes, int w_bytes,
                                        int splits, int k_chunk, float* part, int* counters,
                                        void* stream) {
  using T = CpPlanned;
  const int err = allow_smem(matmul_act_cp_wgmma_kernel<T>, T::SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  matmul_act_cp_wgmma_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), part, counters, M, N, K, act, k_chunk, x_bytes, w_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The CP_WGMMA route of matmul_act_f32: any row pitches, tiles of 64 rows
// by 128 columns of y. x_bytes, w_bytes: the copy width of that operand,
// 16, 8 or 4; splits > 1: K cut into chunks of k_chunk rows (a multiple of
// 32), part an f32 scratch of tiles * splits * 64 * 128 elements and
// counters an int a
// tile, zero, which the launch leaves at zero. Returns the CUDA error code
// of the launch.
extern "C" int matmul_act_f32_cp_wgmma(const float* x, const float* w, const float* b, float* y,
                                       int M, int N, int K, int act, int x_bytes, int w_bytes,
                                       int splits, int k_chunk, float* part, int* counters,
                                       void* stream) {
  using T = nnet_cpf::CpF32Planned<nnet_cpf::FWD>;
  const int err = allow_smem(matmul_act_f32_cp_wgmma_kernel<T>, T::SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  matmul_act_f32_cp_wgmma_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES,
                                      static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, part, counters, M, N, K, act, k_chunk, x_bytes, w_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The WGMMA route of matmul_act_bf16: x, w and y with row pitches of
// 16-byte multiples and 16-byte aligned bases (tile_plan.plan's route).
// Returns the CUDA error code of the tensor-map encodes and the launch.
extern "C" int matmul_act_bf16_wgmma(const void* x, const void* w, const void* b, void* y, int M,
                                     int N, int K, int act, void* stream) {
  const int smem_err = allow_smem(matmul_act_wgmma_kernel, Coop::SMEM_BYTES);
  if (smem_err != 0) return smem_err;
  CUtensorMap tx, tw, ty;
  int err = W::tensor_map(&tx, x, M, K, W::BOX, W::BM);
  if (err == 0) err = W::tensor_map(&tw, w, K, N, W::BOX, W::BK);
  if (err == 0) err = W::tensor_map(&ty, y, M, N, W::BOX, W::BM / 2);
  if (err != 0) return err;
  const dim3 grid((N + Coop::BN - 1) / Coop::BN, (M + W::BM - 1) / W::BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  matmul_act_wgmma_kernel<<<grid, W::THREADS, Coop::SMEM_BYTES, s>>>(
      tx, tw, ty, static_cast<const bf16*>(b), N, K, act);
  return static_cast<int>(cudaGetLastError());
}

// The f32 WGMMA route of matmul_act_f32: x, w and y with row pitches of
// 16-byte multiples and 16-byte aligned bases (tile_plan.plan's route).
// xhi, xlo: scratch of M * K floats each, 16-byte aligned, for x's split
// copies (the pre-pass writes them, the GEMM reads them); blocks: the
// persistent grid, min(tiles, SMs). Returns the CUDA error code of the
// tensor-map encodes and the two launches.
extern "C" int matmul_act_f32_wgmma(const float* x, const float* w, const float* b, float* y,
                                    float* xhi, float* xlo, int M, int N, int K, int act,
                                    int blocks, void* stream) {
  int err = allow_smem(matmul_act_f32_wgmma_kernel, T::S::SMEM_BYTES);
  CUtensorMap tw, txh, txl;
  if (err == 0) err = W::tensor_map(&tw, w, K, N, T::A_BOX, T::BK, 4);
  if (err == 0) err = W::tensor_map(&txh, xhi, M, K, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&txl, xlo, M, K, T::BK, T::ROWS, 4);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n4 = static_cast<size_t>(M) * K / 4;
  const int split_blocks = static_cast<int>(n4 < 132 * 64 * 256 ? (n4 + 255) / 256 : 132 * 64);
  matmul_act_f32_split_kernel<<<split_blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                                           reinterpret_cast<uint4*>(xhi),
                                                           reinterpret_cast<uint4*>(xlo), n4);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  matmul_act_f32_wgmma_kernel<<<blocks, W::THREADS, T::S::SMEM_BYTES, s>>>(tw, txh, txl, b, y, M,
                                                                           N, K, act);
  return static_cast<int>(cudaGetLastError());
}
