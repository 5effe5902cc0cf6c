// Fused weight gradient + momentum SGD update, f32, in place:
//
//     g    = x^T e                 (sum over the bunch, the X^T E convention)
//     corr = g + m * v
//     v    = corr                  (stored at v's dtype: f32 or bf16)
//     p    = p - a * corr          (a = lr/N of train/sgd.py)
//
// Replaces the TPU kernel nnet_asr_tpu/ops/pallas/sgd_fused.py
// (wgrad_momentum_update / _kernel), itself the analog of the reference GPU
// trainer's per-layer Update() (cuBiasedLinearity.cc:44-63): the gradient
// never reaches device memory, and the velocity and weight tiles are read
// and written once, in the GEMM's epilogue.
//
// What bounds it on an H100: at the production shape (bunch 1024,
// 4096 -> 8192) FFMA issue: 2*B*In*Out = 68.7 GFLOP against 537 MB of p/v
// reads and writes (f32 velocity), ~128 FLOP/byte, so the GEMM and not the
// epilogue's bytes sets the time. At example-01's 960 x 1024 -> 135 it is
// launch and latency: 0.27 GFLOP in 48 output tiles, fewer than the 132 SMs.
// The design: the f32 tile scheme of tile_gemm.cuh, one block per (In, Out)
// output tile, looping over the bunch in BK steps inside the block (the
// TPU's sequential "arbitrary" grid axis becomes that loop, so nothing is
// carried between blocks). The contraction runs over the LEADING (bunch)
// dimension of both operands, so the x tile (BK, BM) and the e tile
// (BK, BN) are already k-major: each is loaded coalesced along its rows
// straight into shared memory, and the product is x^T e. The epilogue
// reads p and v (upcasting bf16), and writes both in place: each element
// belongs to exactly one thread of one block, so no other block reads it.
// Ragged edges (598, 135, 960 are not tile multiples) are masked by bounds;
// there is no padding copy. The epilogue rounds each product and sum on
// its own (__fmul_rn / __fadd_rn, no FMA contraction), as the plain
// PyTorch and JAX versions do; bf16 velocity is stored round-to-nearest-
// even (__float2bfloat16_rn), as JAX's astype. Tensor cores (wgmma) are
// later work.
//
// Layout: x (B, In), e (B, Out), p (In, Out), v (In, Out), all row-major
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace nnet_tile;

__device__ __forceinline__ float load_v(const float* v, size_t i) { return v[i]; }
__device__ __forceinline__ float load_v(const __nv_bfloat16* v, size_t i) {
  return __bfloat162float(v[i]);
}
__device__ __forceinline__ void store_v(float* v, size_t i, float x) { v[i] = x; }
__device__ __forceinline__ void store_v(__nv_bfloat16* v, size_t i, float x) {
  v[i] = __float2bfloat16_rn(x);
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
wgrad_momentum_kernel(const float* __restrict__ x, const float* __restrict__ e,
                      float* __restrict__ p, V* __restrict__ v, float a, float m,
                      int B, int In, int Out) {
  __shared__ __align__(16) float Xs[BK][BM + A_PAD];
  __shared__ __align__(16) float Es[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);    // column group (Out)
  const int ty = tid / (BN / TN);    // row group (In)
  const int row0 = blockIdx.y * BM;  // first In index of the tile
  const int col0 = blockIdx.x * BN;  // first Out index of the tile

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < B; k0 += BK) {
    // x tile: BK bunch rows x BM columns, consecutive threads walk a row of x
#pragma unroll
    for (int l = 0; l < (BK * BM) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BM, i = idx % BM;
      const int gk = k0 + k, gi = row0 + i;
      Xs[k][i] = (gk < B && gi < In) ? x[(size_t)gk * In + gi] : 0.0f;
    }
    // e tile: BK bunch rows x BN columns, consecutive threads walk a row of e
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN, j = idx % BN;
      const int gk = k0 + k, gj = col0 + j;
      Es[k][j] = (gk < B && gj < Out) ? e[(size_t)gk * Out + gj] : 0.0f;
    }
    __syncthreads();
    fma_tile(Xs, Es, ty, tx, acc);
    __syncthreads();
  }

  // epilogue after the last bunch step: momentum update of the owned elements
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= In) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= Out) continue;
      const size_t o = (size_t)r * Out + c;
      const float corr = __fadd_rn(acc[i][j], __fmul_rn(load_v(v, o), m));
      store_v(v, o, corr);
      p[o] = __fsub_rn(p[o], __fmul_rn(corr, a));
    }
  }
}

}  // namespace

// v is float* (v_is_bf16 = 0) or __nv_bfloat16* (v_is_bf16 = 1). Returns
// cudaGetLastError() after the launch.
extern "C" int wgrad_momentum_update_f32(const float* x, const float* e, float* p,
                                         void* v, float a, float m, int B, int In,
                                         int Out, int v_is_bf16, void* stream) {
  const dim3 grid((Out + BN - 1) / BN, (In + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_is_bf16) {
    wgrad_momentum_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        x, e, p, static_cast<__nv_bfloat16*>(v), a, m, B, In, Out);
  } else {
    wgrad_momentum_kernel<float><<<grid, THREADS, 0, s>>>(
        x, e, p, static_cast<float*>(v), a, m, B, In, Out);
  }
  return static_cast<int>(cudaGetLastError());
}
