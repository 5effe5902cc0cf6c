// Fused affine + activation, f32: y = act(x @ W + b).
//
// Replaces the TPU kernel nnet_asr_tpu/ops/pallas/matmul_act.py (_kernel,
// called by matmul_act and the custom-VJP affine_sigmoid): a K-blocked
// GEMM into an f32 accumulator with the bias + sigmoid epilogue applied in
// registers, so the pre-activation never reaches device memory.
//
// What bounds it on an H100: FFMA issue, not bytes. At the production
// shape (1024 x 4096 -> 4096) the GEMM does 2*M*N*K = 34 GFLOP over
// 50 MB of operands (~680 FLOP/byte). This first version is the classic
// shared-memory tiled SGEMM of tile_gemm.cuh. Ragged edges (598, 135, 960
// are not tile multiples) are masked: loads outside the matrix read 0,
// stores outside are skipped.
//
// Layout: x (M, K), W (K, N), b (N,), y (M, N), all row-major contiguous.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace nnet_tile;

__global__ void __launch_bounds__(THREADS)
matmul_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int M, int N, int K, int act) {
  // A tile stored transposed (k-major) so a thread reads its 4 rows as one float4
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);    // column group
  const int ty = tid / (BN / TN);    // row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK, consecutive threads walk k (coalesced along a row of x)
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
    }
    // B tile: BK x BN, consecutive threads walk n (coalesced along a row of W)
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gc = col0 + n;
      Bs[k][n] = (gk < K && gc < N) ? w[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // epilogue: bias + activation in registers, masked store
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      float z = acc[i][j] + b[c];
      if (act == 1) z = 1.0f / (1.0f + expf(-z));
      y[(size_t)r * N + c] = z;
    }
  }
}

}  // namespace

// act: 0 = none, 1 = sigmoid. Returns cudaGetLastError() after the launch.
extern "C" int matmul_act_f32(const float* x, const float* w, const float* b,
                              float* y, int M, int N, int K, int act,
                              void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_act_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
