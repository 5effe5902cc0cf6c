// The f32 FFMA tile scheme shared by the GEMM kernels (matmul_act.cu,
// sgd_fused.cu): a 64x64 output tile per 256-thread block, the contraction
// stepped 16 at a time through shared memory, and a 4x4 register
// micro-tile per thread (16 FFMA per 8 shared-memory words read). Full f32
// (no TF32, no tensor cores): the parity tests hold f32.
//
// Both operand tiles are stored k-major in shared memory, As[k][row] and
// Bs[k][col], so a thread reads its 4 rows and its 4 columns as one float4
// each; the kernels differ only in how they fill the tiles.

#pragma once

#include <cuda_runtime.h>

namespace nnet_tile {

constexpr int BM = 64;       // rows of the output tile
constexpr int BN = 64;       // columns of the output tile
constexpr int BK = 16;       // contraction step through shared memory
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_PAD = 4;     // keeps float4 alignment, spreads the stores

// acc[i][j] += sum_k As[k][ty*TM + i] * Bs[k][tx*TN + j]
__device__ __forceinline__ void fma_tile(const float (&As)[BK][BM + A_PAD],
                                         const float (&Bs)[BK][BN], int ty, int tx,
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
    const float4 c = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
    const float av[TM] = {a.x, a.y, a.z, a.w};
    const float bv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace nnet_tile
