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
// work, a bound of 208 us, against 30 us for the bytes. In practice the
// mma.sync issue rate of TF32 (half of wgmma's, tile_gemm.cuh) caps the
// main loop near half of that bound. In bf16 the same product is bounded
// at 34.7 us by the 989 TFLOP/s of dense bf16 (15 us of bytes); one
// mma.sync m16n8k16 pass replaces the three TF32 ones.
// The design: the tensor-core main loop of tile_gemm.cuh (3xTF32 or bf16
// mma.sync, cp.async ring, 128x128 or 64x64 tiles chosen by
// ops/kernels/tile_plan.py), with x K-major and W N-major in shared memory.
// The epilogue adds the bias (a bf16 bias read and upcast) and applies the
// sigmoid in f32 to the output tile, staged through shared memory so that y
// is written in whole rows (bf16 y rounded to nearest even, as JAX's
// astype), masked at the ragged edges (598, 135 and 960 are not tile
// multiples; loads outside the matrix read 0).
//
// Layout: x (M, K), W (K, N), b (N,), y (M, N), all row-major contiguous.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace nnet_tile;

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS)
matmul_act_kernel(const E* __restrict__ x, const E* __restrict__ w, const E* __restrict__ b,
                  E* __restrict__ y, int M, int N, int K, int act, int x_bytes, int w_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[T::MT][T::NT][4];
  gemm_mainloop<T, E, true>(reinterpret_cast<E*>(smem), x, K, x_bytes, w, N, w_bytes, M, N, m0,
                            n0, 0, K, acc);
  constexpr int U = 16;
  epilogue<T, U>(smem, m0, n0, acc, [&](const int (&r)[U], const int (&c)[U], float (&z)[U]) {
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
int launch(const E* x, const E* w, const E* b, E* y, int M, int N, int K, int act, int x_bytes,
           int w_bytes, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, E, true>();
  const int err = allow_smem(matmul_act_kernel<T, E>, smem);
  if (err != 0) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  matmul_act_kernel<T, E><<<grid, T::THREADS, smem, stream>>>(x, w, b, y, M, N, K, act, x_bytes,
                                                              w_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int dispatch(const E* x, const E* w, const E* b, E* y, int M, int N, int K, int act, int tile,
             int x_bytes, int w_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 0 ? launch<BigTile>(x, w, b, y, M, N, K, act, x_bytes, w_bytes, s)
                   : launch<SmallTile>(x, w, b, y, M, N, K, act, x_bytes, w_bytes, s);
}

}  // namespace

// act: 0 = none, 1 = sigmoid. tile: 0 = 128x128, 1 = 64x64. x_vec, w_vec:
// 16-byte copies of that operand (row pitch % 4 == 0 and base 16-byte
// aligned), else 4-byte. Returns the CUDA error code of the launch.
extern "C" int matmul_act_f32(const float* x, const float* w, const float* b, float* y,
                              int M, int N, int K, int act, int tile, int x_vec, int w_vec,
                              void* stream) {
  return dispatch(x, w, b, y, M, N, K, act, tile, x_vec ? 16 : 4, w_vec ? 16 : 4, stream);
}

// The same with bf16 x, w, b and y (f32 accumulation, bias and sigmoid in
// f32, y rounded to nearest even). x_bytes, w_bytes: the copy width of that
// operand, 16, 4 or 2 (tile_plan.plan with elem=2).
extern "C" int matmul_act_bf16(const void* x, const void* w, const void* b, void* y, int M,
                               int N, int K, int act, int tile, int x_bytes, int w_bytes,
                               void* stream) {
  return dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                  static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K, act, tile,
                  x_bytes, w_bytes, stream);
}
