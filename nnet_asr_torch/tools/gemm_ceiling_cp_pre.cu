// A candidate design tools/gemm_ceiling.py --small times and the port does
// not take: the f32 WGMMA route's pre-pass (tf32_wgmma.cuh) feeding the f32
// CP_WGMMA loop. A first kernel
// splits x into hi and lo copies in device memory (K-major: x itself for
// the forward, x transposed for the weight gradient), then the
// cp_tf32_wgmma.cuh loop copies both by cp.async (MODE PRESPLIT) instead of
// splitting x in the block. Two launches a call; compiled only into
// gemm_ceiling's cp_f32_prepass build, beside csrc/.

#include <cuda_runtime.h>

#include "cp_tf32_wgmma.cuh"

namespace {

using namespace nnet_tile;

// hi and lo of n floats
__global__ void __launch_bounds__(256)
cp_pre_split_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo,
                    size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t h, l;
    split_tf32(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// x (B, In) transposed into its hi and lo halves (In, B), a 32 x 32 tile a
// block through shared memory (sgd_fused.cu's pre-pass)
__global__ void __launch_bounds__(256)
cp_pre_split_t_kernel(const float* __restrict__ x, float* __restrict__ hi,
                      float* __restrict__ lo, int B, int In) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r, i = i0 + tx;
    tile[r][tx] = b < B && i < In ? x[(size_t)b * In + i] : 0.0f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r, b = b0 + tx;
    if (i >= In || b >= B) continue;
    uint32_t h, l;
    split_tf32(tile[tx][r], h, l);
    hi[(size_t)i * B + b] = __uint_as_float(h);
    lo[(size_t)i * B + b] = __uint_as_float(l);
  }
}

using Pre = nnet_cpf::CpF32Planned<nnet_cpf::PRESPLIT>;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
matmul_act_f32_cp_pre_kernel(const float* __restrict__ xhi, const float* __restrict__ xlo,
                             const float* __restrict__ w, const float* __restrict__ b,
                             float* __restrict__ y, float* __restrict__ part,
                             int* __restrict__ counters, int M, int N, int K, int act,
                             int k_chunk, int x_bytes, int w_bytes) {
  extern __shared__ uint8_t pre_smem[];
  uint8_t* ring = nnet_cpf::ring_of(pre_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const nnet_cpf::Operands o{w, N, N, xhi, xlo, K, M, w_bytes, x_bytes};
  const float2 bias = nnet_cpf::bias_of(b, N, n0);
  float acc[T::NACC];
  nnet_cpf::mainloop<T>(ring, o, n0, m0, k_begin, min(K, k_begin + k_chunk), acc);
  if (!nnet_cpw::reduce_acc<T>(acc, part, counters)) return;
  nnet_cpf::store_y<T>(acc, bias, y, M, N, m0, n0, act);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
wgrad_momentum_f32_cp_pre_kernel(const float* __restrict__ xhi, const float* __restrict__ xlo,
                                 const float* __restrict__ e, float* __restrict__ p,
                                 float* __restrict__ v, float* __restrict__ part,
                                 int* __restrict__ counters, float a, float m, int B, int In,
                                 int Out, int k_chunk, int x_bytes, int e_bytes) {
  extern __shared__ uint8_t pre_smem[];
  uint8_t* ring = nnet_cpf::ring_of(pre_smem);
  const int in0 = blockIdx.y * T::BM, out0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const nnet_cpf::Operands o{e, Out, Out, xhi, xlo, B, In, e_bytes, x_bytes};
  float acc[T::NACC];
  nnet_cpf::mainloop<T>(ring, o, out0, in0, k_begin, min(B, k_begin + k_chunk), acc);
  if (!nnet_cpw::reduce_acc<T>(acc, part, counters)) return;
  nnet_cpf::update_pv<T, float>(acc, p, v, a, m, In, Out, in0, out0);
}

int split_blocks(size_t n) { return static_cast<int>(n < 132 * 8 * 256 ? (n + 255) / 256 : 132 * 8); }

}  // namespace

// y = act(x @ W + b): x split into xhi, xlo (M x K floats each), then the
// PRESPLIT loop; xh_bytes: the copy width of the split copies (pitch K)
extern "C" int matmul_act_f32_cp_pre(const float* x, const float* w, const float* b, float* y,
                                     float* xhi, float* xlo, int M, int N, int K, int act,
                                     int xh_bytes, int w_bytes, int splits, int k_chunk,
                                     float* part, int* counters, void* stream) {
  using T = Pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = allow_smem(matmul_act_f32_cp_pre_kernel<T>, T::SMEM_BYTES);
  if (err != 0) return err;
  const size_t n = static_cast<size_t>(M) * K;
  cp_pre_split_kernel<<<split_blocks(n), 256, 0, s>>>(x, xhi, xlo, n);
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  matmul_act_f32_cp_pre_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
      xhi, xlo, w, b, y, part, counters, M, N, K, act, k_chunk, xh_bytes, w_bytes);
  return static_cast<int>(cudaGetLastError());
}

// g = x^T e, then the momentum update (f32 v): x transposed and split into
// xhi, xlo (In x B floats each), then the PRESPLIT loop; xh_bytes: the copy
// width of the split copies (pitch B)
extern "C" int wgrad_momentum_update_f32_cp_pre(const float* x, const float* e, float* p,
                                                float* v, float* xhi, float* xlo, float* part,
                                                int* counters, float a, float m, int B, int In,
                                                int Out, int splits, int k_chunk, int xh_bytes,
                                                int e_bytes, void* stream) {
  using T = Pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = allow_smem(wgrad_momentum_f32_cp_pre_kernel<T>, T::SMEM_BYTES);
  if (err != 0) return err;
  cp_pre_split_t_kernel<<<dim3((In + 31) / 32, (B + 31) / 32), 256, 0, s>>>(x, xhi, xlo, B, In);
  const dim3 grid((Out + T::BN - 1) / T::BN, (In + T::BM - 1) / T::BM, splits);
  wgrad_momentum_f32_cp_pre_kernel<T><<<grid, T::THREADS, T::SMEM_BYTES, s>>>(
      xhi, xlo, e, p, v, part, counters, a, m, B, In, Out, k_chunk, xh_bytes, e_bytes);
  return static_cast<int>(cudaGetLastError());
}
