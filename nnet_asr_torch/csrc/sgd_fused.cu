// Fused weight gradient + momentum SGD update, in place:
//
//     g    = x^T e                 (sum over the bunch, the X^T E convention)
//     corr = g + m * v
//     v    = corr                  (stored at v's dtype: f32 or bf16)
//     p    = p - a * corr          (a = lr/N of train/sgd.py)
//
// with f32 x and e (f32-accurate), or bf16 x and e (the bf16 compute mode:
// f32 accumulation, then g rounded to bf16 once, after the whole sum and
// before the f32 epilogue, where JAX's bf16 mode rounds dW:
// matmul_act.py:129 astype(bf16), then apply_updates in f32). p is f32.
//
// Replaces the TPU kernel nnet_asr_tpu/ops/pallas/sgd_fused.py
// (wgrad_momentum_update / _kernel), itself the analog of the reference GPU
// trainer's per-layer Update() (cuBiasedLinearity.cc:44-63): the gradient
// never reaches device memory, and the velocity and weight tiles are read
// and written once, in the GEMM's epilogue.
//
// What bounds it on an H100: at the production shape (bunch 1024,
// 4096 -> 8192) operations: 2*B*In*Out = 68.7 GFLOP, a bound of 416 us at
// the 165 TFLOP/s of f32-accurate 3xTF32, against 587 MB of x, e and the
// p/v reads and writes (f32 velocity), 175 us. In practice the mma.sync
// issue rate of TF32 (half of wgmma's, tile_gemm.cuh) caps the main loop
// near half of that bound. With bf16 operands the operations take 69.5 us
// at 989 TFLOP/s and the p/v bytes (537 MB with f32 velocity) 160 us: the
// bf16 variant is bound by bytes. At example-01's 960 x 1024 -> 135 it is
// bytes and latency: 0.27 GFLOP in only 48 64x64 output tiles for 132 SMs.
// The design: the tensor-core main loop of tile_gemm.cuh (3xTF32 or bf16
// mma.sync, cp.async ring) with the bunch as the contraction, x and e both
// loaded M/N-major (rows of the bunch) straight from row-major memory. The
// TPU's sequential "arbitrary" grid axis becomes the loop over the bunch
// inside each block. Where the 64x64 tiles alone give fewer than two blocks
// per SM, the plan (ops/kernels/tile_plan.py) splits the bunch S ways: each
// split writes its f32 partial tile to a scratch (S, In, Out) buffer the
// wrapper allocates, and a second kernel sums the S partials in a fixed
// order, rounds the sum to bf16 for bf16 operands, and applies the same
// epilogue. No float atomics, so two runs give the same bits. The epilogue
// reads p and v (upcasting bf16) in whole rows, 16 elements per thread at a
// time with every load before the first store, and writes both in place:
// each element belongs to exactly one thread, so no other block reads it.
// Ragged edges (598, 135, 960 are not tile multiples) are masked by bounds;
// there is no padding copy. The epilogue rounds each product and sum on its
// own (__fmul_rn / __fadd_rn, no FMA contraction), as the plain PyTorch and
// JAX versions do; bf16 velocity is stored round-to-nearest-even
// (__float2bfloat16_rn), as JAX's astype.
//
// Layout: x (B, In), e (B, Out), p (In, Out), v (In, Out), all row-major
// contiguous; scratch (S, In, Out) f32 when S > 1.

#include <cuda_runtime.h>

#include <type_traits>

#include "tile_gemm.cuh"

namespace {

using namespace nnet_tile;

// The weight gradient as the update takes it: the f32 sum, or for bf16
// operands that sum rounded to bf16 (to nearest even).
template <class E>
__device__ __forceinline__ float grad_at(float g) {
  if constexpr (std::is_same<E, bf16>::value) return __bfloat162float(__float2bfloat16_rn(g));
  return g;
}

template <class V>
__device__ __forceinline__ void momentum_update(float* p, V* v, size_t o, float g, float a,
                                                float m) {
  const float corr = __fadd_rn(g, __fmul_rn(to_f32(v[o]), m));
  store_rn(v + o, corr);
  p[o] = __fsub_rn(p[o], __fmul_rn(corr, a));
}

// Marks the split-K GEMM: store the f32 partial of split blockIdx.z.
struct Partial {};

// E = float or bf16: the operands. V = float or bf16: the fused epilogue;
// V = Partial: store the f32 partial of split blockIdx.z into part.
template <class T, class E, class V>
__global__ void __launch_bounds__(T::THREADS)
wgrad_momentum_kernel(const E* __restrict__ x, const E* __restrict__ e, float* __restrict__ p,
                      V* __restrict__ v, float* __restrict__ part, float a, float m, int B,
                      int In, int Out, int k_chunk, int x_bytes, int e_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(B, k_begin + k_chunk);
  float acc[T::MT][T::NT][4];
  gemm_mainloop<T, E, false>(reinterpret_cast<E*>(smem), x, In, x_bytes, e, Out, e_bytes, In,
                             Out, m0, n0, k_begin, k_end, acc);
  constexpr int U = 16;
  epilogue<T, U>(smem, m0, n0, acc, [&](const int (&r)[U], const int (&c)[U], float (&g)[U]) {
    size_t o[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = r[u] < In && c[u] < Out;
      o[u] = (size_t)r[u] * Out + c[u];
    }
    if constexpr (std::is_same<V, Partial>::value) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (in[u]) part[(size_t)blockIdx.z * In * Out + o[u]] = g[u];
    } else {
      float pv[U], vv[U];   // every load before the first store
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pv[u] = in[u] ? p[o[u]] : 0.0f;
        vv[u] = in[u] ? to_f32(v[o[u]]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!in[u]) continue;
        const float corr = __fadd_rn(grad_at<E>(g[u]), __fmul_rn(vv[u], m));
        store_rn(v + o[u], corr);
        p[o[u]] = __fsub_rn(pv[u], __fmul_rn(corr, a));
      }
    }
  });
}

// The S partials summed in split order, then (bf16 operands) rounded, then
// the epilogue.
template <class E, class V>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ p,
                                    V* __restrict__ v, float a, float m, int S, size_t n) {
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (size_t)gridDim.x * blockDim.x) {
    float g = part[o];
    for (int s = 1; s < S; ++s) g = __fadd_rn(g, part[(size_t)s * n + o]);
    momentum_update(p, v, o, grad_at<E>(g), a, m);
  }
}

template <class T, class E, class V>
int launch_gemm(const E* x, const E* e, float* p, V* v, float* part, float a, float m, int B,
                int In, int Out, int splits, int k_chunk, int x_bytes, int e_bytes,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<T, E, false>();
  const int err = allow_smem(wgrad_momentum_kernel<T, E, V>, smem);
  if (err != 0) return err;
  const dim3 grid((Out + T::BN - 1) / T::BN, (In + T::BM - 1) / T::BM, splits);
  wgrad_momentum_kernel<T, E, V><<<grid, T::THREADS, smem, stream>>>(
      x, e, p, v, part, a, m, B, In, Out, k_chunk, x_bytes, e_bytes);
  return static_cast<int>(cudaGetLastError());
}

// one split: the fused epilogue in the GEMM; several: partials, then reduce
template <class T, class E, class V>
int launch(const E* x, const E* e, float* p, V* v, float* part, float a, float m, int B, int In,
           int Out, int splits, int k_chunk, int x_bytes, int e_bytes, cudaStream_t stream) {
  if (splits <= 1)
    return launch_gemm<T, E, V>(x, e, p, v, nullptr, a, m, B, In, Out, 1, B, x_bytes, e_bytes,
                                stream);
  const int err = launch_gemm<T, E, Partial>(x, e, nullptr, nullptr, part, a, m, B, In, Out,
                                             splits, k_chunk, x_bytes, e_bytes, stream);
  if (err != 0) return err;
  const size_t n = (size_t)In * Out;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  wgrad_reduce_kernel<E, V><<<blocks, threads, 0, stream>>>(part, p, v, a, m, splits, n);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int dispatch(const E* x, const E* e, float* p, void* v, float* part, float a, float m, int B,
             int In, int Out, int v_is_bf16, int tile, int splits, int k_chunk, int x_bytes,
             int e_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* vb = static_cast<bf16*>(v);
  float* vf = static_cast<float*>(v);
  if (tile == 0)
    return v_is_bf16 ? launch<BigTile>(x, e, p, vb, part, a, m, B, In, Out, splits, k_chunk,
                                       x_bytes, e_bytes, s)
                     : launch<BigTile>(x, e, p, vf, part, a, m, B, In, Out, splits, k_chunk,
                                       x_bytes, e_bytes, s);
  return v_is_bf16 ? launch<SmallTile>(x, e, p, vb, part, a, m, B, In, Out, splits, k_chunk,
                                       x_bytes, e_bytes, s)
                   : launch<SmallTile>(x, e, p, vf, part, a, m, B, In, Out, splits, k_chunk,
                                       x_bytes, e_bytes, s);
}

}  // namespace

// v is float* (v_is_bf16 = 0) or __nv_bfloat16* (v_is_bf16 = 1). tile:
// 0 = 128x128, 1 = 64x64. splits > 1: the bunch is cut into chunks of
// k_chunk rows (a multiple of the tile's BK) and part is an f32 scratch of
// splits * In * Out elements; else part is unused. x_vec, e_vec: 16-byte
// copies of that operand. Returns the CUDA error code of the launches.
extern "C" int wgrad_momentum_update_f32(const float* x, const float* e, float* p, void* v,
                                         float* part, float a, float m, int B, int In,
                                         int Out, int v_is_bf16, int tile, int splits,
                                         int k_chunk, int x_vec, int e_vec, void* stream) {
  return dispatch(x, e, p, v, part, a, m, B, In, Out, v_is_bf16, tile, splits, k_chunk,
                  x_vec ? 16 : 4, e_vec ? 16 : 4, stream);
}

// The same with bf16 x and e: g = x^T e accumulated in f32 and rounded to
// bf16 after the whole (split-K) sum, then the f32 update. x_bytes,
// e_bytes: the copy width of that operand, 16, 4 or 2.
extern "C" int wgrad_momentum_update_bf16(const void* x, const void* e, float* p, void* v,
                                          float* part, float a, float m, int B, int In,
                                          int Out, int v_is_bf16, int tile, int splits,
                                          int k_chunk, int x_bytes, int e_bytes, void* stream) {
  return dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(e), p, v, part, a, m,
                  B, In, Out, v_is_bf16, tile, splits, k_chunk, x_bytes, e_bytes, stream);
}
