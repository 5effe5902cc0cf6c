// A candidate design of the f32 WGMMA route that the port does not take,
// for tools/gemm_ceiling.py's comparison (that tool compiles this file
// beside csrc/ in its f32_wgmma_ss build; the port never builds it):
// design (c) for both operands. y = act(x @ W + b) as y^T = W^T x^T on the
// ping-pong schedule of csrc/tf32_wgmma.cuh, but with W, too, split by a
// pre-pass, and transposed, into K-major hi and lo copies (N, K), so that
// wgmma reads both operands from shared memory (SS): no fragment loads and
// no register split in the main loop, against W's 12 bytes an element in
// the pre-pass (64 MB read and 128 MB written at 4096 x 4096) and four 16
// KB tiles a stage (64 KB: 3 stages in place of 4).

#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"

namespace {

namespace W = nnet_wgmma;
namespace T = nnet_tf32;

struct SS {
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = 2 * T::B_BYTES;               // W's hi and lo
  static constexpr int STAGE_BYTES = A_BYTES + 2 * T::B_BYTES;  // 64 KB
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int READERS = 4;
  static constexpr size_t SMEM_BYTES = RING_BYTES + 128 + 1024;
};

#define NNET_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) += A (64 x 8) * B (8 x 128), both TF32 K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k8_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : NNET_D8(0), NNET_D8(8), NNET_D8(16), NNET_D8(24), NNET_D8(32), NNET_D8(40), NNET_D8(48),
        NNET_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef NNET_D8

// W's hi and lo (128 x 32 each, K-major), then x's
__device__ __forceinline__ void produce_tile(const W::Smem& s, const CUtensorMap* twh,
                                             const CUtensorMap* twl, const CUtensorMap* txh,
                                             const CUtensorMap* txl, int a0, int b0, int ktiles,
                                             W::RingPos<SS>& pos) {
  for (int kt = 0; kt < ktiles; ++kt) {
    W::mbar_wait(W::smem_u32(&s.empty[pos.stage]), pos.phase ^ 1);
    const uint32_t full = W::smem_u32(&s.full[pos.stage]);
    W::mbar_expect_tx(full, SS::STAGE_BYTES);
    const uint32_t a = W::smem_u32(s.ring + pos.stage * SS::STAGE_BYTES);
    const int k0 = kt * T::BK;
    W::tma_load(a, twh, full, k0, a0);
    W::tma_load(a + T::B_BYTES, twl, full, k0, a0);
    W::tma_load(a + SS::A_BYTES, txh, full, k0, b0);
    W::tma_load(a + SS::A_BYTES + T::B_BYTES, txl, full, k0, b0);
    pos.advance();
  }
}

// a stage's 24 wgmma as one group, one group in flight (wgmma_gemm.cuh's
// consume_tile); the m64 halves of A at rows 0 and 64 (8 KB apart)
__device__ __forceinline__ void consume_tile(const W::Smem& s, int ktiles, W::RingPos<SS>& pos,
                                             float (&acc0)[64], float (&acc1)[64]) {
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    W::mbar_wait(W::smem_u32(&s.full[pos.stage]), pos.phase);
    const uint32_t ah = W::smem_u32(s.ring + pos.stage * SS::STAGE_BYTES);
    const uint32_t al = ah + T::B_BYTES, bh = ah + SS::A_BYTES, bl = bh + T::B_BYTES;
    W::fence_acc(acc0);
    W::fence_acc(acc1);
    W::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 8; ++kk) {
      const uint64_t dh = W::smem_desc(bh + kk * 32, 16, 1024);
      const uint64_t dl = W::smem_desc(bl + kk * 32, 16, 1024);
      wgmma_m64n128k8_ss(acc0, W::smem_desc(al + kk * 32, 16, 1024), dh);
      wgmma_m64n128k8_ss(acc1, W::smem_desc(al + 8192 + kk * 32, 16, 1024), dh);
      wgmma_m64n128k8_ss(acc0, W::smem_desc(ah + kk * 32, 16, 1024), dl);
      wgmma_m64n128k8_ss(acc1, W::smem_desc(ah + 8192 + kk * 32, 16, 1024), dl);
      wgmma_m64n128k8_ss(acc0, W::smem_desc(ah + kk * 32, 16, 1024), dh);
      wgmma_m64n128k8_ss(acc1, W::smem_desc(ah + 8192 + kk * 32, 16, 1024), dh);
    }
    W::wgmma_commit();
    W::wgmma_wait<1>();
    W::fence_acc(acc0);
    W::fence_acc(acc1);
    if (prev >= 0 && leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
    prev = pos.stage;
    pos.advance();
  }
  W::wgmma_wait<0>();
  W::fence_acc(acc0);
  W::fence_acc(acc1);
  if (leader) W::mbar_arrive(W::smem_u32(&s.empty[prev]));
}

// matmul_act.cu's pre-pass and epilogue, in this design's rows: wgmma row
// g of each 16 is column g of y here (no permutation: nothing is loaded
// into registers), so a thread's pairs are y rows, stored one element at a
// time
__global__ void __launch_bounds__(256)
ss_split_kernel(const float4* __restrict__ x, uint4* __restrict__ hi, uint4* __restrict__ lo,
                size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    uint4 h, l;
    nnet_tile::split_tf32(v.x, h.x, l.x);
    nnet_tile::split_tf32(v.y, h.y, l.y);
    nnet_tile::split_tf32(v.z, h.z, l.z);
    nnet_tile::split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// sgd_fused.cu's transposing pre-pass: w (K, N) -> hi, lo (N, K)
__global__ void __launch_bounds__(256)
ss_split_transposed_kernel(const float* __restrict__ x, float* __restrict__ hi,
                           float* __restrict__ lo, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    tile[r][tx] = r0 + r < rows && c0 + tx < cols ? x[(size_t)(r0 + r) * cols + c0 + tx] : 0.0f;
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, rr = r0 + tx;
    if (c >= cols || rr >= rows) continue;
    uint32_t h, l;
    nnet_tile::split_tf32(tile[tx][r], h, l);
    hi[(size_t)c * rows + rr] = __uint_as_float(h);
    lo[(size_t)c * rows + rr] = __uint_as_float(l);
  }
}

__device__ __forceinline__ void store_y(const float* __restrict__ b, float* __restrict__ y, int M,
                                        int N, int n0, int m0, int act, const float (&acc)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 16 * w + (lane >> 2) + 8 * h;
    if (n >= N) continue;
    const float bn = b[n];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * i + 2 * t + e;
        if (m >= M) continue;
        float z = acc[4 * i + 2 * h + e] + bn;
        if (act == 1) z = 1.0f / (1.0f + expf(-z));
        y[(size_t)m * N + n] = z;
      }
  }
}

__global__ void __launch_bounds__(W::THREADS, 1)
matmul_act_f32_ss_kernel(const __grid_constant__ CUtensorMap twh,
                         const __grid_constant__ CUtensorMap twl,
                         const __grid_constant__ CUtensorMap txh,
                         const __grid_constant__ CUtensorMap txl, const float* __restrict__ b,
                         float* __restrict__ y, int M, int N, int K, int act) {
  extern __shared__ uint8_t wg_smem[];
  const W::Smem s = W::setup_smem<SS>(wg_smem);
  const int a_tiles = (N + T::ROWS - 1) / T::ROWS;
  const int tiles = a_tiles * ((M + T::ROWS - 1) / T::ROWS);
  const int ktiles = (K + T::BK - 1) / T::BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    W::setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      W::RingPos<SS> pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        produce_tile(s, &twh, &twl, &txh, &txl, (tile % a_tiles) * T::ROWS,
                     (tile / a_tiles) * T::ROWS, ktiles, pos);
    }
  } else {
    W::setmaxnreg_inc<W::CONSUMER_REGS>();
    const int c = wg - 1;
    float acc0[64], acc1[64];
    W::RingPos<SS> pos;
    pos.skip(c * ktiles);
    for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
      const int n0 = (tile % a_tiles) * T::ROWS, m0 = (tile / a_tiles) * T::ROWS;
      if (tile >= gridDim.x) W::named_sync(1 + c, 256);
      consume_tile(s, ktiles, pos, acc0, acc1);
      if (tile + gridDim.x < tiles) W::named_arrive(2 - c, 256);
      pos.skip(ktiles);
      store_y(b, y, M, N, n0, m0, act, acc0);
      store_y(b, y, M, N, n0 + 64, m0, act, acc1);
    }
  }
}

}  // namespace

// y = act(x @ w + b) by design (c) for both operands: whi, wlo (N * K
// floats each) and xhi, xlo (M * K each) are scratch the caller
// allocates, 16-byte aligned; blocks: min(tiles, SMs). Returns the CUDA
// error code of the encodes and the three launches.
extern "C" int matmul_act_f32_wgmma_ss(const float* x, const float* w, const float* b, float* y,
                                       float* xhi, float* xlo, float* whi, float* wlo, int M,
                                       int N, int K, int act, int blocks, void* stream) {
  int err = static_cast<int>(cudaFuncSetAttribute(
      matmul_act_f32_ss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SS::SMEM_BYTES)));
  CUtensorMap twh, twl, txh, txl;
  if (err == 0) err = W::tensor_map(&twh, whi, N, K, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&twl, wlo, N, K, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&txh, xhi, M, K, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&txl, xlo, M, K, T::BK, T::ROWS, 4);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n4 = static_cast<size_t>(M) * K / 4;
  ss_split_kernel<<<static_cast<int>(n4 < 132 * 64 * 256 ? (n4 + 255) / 256 : 132 * 64), 256, 0,
                    s>>>(reinterpret_cast<const float4*>(x), reinterpret_cast<uint4*>(xhi),
                         reinterpret_cast<uint4*>(xlo), n4);
  ss_split_transposed_kernel<<<dim3((N + 31) / 32, (K + 31) / 32), 256, 0, s>>>(w, whi, wlo, K,
                                                                                N);
  matmul_act_f32_ss_kernel<<<blocks, W::THREADS, SS::SMEM_BYTES, s>>>(twh, twl, txh, txl, b, y, M,
                                                                      N, K, act);
  return static_cast<int>(cudaGetLastError());
}
