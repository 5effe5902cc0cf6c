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
// p/v reads and writes (f32 velocity), 175 us. The mma.sync issue rate of
// TF32 (half of wgmma's, tile_gemm.cuh) caps that loop near half of the
// bound, so the production shapes take 3xTF32 wgmma (below). With bf16
// operands the operations take 69.5 us
// at 989 TFLOP/s and the p/v bytes (537 MB with f32 velocity) 160 us: the
// bf16 variant is bound by bytes. At example-01's 960 x 1024 -> 135 it is
// bytes and latency: 0.27 GFLOP in only 48 64x64 output tiles for 132 SMs.
// The design: the tensor-core main loop of tile_gemm.cuh (3xTF32 or bf16
// mma.sync, cp.async ring) with the bunch as the contraction, x and e both
// loaded M/N-major (rows of the bunch) straight from row-major memory. The
// TPU's sequential "arbitrary" grid axis becomes the loop over the bunch
// inside each block. Where the 64x64 tiles alone give fewer than two blocks
// per SM, the plan (ops/kernels/tile_plan.py) splits the bunch S ways: each
// split writes its f32 partial tile to a scratch buffer the wrapper
// allocates, and the block that arrives last at a tile (an int counter per
// tile) sums the S partials in split order (tile_gemm.cuh reduce_splits),
// then, for bf16 operands, rounds the sum to bf16 once, and applies the
// epilogue, in the same launch: the partials of one call (2 x 2.4 MB at
// 960 x 598 -> 1024) stay in the 50 MB L2, and there is no second launch.
// No float atomics, so two runs give the same bits. The epilogue
// reads p and v (upcasting bf16) in whole rows, 16 elements per thread at a
// time with every load before the first store, and writes both in place:
// each element belongs to exactly one thread, so no other block reads it.
// Ragged edges (598, 135, 960 are not tile multiples) are masked by bounds;
// there is no padding copy. The epilogue rounds each product and sum on its
// own (__fmul_rn / __fadd_rn, no FMA contraction), as the plain PyTorch and
// JAX versions do; bf16 velocity is stored round-to-nearest-even
// (__float2bfloat16_rn), as JAX's astype.
//
// bf16 x and e whose rows TMA can describe (pitches of 16-byte multiples,
// 16-byte aligned bases, and p and v 16-byte aligned: every production
// shape) take the WGMMA route instead (wgrad_momentum_wgmma_kernel):
// wgmma_gemm.cuh's warp-specialised TMA ring with m64n128k16 wgmma reading
// x M-major and e N-major, on a persistent grid of min(tiles, SMs) blocks
// that walk the 128x128 output tiles in a fixed order. The epilogue bounds
// this route (each tile reads and writes 256 KB of f32 p and v against
// ~4 us of wgmma work), so the two consumer warpgroups take turns
// (PingPong): one runs a tile's wgmma while the other updates p and v for
// the tile before. The epilogue stages g, rounded once to bf16, in shared
// memory and then walks whole rows, so each warp reads and writes 512
// contiguous bytes of f32 p and v with 16-byte accesses; the rows a warp
// has in flight are all loaded before the first store, and the arithmetic
// is the mma.sync epilogue's. It never splits the bunch (the production
// shapes have >= 256 tiles).
//
// bf16 x and e off TMA whose rows cp.async can copy (x's pitch and base in
// whole 4-byte units; e's too, or e's base 16-byte aligned where one tile
// spans Out <= 136: MLP3's 960x598->1024 and 960x1024->135, the plan's
// CP_WGMMA route) take cp_wgmma.cuh's wgrad_mainloop instead of mma.sync
// (wgrad_momentum_bf16_cp_wgmma_kernel): g = x^T e by bf16 wgmma with In on
// its M and Out on its N, x read M-major and e N-major (the trans bits; no
// transpose), 64x64 tiles, or one 64x136 tile across Out whose e stage of
// 64 whole rows (17,280 bytes at Out = 135) is copied as one run and
// realigned into the swizzled boxes by the block; the bunch split (3 ways
// at 598->1024, 5 at 1024->135: tile_plan.cp_wgrad_splits), a tile's
// splits one cluster whose blocks stash their f32 partials and each sum a
// share of the tile's elements in split order through distributed shared
// memory (no scratch, no float atomics), round g to bf16 once and update
// p and v in whole rows, 16 bytes an access (the ROWS tile's rows of p and
// v are one run).
//
// f32 x and e on the same route (pitches of 16-byte multiples, a bunch
// that is a multiple of 4, x, e, p and v 16-byte aligned, and the 128x128
// tiles filling the card: the production stack's weight gradients) take
// tf32_wgmma.cuh's 3xTF32 wgmma instead of mma.sync, whose TF32 issue rate
// held them at about a third of the 3xTF32 bound (1,297 us against 416 at
// 1024 x 4096 -> 8192). TF32 wgmma reads shared-memory operands K-major
// only, and both x and e are MN-major here (the contraction runs over the
// bunch), so the kernel computes g^T = e^T x: e is the A operand, its raw
// tile brought by TMA and each thread's fragment split in registers; x,
// the smaller operand, is transposed and split into hi and lo copies (In,
// B) by a pre-pass kernel (wgrad_momentum_f32_split_kernel, through a
// shared 32 x 32 tile; 12 bytes an element of x, ~15 us at 1024 x 4096)
// into scratch the wrapper allocates. The schedule is the bf16 route's
// PingPong (a persistent grid of min(tiles, SMs) blocks, the two consumer
// warpgroups taking turns on 128 x 128 tiles), since the p and v update,
// 4 x 134 MB of f32 at 4096 x 8192 (~160 us, 38% of the product's bound),
// would otherwise idle the tensor cores; the update reads and writes p and
// v from the accumulator fragments as 16-byte quads of neighbouring columns
// (a warp's access: 4 rows of 128 contiguous bytes), 4 rows in flight
// before the first store, with the mma.sync epilogue's arithmetic.
//
// f32 x and e at every shape the f32 WGMMA route leaves whose 128x128
// tiles would not fill the card (the recipes' weight gradients: MLP3's
// 960x598->1024, TIMIT's 1024x368->500; tile_plan.py's CP_WGMMA route at 4
// bytes an element) take cp_tf32_wgmma.cuh's loop
// (wgrad_momentum_f32_cp_wgmma_kernel): g^T = e^T x by 3xTF32 wgmma, e
// brought raw by cp.async and split in registers, x brought raw by cp.async
// and transposed and split into K-major hi and lo by the block itself (no
// pre-pass, one launch), on tiles of 64 rows (In) by 128 columns (Out) of p
// and v (two warpgroups sharing x's split), the bunch split where the tiles
// leave SMs idle (3 ways at 960x598->1024: tile_plan.cp_f32_splits), the
// partials reduced in the launch. It is bound there by latency (the
// cp_tf32_wgmma.cuh note), not operations or device memory. The update
// reads and writes p and v from the fragments, two neighbouring columns at
// a time, 8 rows in flight before the first store, with the mma.sync
// epilogue's arithmetic and both velocity types. A weight gradient of an
// odd Out (MLP3's 960x1024->135: 4-byte copies of e, one element of p and
// v at a time, the last 64-column tiles 7 columns full) turns g around on
// cp_tf32_wgmma.cuh's warp-specialised ring instead
// (wgrad_momentum_f32_ws_wgmma_kernel, tile_plan.py's WS_WGMMA route), for
// an Out of at most 136: g = x^T e with In on wgmma's M and Out on its N
// (136 columns for 135), x the register operand, e's stage BK whole rows
// copied as one run by the producer warpgroup and transposed and split by
// it; the bunch split into up to 6 splits a tile, one cluster, which sums
// the partials through distributed shared memory and updates p and v
// between its blocks, whole rows of neighbouring columns a warp. Any other
// odd Out keeps the mma.sync kernel above (tile_plan.cp_f32_keeps_mma_sync);
// what the card measured of both at 135 is in tile_plan.ws_f32_takes.
//
// Layout: x (B, In), e (B, Out), p (In, Out), v (In, Out), all row-major
// contiguous; with S > 1 splits an f32 scratch of S partial 64x64 tiles a
// tile and an int counter a tile.

#include <cuda_runtime.h>

#include <type_traits>

#include "cp_tf32_wgmma.cuh"
#include "tf32_wgmma.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace nnet_tile;
namespace W = nnet_wgmma;
namespace T = nnet_tf32;

// The weight gradient as the update takes it: the f32 sum, or for bf16
// operands that sum rounded to bf16 (to nearest even).
template <class E>
__device__ __forceinline__ float grad_at(float g) {
  if constexpr (std::is_same<E, bf16>::value) return __bfloat162float(__float2bfloat16_rn(g));
  return g;
}

// g = x^T e for one BM x BN tile of p and v, then the momentum update in
// place. E = float or bf16: the operands; V = float or bf16: the velocity.
// With gridDim.z > 1, split blockIdx.z of the bunch (k_chunk rows), the
// last split to arrive summing the partials (part, counters: reduce_splits)
// before the update.
template <class T, class E, class V>
__global__ void __launch_bounds__(T::THREADS)
wgrad_momentum_kernel(const E* __restrict__ x, const E* __restrict__ e, float* __restrict__ p,
                      V* __restrict__ v, float* __restrict__ part, int* __restrict__ counters,
                      float a, float m, int B, int In, int Out, int k_chunk, int x_bytes,
                      int e_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  float acc[T::MT][T::NT][4];
  gemm_mainloop<T, E, false>(reinterpret_cast<E*>(smem), x, In, x_bytes, e, Out, e_bytes, In,
                             Out, m0, n0, k_begin, min(B, k_begin + k_chunk), acc);
  stage_acc<T>(smem, acc);
  if (!reduce_splits<T>(smem, part, counters)) return;
  constexpr int U = 16;
  epilogue<T, U>(smem, m0, n0, [&](const int (&r)[U], const int (&c)[U], float (&g)[U]) {
    size_t o[U];
    bool in[U];
    float pv[U], vv[U];   // every load before the first store
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = r[u] < In && c[u] < Out;
      o[u] = (size_t)r[u] * Out + c[u];
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
  });
}

template <class T, class E, class V>
int launch(const E* x, const E* e, float* p, V* v, float* part, int* counters, float a, float m,
           int B, int In, int Out, int splits, int k_chunk, int x_bytes, int e_bytes,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, E, false>();
  const int err = allow_smem(wgrad_momentum_kernel<T, E, V>, smem);
  if (err != 0) return err;
  const dim3 grid((Out + T::BN - 1) / T::BN, (In + T::BM - 1) / T::BM, splits);
  wgrad_momentum_kernel<T, E, V><<<grid, T::THREADS, smem, stream>>>(
      x, e, p, v, part, counters, a, m, B, In, Out, k_chunk, x_bytes, e_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int dispatch(const E* x, const E* e, float* p, void* v, float* part, int* counters, float a,
             float m, int B, int In, int Out, int v_is_bf16, int tile, int splits, int k_chunk,
             int x_bytes, int e_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* vb = static_cast<bf16*>(v);
  float* vf = static_cast<float*>(v);
  if (tile == 0)
    return v_is_bf16 ? launch<BigTile>(x, e, p, vb, part, counters, a, m, B, In, Out, splits,
                                       k_chunk, x_bytes, e_bytes, s)
                     : launch<BigTile>(x, e, p, vf, part, counters, a, m, B, In, Out, splits,
                                       k_chunk, x_bytes, e_bytes, s);
  return v_is_bf16 ? launch<SmallTile>(x, e, p, vb, part, counters, a, m, B, In, Out, splits,
                                       k_chunk, x_bytes, e_bytes, s)
                   : launch<SmallTile>(x, e, p, vf, part, counters, a, m, B, In, Out, splits,
                                       k_chunk, x_bytes, e_bytes, s);
}

__device__ __forceinline__ float4 load4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 load4(const bf16* q) {
  const uint2 u = *reinterpret_cast<const uint2*>(q);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* q, float4 x) {
  *reinterpret_cast<float4*>(q) = x;
}
// round to nearest even, as JAX's astype
__device__ __forceinline__ void store4(bf16* q, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(q) = u;
}

// v <- g + m v; p <- p - a v for one element, in f32 with no contraction
__device__ __forceinline__ void momentum(float g, float& p, float& v, float a, float m) {
  v = __fadd_rn(g, __fmul_rn(v, m));
  p = __fsub_rn(p, __fmul_rn(v, a));
}

// The WGMMA route's epilogue for one ping-pong tile (rows m0.., columns
// n0.. of p and v): g rounded once to bf16 (the rounding grad_at<bf16>
// makes) and staged row-major in the consumer's buffer gs (G_PITCH), then
// each warp takes rows w, w + 4, ..., R at a time, lane l columns n0 + 4l
// .. n0 + 4l + 3: a warp reads and writes 512 contiguous bytes of f32 p (and
// of f32 v) a row, 16 bytes a lane. The fragments hold rows 16w + l/4 + 8h
// (+ 64 for acc1), columns 8i + 2(l%4) + e at d[4i + 2h + e].
template <class V>
__device__ __forceinline__ void update_tile(bf16* __restrict__ gs, float* __restrict__ p,
                                            V* __restrict__ v, float a, float m, int In,
                                            int Out, int m0, int n0, const float (&acc0)[64],
                                            const float (&acc1)[64]) {
  constexpr int R = 8;   // rows a warp has in flight
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
  const int bar = 2 + threadIdx.x / 128;   // the consumer's own barrier: 3 or 4
  W::named_sync(bar, 128);   // its last tile's update has read gs
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h, col = 8 * i + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(gs + row * W::G_PITCH + col) =
          __floats2bfloat162_rn(acc0[4 * i + 2 * h], acc0[4 * i + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(gs + (row + 64) * W::G_PITCH + col) =
          __floats2bfloat162_rn(acc1[4 * i + 2 * h], acc1[4 * i + 2 * h + 1]);
    }
  W::named_sync(bar, 128);
  const int col = n0 + 4 * lane;
  if (col >= Out) return;   // Out is a multiple of 4 on this route
#pragma unroll 1
  for (int r0 = warp; r0 < W::BM; r0 += 4 * R) {
    float4 pv[R], vv[R];   // every load before the first store
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = m0 + r0 + 4 * j;
      const size_t o = (size_t)r * Out + col;
      pv[j] = r < In ? load4(p + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vv[j] = r < In ? load4(v + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = m0 + r0 + 4 * j;
      if (r >= In) continue;
      const size_t o = (size_t)r * Out + col;
      const uint2 gu = *reinterpret_cast<const uint2*>(gs + (r0 + 4 * j) * W::G_PITCH + 4 * lane);
      const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gu.x));
      const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gu.y));
      momentum(g01.x, pv[j].x, vv[j].x, a, m);
      momentum(g01.y, pv[j].y, vv[j].y, a, m);
      momentum(g23.x, pv[j].z, vv[j].z, a, m);
      momentum(g23.y, pv[j].w, vv[j].w, a, m);
      store4(v + o, vv[j]);
      store4(p + o, pv[j]);
    }
  }
}

// g = x^T e, bf16; v, p updated in place. A persistent grid: block k takes
// tiles k, k + gridDim.x, ... (tile t at rows (t % m_tiles) * 128, columns
// (t / m_tiles) * 128), the producer loading them in that order and the
// two consumers taking turns (wgmma_gemm.cuh, PingPong): consumer c the
// block's tiles c, c + 2, ..., skipping the other's stages in the ring.
template <class V>
__global__ void __launch_bounds__(W::THREADS, 1)
wgrad_momentum_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap te, float* __restrict__ p,
                            V* __restrict__ v, float a, float m, int B, int In, int Out) {
  using S = W::PingPong;
  extern __shared__ uint8_t wg_smem[];
  const W::Smem s = W::setup_smem<S>(wg_smem);
  const int m_tiles = (In + W::BM - 1) / W::BM;
  const int tiles = m_tiles * ((Out + S::BN - 1) / S::BN);
  const int ktiles = (B + W::BK - 1) / W::BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    W::setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      W::RingPos<S> pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        W::produce_tile<S, false>(s, &tx, &te, (tile % m_tiles) * W::BM,
                                  (tile / m_tiles) * S::BN, ktiles, pos);
    }
  } else {
    W::setmaxnreg_inc<W::CONSUMER_REGS>();
    const int c = wg - 1;
    bf16* gs = reinterpret_cast<bf16*>(s.extra + c * W::G_BYTES);
    float acc0[64], acc1[64];
    W::RingPos<S> pos;
    pos.skip(c * ktiles);
    for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
      const int m0 = (tile % m_tiles) * W::BM, n0 = (tile / m_tiles) * S::BN;
      // main loops in turn (wgmma_gemm.cuh): consumer c waits at barrier
      // 1 + c for the other's main loop of the tile before
      if (tile >= gridDim.x) W::named_sync(1 + c, 256);
      W::consume_tile<false>(s, ktiles, pos, acc0, acc1);
      if (tile + gridDim.x < tiles) W::named_arrive(2 - c, 256);
      pos.skip(ktiles);
      update_tile(gs, p, v, a, m, In, Out, m0, n0, acc0, acc1);
    }
  }
}

template <class V>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& te, float* p, V* v, float a, float m,
                 int B, int In, int Out, int blocks, cudaStream_t stream) {
  const int smem_err = allow_smem(wgrad_momentum_wgmma_kernel<V>, W::PingPong::SMEM_BYTES);
  if (smem_err != 0) return smem_err;
  wgrad_momentum_wgmma_kernel<V><<<blocks, W::THREADS, W::PingPong::SMEM_BYTES, stream>>>(
      tx, te, p, v, a, m, B, In, Out);
  return static_cast<int>(cudaGetLastError());
}

// The pre-pass of the f32 WGMMA route: x (B, In) transposed into its hi
// and lo halves (In, B) (tile_gemm.cuh split_tf32), a 32 x 32 tile a block
// through shared memory (pitch 33: the transposed reads hit 32 banks), so
// that the reads of x and the writes of each half are whole rows.
__global__ void __launch_bounds__(256)
wgrad_momentum_f32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                float* __restrict__ lo, int B, int In) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r, i = i0 + tx;
    tile[r][tx] = b < B && i < In ? x[(size_t)b * In + i] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r, b = b0 + tx;
    if (i >= In || b >= B) continue;
    uint32_t h, l;
    split_tf32(tile[tx][r], h, l);
    hi[(size_t)i * B + b] = __uint_as_float(h);
    lo[(size_t)i * B + b] = __uint_as_float(l);
  }
}

// The f32 WGMMA route's update for one ping-pong tile of g^T: its A
// columns (Out) from out0 on, B rows (In) from in0 on. A thread's
// accumulators are g[in][out .. out + 3] for out = out0 + 32w + 4g and in =
// in0 + 8i + 2t + e (tf32_wgmma.cuh acc_quad); p and v are read and written
// there in 16-byte accesses (load4 / store4: 8 bytes of bf16 v), 4 rows of
// each in flight before the first store (8 spill beside the 128
// accumulators), with the mma.sync epilogue's
// arithmetic. Out is a multiple of 4 on this route, so the four are wholly
// inside or outside.
template <class V>
__device__ __forceinline__ void update_tile_f32(float* __restrict__ p, V* __restrict__ v,
                                                float a, float m, int In, int Out, int out0,
                                                int in0, const float (&acc0)[64],
                                                const float (&acc1)[64]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int out = out0 + 32 * w + 4 * (lane >> 2), t = lane & 3;
  if (out >= Out) return;
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += 2) {
    float4 pv[4], vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int in = in0 + 8 * (i0 + j / 2) + 2 * t + j % 2;
      const size_t o = (size_t)in * Out + out;
      pv[j] = in < In ? load4(p + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vv[j] = in < In ? load4(v + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int in = in0 + 8 * (i0 + j / 2) + 2 * t + j % 2;
      if (in >= In) continue;
      const size_t o = (size_t)in * Out + out;
      const float4 g = T::acc_quad(acc0, acc1, i0 + j / 2, j % 2);
      momentum(g.x, pv[j].x, vv[j].x, a, m);
      momentum(g.y, pv[j].y, vv[j].y, a, m);
      momentum(g.z, pv[j].z, vv[j].z, a, m);
      momentum(g.w, pv[j].w, vv[j].w, a, m);
      store4(v + o, vv[j]);
      store4(p + o, pv[j]);
    }
  }
}

// g = x^T e, f32, as g^T = e^T x by 3xTF32 wgmma (tf32_wgmma.cuh,
// PingPong: a persistent grid of 128 x 128 tiles of g^T); v, p updated in
// place. te: e's (B, Out) map; txh, txl: the (In, B) maps of x's
// transposed split copies.
template <class V>
__global__ void __launch_bounds__(W::THREADS, 1)
wgrad_momentum_f32_wgmma_kernel(const __grid_constant__ CUtensorMap te,
                                const __grid_constant__ CUtensorMap txh,
                                const __grid_constant__ CUtensorMap txl, float* __restrict__ p,
                                V* __restrict__ v, float a, float m, int B, int In, int Out) {
  T::pingpong_gemm(&te, &txh, &txl, Out, In, B,
                   [&](int out0, int in0, const float (&acc0)[64], const float (&acc1)[64]) {
                     update_tile_f32(p, v, a, m, In, Out, out0, in0, acc0, acc1);
                   });
}

template <class V>
int launch_f32_wgmma(const CUtensorMap& te, const CUtensorMap& txh, const CUtensorMap& txl,
                     float* p, V* v, float a, float m, int B, int In, int Out, int blocks,
                     cudaStream_t stream) {
  const int smem_err = allow_smem(wgrad_momentum_f32_wgmma_kernel<V>, T::S::SMEM_BYTES);
  if (smem_err != 0) return smem_err;
  wgrad_momentum_f32_wgmma_kernel<V><<<blocks, W::THREADS, T::S::SMEM_BYTES, stream>>>(
      te, txh, txl, p, v, a, m, B, In, Out);
  return static_cast<int>(cudaGetLastError());
}

// g = x^T e, f32, on the CP_WGMMA route (cp_tf32_wgmma.cuh): g^T = e^T x a
// T::BN x T::BM tile a block (e the register operand, x transposed and
// split in the block); with gridDim.z > 1, split blockIdx.z of the bunch
// (k_chunk rows), the last split to arrive summing the partials (part,
// counters: cp_wgmma.cuh reduce_acc); then v, p updated in place
template <class T, class V>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
wgrad_momentum_f32_cp_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ e,
                                   float* __restrict__ p, V* __restrict__ v,
                                   float* __restrict__ part, int* __restrict__ counters, float a,
                                   float m, int B, int In, int Out, int k_chunk, int x_bytes,
                                   int e_bytes) {
  extern __shared__ uint8_t cpf_smem[];
  uint8_t* ring = nnet_cpf::ring_of(cpf_smem);
  const int in0 = blockIdx.y * T::BM, out0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  const nnet_cpf::Operands o{e, Out, Out, x, nullptr, In, In, e_bytes, x_bytes};
  float acc[T::NACC];
  nnet_cpf::mainloop<T>(ring, o, out0, in0, k_begin, min(B, k_begin + k_chunk), acc);
  if (!nnet_cpw::reduce_acc<T>(acc, part, counters)) return;
  nnet_cpf::update_pv<T, V>(acc, p, v, a, m, In, Out, in0, out0);
}

// g = x^T e, f32, on the WS_WGMMA route (cp_tf32_wgmma.cuh's
// warp-specialised ring): g = x^T e with In on wgmma's M and Out (at most
// T::NB) on its N, a tile of T::BN rows of p and v by T::NB columns a
// block, x the register operand (split by the consumers), e brought raw
// (its whole rows as one run a stage) and transposed and split by the
// producer; with gridDim.z > 1, split blockIdx.z of the bunch, the
// splits of a tile one cluster that sums their partials and updates v, p
// in place between its blocks
template <class T, class V>
__global__ void __launch_bounds__(T::THREADS, 1)
wgrad_momentum_f32_ws_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ e,
                                   float* __restrict__ p, V* __restrict__ v, float a, float m,
                                   int B, int In, int Out, int k_chunk, int x_bytes,
                                   int e_bytes) {
  extern __shared__ uint8_t cpf_smem[];
  uint8_t* ring = nnet_cpf::ring_of(cpf_smem);
  const int in0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(B, k_begin + k_chunk);
  nnet_cpf::ws_init<T>(ring);
  if (threadIdx.x >= T::CONSUMERS) {
    const nnet_cpf::Operands o{x, In, In, e, nullptr, Out, Out, x_bytes, e_bytes};
    nnet_cpf::ws_produce<T>(ring, o, in0, k_begin, k_end);
    nnet_cpf::ws_sync(gridDim.z);   // the partials stashed
    nnet_cpf::ws_sync(gridDim.z);   // and read
  } else {
    float acc[T::NACC];
    nnet_cpf::ws_consume<T>(ring, (k_end - k_begin + nnet_cpf::BK - 1) / nnet_cpf::BK, acc);
    nnet_cpf::ws_stash<T>(ring, acc);
    nnet_cpf::ws_sync(gridDim.z);
    nnet_cpf::ws_update_pv<T, V>(ring, p, v, a, m, In, Out, in0);
    nnet_cpf::ws_sync(gridDim.z);
  }
}

template <class V>
int launch_f32_ws_wgmma(const float* x, const float* e, float* p, V* v, float a, float m, int B,
                        int In, int Out, int splits, int k_chunk, int x_bytes, int e_bytes,
                        cudaStream_t stream) {
  using T = nnet_cpf::WsF32Rows;
  if (Out > T::NB) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(wgrad_momentum_f32_ws_wgmma_kernel<T, V>, T::SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((In + T::BN - 1) / T::BN, 1, splits);
  return nnet_cpf::launch_ws(wgrad_momentum_f32_ws_wgmma_kernel<T, V>, grid, T::THREADS,
                             T::SMEM_BYTES, stream, x, e, p, v, a, m, B, In, Out, k_chunk,
                             x_bytes, e_bytes);
}

template <class V>
int launch_f32_cp_wgmma(const float* x, const float* e, float* p, V* v, float* part,
                        int* counters, float a, float m, int B, int In, int Out, int splits,
                        int k_chunk, int x_bytes, int e_bytes, cudaStream_t stream) {
  using T = nnet_cpf::CpF32Planned<nnet_cpf::WGRAD>;
  const int err = allow_smem(wgrad_momentum_f32_cp_wgmma_kernel<T, V>, T::SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((Out + T::BN - 1) / T::BN, (In + T::BM - 1) / T::BM, splits);
  wgrad_momentum_f32_cp_wgmma_kernel<T, V><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      x, e, p, v, part, counters, a, m, B, In, Out, k_chunk, x_bytes, e_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 CP_WGMMA route's update of chunks lo + threadIdx.x, ... < hi
// of 4 elements of the tile at rows m0.., columns n0.. of p and v (In,
// Out): g the sum of the f32 stashes of the cluster's `nsum` blocks
// (nnet_cpw::cluster_sum4, in rank order), rounded once to bf16
// (grad_at<bf16>), then the mma.sync epilogue's arithmetic. A column
// tile's chunk k is row k / (BN / 4), columns 4 (k % (BN / 4)) .. + 3;
// the ROWS tile spans every column, so
// its rows of p and v are one run and chunk k is its elements 4k .. 4k + 3,
// as in the flat stash. Whole chunks of aligned rows move 16 bytes of p
// (and of f32 v, 8 of bf16 v) an access, the rest one element; R chunks'
// p and v are loaded before the first store.
template <class T, class V>
__device__ __forceinline__ void cp_update(const float* st, int nsum, float* __restrict__ p,
                                          V* __restrict__ v, float a, float m, int In, int Out,
                                          int m0, int n0, int lo, int hi) {
  constexpr int CPR = T::BN / 4, R = 4;
  const int rows = min(T::BM, In - m0), cols = min(T::BN, Out - n0);
  const bool vec = (T::ROWS || Out % 4 == 0) && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % (4 * sizeof(V)) == 0;
  for (int k0 = lo + threadIdx.x; k0 < hi; k0 += R * T::THREADS) {
    int so[R], n[R];
    size_t go[R];
    float4 pv[R], vv[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int k = k0 + u * T::THREADS;
      n[u] = 0;
      so[u] = 0;
      go[u] = 0;
      if (k < hi) {
        if constexpr (T::ROWS) {
          so[u] = 4 * k;
          go[u] = (size_t)m0 * Out + 4 * k;
          n[u] = min(4, rows * Out - 4 * k);
        } else {
          const int r = k / CPR, c = 4 * (k % CPR);
          if (r < rows && c < cols) {
            so[u] = r * T::SP + c;
            go[u] = (size_t)(m0 + r) * Out + n0 + c;
            n[u] = min(4, cols - c);
          }
        }
      }
      pv[u] = vv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n[u] == 4 && vec) {
        pv[u] = load4(p + go[u]);
        vv[u] = load4(v + go[u]);
      } else {
        float* pf = &pv[u].x;
        float* vf = &vv[u].x;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n[u]) {
            pf[j] = p[go[u] + j];
            vf[j] = to_f32(v[go[u] + j]);
          }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (n[u] == 0) continue;
      const float4 g = nnet_cpw::cluster_sum4<nnet_cpw::MAX_CLUSTER>(st, so[u], nsum);
      momentum(grad_at<bf16>(g.x), pv[u].x, vv[u].x, a, m);
      momentum(grad_at<bf16>(g.y), pv[u].y, vv[u].y, a, m);
      momentum(grad_at<bf16>(g.z), pv[u].z, vv[u].z, a, m);
      momentum(grad_at<bf16>(g.w), pv[u].w, vv[u].w, a, m);
      if (n[u] == 4 && vec) {
        store4(v + go[u], vv[u]);
        store4(p + go[u], pv[u]);
      } else {
        const float* pf = &pv[u].x;
        const float* vf = &vv[u].x;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n[u]) {
            store_rn(v + go[u] + j, vf[j]);
            p[go[u] + j] = pf[j];
          }
      }
    }
  }
}

// g = x^T e, bf16, on the CP_WGMMA route (cp_wgmma.cuh wgrad_mainloop): a
// T::BM x T::BN tile of p and v a block, In on wgmma's M and Out on its N;
// with gridDim.z > 1, split blockIdx.z of the bunch (k_chunk rows), the
// tile's splits one cluster, each block updating a share of the tile from
// every split's stash; then v, p updated in place
template <class T, class V>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
wgrad_momentum_bf16_cp_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e,
                                    float* __restrict__ p, V* __restrict__ v, float a, float m,
                                    int B, int In, int Out, int k_chunk, int x_bytes,
                                    int e_bytes) {
  extern __shared__ uint8_t cpw_smem[];
  uint8_t* ring = nnet_cpf::ring_of(cpw_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * k_chunk;
  float acc[T::NACC];
  nnet_cpw::wgrad_mainloop<T>(ring, x, e, In, Out, m0, n0, k_begin, min(B, k_begin + k_chunk),
                              x_bytes, e_bytes, acc);
  float* st = reinterpret_cast<float*>(ring);
  const int chunks = T::ROWS ? (min(T::BM, In - m0) * Out + 3) / 4 : T::BM * (T::BN / 4);
  const int splits = gridDim.z, per = (chunks + splits - 1) / splits;
  const auto meet = [splits] {   // the cluster's barrier, or the block's for one split
    if (splits > 1)
      nnet_cpw::cluster_barrier();
    else
      __syncthreads();
  };
  nnet_cpw::stash_acc<T>(st, acc, Out);
  meet();   // every split's partial stashed
  const int lo = min(chunks, (int)blockIdx.z * per);
  cp_update<T, V>(st, splits, p, v, a, m, In, Out, m0, n0, lo, min(chunks, lo + per));
  meet();   // and read before any block exits
}

template <class T, class V>
int launch_bf16_cp_wgmma(const bf16* x, const bf16* e, float* p, V* v, float a, float m, int B,
                         int In, int Out, int splits, int k_chunk, int x_bytes, int e_bytes,
                         cudaStream_t stream) {
  if (T::ROWS && (Out > T::BN || reinterpret_cast<uintptr_t>(e) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > nnet_cpw::MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(wgrad_momentum_bf16_cp_wgmma_kernel<T, V>, T::SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((Out + T::BN - 1) / T::BN, (In + T::BM - 1) / T::BM, splits);
  return nnet_cpf::launch_ws(wgrad_momentum_bf16_cp_wgmma_kernel<T, V>, grid, T::THREADS,
                             T::SMEM_BYTES, stream, x, e, p, v, a, m, B, In, Out, k_chunk,
                             x_bytes, e_bytes);
}

// The tiles the bf16 CP_WGMMA weight gradient is built with
// (tile_plan.CP_WGRAD_TILE and CP_WGRAD_STAGES; tools/gemm_ceiling.py
// --small --bf16-wgrad's cpw_* builds swap these lines): column tiles of
// 64 x 64 for Out > 136 on a 3-stage ring, the ROWS tile for Out <= 136 on
// a 4-stage ring, both with split-K as a cluster (the measurements that
// chose them over 64 x 128 tiles and tickets: tile_plan.cp_wgrad_splits)
using CpWgradCols = nnet_cpw::CpWgradTile<64, 3>;
using CpWgradRows = nnet_cpw::CpWgradTile<136, 4>;

template <class V>
int dispatch_bf16_cp_wgmma(const bf16* x, const bf16* e, float* p, V* v, float a, float m,
                           int B, int In, int Out, int rows, int splits, int k_chunk, int x_bytes,
                           int e_bytes, cudaStream_t s) {
  return rows ? launch_bf16_cp_wgmma<CpWgradRows>(x, e, p, v, a, m, B, In, Out, splits, k_chunk,
                                                  x_bytes, e_bytes, s)
              : launch_bf16_cp_wgmma<CpWgradCols>(x, e, p, v, a, m, B, In, Out, splits, k_chunk,
                                                  x_bytes, e_bytes, s);
}

}  // namespace

// v is float* (v_is_bf16 = 0) or __nv_bfloat16* (v_is_bf16 = 1). tile:
// 0 = 128x128, 1 = 64x64. splits > 1 (64x64 only): the bunch is cut into
// chunks of k_chunk rows (a multiple of the tile's BK), part is an f32
// scratch of (tiles * splits * 64 * 64) elements and counters holds an int
// per tile, zero, which the launch leaves at zero; else both are unused.
// x_bytes, e_bytes: the copy width of that operand, 16, 8 or 4. Returns
// the CUDA error code of the launch.
extern "C" int wgrad_momentum_update_f32(const float* x, const float* e, float* p, void* v,
                                         float* part, int* counters, float a, float m, int B,
                                         int In, int Out, int v_is_bf16, int tile, int splits,
                                         int k_chunk, int x_bytes, int e_bytes, void* stream) {
  return dispatch(x, e, p, v, part, counters, a, m, B, In, Out, v_is_bf16, tile, splits,
                  k_chunk, x_bytes, e_bytes, stream);
}

// The same with bf16 x and e: g = x^T e accumulated in f32 and rounded to
// bf16 after the whole (split-K) sum, then the f32 update. x_bytes,
// e_bytes: 16, 8, 4 or 2.
extern "C" int wgrad_momentum_update_bf16(const void* x, const void* e, float* p, void* v,
                                          float* part, int* counters, float a, float m, int B,
                                          int In, int Out, int v_is_bf16, int tile, int splits,
                                          int k_chunk, int x_bytes, int e_bytes, void* stream) {
  return dispatch(static_cast<const bf16*>(x), static_cast<const bf16*>(e), p, v, part,
                  counters, a, m, B, In, Out, v_is_bf16, tile, splits, k_chunk, x_bytes,
                  e_bytes, stream);
}

// The CP_WGMMA route of wgrad_momentum_update_f32: any row pitches, tiles
// of 64 rows by 128 columns of p and v. splits > 1: the bunch cut into
// chunks of k_chunk rows (a multiple of 32), part an f32 scratch of tiles *
// splits * 64 * 128 elements and counters an int a tile, zero, which the
// launch leaves at
// zero; else both unused. x_bytes, e_bytes: the copy width of that operand,
// 16, 8 or 4. Returns the CUDA error code of the launch.
extern "C" int wgrad_momentum_update_f32_cp_wgmma(const float* x, const float* e, float* p,
                                                  void* v, float* part, int* counters, float a,
                                                  float m, int B, int In, int Out, int v_is_bf16,
                                                  int splits, int k_chunk, int x_bytes,
                                                  int e_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16 ? launch_f32_cp_wgmma(x, e, p, static_cast<bf16*>(v), part, counters, a, m, B,
                                         In, Out, splits, k_chunk, x_bytes, e_bytes, s)
                   : launch_f32_cp_wgmma(x, e, p, static_cast<float*>(v), part, counters, a, m,
                                         B, In, Out, splits, k_chunk, x_bytes, e_bytes, s);
}

// The WS_WGMMA route of wgrad_momentum_update_f32: Out at most 136 (else
// cudaErrorInvalidValue), any row pitches, tiles of 64 rows of p and v by
// 136 columns (nnet_cpf::WsF32Rows). splits (1 to 8, a cluster of them a
// tile): the bunch cut into chunks of k_chunk rows (a multiple of 32).
// x_bytes: the copy width of x, 16, 8 or 4; e_bytes: that of e's stage of
// whole rows, one run, by its base alone. Returns the CUDA error code of
// the launch.
extern "C" int wgrad_momentum_update_f32_ws_wgmma(const float* x, const float* e, float* p,
                                                  void* v, float a, float m, int B, int In,
                                                  int Out, int v_is_bf16, int splits,
                                                  int k_chunk, int x_bytes, int e_bytes,
                                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16 ? launch_f32_ws_wgmma(x, e, p, static_cast<bf16*>(v), a, m, B, In, Out, splits,
                                         k_chunk, x_bytes, e_bytes, s)
                   : launch_f32_ws_wgmma(x, e, p, static_cast<float*>(v), a, m, B, In, Out,
                                         splits, k_chunk, x_bytes, e_bytes, s);
}

// The CP_WGMMA route of wgrad_momentum_update_bf16: x with row pitch and
// base in whole 4-byte units; rows = 0: column tiles (CpWgradCols), e
// likewise, e_bytes its copy width (16, 8 or 4); rows = 1: the ROWS tile,
// Out at most 136 and e 16-byte aligned (else cudaErrorInvalidValue), its
// stages copied as runs. x_bytes: x's copy width, 16, 8 or 4. splits > 1:
// the bunch cut into chunks of k_chunk rows (a multiple of 64), a tile's
// splits one cluster, at most MAX_CLUSTER (6) of them (else
// cudaErrorInvalidValue). Returns the CUDA error code of the launch.
extern "C" int wgrad_momentum_update_bf16_cp_wgmma(const void* x, const void* e, float* p,
                                                   void* v, float a, float m, int B, int In,
                                                   int Out, int v_is_bf16, int rows, int splits,
                                                   int k_chunk, int x_bytes, int e_bytes,
                                                   void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* eb = static_cast<const bf16*>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16 ? dispatch_bf16_cp_wgmma(xb, eb, p, static_cast<bf16*>(v), a, m, B, In, Out,
                                            rows, splits, k_chunk, x_bytes, e_bytes, s)
                   : dispatch_bf16_cp_wgmma(xb, eb, p, static_cast<float*>(v), a, m, B, In, Out,
                                            rows, splits, k_chunk, x_bytes, e_bytes, s);
}

// The WGMMA route of wgrad_momentum_update_bf16: x, e with row pitches of
// 16-byte multiples, x, e, p and v 16-byte aligned (tile_plan.plan's
// route); blocks: the persistent grid, min(tiles, SMs); no split-K.
// Returns the CUDA error code of the tensor-map encodes and the launch.
extern "C" int wgrad_momentum_update_bf16_wgmma(const void* x, const void* e, float* p, void* v,
                                                float a, float m, int B, int In, int Out,
                                                int v_is_bf16, int blocks, void* stream) {
  CUtensorMap tx, te;
  int err = W::tensor_map(&tx, x, B, In, W::BOX, W::BK);
  if (err == 0) err = W::tensor_map(&te, e, B, Out, W::BOX, W::BK);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_is_bf16 ? launch_wgmma(tx, te, p, static_cast<bf16*>(v), a, m, B, In, Out, blocks, s)
                   : launch_wgmma(tx, te, p, static_cast<float*>(v), a, m, B, In, Out, blocks, s);
}

// The f32 WGMMA route of wgrad_momentum_update_f32: x, e with row pitches
// of 16-byte multiples, B a multiple of 4, x, e, p and v 16-byte aligned
// (tile_plan.plan's route); xhi, xlo: scratch of In * B floats each,
// 16-byte aligned, for x's transposed split copies (the pre-pass writes
// them, the GEMM reads them); blocks: the persistent grid, min(tiles,
// SMs). Returns the CUDA error code of the tensor-map encodes and the two
// launches.
extern "C" int wgrad_momentum_update_f32_wgmma(const float* x, const float* e, float* p, void* v,
                                               float* xhi, float* xlo, float a, float m, int B,
                                               int In, int Out, int v_is_bf16, int blocks,
                                               void* stream) {
  CUtensorMap te, txh, txl;
  int err = W::tensor_map(&te, e, B, Out, T::A_BOX, T::BK, 4);
  if (err == 0) err = W::tensor_map(&txh, xhi, In, B, T::BK, T::ROWS, 4);
  if (err == 0) err = W::tensor_map(&txl, xlo, In, B, T::BK, T::ROWS, 4);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_momentum_f32_split_kernel<<<dim3((In + 31) / 32, (B + 31) / 32), 256, 0, s>>>(x, xhi, xlo,
                                                                                      B, In);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return v_is_bf16
             ? launch_f32_wgmma(te, txh, txl, p, static_cast<bf16*>(v), a, m, B, In, Out, blocks, s)
             : launch_f32_wgmma(te, txh, txl, p, static_cast<float*>(v), a, m, B, In, Out, blocks,
                                s);
}
