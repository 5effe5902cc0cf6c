// Fused softmax + cross-entropy + gradient, f32, in one launch.
//
// Replaces the TPU kernel nnet_asr_tpu/ops/pallas/softmax_ce.py (_kernel,
// called by _fwd_impl under the custom-VJP fused_softmax_xent). Per row:
//   err  = softmax(logits) - onehot(label)   (the stored CE gradient)
//   xent = -max(logp[label], -1e10)          (rows with a label in [0, C))
//   hit  = first-max column == label         (rows with label >= 0; the
//                                             lowest column wins a tie)
// A label outside [0, C) picks nothing. The row max propagates NaN, as
// jnp.max does: a row that holds a NaN has NaN err, NaN xent when it is
// labelled, and no column reaches its max, so the first-max column is C.
//
// What bounds it on an H100: memory bytes, one read of the logits and one
// write of err, a few operations per element. So each element is read from
// device memory once and written once, and the work per element is kept
// small enough to hide behind the memory traffic.
// ops/kernels/softmax_plan.py picks the variant, its block and its grid:
//  - NARROW (C <= 512): one warp per row, four rows a block; the row lives
//    in registers and every reduction is a warp shuffle.
//  - ROWS (C <= 8192): one block per row, up to 512 threads x 16 values in
//    registers (no spills under the 64-register cap that keeps 1024
//    threads an SM; 32 values a thread spilled there).
//  - WIDE (C > 8192): one block per row and two walks: the first keeps an
//    online max and sum of exp per thread, the second writes err (its
//    re-read mostly hits L2).
// NARROW and ROWS hold the whole row in registers: one reduction gives the
// NaN-propagating max, exp(x - max) is taken once per element and kept in
// place, a second reduction sums it (and finds the first-max column), and
// err = e * (1/s) is written from the registers (within an ulp of 1 of
// e / s; PERF.md holds the measured difference to the plain version). The
// grid is what the card holds at once: a block walks rows r, r + stride,
// ..., and copies the next row into shared memory while it works on this
// one. A block reduction ends with one more butterfly over the warps'
// values, lane w holding warp w's.
//  - 16-byte loads and stores where C is a multiple of 4 floats and the
//    base is 16-byte aligned, 4-byte ones otherwise (MLP3's 135 columns).
//  - One launch: each block writes its partial (xent, hits), summed over
//    its rows in a fixed order; the block that draws the last ticket (a
//    __threadfence, then atomicAdd on a counter the wrapper keeps per
//    stream) sums the partials in a fixed order, writes both scalars and
//    sets the counter back to 0. No float atomics, so runs repeat bit for
//    bit whichever block finishes last.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// must match ops/kernels/softmax_plan.py
constexpr int NARROW = 0, ROWS = 1, WIDE = 2;
constexpr int NARROW_ROWS = 4;     // rows (one warp each) a NARROW block works on at once
constexpr int ROWS_THREADS = 512;  // most threads of a ROWS block
constexpr int ROWS_VPT = 16;       // values a thread of a ROWS block
constexpr int WIDE_THREADS = 512;
constexpr int WIDE_UNROLL = 4;     // chunks a thread loads per step of a walk
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* logits;
  const int* labels;
  float* err;
  float* part;    // 2 x gridDim.x: partial xent (f32), then partial hits (i32)
  int* ticket;    // 0 between launches
  float* xent;
  int* corr;
  int B, C;
};

// The larger of a and b, NaN if either is NaN (as jnp.max; fmaxf drops NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Butterfly sum: a + b == b + a, so every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

__device__ __forceinline__ int warp_min(int c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c = min(c, __shfl_xor_sync(FULL, c, o));
  return c;
}

// Reductions over a row's warp (ONE_WARP) or block; every thread of the row
// gets the result. Over a block: each warp's butterfly, then one more over
// the warps' values, lane w holding warp w's.
template <bool ONE_WARP>
__device__ __forceinline__ float row_max(float m, float* sh) {
  m = warp_max_nan(m);
  const int nw = blockDim.x / 32, lane = threadIdx.x % 32;
  if (ONE_WARP || nw == 1) return m;
  if (lane == 0) sh[threadIdx.x / 32] = m;
  __syncthreads();
  return warp_max_nan(lane < nw ? sh[lane] : -INFINITY);
}

// (sum of s, least c) in one round
template <bool ONE_WARP>
__device__ __forceinline__ void row_sum_min(float& s, int& c, float* sh, int* sc) {
  s = warp_sum(s);
  c = warp_min(c);
  const int nw = blockDim.x / 32, lane = threadIdx.x % 32;
  if (ONE_WARP || nw == 1) return;
  if (lane == 0) {
    sh[threadIdx.x / 32] = s;
    sc[threadIdx.x / 32] = c;
  }
  __syncthreads();
  s = warp_sum(lane < nw ? sh[lane] : 0.0f);
  c = warp_min(lane < nw ? sc[lane] : INT_MAX);
}

// A row's xent term: -max(logp, -1e10) with NaN kept (fmaxf would drop it).
__device__ __forceinline__ float xent_term(float xl, float m, float s) {
  const float lp = xl - m - logf(s);
  return -(lp < -1e10f ? -1e10f : lp);
}

// The block's rows' stats (row_x, row_h: one slot per row group, each
// summed over its rows in row order) -> the block's partial, the slots
// summed in order; the last block to finish sums all partials. Every
// thread of the block calls it.
__device__ void finish(const Args& a, const float* row_x, const int* row_h, int groups) {
  __shared__ float sx[MAX_WARPS];
  __shared__ int sc[MAX_WARPS];
  __shared__ bool last;
  const int nb = gridDim.x, nw = blockDim.x / 32, lane = threadIdx.x % 32;
  float* part_x = a.part;
  int* part_c = reinterpret_cast<int*>(a.part + nb);
  __syncthreads();  // row_x, row_h written
  if (threadIdx.x == 0) {
    float bx = 0.0f;
    int bc = 0;
    for (int g = 0; g < groups; ++g) {
      bx += row_x[g];
      bc += row_h[g];
    }
    part_x[blockIdx.x] = bx;
    part_c[blockIdx.x] = bc;
    __threadfence();
    last = atomicAdd(a.ticket, 1) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread t sums partials t, t + T, ... in order; then each warp's
  // butterfly; then one over the warps' sums
  float x = 0.0f;
  int n = 0;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    x += __ldcg(part_x + i);
    n += __ldcg(part_c + i);
  }
  x = warp_sum(x);
  n = warp_sum(n);
  if (lane == 0) {
    sx[threadIdx.x / 32] = x;
    sc[threadIdx.x / 32] = n;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    x = warp_sum(lane < nw ? sx[lane] : 0.0f);
    n = warp_sum(lane < nw ? sc[lane] : 0);
    if (lane == 0) {
      *a.xent = x;
      *a.corr = n;
      *a.ticket = 0;
    }
  }
}

// 16- or 4-byte asynchronous copy from global to shared memory.
template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// NARROW (ONE_WARP: a row per warp) and ROWS (a row per block). Thread t of
// a row of nt threads takes chunks t + k*nt (k < kmax <= VPT/VEC) of VEC
// columns: value i of the thread is chunk slot k = i / VEC, column
// (t + k*nt)*VEC + i % VEC; slots past the row read -inf, so that no loop
// over the values needs a mask. While a row is worked on in registers,
// the next row of the group is copied into the thread's own slots of
// shared memory (cp.async: no registers held, no barrier, since a thread
// reads back only what it copied). Per value: one max, one exp, one add,
// one multiply. Only a thread that holds the row max looks for its first
// column (the least over threads rides on the sum's reduction); the thread
// that holds x[label] reads it back from its slot and writes the one-hot
// entry of err over its own store.
template <int VPT, int VEC, bool ONE_WARP>
__global__ void __launch_bounds__(ROWS_THREADS, 2) softmax_xent_rows(const Args a) {
  static_assert(VPT % VEC == 0, "whole chunks");
  constexpr int SLOTS = VPT / VEC;
  __shared__ __align__(16) float buf[(ONE_WARP ? 32 * NARROW_ROWS : ROWS_THREADS) * VPT];
  __shared__ float sm[MAX_WARPS], ss[MAX_WARPS];
  __shared__ int sc[MAX_WARPS];
  __shared__ float row_x[NARROW_ROWS];
  __shared__ int row_h[NARROW_ROWS];
  __shared__ float s_xl;
  const int C = a.C;
  const int t = ONE_WARP ? threadIdx.x % 32 : threadIdx.x;
  const int nt = ONE_WARP ? 32 : blockDim.x;
  const int group = ONE_WARP ? threadIdx.x / 32 : 0;
  const int groups = ONE_WARP ? NARROW_ROWS : 1;
  const int stride = gridDim.x * groups;
  const int nch = C / VEC;                                   // chunks of a row
  const int kmax = t < nch ? (nch - 1 - t) / nt + 1 : 0;     // this thread's
  float* mine = buf + group * nt * VPT;  // slot k of thread t: chunk k*nt + t

  auto fetch = [&](int r) {
    const float* x = a.logits + static_cast<size_t>(r) * C;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
      if (k < kmax) cp_async<VEC>(mine + (k * nt + t) * VEC, x + (t + k * nt) * VEC);
    cp_async_commit();
  };

  float gx = 0.0f;  // the group's rows' stats, in row order (thread t == 0)
  int gh = 0;
  int r = blockIdx.x * groups + group;
  int label = 0;
  if (r < a.B) {
    fetch(r);
    label = a.labels[r];
  }
  for (; r < a.B; r += stride) {  // the same rows for the whole group
    float v[VPT];
    cp_async_wait_all();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if constexpr (VEC == 4) {
        float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (k < kmax) q = reinterpret_cast<const float4*>(mine)[k * nt + t];
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      } else {
        v[k] = k < kmax ? mine[k * nt + t] : -INFINITY;
      }
    }
    const bool picks = label >= 0 && label < C;
    int li = -1;  // the index of the label's value, if this thread holds it
    float xl = 0.0f;
    if (picks) {
      const int d = label / VEC - t;
      if (d >= 0 && d % nt == 0) {
        li = d / nt * VEC + label % VEC;
        xl = mine[(d / nt * nt + t) * VEC + label % VEC];
      }
    }
    const int rn = r + stride;
    int nlabel = 0;
    if (rn < a.B) {  // the slots are read: refill them with the next row
      fetch(rn);
      nlabel = a.labels[rn];
    }

    float tm = -INFINITY;
#pragma unroll
    for (int i = 0; i < VPT; ++i) tm = max_nan(tm, v[i]);
    const float m = row_max<ONE_WARP>(tm, sm);
    int first = C;  // NaN max: no column reaches it
    if (tm == m && kmax > 0) {
      int fi = 0;
#pragma unroll
      for (int i = VPT - 1; i >= 0; --i)
        if (v[i] == m) fi = i;
      first = (t + fi / VEC * nt) * VEC + fi % VEC;
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      v[i] = expf(v[i] - m);
      s += v[i];
    }
    if (!ONE_WARP && li >= 0) s_xl = xl;  // thread 0 reads it after the barrier
    row_sum_min<ONE_WARP>(s, first, ss, sc);
    const float inv = 1.0f / s;
    float* e = a.err + static_cast<size_t>(r) * C;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (k >= kmax) continue;
      if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(e)[t + k * nt] =
            make_float4(v[4 * k] * inv, v[4 * k + 1] * inv, v[4 * k + 2] * inv,
                        v[4 * k + 3] * inv);
      } else {
        e[t + k * nt] = v[k] * inv;
      }
    }
    if (li >= 0) e[label] = expf(xl - m) * inv - 1.0f;  // over this thread's own store
    if constexpr (ONE_WARP)
      xl = __shfl_sync(FULL, xl, picks ? label / VEC % 32 : 0);
    else if (t == 0 && picks)
      xl = s_xl;
    if (t == 0) {
      gx += picks ? xent_term(xl, m, s) : 0.0f;
      gh += (label >= 0 && first == label) ? 1 : 0;
    }
    label = nlabel;
  }
  if (t == 0) {
    row_x[group] = gx;
    row_h[group] = gh;
  }
  finish(a, row_x, row_h, groups);
}

// WIDE: a row per block, walked twice in steps of WIDE_UNROLL chunks a
// thread (thread t takes chunks t + k*T, k rising, as in the ROWS kernel).
// Walk 1 keeps, per thread, the NaN-propagating max and s = sum of
// exp(x - max), rescaled when the max rises; the thread that meets
// x[label] hands it over. Walk 2 writes err, and a thread that holds the
// row max looks for its first column there. The next row's label is
// loaded a row ahead.
template <int VEC>
__global__ void __launch_bounds__(WIDE_THREADS, 2) softmax_xent_wide(const Args a) {
  constexpr int U = WIDE_UNROLL;
  __shared__ float sm[MAX_WARPS], ss[MAX_WARPS], ss2[MAX_WARPS];
  __shared__ int sc[MAX_WARPS], sc2[MAX_WARPS];
  __shared__ float row_x[1];
  __shared__ int row_h[1];
  __shared__ float s_xl[2];  // by row parity: the next row's is written before a barrier
  const int C = a.C;
  const int t = threadIdx.x, nt = blockDim.x;
  const int nch = C / VEC;  // chunks of a row (VEC == 4: C % 4 == 0)
  float gx = 0.0f;
  int gh = 0;
  int label = blockIdx.x < a.B ? a.labels[blockIdx.x] : 0;
  for (int r = blockIdx.x, it = 0; r < a.B; r += gridDim.x, it ^= 1) {
    const float* x = a.logits + static_cast<size_t>(r) * C;
    const int nlabel = r + gridDim.x < a.B ? a.labels[r + gridDim.x] : 0;
    const bool picks = label >= 0 && label < C;
    const int lch = picks ? label / VEC : -1;  // the label's chunk

    // chunk u of a step: base + u*nt + t; slots past the row are skipped
    auto load = [&](int base, float (&v)[U * VEC]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = base + u * nt + t;
        if constexpr (VEC == 4) {
          float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (ch < nch) q = reinterpret_cast<const float4*>(x)[ch];
          v[4 * u] = q.x;
          v[4 * u + 1] = q.y;
          v[4 * u + 2] = q.z;
          v[4 * u + 3] = q.w;
        } else {
          v[u] = ch < nch ? x[ch] : 0.0f;
        }
      }
    };

    float m = -INFINITY, s = 0.0f;
    for (int base = 0; base < nch; base += U * nt) {
      float v[U * VEC];
      load(base, v);
      const float old = m;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u * nt + t == lch) s_xl[it] = x[label];  // read after the sum's barrier
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (base + u * nt + t < nch) m = max_nan(m, v[u * VEC + j]);
      }
      if (m != -INFINITY) {  // else nothing but -inf so far: exp adds 0
        if (m != old) s *= expf(old - m);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (base + u * nt + t < nch) s += expf(v[u * VEC + j] - m);
      }
    }
    const float mt = m;  // this thread's max, which s is taken against
    m = row_max<false>(mt, sm);
    s = mt == m ? s : s * expf(mt - m);
    int first = C;  // NaN max: no column reaches it
    row_sum_min<false>(s, first, ss, sc);
    const float inv = 1.0f / s;
    const float xl = (t == 0 && picks) ? s_xl[it] : 0.0f;

    float* e = a.err + static_cast<size_t>(r) * C;
    for (int base = 0; base < nch; base += U * nt) {
      float v[U * VEC];
      load(base, v);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ch = base + u * nt + t;
        if (ch >= nch) continue;
        if (mt == m) {  // this thread holds the row max: its first column
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (v[u * VEC + j] == m) first = min(first, ch * VEC + j);
        }
        if constexpr (VEC == 4) {
          const int c0 = 4 * ch;
          float4 q;
          q.x = expf(v[4 * u] - m) * inv - (c0 == label ? 1.0f : 0.0f);
          q.y = expf(v[4 * u + 1] - m) * inv - (c0 + 1 == label ? 1.0f : 0.0f);
          q.z = expf(v[4 * u + 2] - m) * inv - (c0 + 2 == label ? 1.0f : 0.0f);
          q.w = expf(v[4 * u + 3] - m) * inv - (c0 + 3 == label ? 1.0f : 0.0f);
          reinterpret_cast<float4*>(e)[ch] = q;
        } else {
          e[ch] = expf(v[u] - m) * inv - (ch == label ? 1.0f : 0.0f);
        }
      }
    }
    float none = 0.0f;
    row_sum_min<false>(none, first, ss2, sc2);  // the least first column
    if (t == 0) {
      gx += picks ? xent_term(xl, m, s) : 0.0f;
      gh += (label >= 0 && first == label) ? 1 : 0;
    }
    label = nlabel;
  }
  if (t == 0) {
    row_x[0] = gx;
    row_h[0] = gh;
  }
  finish(a, row_x, row_h, 1);
}

// false: the plan asks for a shape that has no instance
template <int VPT, bool ONE_WARP>
bool launch_rows(const Args& a, bool vec, int blocks, int threads, cudaStream_t st) {
  if (vec) {
    if constexpr (VPT % 4 == 0) {
      softmax_xent_rows<VPT, 4, ONE_WARP><<<blocks, threads, 0, st>>>(a);
      return true;
    }
    return false;
  }
  softmax_xent_rows<VPT, 1, ONE_WARP><<<blocks, threads, 0, st>>>(a);
  return true;
}

}  // namespace

// One launch of the plan's variant on ``blocks`` blocks (part holds 2 x
// blocks values); returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a plan outside the instances.
extern "C" int softmax_xent_f32(const float* logits, const int* labels, float* err,
                                float* part, int* ticket, float* xent, int* corr, int B,
                                int C, int variant, int blocks, int threads, int vpt, int vec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{logits, labels, err, part, ticket, xent, corr, B, C};
  bool ok = B > 0 && C > 0 && blocks > 0 && (!vec || C % 4 == 0);
  if (ok && variant == NARROW) {
    ok = threads == 32 * NARROW_ROWS && 32 * vpt >= C;
    if (ok) switch (vpt) {
        case 1: ok = launch_rows<1, true>(a, vec, blocks, threads, st); break;
        case 2: ok = launch_rows<2, true>(a, vec, blocks, threads, st); break;
        case 4: ok = launch_rows<4, true>(a, vec, blocks, threads, st); break;
        case 8: ok = launch_rows<8, true>(a, vec, blocks, threads, st); break;
        case 16: ok = launch_rows<16, true>(a, vec, blocks, threads, st); break;
        default: ok = false;
      }
  } else if (ok && variant == ROWS) {
    ok = threads % 32 == 0 && threads >= 64 && threads <= ROWS_THREADS && vpt == ROWS_VPT &&
         threads * vpt >= C && launch_rows<ROWS_VPT, false>(a, vec, blocks, threads, st);
  } else if (ok && variant == WIDE) {
    ok = threads == WIDE_THREADS && vpt == WIDE_UNROLL * (vec ? 4 : 1);
    if (ok) {
      if (vec)
        softmax_xent_wide<4><<<blocks, threads, 0, st>>>(a);
      else
        softmax_xent_wide<1><<<blocks, threads, 0, st>>>(a);
    }
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a code returned by the entry points.
extern "C" const char* nnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
