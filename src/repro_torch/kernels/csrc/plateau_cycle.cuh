// The cycle loop shared by the two plateau kernels: K1 (plateau.cu, noise
// stepped in-kernel, packed spins) and K4 (plateau_pregen.cu, noise read
// from a pregenerated buffer, dense spins).
//
// One block owns TR trials of one problem.  Their spins live in shared
// memory as floats, double-buffered ([N][TR], so one vector load gives
// spin k of every trial); thread j owns column j (and j + blockDim.x, ...)
// of Itanh, of the noise and of the best spins.  Per cycle c: field =
// m @ J + h, with J streamed from L2 (thread j reads column j of row k:
// neighbouring threads, neighbouring addresses; each element serves the
// block's TR trials); at c >= 1, when `eligible`, fold H = -(h.m +
// m.field)/2 into the running best (strict <: the first minimum is kept);
// Itanh = clamp(field + n_rnd*r + Itanh, -I0, I0-1); m = sign(Itanh).
// After the loop one more field folds the final state.  The energy is
// reduced in int32, exact: the sum is even and far below 2^31 (the TPU
// kernels' float32 energy is exact too, every partial sum being below
// 2^24).
//
// The kernel supplies the two things that differ, as an `IO` object:
//   int io.noise(int t, int j, int c)  the +-1 noise of trial t, column j
//                                      at cycle c (called once per (t, j, c),
//                                      in cycle order, by the owning thread);
//   void io.store_best(int t, const float* m)  called by every thread of the
//                                      block when trial t improved, with the
//                                      improving spins.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace plateau {

constexpr int MAX_THREADS = 1024;
constexpr int DEFAULT_SMEM = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One shared-memory vector load of spin k of each of the block's trials.
template <int TR> __device__ __forceinline__ void load_spins(const float* p, float* v);
template <> __device__ __forceinline__ void load_spins<1>(const float* p, float* v) {
  v[0] = p[0];
}
template <> __device__ __forceinline__ void load_spins<2>(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
template <> __device__ __forceinline__ void load_spins<4>(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The C cycles and the epilogue fold of one block.  `m_cur`/`m_nxt` hold
// the block's spins ([N][TR], both filled), `it` the Itanh of its first
// trial (row stride N, updated in place), `bh_s` its running best energies
// (shared).  Trials t >= nt are idle: their spins are read but nothing of
// theirs is written.  Returns the buffer that holds the final spins.
template <typename JT, int TR, typename IO>
__device__ __forceinline__ float* run_cycles(IO& io, float* m_cur, float* m_nxt,
                                             const JT* __restrict__ J,
                                             const int* __restrict__ h, int* it, int* bh_s,
                                             int nt, int N, int i0, int n_cycles, int n_rnd,
                                             int eligible) {
  __shared__ int red[TR][32];
  __shared__ int better_s[TR];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = eligible && (c > 0 || last);
    if (last && !fold) break;
    int ep[TR];
#pragma unroll
    for (int t = 0; t < TR; ++t) ep[t] = 0;

    for (int j = tid; j < N; j += nthr) {
      float acc[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[t] = 0.f;
      const JT* Jc = J + j;
#pragma unroll 8
      for (int k = 0; k < N; ++k) {
        const float jv = to_f32(Jc[(size_t)k * N]);
        float mv[TR];
        load_spins<TR>(m_cur + k * TR, mv);
#pragma unroll
        for (int t = 0; t < TR; ++t) acc[t] = fmaf(mv[t], jv, acc[t]);
      }
      const int hj = h[j];
      float mj[TR];
      load_spins<TR>(m_cur + j * TR, mj);
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int f = __float2int_rz(acc[t]) + hj;
        const int s = mj[t] > 0.f ? 1 : -1;
        ep[t] += s * (hj + f);
        if (!last && t < nt) {
          const int r = io.noise(t, j, c);
          const size_t e = (size_t)t * N + j;
          const int I = min(max(f + n_rnd * r + it[e], -i0), i0 - 1);
          it[e] = I;
          m_nxt[j * TR + t] = I >= 0 ? 1.f : -1.f;
        }
      }
    }

    if (fold) {
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int v = warp_sum(ep[t]);
        if (lane == 0) red[t][warp] = v;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          const int v = warp_sum(lane < nwarps ? red[t][lane] : 0);
          if (lane == 0) {
            const int H = -v / 2;
            const int better = (t < nt) && (H < bh_s[t]);
            if (better) bh_s[t] = H;
            better_s[t] = better;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (better_s[t]) io.store_best(t, m_cur);
      }
    }
    if (!last) {
      float* tmp = m_cur;
      m_cur = m_nxt;
      m_nxt = tmp;
    }
    __syncthreads();
  }
  return m_cur;
}

}  // namespace plateau
