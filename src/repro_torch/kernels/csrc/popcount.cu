// K2 — a whole HA-SSA plateau chain (C cycles with a per-cycle I0 and fold
// write-enable) in one launch, with the XNOR-popcount field, for B
// problems x R trials.  Integer arithmetic only: no float anywhere.
//
// Replaces: src/repro/kernels/ssa_update.py:_plateau_popcount_kernel
// (wrappers ssa_plateau_popcount_batched / ssa_plateau_popcount), in both
// its modes: the classical kernel first, the SSQA ring mode (jperp_sched,
// n_replicas > 0) after it, at popcount_ring_kernel.  Per cycle c:
//   field = h + base + sum_b 2^(b+1) * popcount(XNOR(m, sign) & mags[b]);
//   if fold_sched[c] > 0, fold H = -(h.m + m.field)/2 of the state current
//   at c into the running best (strict <: the first minimum is kept; the
//   best words are that state's words);
//   step the xorshift128 lanes (t = x ^ (x << 11);
//   w' = (w ^ (w >> 19)) ^ (t ^ (t >> 8))) and take the MSB of w' as +-1
//   noise; Itanh = clamp(field + n_rnd*r + Itanh, -i0_sched[c],
//   i0_sched[c]-1); m = sign(Itanh).
// After the loop, fold_sched[C] folds the final state with one more field,
// so a launch evaluates C+1 fields.  Spins enter and leave as 32-bit words,
// bit k of word w = spin 32w+k; output words have 0 in every bit >= N (the
// JAX kernel's are 0 there too for n_rnd >= 1).
//
// What bounds it on the H100: R*N*Nw*nb*(C+1) popcounts (7.57e9 at K2000:
// R = 100, N = 2000, Nw = 63, nb = 1, C = 600), at 16 popc per SM per clock
// on 132 SMs at 1.98 GHz: 1.81 ms.  The bytes are small: the planes are
// (1+nb)*N*Nw*4 B = 1.0 MB at K2000, the state a few MB.  Operations bound
// it.
//
// Design: every cycle needs all N fields of a trial before the next, so a
// block owns whole trials — one block per (problem, TR = 2 trials) — and
// no grid-wide sync
// is needed.  The block's spin words live in shared memory, double-
// buffered and laid out [Nw][TR] (one 8-byte load gives word w of both
// trials), with its best words [TR][Nw] beside them.  The planes (1 MB at
// K2000) do not fit in shared memory; they stream from L2 every cycle and
// each word read serves the block's TR trials.  They arrive transposed,
// [Nw][N] per plane (the layout repro_torch.kernels.ssa_update.
// popcount_planes makes once per set of couplings), so thread j owns field
// row j and a warp's 32 loads of word w fall on 128 consecutive bytes.  Itanh and the four
// lane words of (trial, column j) stay in global memory, in the output
// tensors, touched once per cycle by the thread of column j.  New spin
// words are warp ballots over 32 consecutive columns, so tail bits are 0.
#include <cuda_runtime.h>

#include "ring.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int DEFAULT_SMEM = 48 * 1024;
// Trials per block.  ssa_update.py's shared-memory check assumes the same.
constexpr int TR = 2;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NB is the number of magnitude planes when it is known at compile time
// (1: every +-1-weight instance), 0 when it is taken from nb_rt.
template <int NB>
__global__ void __launch_bounds__(MAX_THREADS)
popcount_chain_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
                      const uint32_t* __restrict__ signT, const uint32_t* __restrict__ magsT,
                      const int* __restrict__ base, const int* __restrict__ h,
                      const uint32_t* __restrict__ rng_in, const int* __restrict__ i0_sched,
                      const int* __restrict__ fold_sched, const int* __restrict__ bh_in,
                      const uint32_t* __restrict__ bmp_in, uint32_t* __restrict__ mp_out,
                      int* __restrict__ it_out, uint32_t* __restrict__ rng_out,
                      int* __restrict__ bh_out, uint32_t* __restrict__ bmp_out, int R, int N,
                      int nb_rt, int n_cycles, int n_rnd) {
  const int nb = NB ? NB : nb_rt;
  const int Nw = (N + 31) >> 5;
  extern __shared__ __align__(16) uint32_t smem_words[];
  uint32_t* w_cur = smem_words;                // [Nw][TR]
  uint32_t* w_nxt = w_cur + (size_t)Nw * TR;   // [Nw][TR]
  uint32_t* best_w = w_nxt + (size_t)Nw * TR;  // [TR][Nw]
  __shared__ int bh_s[TR];
  __shared__ int red[TR][32];
  __shared__ int better_s[TR];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TR;
  const int nt = min(TR, R - t0);  // trials of this block; the rest are idle
  const size_t RN = (size_t)R * N;
  const size_t row0 = (size_t)b * R + t0;                     // first (b, trial) row
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;   // lane word 0 of row0

  // Prologue: the block's words to shared memory (idle trials get 0);
  // Itanh and the lanes copied to the outputs, where the cycles update them.
  for (int e = tid; e < Nw * TR; e += nthr) {
    const int w = e / TR, t = e % TR;
    w_cur[e] = (t < nt) ? mp_in[(row0 + t) * Nw + w] : 0u;
  }
  for (int e = tid; e < TR * Nw; e += nthr) {
    const int t = e / Nw;
    best_w[e] = (t < nt) ? bmp_in[(row0 + t) * Nw + e % Nw] : 0u;
  }
  for (int t = 0; t < nt; ++t) {
    for (int j = tid; j < N; j += nthr) {
      const size_t e = (row0 + t) * N + j;
      it_out[e] = it_in[e];
      const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) rng_out[l + q * RN] = rng_in[l + q * RN];
    }
  }
  if (tid < TR) bh_s[tid] = (tid < nt) ? bh_in[row0 + tid] : 0;
  __syncthreads();

  const uint32_t* sg = signT + (size_t)b * Nw * N;
  const uint32_t* mg = magsT + (size_t)b * nb * Nw * N;
  const int* hb = h + (size_t)b * N;
  const int* bs = base + (size_t)b * N;
  int* it = it_out + row0 * N;
  uint32_t* rng = rng_out + lane0;
  const size_t plane = (size_t)Nw * N;

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = fold_sched[c] > 0;
    if (last && !fold) break;
    const int i0 = last ? 0 : i0_sched[c];
    int ep[TR];
#pragma unroll
    for (int t = 0; t < TR; ++t) ep[t] = 0;

    // j0 is the same for the whole warp, so every lane reaches the ballots.
    for (int j0 = warp << 5; j0 < N; j0 += nthr) {
      const int j = j0 + lane;
      const bool valid = j < N;
      int acc[TR];
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[t] = 0;
      if (valid) {
        const uint32_t* sj = sg + j;
        const uint32_t* mj = mg + j;
#pragma unroll 4
        for (int w = 0; w < Nw; ++w) {
          const uint32_t s = sj[(size_t)w * N];
          const uint2 mv = *reinterpret_cast<const uint2*>(w_cur + w * TR);
          const uint32_t x[TR] = {~(mv.x ^ s), ~(mv.y ^ s)};
          // With NB = 1 the trip count is a constant and the loop unrolls.
          for (int p = 0; p < nb; ++p) {
            const uint32_t mk = mj[p * plane + (size_t)w * N];
#pragma unroll
            for (int t = 0; t < TR; ++t) acc[t] += __popc(x[t] & mk) << (p + 1);
          }
        }
      }
      const int hj = valid ? hb[j] : 0;
      const int cj = valid ? hj + bs[j] : 0;
      const uint32_t* wj = w_cur + (j0 >> 5) * TR;  // word of columns j0 .. j0+31
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int f = cj + acc[t];
        if (fold && valid) ep[t] += (((wj[t] >> lane) & 1u) ? 1 : -1) * (hj + f);
        if (!last) {
          bool up = false;
          if (valid && t < nt) {
            const size_t l = (size_t)t * N + j;
            const uint32_t xs = rng[l], ys = rng[l + RN];
            const uint32_t zs = rng[l + 2 * RN], ws = rng[l + 3 * RN];
            const uint32_t tt = xs ^ (xs << 11);
            const uint32_t wn = (ws ^ (ws >> 19)) ^ (tt ^ (tt >> 8));
            rng[l] = ys;
            rng[l + RN] = zs;
            rng[l + 2 * RN] = ws;
            rng[l + 3 * RN] = wn;
            const int r = (wn >> 31) ? 1 : -1;
            const int I = min(max(f + n_rnd * r + it[l], -i0), i0 - 1);
            it[l] = I;
            up = I >= 0;
          }
          const uint32_t word = __ballot_sync(0xffffffffu, up);
          if (lane == 0) w_nxt[(j0 >> 5) * TR + t] = word;
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
            const int H = -v / 2;  // the sum is even: exact
            const int better = (t < nt) && (H < bh_s[t]);
            if (better) bh_s[t] = H;
            better_s[t] = better;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        if (better_s[t]) {
          for (int w = tid; w < Nw; w += nthr) best_w[t * Nw + w] = w_cur[w * TR + t];
        }
      }
    }
    if (!last) {
      uint32_t* tmp = w_cur;
      w_cur = w_nxt;
      w_nxt = tmp;
    }
    __syncthreads();
  }

  for (int e = tid; e < nt * Nw; e += nthr) {
    const int t = e / Nw, w = e % Nw;
    mp_out[row0 * Nw + e] = w_cur[w * TR + t];
    bmp_out[row0 * Nw + e] = best_w[e];
  }
  if (tid < nt) bh_out[row0 + tid] = bh_s[tid];
}

template <int NB>
int launch(const void* mp_in, const void* it_in, const void* signT, const void* magsT,
           const void* base, const void* h, const void* rng_in, const void* i0_sched,
           const void* fold_sched, const void* bh_in, const void* bmp_in, void* mp_out,
           void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B, int R, int N,
           int nb, int n_cycles, int n_rnd, cudaStream_t stream) {
  const int Nw = (N + 31) / 32;
  const size_t smem = sizeof(uint32_t) * 3 * (size_t)Nw * TR;
  auto kernel = popcount_chain_kernel<NB>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + TR - 1) / TR, B);
  const int threads = std::min(MAX_THREADS, (N + 31) / 32 * 32);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
      static_cast<const uint32_t*>(signT), static_cast<const uint32_t*>(magsT),
      static_cast<const int*>(base), static_cast<const int*>(h),
      static_cast<const uint32_t*>(rng_in), static_cast<const int*>(i0_sched),
      static_cast<const int*>(fold_sched), static_cast<const int*>(bh_in),
      static_cast<const uint32_t*>(bmp_in), static_cast<uint32_t*>(mp_out),
      static_cast<int*>(it_out), static_cast<uint32_t*>(rng_out), static_cast<int*>(bh_out),
      static_cast<uint32_t*>(bmp_out), R, N, nb, n_cycles, n_rnd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2's SSQA ring mode (the JAX body's n_replicas > 0 mode).  The update of
// cycle c gains jperp_sched[c] * (m[k-1] + m[k+1]) over a ring of R
// consecutive trials (k +- 1 mod R; with R = 2 the one neighbour counts
// twice); the energy, and so the best tracking, keeps the base field.  A
// kernel of its own: the classical TR = 2 kernel above compiles as before.
//
// One block owns one whole ring, since every replica's update needs its
// neighbours' spins of cycle c: the ring's words, [Nw][R] (word w of every
// replica side by side), double-buffered, with its best words [R][Nw]
// (12 KB at N = 2000, R = 16).  The JAX kernel keeps a separate two-plane
// ring scratch, read at plane c % 2; here the current buffer of the double
// buffer is that plane: it holds cycle c's words of every replica, and the
// new words go to the other buffer, visible only after the barrier that
// ends the cycle.  The coupling of column j is bit j of the neighbours'
// words there.  One pass over the planes accumulates RING_G replicas
// (ring.cuh); a ring takes ceil(R/RING_G) passes per cycle.
//
// What bounds it: the classical mode's R*N*Nw*nb*(C+1) popcounts plus
// 2*R*N*C adds of the coupling.  With one block per ring it keeps only
// T/R SMs busy (12 of 132 at 96 trials, R = 8).
template <int NB>
__global__ void __launch_bounds__(MAX_THREADS)
popcount_ring_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
                     const uint32_t* __restrict__ signT, const uint32_t* __restrict__ magsT,
                     const int* __restrict__ base, const int* __restrict__ h,
                     const uint32_t* __restrict__ rng_in, const int* __restrict__ i0_sched,
                     const int* __restrict__ jperp_sched, const int* __restrict__ fold_sched,
                     const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
                     uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
                     uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
                     uint32_t* __restrict__ bmp_out, int T, int N, int nb_rt, int n_cycles,
                     int n_rnd, int R) {
  constexpr int G = RING_G;
  const int nb = NB ? NB : nb_rt;
  const int Nw = (N + 31) >> 5;
  extern __shared__ __align__(16) uint32_t smem_words[];
  uint32_t* w_cur = smem_words;               // [Nw][R]
  uint32_t* w_nxt = w_cur + (size_t)Nw * R;   // [Nw][R]
  uint32_t* best_w = w_nxt + (size_t)Nw * R;  // [R][Nw]
  __shared__ int bh_s[MAX_RING];
  __shared__ int red[MAX_RING][32];
  __shared__ int better_s[MAX_RING];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * R;  // first trial of this block's ring
  const size_t RN = (size_t)T * N;
  const size_t row0 = (size_t)b * T + t0;
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;

  for (int e = tid; e < Nw * R; e += nthr) {
    const int w = e / R, t = e % R;
    w_cur[e] = mp_in[(row0 + t) * Nw + w];
  }
  for (int e = tid; e < R * Nw; e += nthr) best_w[e] = bmp_in[row0 * Nw + e];
  for (int t = 0; t < R; ++t) {
    for (int j = tid; j < N; j += nthr) {
      const size_t e = (row0 + t) * N + j;
      it_out[e] = it_in[e];
      const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) rng_out[l + q * RN] = rng_in[l + q * RN];
    }
  }
  if (tid < R) bh_s[tid] = bh_in[row0 + tid];
  __syncthreads();

  const uint32_t* sg = signT + (size_t)b * Nw * N;
  const uint32_t* mg = magsT + (size_t)b * nb * Nw * N;
  const int* hb = h + (size_t)b * N;
  const int* bs = base + (size_t)b * N;
  int* it = it_out + row0 * N;
  uint32_t* rng = rng_out + lane0;
  const size_t plane = (size_t)Nw * N;

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = fold_sched[c] > 0;
    if (last && !fold) break;
    const int i0 = last ? 0 : i0_sched[c];
    const int jperp = last ? 0 : jperp_sched[c];
    for (int g = 0; g < R; g += G) {
      int ep[G];
#pragma unroll
      for (int t = 0; t < G; ++t) ep[t] = 0;
      // j0 is the same for the whole warp, so every lane reaches the ballots.
      for (int j0 = warp << 5; j0 < N; j0 += nthr) {
        const int j = j0 + lane;
        const bool valid = j < N;
        int acc[G];
#pragma unroll
        for (int t = 0; t < G; ++t) acc[t] = 0;
        if (valid) {
          const uint32_t* sj = sg + j;
          const uint32_t* mj = mg + j;
#pragma unroll 4
          for (int w = 0; w < Nw; ++w) {
            const uint32_t s = sj[(size_t)w * N];
            uint32_t x[G];
#pragma unroll
            for (int t = 0; t < G; ++t)
              x[t] = g + t < R ? ~(w_cur[w * R + g + t] ^ s) : 0u;
            // With NB = 1 the trip count is a constant and the loop unrolls.
            for (int p = 0; p < nb; ++p) {
              const uint32_t mk = mj[p * plane + (size_t)w * N];
#pragma unroll
              for (int t = 0; t < G; ++t) acc[t] += __popc(x[t] & mk) << (p + 1);
            }
          }
        }
        const int hj = valid ? hb[j] : 0;
        const int cj = valid ? hj + bs[j] : 0;
        const uint32_t* wj = w_cur + (j0 >> 5) * R;  // words of columns j0 .. j0+31
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int k = g + t;  // the replica; k >= R is the same for the whole warp
          if (k >= R) break;
          const int f = cj + acc[t];
          if (fold && valid) ep[t] += (((wj[k] >> lane) & 1u) ? 1 : -1) * (hj + f);
          if (!last) {
            bool up = false;
            if (valid) {
              const int kp = k == 0 ? R - 1 : k - 1, kn = k == R - 1 ? 0 : k + 1;
              const int coup =
                  (((wj[kp] >> lane) & 1u) ? 1 : -1) + (((wj[kn] >> lane) & 1u) ? 1 : -1);
              const size_t l = (size_t)k * N + j;
              const uint32_t xs = rng[l], ys = rng[l + RN];
              const uint32_t zs = rng[l + 2 * RN], ws = rng[l + 3 * RN];
              const uint32_t tt = xs ^ (xs << 11);
              const uint32_t wn = (ws ^ (ws >> 19)) ^ (tt ^ (tt >> 8));
              rng[l] = ys;
              rng[l + RN] = zs;
              rng[l + 2 * RN] = ws;
              rng[l + 3 * RN] = wn;
              const int r = (wn >> 31) ? 1 : -1;
              const int I = min(max(f + jperp * coup + n_rnd * r + it[l], -i0), i0 - 1);
              it[l] = I;
              up = I >= 0;
            }
            const uint32_t word = __ballot_sync(0xffffffffu, up);
            if (lane == 0) w_nxt[(j0 >> 5) * R + k] = word;
          }
        }
      }
      if (fold) {
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int v = warp_sum(ep[t]);
          if (lane == 0 && g + t < R) red[g + t][warp] = v;
        }
      }
    }

    if (fold) {
      __syncthreads();
      if (warp == 0) {
        for (int t = 0; t < R; ++t) {
          const int v = warp_sum(lane < nwarps ? red[t][lane] : 0);
          if (lane == 0) {
            const int H = -v / 2;  // the sum is even: exact
            const int better = H < bh_s[t];
            if (better) bh_s[t] = H;
            better_s[t] = better;
          }
        }
      }
      __syncthreads();
      for (int t = 0; t < R; ++t) {
        if (better_s[t]) {
          for (int w = tid; w < Nw; w += nthr) best_w[t * Nw + w] = w_cur[w * R + t];
        }
      }
    }
    if (!last) {
      uint32_t* tmp = w_cur;
      w_cur = w_nxt;
      w_nxt = tmp;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * Nw; e += nthr) {
    const int t = e / Nw, w = e % Nw;
    mp_out[row0 * Nw + e] = w_cur[w * R + t];
    bmp_out[row0 * Nw + e] = best_w[e];
  }
  if (tid < R) bh_out[row0 + tid] = bh_s[tid];
}

template <int NB>
int launch_ring(const void* mp_in, const void* it_in, const void* signT, const void* magsT,
                const void* base, const void* h, const void* rng_in, const void* i0_sched,
                const void* jperp_sched, const void* fold_sched, const void* bh_in,
                const void* bmp_in, void* mp_out, void* it_out, void* rng_out, void* bh_out,
                void* bmp_out, int B, int T, int N, int nb, int n_cycles, int n_rnd, int R,
                cudaStream_t stream) {
  const int Nw = (N + 31) / 32;
  const size_t smem = sizeof(uint32_t) * 3 * (size_t)Nw * R;
  auto kernel = popcount_ring_kernel<NB>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(T / R, B);
  const int threads = std::min(MAX_THREADS, (N + 31) / 32 * 32);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
      static_cast<const uint32_t*>(signT), static_cast<const uint32_t*>(magsT),
      static_cast<const int*>(base), static_cast<const int*>(h),
      static_cast<const uint32_t*>(rng_in), static_cast<const int*>(i0_sched),
      static_cast<const int*>(jperp_sched), static_cast<const int*>(fold_sched),
      static_cast<const int*>(bh_in), static_cast<const uint32_t*>(bmp_in),
      static_cast<uint32_t*>(mp_out), static_cast<int*>(it_out),
      static_cast<uint32_t*>(rng_out), static_cast<int*>(bh_out),
      static_cast<uint32_t*>(bmp_out), T, N, nb, n_cycles, n_rnd, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssa_plateau_popcount_ring(
    const void* mp_in, const void* it_in, const void* signT, const void* magsT,
    const void* base, const void* h, const void* rng_in, const void* i0_sched,
    const void* jperp_sched, const void* fold_sched, const void* bh_in, const void* bmp_in,
    void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B, int T,
    int N, int nb, int n_cycles, int n_rnd, int n_replicas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || n_replicas < 1 || n_replicas > MAX_RING)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = nb == 1 ? launch_ring<1> : launch_ring<0>;
  return run(mp_in, it_in, signT, magsT, base, h, rng_in, i0_sched, jperp_sched, fold_sched,
             bh_in, bmp_in, mp_out, it_out, rng_out, bh_out, bmp_out, B, T, N, nb, n_cycles,
             n_rnd, n_replicas, s);
}

extern "C" int repro_ssa_plateau_popcount(
    const void* mp_in, const void* it_in, const void* signT, const void* magsT,
    const void* base, const void* h, const void* rng_in, const void* i0_sched,
    const void* fold_sched, const void* bh_in, const void* bmp_in, void* mp_out,
    void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B, int R, int N, int nb,
    int n_cycles, int n_rnd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  // nb = 1 (every +-1-weight instance) gets a constant trip count.
  auto run = nb == 1 ? launch<1> : launch<0>;
  return run(mp_in, it_in, signT, magsT, base, h, rng_in, i0_sched, fold_sched, bh_in, bmp_in,
             mp_out, it_out, rng_out, bh_out, bmp_out, B, R, N, nb, n_cycles, n_rnd, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
