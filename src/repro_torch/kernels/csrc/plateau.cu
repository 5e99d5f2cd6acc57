// K1 — one constant-I0 plateau of C cycles of the HA-SSA spin update, in
// one launch, for B problems x R trials.
//
// Replaces: src/repro/kernels/ssa_update.py:_plateau_streamed_kernel
// (wrappers ssa_plateau_packed_batched / ssa_plateau_packed), in both its
// modes: the classical kernel first, the SSQA ring mode (n_replicas > 0)
// after it, at ring_kernel.  Per cycle: field = m @ J + h; at c >= 1, when `eligible`, fold
// H = -(h.m + m.field)/2 into the running best (strict <); step the
// xorshift128 lanes (t = x ^ (x << 11); w' = (w ^ (w >> 19)) ^ (t ^ (t >> 8)))
// and take the MSB of w' as +-1 noise; Itanh = clamp(field + n_rnd*r +
// Itanh, -I0, I0-1); m = sign(Itanh).  After the loop one more field folds
// the final state.  Spins enter and leave as 32-bit words, bit k of word w
// = spin 32w+k; output words have 0 in every bit >= N.
//
// What bounds it on the H100: the arithmetic is 2·R·N²·(C+1) operations
// (8.1e10 at K2000: N = 2000, R = 100, C = 100), 1.2 ms at the float32
// CUDA-core peak of 67 TFLOP/s; the bytes it must move are ~24 MB (J once,
// the state in and out), 7 us at 3.35 TB/s.  Operations bound it in
// principle.  This design is far from that bound (about 15x on an H100 at
// 700 W): every cycle needs all N spins of a trial before the next, so a
// block owns whole trials and streams the whole of J (16 MB in float32 at
// N = 2000) from L2 every cycle, one scalar load per element per thread.
// Measured, a bfloat16 J (half the bytes) is only ~10% faster, so the
// limit is the latency of those loads rather than L2's byte rate.
//
// Design: one block per (problem, TR trials), TR = 1, 2 or 4 (the result
// does not depend on the tiling; 2 measured fastest at K2000).  J does not
// fit in shared memory (227 KB per block), so it streams from L2 (50 MB
// holds K2000's J) every cycle; the cycle loop is plateau_cycle.cuh's,
// shared with K4.  The spins of the block's trials live in shared memory
// as floats, double-buffered, with the running best spins as packed words
// beside them; Itanh and the four lane words (20 B per element) stay in
// global memory, in the output tensors, each touched once per cycle by the
// thread that owns its column.  Packed words are made with warp ballots,
// so tail bits are 0.
#include "plateau_cycle.cuh"
#include "ring.cuh"

#include <algorithm>

namespace {

using plateau::DEFAULT_SMEM;
using plateau::MAX_THREADS;

// Packed word w of trial t of the spins in `m` ([N][TR] floats); called by
// whole warps.  Bits at index >= N are 0.
template <int TR>
__device__ __forceinline__ uint32_t pack_word(const float* m, int t, int w, int N, int lane) {
  const int k = (w << 5) + lane;
  return __ballot_sync(0xffffffffu, k < N && m[k * TR + t] > 0.f);
}

// Noise stepped from the carried xorshift128 lanes (in the output tensor);
// the running best as packed words in shared memory.
template <int TR>
struct StreamedIO {
  uint32_t* rng;  // lane word 0 of the block's first trial; words RN apart
  size_t RN;
  uint32_t* best_w;  // [TR][Nw] shared
  int N, Nw;

  __device__ __forceinline__ int noise(int t, int j, int) {
    const size_t l = (size_t)t * N + j;
    const uint32_t x = rng[l], y = rng[l + RN];
    const uint32_t z = rng[l + 2 * RN], w = rng[l + 3 * RN];
    const uint32_t tt = x ^ (x << 11);
    const uint32_t wn = (w ^ (w >> 19)) ^ (tt ^ (tt >> 8));
    rng[l] = y;
    rng[l + RN] = z;
    rng[l + 2 * RN] = w;
    rng[l + 3 * RN] = wn;
    return (wn >> 31) ? 1 : -1;
  }

  __device__ __forceinline__ void store_best(int t, const float* m) {
    const int lane = threadIdx.x & 31;
    for (int w = threadIdx.x >> 5; w < Nw; w += blockDim.x >> 5) {
      const uint32_t word = pack_word<TR>(m, t, w, N, lane);
      if (lane == 0) best_w[t * Nw + w] = word;
    }
  }
};

template <typename JT, int TR>
__global__ void __launch_bounds__(MAX_THREADS)
plateau_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
               const JT* __restrict__ J, const int* __restrict__ h,
               const uint32_t* __restrict__ rng_in, int i0,
               const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
               uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
               uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
               uint32_t* __restrict__ bmp_out, int R, int N, int n_cycles, int n_rnd,
               int eligible) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_cur = reinterpret_cast<float*>(smem_raw);  // [N][TR]
  float* m_nxt = m_cur + (size_t)N * TR;              // [N][TR]
  const int Nw = (N + 31) >> 5;
  uint32_t* best_w = reinterpret_cast<uint32_t*>(m_nxt + (size_t)N * TR);  // [TR][Nw]
  __shared__ int bh_s[TR];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TR;
  const int nt = min(TR, R - t0);  // trials of this block; the rest are idle
  const size_t RN = (size_t)R * N;
  const size_t row0 = (size_t)b * R + t0;                     // first (b, trial) row
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;   // lane word 0 of row0

  // Prologue: unpack spins, copy Itanh and the lanes to the outputs (the
  // thread that owns column j copies it and is the only one to touch it).
  for (int j = tid; j < N; j += nthr) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      float s = -1.f;
      if (t < nt) {
        const uint32_t wd = mp_in[(row0 + t) * Nw + (j >> 5)];
        s = ((wd >> (j & 31)) & 1u) ? 1.f : -1.f;
        const size_t e = (row0 + t) * N + j;
        it_out[e] = it_in[e];
        const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) rng_out[l + q * RN] = rng_in[l + q * RN];
      }
      m_cur[j * TR + t] = s;
      m_nxt[j * TR + t] = s;
    }
  }
  for (int e = tid; e < TR * Nw; e += nthr) {
    const int t = e / Nw;
    best_w[e] = (t < nt) ? bmp_in[(row0 + t) * Nw + e % Nw] : 0u;
  }
  if (tid < TR) bh_s[tid] = (tid < nt) ? bh_in[row0 + tid] : 0;
  __syncthreads();

  StreamedIO<TR> io{rng_out + lane0, RN, best_w, N, Nw};
  m_cur = plateau::run_cycles<JT, TR>(io, m_cur, m_nxt, J + (size_t)b * N * N,
                                      h + (size_t)b * N, it_out + row0 * N, bh_s, nt, N, i0,
                                      n_cycles, n_rnd, eligible);

  for (int t = 0; t < nt; ++t) {
    for (int w = warp; w < Nw; w += nwarps) {
      const uint32_t word = pack_word<TR>(m_cur, t, w, N, lane);
      if (lane == 0) mp_out[(row0 + t) * Nw + w] = word;
    }
  }
  for (int e = tid; e < nt * Nw; e += nthr) bmp_out[row0 * Nw + e] = best_w[e];
  if (tid < nt) bh_out[row0 + tid] = bh_s[tid];
}

template <typename JT, int TR>
int launch(const void* mp_in, const void* it_in, const void* J, const void* h,
           const void* rng_in, int i0, const void* bh_in, const void* bmp_in, void* mp_out,
           void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B, int R, int N,
           int n_cycles, int n_rnd, int eligible, cudaStream_t stream) {
  const int Nw = (N + 31) / 32;
  const size_t smem = sizeof(float) * 2 * (size_t)N * TR + sizeof(uint32_t) * (size_t)TR * Nw;
  auto kernel = plateau_kernel<JT, TR>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + TR - 1) / TR, B);
  const int threads = std::min(MAX_THREADS, (N + 31) / 32 * 32);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
      static_cast<const JT*>(J), static_cast<const int*>(h),
      static_cast<const uint32_t*>(rng_in), i0, static_cast<const int*>(bh_in),
      static_cast<const uint32_t*>(bmp_in), static_cast<uint32_t*>(mp_out),
      static_cast<int*>(it_out), static_cast<uint32_t*>(rng_out),
      static_cast<int*>(bh_out), static_cast<uint32_t*>(bmp_out), R, N, n_cycles, n_rnd,
      eligible);
  return static_cast<int>(cudaGetLastError());
}

template <typename JT>
int launch_tr(int tr, const void* mp_in, const void* it_in, const void* J, const void* h,
              const void* rng_in, int i0, const void* bh_in, const void* bmp_in,
              void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B,
              int R, int N, int n_cycles, int n_rnd, int eligible, cudaStream_t s) {
  switch (tr) {
    case 1:
      return launch<JT, 1>(mp_in, it_in, J, h, rng_in, i0, bh_in, bmp_in, mp_out, it_out,
                           rng_out, bh_out, bmp_out, B, R, N, n_cycles, n_rnd, eligible, s);
    case 2:
      return launch<JT, 2>(mp_in, it_in, J, h, rng_in, i0, bh_in, bmp_in, mp_out, it_out,
                           rng_out, bh_out, bmp_out, B, R, N, n_cycles, n_rnd, eligible, s);
    case 4:
      return launch<JT, 4>(mp_in, it_in, J, h, rng_in, i0, bh_in, bmp_in, mp_out, it_out,
                           rng_out, bh_out, bmp_out, B, R, N, n_cycles, n_rnd, eligible, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K1's SSQA ring mode (the JAX body's n_replicas > 0 mode).  Per cycle the
// update field gains jperp * (m[k-1] + m[k+1]) over a ring of R consecutive
// trials (k +- 1 mod R; with R = 2 the one neighbour counts twice); the
// energy, and so the best tracking, keeps the base field.  A kernel of its
// own: the classical kernel above, and K4, compile as before.
//
// A ring's update needs every replica's spins of cycle c, so one block owns
// one whole ring.  The classical layout ([N][TR] floats, double-buffered)
// would need 2*N*R*4 B of shared memory, 256 KB at N = 2000, R = 16: over
// the 227 KB a block has.  Here the ring's spins of column k are the bits
// of one 32-bit word (bit t = replica t, 1 = +1), double-buffered: 8*N B
// (32 KB at N = 4096) for any R <= 32, and thread j owns word j of the next
// buffer, so it writes it without a ballot.  The field of replica t sums
// +-J[k][j], the sign flipped from bit t of word k by an xor on the float's
// sign bit, which is exact, as the classical kernel's fmaf by +-1 is: both
// add integers below 2^24.  One pass over J accumulates RING_G replicas
// (ring.cuh); a ring takes ceil(R/RING_G) passes per cycle.  The coupling
// reads word j
// of the current buffer, which holds cycle c's spins of every replica;
// nothing of cycle c+1 is visible before the barrier that ends the cycle.
//
// What bounds it: the same 2*R*N^2*(C+1) operations as the classical mode
// and 2*R*N*C adds of the coupling.  With one block per ring it keeps only
// T/R SMs busy (12 of 132 at 96 trials, R = 8; 1 at 16 trials, R = 16),
// and each sign flip costs two integer operations beside the float add.
// Splitting a ring over a thread-block cluster is the speed work.
template <typename JT>
__global__ void __launch_bounds__(MAX_THREADS)
ring_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
            const JT* __restrict__ J, const int* __restrict__ h,
            const uint32_t* __restrict__ rng_in, int i0, int jperp,
            const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
            uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
            uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
            uint32_t* __restrict__ bmp_out, int T, int N, int n_cycles, int n_rnd,
            int eligible, int R) {
  constexpr int G = RING_G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s_cur = reinterpret_cast<uint32_t*>(smem_raw);  // [N], bit t = replica t
  uint32_t* s_nxt = s_cur + N;                               // [N]
  uint32_t* best_w = s_nxt + N;                              // [R][Nw]
  const int Nw = (N + 31) >> 5;
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

  // Prologue: column j's spins of the ring into word j; Itanh and the lanes
  // copied to the outputs, where the cycles update them.
  for (int j = tid; j < N; j += nthr) {
    uint32_t word = 0;
    for (int t = 0; t < R; ++t) {
      word |= ((mp_in[(row0 + t) * Nw + (j >> 5)] >> (j & 31)) & 1u) << t;
      const size_t e = (row0 + t) * N + j;
      it_out[e] = it_in[e];
      const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) rng_out[l + q * RN] = rng_in[l + q * RN];
    }
    s_cur[j] = word;
    s_nxt[j] = word;
  }
  for (int e = tid; e < R * Nw; e += nthr) best_w[e] = bmp_in[row0 * Nw + e];
  if (tid < R) bh_s[tid] = bh_in[row0 + tid];
  __syncthreads();

  const JT* Jb = J + (size_t)b * N * N;
  const int* hb = h + (size_t)b * N;
  int* it = it_out + row0 * N;
  uint32_t* rng = rng_out + lane0;

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = eligible && (c > 0 || last);
    if (last && !fold) break;
    for (int g = 0; g < R; g += G) {
      int ep[G];
#pragma unroll
      for (int t = 0; t < G; ++t) ep[t] = 0;
      for (int j = tid; j < N; j += nthr) {
        float acc[G];
#pragma unroll
        for (int t = 0; t < G; ++t) acc[t] = 0.f;
        const JT* Jc = Jb + j;
#pragma unroll 8
        for (int k = 0; k < N; ++k) {
          const uint32_t jv = __float_as_uint(plateau::to_f32(Jc[(size_t)k * N]));
          const uint32_t neg = ~s_cur[k] >> g;  // bit t: replica g+t is -1
#pragma unroll
          for (int t = 0; t < G; ++t)
            acc[t] += __uint_as_float(jv ^ ((neg << (31 - t)) & 0x80000000u));
        }
        const int hj = hb[j];
        const uint32_t wj = s_cur[j];
        uint32_t up = 0;
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int k = g + t;  // the replica
          if (k >= R) break;
          const int f = __float2int_rz(acc[t]) + hj;
          ep[t] += (((wj >> k) & 1u) ? 1 : -1) * (hj + f);
          if (!last) {
            const int kp = k == 0 ? R - 1 : k - 1, kn = k == R - 1 ? 0 : k + 1;
            const int coup = (((wj >> kp) & 1u) ? 1 : -1) + (((wj >> kn) & 1u) ? 1 : -1);
            const size_t l = (size_t)k * N + j;
            const uint32_t x = rng[l], y = rng[l + RN];
            const uint32_t z = rng[l + 2 * RN], w = rng[l + 3 * RN];
            const uint32_t tt = x ^ (x << 11);
            const uint32_t wn = (w ^ (w >> 19)) ^ (tt ^ (tt >> 8));
            rng[l] = y;
            rng[l + RN] = z;
            rng[l + 2 * RN] = w;
            rng[l + 3 * RN] = wn;
            const int r = (wn >> 31) ? 1 : -1;
            const int I = min(max(f + jperp * coup + n_rnd * r + it[l], -i0), i0 - 1);
            it[l] = I;
            up |= (uint32_t)(I >= 0) << k;
          }
        }
        if (!last) s_nxt[j] = (g == 0 ? 0u : s_nxt[j]) | up;
      }
      if (fold) {
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int v = plateau::warp_sum(ep[t]);
          if (lane == 0 && g + t < R) red[g + t][warp] = v;
        }
      }
    }

    if (fold) {
      __syncthreads();
      if (warp == 0) {
        for (int t = 0; t < R; ++t) {
          const int v = plateau::warp_sum(lane < nwarps ? red[t][lane] : 0);
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
        if (!better_s[t]) continue;
        for (int w = warp; w < Nw; w += nwarps) {
          const int k = (w << 5) + lane;
          const uint32_t word = __ballot_sync(0xffffffffu, k < N && ((s_cur[k] >> t) & 1u));
          if (lane == 0) best_w[t * Nw + w] = word;
        }
      }
    }
    if (!last) {
      uint32_t* tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = tmp;
    }
    __syncthreads();
  }

  for (int t = 0; t < R; ++t) {
    for (int w = warp; w < Nw; w += nwarps) {
      const int k = (w << 5) + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, k < N && ((s_cur[k] >> t) & 1u));
      if (lane == 0) mp_out[(row0 + t) * Nw + w] = word;
    }
  }
  for (int e = tid; e < R * Nw; e += nthr) bmp_out[row0 * Nw + e] = best_w[e];
  if (tid < R) bh_out[row0 + tid] = bh_s[tid];
}

template <typename JT>
int launch_ring(const void* mp_in, const void* it_in, const void* J, const void* h,
                const void* rng_in, int i0, int jperp, const void* bh_in, const void* bmp_in,
                void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B,
                int T, int N, int n_cycles, int n_rnd, int eligible, int R,
                cudaStream_t stream) {
  const int Nw = (N + 31) / 32;
  const size_t smem = sizeof(uint32_t) * (2 * (size_t)N + (size_t)R * Nw);
  auto kernel = ring_kernel<JT>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(T / R, B);
  const int threads = std::min(MAX_THREADS, (N + 31) / 32 * 32);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
      static_cast<const JT*>(J), static_cast<const int*>(h),
      static_cast<const uint32_t*>(rng_in), i0, jperp, static_cast<const int*>(bh_in),
      static_cast<const uint32_t*>(bmp_in), static_cast<uint32_t*>(mp_out),
      static_cast<int*>(it_out), static_cast<uint32_t*>(rng_out),
      static_cast<int*>(bh_out), static_cast<uint32_t*>(bmp_out), T, N, n_cycles, n_rnd,
      eligible, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssa_plateau_packed_ring(const void* mp_in, const void* it_in,
                                             const void* J, const void* h,
                                             const void* rng_in, int i0, int jperp,
                                             const void* bh_in, const void* bmp_in,
                                             void* mp_out, void* it_out, void* rng_out,
                                             void* bh_out, void* bmp_out, int B, int T,
                                             int N, int n_cycles, int n_rnd, int eligible,
                                             int j_bf16, int n_replicas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_replicas < 1 || n_replicas > MAX_RING) return static_cast<int>(cudaErrorInvalidValue);
  auto run = j_bf16 ? launch_ring<__nv_bfloat16> : launch_ring<float>;
  return run(mp_in, it_in, J, h, rng_in, i0, jperp, bh_in, bmp_in, mp_out, it_out, rng_out,
             bh_out, bmp_out, B, T, N, n_cycles, n_rnd, eligible, n_replicas, s);
}

extern "C" int repro_ssa_plateau_packed(const void* mp_in, const void* it_in, const void* J,
                                        const void* h, const void* rng_in, int i0,
                                        const void* bh_in, const void* bmp_in, void* mp_out,
                                        void* it_out, void* rng_out, void* bh_out,
                                        void* bmp_out, int B, int R, int N, int n_cycles,
                                        int n_rnd, int eligible, int j_bf16,
                                        int trials_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (j_bf16) {
    return launch_tr<__nv_bfloat16>(trials_per_block, mp_in, it_in, J, h, rng_in, i0, bh_in,
                                    bmp_in, mp_out, it_out, rng_out, bh_out, bmp_out, B, R,
                                    N, n_cycles, n_rnd, eligible, s);
  }
  return launch_tr<float>(trials_per_block, mp_in, it_in, J, h, rng_in, i0, bh_in, bmp_in,
                          mp_out, it_out, rng_out, bh_out, bmp_out, B, R, N, n_cycles,
                          n_rnd, eligible, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
