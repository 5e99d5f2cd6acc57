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

#include <cooperative_groups.h>

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
// A ring's update needs every replica's spins of cycle c, so a ring is one
// thread-block cluster of CS blocks (CS in 1, 2, 4, 8, 16; the wrapper
// chooses it, ssa_update.ring_cluster_size), launched with
// cudaLaunchKernelEx on a grid of (T/R * CS, B).  Block q of the cluster
// owns a slice of whole 32-column words (Nw words split as evenly as
// possible): for its columns it computes the field of all R replicas over
// every k, and it alone steps their xorshift lanes, their Itanh and their
// words of m_packed and best_m_packed.  Every block keeps the ring's spins
// of every column k as the bits of one 32-bit word (bit t = replica t, 1 =
// +1), double-buffered, 8*N B; after its update a block writes its new words
// into the next buffer of every block of the cluster through distributed
// shared memory, and cluster.sync() closes the cycle: nothing of cycle c+1
// is visible before it.  The energy fold: each block sums its columns'
// share of h.m + m.field per replica, writes it into every peer's
// [parity][CS][MAX_RING] array, and after the barrier every block adds the
// CS shares in rank order, so H, the running best and the "better" flags
// come out identical everywhere; each block then ballots its own words into
// its best words.  Integer sums make all of it bit-identical to the plain
// version whatever CS is.
//
// Inside a block, RING_THREADS threads split the block's columns (4 per
// thread, CT threads across a column tile) and k (RING_THREADS / CT
// k-ranges); the k-ranges' partial fields meet in shared memory before the
// update.  Where N % 4 == 0 a thread's 4 columns are neighbours, read with
// one 16-byte load per k (a quarter of the L2 requests of 4 scalar loads);
// otherwise they are CT apart.  One pass over J accumulates RING_G replicas (ring.cuh): per
// column and k one float fma per replica, the replica's sign read as +-1.0f
// from a table built once per pass from the spin words (two 16-byte
// shared-memory broadcasts per k), so the sign flip costs no instruction in
// the inner loop.  Every operand is an integer below 2^24 and the sums are
// exact in any order, as the classical kernel's fmaf by +-1 is.
//
// What bounds it: the same 2*R*N^2*(C+1) operations as the classical mode
// and 2*R*N*C adds of the coupling, on the CUDA cores (1.16 ms at K2000, 96
// trials, C = 100).  Measured on an H100 at 700 W: about 4.1 ms there, with
// clusters of 8 (96 blocks); each ring streams J from L2 once per pass and
// cycle (16 MB in float32 at N = 2000), 4.7 TB/s at 12 rings.  The vector
// loads (4x fewer L2 requests, the same bytes) cut the time by a fifth,
// and a bfloat16 J (half the bytes) takes about as long, so the per-block
// instruction stream, not L2's byte rate, is what binds it now.  256
// threads a block leave each thread up to 255 registers for its 32
// accumulators and 8 unrolled k steps.
constexpr int RING_THREADS = 256;
constexpr int RING_WARPS = RING_THREADS / 32;
constexpr int MAX_CS = 16;                    // blocks per cluster (16 non-portable)
constexpr int RING_KC = 2048;                 // k per sign-table chunk
constexpr int RING_WORK = RING_KC * RING_G;   // floats: the table, or the k-range partials
static_assert(RING_WORK >= 4 * RING_G * RING_THREADS, "k-range partials fit the table");
static_assert(RING_G == 8, "the sign table holds two float4 per k");

// Four neighbouring values of J as floats, one vector load (0 when !ok).
__device__ __forceinline__ void load4(const float* p, bool ok, float (&x)[4]) {
  const float4 v = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok, float (&x)[4]) {
  const uint2 v = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <typename JT, bool VEC>
__global__ void __launch_bounds__(RING_THREADS, 1)
ring_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
            const JT* __restrict__ J, const int* __restrict__ h,
            const uint32_t* __restrict__ rng_in, int i0, int jperp,
            const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
            uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
            uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
            uint32_t* __restrict__ bmp_out, int T, int N, int n_cycles, int n_rnd,
            int eligible, int R, int CT) {
  constexpr int G = RING_G;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* work = reinterpret_cast<float*>(smem_raw);              // [RING_WORK]
  uint32_t* s_cur = reinterpret_cast<uint32_t*>(work + RING_WORK);  // [N], bit t = replica t
  uint32_t* s_nxt = s_cur + N;                                    // [N]
  uint32_t* best_w = s_nxt + N;                                   // [R][nwq]
  __shared__ int bh_s[MAX_RING];
  __shared__ int better_s[MAX_RING];
  __shared__ int eps[MAX_RING][RING_WARPS];
  __shared__ int part[2][MAX_CS][MAX_RING];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / CS) * R;  // first trial of this cluster's ring
  const size_t RN = (size_t)T * N;
  const size_t row0 = (size_t)b * T + t0;
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;
  const int Nw = (N + 31) >> 5;
  const int w_lo = q * Nw / CS, nwq = (q + 1) * Nw / CS - w_lo;  // this block's words
  const int c_lo = w_lo * 32, c_hi = min(N, (w_lo + nwq) * 32);   // and columns
  const int KG = RING_THREADS / CT, TW = 4 * CT;
  const int kg = tid / CT, ct = tid % CT;

  // Prologue: every column's spins of the ring into word j; this block's
  // columns' Itanh and lanes copied to the outputs, where the cycles update
  // them; its best words.
  for (int j = tid; j < N; j += RING_THREADS) {
    uint32_t word = 0;
    for (int t = 0; t < R; ++t) word |= ((mp_in[(row0 + t) * Nw + (j >> 5)] >> (j & 31)) & 1u) << t;
    s_cur[j] = word;
  }
  for (int j = c_lo + tid; j < c_hi; j += RING_THREADS) {
    for (int t = 0; t < R; ++t) {
      const size_t e = (row0 + t) * N + j;
      it_out[e] = it_in[e];
      const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
      for (int r = 0; r < 4; ++r) rng_out[l + r * RN] = rng_in[l + r * RN];
    }
  }
  for (int e = tid; e < R * nwq; e += RING_THREADS)
    best_w[e] = bmp_in[(row0 + e / nwq) * Nw + w_lo + e % nwq];
  if (tid < R) bh_s[tid] = bh_in[row0 + tid];
  cluster.sync();  // every block runs before any writes into a peer

  const JT* Jb = J + (size_t)b * N * N;
  const int* hb = h + (size_t)b * N;
  int* it = it_out + row0 * N;
  uint32_t* rng = rng_out + lane0;

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = eligible && (c > 0 || last);
    if (last && !fold) break;
    const int par = c & 1;
    for (int g = 0; g < R; g += G) {
      const bool last_pass = g + G >= R;
      int ep[G];
#pragma unroll
      for (int t = 0; t < G; ++t) ep[t] = 0;
      for (int tile = c_lo; tile < c_hi; tile += TW) {
        float acc[4][G];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < G; ++t) acc[i][t] = 0.f;
        // This thread's columns: with VEC (N % 4 == 0) four neighbours,
        // col + i, read with one vector load per k; otherwise col + i * CT.
        const int col = tile + (VEC ? 4 * ct : ct);
        bool ok[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ok[i] = col + (VEC ? i : i * CT) < c_hi;
        for (int k0 = 0; k0 < N; k0 += RING_KC) {
          const int kn = min(RING_KC, N - k0);
          __syncthreads();  // the previous users of `work` are done
          for (int k = tid; k < kn; k += RING_THREADS) {
            const uint32_t w = s_cur[k0 + k] >> g;  // bit t: replica g + t
            float4* s = reinterpret_cast<float4*>(work + k * G);
            s[0] = make_float4(__int_as_float(0xbf800000u ^ ((w & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 1) & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 2) & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 3) & 1u) << 31)));
            s[1] = make_float4(__int_as_float(0xbf800000u ^ (((w >> 4) & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 5) & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 6) & 1u) << 31)),
                               __int_as_float(0xbf800000u ^ (((w >> 7) & 1u) << 31)));
          }
          __syncthreads();
          const int kb = kg * kn / KG, ke = (kg + 1) * kn / KG;
          const JT* Jk = Jb + (size_t)(k0 + kb) * N + col;
#pragma unroll 8
          for (int k = kb; k < ke; ++k, Jk += N) {
            const float4 s0 = *reinterpret_cast<const float4*>(work + k * G);
            const float4 s1 = *reinterpret_cast<const float4*>(work + k * G + 4);
            float x[4];
            if (VEC) {
              load4(Jk, ok[0], x);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) x[i] = ok[i] ? plateau::to_f32(Jk[i * CT]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = x[i];
              acc[i][0] = fmaf(s0.x, v, acc[i][0]);
              acc[i][1] = fmaf(s0.y, v, acc[i][1]);
              acc[i][2] = fmaf(s0.z, v, acc[i][2]);
              acc[i][3] = fmaf(s0.w, v, acc[i][3]);
              acc[i][4] = fmaf(s1.x, v, acc[i][4]);
              acc[i][5] = fmaf(s1.y, v, acc[i][5]);
              acc[i][6] = fmaf(s1.z, v, acc[i][6]);
              acc[i][7] = fmaf(s1.w, v, acc[i][7]);
            }
          }
        }
        __syncthreads();  // the table's readers are done: `work` takes the partials
#pragma unroll
        for (int t = 0; t < G; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            work[(kg * G + t) * TW + (VEC ? 4 * ct + i : i * CT + ct)] = acc[i][t];
        __syncthreads();
        for (int u = tid; u < TW && tile + u < c_hi; u += RING_THREADS) {
          const int j = tile + u;
          const int hj = hb[j];
          const uint32_t wj = s_cur[j];
          // The pass's lanes and Itanh of column j, all loaded before any
          // store, so the loads of the RING_G replicas overlap.
          uint32_t x[G], y[G], z[G], w[G];
          int itj[G];
#pragma unroll
          for (int t = 0; t < G; ++t) {
            if (last || g + t >= R) continue;
            const size_t l = (size_t)(g + t) * N + j;
            x[t] = rng[l];
            y[t] = rng[l + RN];
            z[t] = rng[l + 2 * RN];
            w[t] = rng[l + 3 * RN];
            itj[t] = it[l];
          }
          uint32_t up = 0;
#pragma unroll
          for (int t = 0; t < G; ++t) {
            const int k = g + t;  // the replica
            if (k >= R) continue;
            float f = 0.f;
            for (int p = 0; p < KG; ++p) f += work[(p * G + t) * TW + u];
            const int fi = __float2int_rz(f) + hj;
            ep[t] += (((wj >> k) & 1u) ? 1 : -1) * (hj + fi);
            if (!last) {
              const int kp = k == 0 ? R - 1 : k - 1, kn = k == R - 1 ? 0 : k + 1;
              const int coup = (((wj >> kp) & 1u) ? 1 : -1) + (((wj >> kn) & 1u) ? 1 : -1);
              const size_t l = (size_t)k * N + j;
              const uint32_t tt = x[t] ^ (x[t] << 11);
              const uint32_t wn = (w[t] ^ (w[t] >> 19)) ^ (tt ^ (tt >> 8));
              rng[l] = y[t];
              rng[l + RN] = z[t];
              rng[l + 2 * RN] = w[t];
              rng[l + 3 * RN] = wn;
              const int r = (wn >> 31) ? 1 : -1;
              const int I = min(max(fi + jperp * coup + n_rnd * r + itj[t], -i0), i0 - 1);
              it[l] = I;
              up |= (uint32_t)(I >= 0) << k;
            }
          }
          if (!last) {
            const uint32_t word = (g == 0 ? 0u : s_nxt[j]) | up;
            if (last_pass) {
              for (int p = 0; p < CS; ++p) *cluster.map_shared_rank(s_nxt + j, p) = word;
            } else {
              s_nxt[j] = word;
            }
          }
        }
      }
      if (fold) {
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int v = plateau::warp_sum(ep[t]);
          if (lane == 0 && g + t < R) eps[g + t][warp] = v;
        }
      }
    }

    if (fold) {
      __syncthreads();
      if (warp == 0) {  // this block's share of each replica's energy, to every peer
        for (int t = 0; t < R; ++t) {
          const int v = plateau::warp_sum(lane < RING_WARPS ? eps[t][lane] : 0);
          if (lane < CS) *cluster.map_shared_rank(&part[par][q][t], lane) = v;
        }
      }
    }
    cluster.sync();  // cycle c+1's words and the energy shares are everywhere
    if (fold) {
      if (warp == 0 && lane < R) {
        int v = 0;
        for (int p = 0; p < CS; ++p) v += part[par][p][lane];
        const int H = -v / 2;  // the sum is even: exact
        const int better = H < bh_s[lane];
        if (better) bh_s[lane] = H;
        better_s[lane] = better;
      }
      __syncthreads();
      for (int t = 0; t < R; ++t) {
        if (!better_s[t]) continue;
        for (int w = warp; w < nwq; w += RING_WARPS) {
          const int k = ((w_lo + w) << 5) + lane;
          const uint32_t word = __ballot_sync(0xffffffffu, k < N && ((s_cur[k] >> t) & 1u));
          if (lane == 0) best_w[t * nwq + w] = word;
        }
      }
    }
    if (!last) {
      uint32_t* tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = tmp;
    }
  }

  __syncthreads();
  for (int t = 0; t < R; ++t) {
    for (int w = warp; w < nwq; w += RING_WARPS) {
      const int k = ((w_lo + w) << 5) + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, k < N && ((s_cur[k] >> t) & 1u));
      if (lane == 0) mp_out[(row0 + t) * Nw + w_lo + w] = word;
    }
  }
  for (int e = tid; e < R * nwq; e += RING_THREADS)
    bmp_out[(row0 + e / nwq) * Nw + w_lo + e % nwq] = best_w[e];
  if (q == 0 && tid < R) bh_out[row0 + tid] = bh_s[tid];
}

// Shared memory of a ring block: the work area, the two spin buffers and
// the best words of its slice.
size_t ring_smem(int N, int R, int cs) {
  const int Nw = (N + 31) / 32;
  const int nwq = (Nw + cs - 1) / cs;
  return sizeof(float) * RING_WORK + sizeof(uint32_t) * (2 * (size_t)N + (size_t)R * nwq);
}

template <typename JT, bool VEC>
cudaError_t ring_config(int N, int R, int cs, size_t* smem) {
  auto kernel = ring_kernel<JT, VEC>;
  *smem = ring_smem(N, R, cs);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(*smem));
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

void ring_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int n_rings, int B,
                        int cs, size_t smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_rings * cs, B);
  cfg->blockDim = dim3(RING_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename JT>
int launch_ring(const void* mp_in, const void* it_in, const void* J, const void* h,
                const void* rng_in, int i0, int jperp, const void* bh_in, const void* bmp_in,
                void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B,
                int T, int N, int n_cycles, int n_rnd, int eligible, int R, int cs,
                cudaStream_t stream) {
  // Vector loads of four neighbouring columns need aligned rows.
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(J) % (4 * sizeof(JT)) == 0;
  size_t smem = 0;
  cudaError_t e = vec ? ring_config<JT, true>(N, R, cs, &smem)
                      : ring_config<JT, false>(N, R, cs, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Column threads: the block's widest slice, 4 columns a thread, a power
  // of two of at least a warp; the rest of the threads split k.
  const int Nw = (N + 31) / 32;
  const int cols = 32 * ((Nw + cs - 1) / cs);
  int ct = 32;
  while (ct < RING_THREADS && 4 * ct < cols) ct *= 2;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ring_launch_config(&cfg, &attr, T / R, B, cs, smem, stream);
  e = cudaLaunchKernelEx(&cfg, vec ? ring_kernel<JT, true> : ring_kernel<JT, false>,
                         static_cast<const uint32_t*>(mp_in),
                         static_cast<const int*>(it_in), static_cast<const JT*>(J),
                         static_cast<const int*>(h), static_cast<const uint32_t*>(rng_in), i0,
                         jperp, static_cast<const int*>(bh_in),
                         static_cast<const uint32_t*>(bmp_in), static_cast<uint32_t*>(mp_out),
                         static_cast<int*>(it_out), static_cast<uint32_t*>(rng_out),
                         static_cast<int*>(bh_out), static_cast<uint32_t*>(bmp_out), T, N,
                         n_cycles, n_rnd, eligible, R, ct);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of `cs` ring blocks (N spins, rings of R) the card can
// run at once; 0 when none fits.  Negative: a CUDA error code, negated.
extern "C" int repro_ring_max_clusters(int N, int R, int cs, int j_bf16) {
  size_t smem = 0;
  const bool vec = N % 4 == 0;
  cudaError_t e = j_bf16 ? (vec ? ring_config<__nv_bfloat16, true>(N, R, cs, &smem)
                                : ring_config<__nv_bfloat16, false>(N, R, cs, &smem))
                         : (vec ? ring_config<float, true>(N, R, cs, &smem)
                                : ring_config<float, false>(N, R, cs, &smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ring_launch_config(&cfg, &attr, 1, 1, cs, smem, nullptr);
  int n = 0;
  auto kernel = j_bf16 ? (vec ? (void*)ring_kernel<__nv_bfloat16, true>
                              : (void*)ring_kernel<__nv_bfloat16, false>)
                       : (vec ? (void*)ring_kernel<float, true> : (void*)ring_kernel<float, false>);
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a size that does not fit is an answer, not a fault
    return 0;
  }
  return n;
}

extern "C" int repro_ssa_plateau_packed_ring(const void* mp_in, const void* it_in,
                                             const void* J, const void* h,
                                             const void* rng_in, int i0, int jperp,
                                             const void* bh_in, const void* bmp_in,
                                             void* mp_out, void* it_out, void* rng_out,
                                             void* bh_out, void* bmp_out, int B, int T,
                                             int N, int n_cycles, int n_rnd, int eligible,
                                             int j_bf16, int n_replicas, int cluster_size,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_replicas < 1 || n_replicas > MAX_RING || cluster_size < 1 || cluster_size > MAX_CS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = j_bf16 ? launch_ring<__nv_bfloat16> : launch_ring<float>;
  return run(mp_in, it_in, J, h, rng_in, i0, jperp, bh_in, bmp_in, mp_out, it_out, rng_out,
             bh_out, bmp_out, B, T, N, n_cycles, n_rnd, eligible, n_replicas, cluster_size, s);
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
