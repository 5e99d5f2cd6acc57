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
// principle.  Every cycle needs all N spins of a trial before the next, and
// J (16 MB in float32 at N = 2000) does not fit in shared memory, so J
// streams from L2 (50 MB) every cycle; the design makes each element read
// serve a group of trials, and the L2 requests as few as 16-byte loads
// allow.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): about
// 4.2 ms at K2000 in clusters of 8 (13 groups, 104 blocks), 3.5x the
// bound; a bfloat16 J takes as long, and the time follows the block count
// (clusters of 1, 2, 4, 8: about 26.8, 13.6, 7.2, 4.2 ms), so each block's
// instruction stream binds it, not L2's byte rate.
//
// Design: the classical kernel is plateau_cycle.cuh's cluster loop, shared
// with K4: a group of GROUP = 8 trials is one thread-block cluster, J's
// columns split over its blocks as whole 32-column words, the group's spins
// kept in every block as one word per column (bit t = trial t) and
// exchanged through distributed shared memory each cycle; a thread owns 4
// columns (one 16-byte load per k where N % 4 == 0).  This file supplies
// its IO: the spins come in as packed words, Itanh and the four lane words
// (20 B per element) stay in global memory, in the output tensors, each
// touched once per cycle by the thread that owns its column, and the best
// spins are packed words in shared memory, made with warp ballots (so tail
// bits are 0) and written out at the end.
#include "plateau_cycle.cuh"
#include "ring.cuh"

#include <cooperative_groups.h>

namespace {

using plateau::GROUP;
using plateau::MAX_CS;
using plateau::THREADS;
using plateau::WARPS;
using plateau::WORK;
using plateau::KC;
using plateau::Slice;
using plateau::load4;
using plateau::sign_table;
using plateau::to_f32;
using plateau::warp_sum;

// The group's spins as packed words of (B, R, Nw), its xorshift128 lanes
// stepped in the output tensor, its running best as packed words in shared
// memory.  Pointers start at the group's first trial; rows Nw (words) or N
// (lanes) apart, lane words RN apart.
struct StreamedIO {
  const uint32_t* mp_in;
  uint32_t* mp_out;
  const uint32_t* rng_in;
  uint32_t* rng;
  const uint32_t* bmp_in;
  uint32_t* bmp_out;
  size_t RN;
  int N, Nw, nt;
  uint32_t* best_w;  // [GROUP][nwq] shared: the block's words of each trial's best

  __device__ __forceinline__ uint32_t spins(int j) const {
    uint32_t word = 0;
    for (int t = 0; t < nt; ++t) word |= ((mp_in[(size_t)t * Nw + (j >> 5)] >> (j & 31)) & 1u) << t;
    return word;
  }

  __device__ __forceinline__ void begin(const Slice& sl, uint32_t* extra) {
    best_w = extra;
    for (int j = sl.c_lo + threadIdx.x; j < sl.c_hi; j += THREADS) {
      for (int t = 0; t < nt; ++t) {
        const size_t l = (size_t)t * N + j;
#pragma unroll
        for (int r = 0; r < 4; ++r) rng[l + r * RN] = rng_in[l + r * RN];
      }
    }
    for (int e = threadIdx.x; e < GROUP * sl.nwq; e += THREADS) {
      const int t = e / sl.nwq;
      best_w[e] = t < nt ? bmp_in[(size_t)t * Nw + sl.w_lo + e % sl.nwq] : 0u;
    }
  }

  // The lanes of every live trial loaded before any store, so the loads
  // overlap.
  __device__ __forceinline__ void noise(int j, int, int (&r)[GROUP]) {
    uint32_t x[GROUP], y[GROUP], z[GROUP], w[GROUP];
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      if (t >= nt) continue;
      const size_t l = (size_t)t * N + j;
      x[t] = rng[l];
      y[t] = rng[l + RN];
      z[t] = rng[l + 2 * RN];
      w[t] = rng[l + 3 * RN];
    }
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
      if (t >= nt) continue;
      const size_t l = (size_t)t * N + j;
      const uint32_t tt = x[t] ^ (x[t] << 11);
      const uint32_t wn = (w[t] ^ (w[t] >> 19)) ^ (tt ^ (tt >> 8));
      rng[l] = y[t];
      rng[l + RN] = z[t];
      rng[l + 2 * RN] = w[t];
      rng[l + 3 * RN] = wn;
      r[t] = (wn >> 31) ? 1 : -1;
    }
  }

  // Word w of the block's slice of trial t's spins in `s`; whole warps.
  __device__ __forceinline__ uint32_t word(const uint32_t* s, int t, const Slice& sl,
                                           int w) const {
    const int k = ((sl.w_lo + w) << 5) + (threadIdx.x & 31);
    return __ballot_sync(0xffffffffu, k < N && ((s[k] >> t) & 1u));
  }

  __device__ __forceinline__ void store_best(int t, const uint32_t* s, const Slice& sl) {
    for (int w = threadIdx.x >> 5; w < sl.nwq; w += WARPS) {
      const uint32_t b = word(s, t, sl, w);
      if ((threadIdx.x & 31) == 0) best_w[t * sl.nwq + w] = b;
    }
  }

  __device__ __forceinline__ void finish(const uint32_t* s, const Slice& sl) {
    for (int t = 0; t < nt; ++t) {
      for (int w = threadIdx.x >> 5; w < sl.nwq; w += WARPS) {
        const uint32_t b = word(s, t, sl, w);
        if ((threadIdx.x & 31) == 0) mp_out[(size_t)t * Nw + sl.w_lo + w] = b;
      }
    }
    for (int e = threadIdx.x; e < nt * sl.nwq; e += THREADS)
      bmp_out[(size_t)(e / sl.nwq) * Nw + sl.w_lo + e % sl.nwq] = best_w[e];
  }
};

template <typename JT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
plateau_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
               const JT* __restrict__ J, const int* __restrict__ h,
               const uint32_t* __restrict__ rng_in, int i0,
               const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
               uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
               uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
               uint32_t* __restrict__ bmp_out, int R, int N, int n_cycles, int n_rnd,
               int eligible, int CT) {
  const int CS = (int)cooperative_groups::this_cluster().num_blocks();
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / CS) * GROUP;  // the group's first trial
  const int nt = min(GROUP, R - t0);          // its live trials; the rest are idle
  const int Nw = (N + 31) >> 5;
  const size_t RN = (size_t)R * N;
  const size_t row0 = (size_t)b * R + t0;
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;
  StreamedIO io{mp_in + row0 * Nw, mp_out + row0 * Nw, rng_in + lane0, rng_out + lane0,
                bmp_in + row0 * Nw, bmp_out + row0 * Nw, RN, N, Nw, nt, nullptr};
  plateau::run_group<JT, VEC>(io, J + (size_t)b * N * N, h + (size_t)b * N, it_in + row0 * N,
                              it_out + row0 * N, bh_in + row0, bh_out + row0, nt, N, i0,
                              n_cycles, n_rnd, eligible, CT);
}

// Shared memory of a classical block: the work area, the group's two spin
// buffers and the best words of its slice.
size_t plateau_smem(int N, int cs) {
  const int nwq = ((N + 31) / 32 + cs - 1) / cs;
  return sizeof(float) * WORK + sizeof(uint32_t) * (2 * (size_t)N + (size_t)GROUP * nwq);
}

template <typename JT, bool VEC>
int launch(const void* mp_in, const void* it_in, const void* J, const void* h,
           const void* rng_in, int i0, const void* bh_in, const void* bmp_in, void* mp_out,
           void* it_out, void* rng_out, void* bh_out, void* bmp_out, int B, int R, int N,
           int n_cycles, int n_rnd, int eligible, int cs, cudaStream_t stream) {
  auto kernel = plateau_kernel<JT, VEC>;
  const size_t smem = plateau_smem(N, cs);
  cudaError_t e = plateau::cluster_attributes(kernel, smem, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  plateau::cluster_launch_config(&cfg, &attr, (R + GROUP - 1) / GROUP, B, cs, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(mp_in),
                         static_cast<const int*>(it_in), static_cast<const JT*>(J),
                         static_cast<const int*>(h), static_cast<const uint32_t*>(rng_in), i0,
                         static_cast<const int*>(bh_in), static_cast<const uint32_t*>(bmp_in),
                         static_cast<uint32_t*>(mp_out), static_cast<int*>(it_out),
                         static_cast<uint32_t*>(rng_out), static_cast<int*>(bh_out),
                         static_cast<uint32_t*>(bmp_out), R, N, n_cycles, n_rnd, eligible,
                         plateau::column_threads(N, cs));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1's SSQA ring mode (the JAX body's n_replicas > 0 mode).  Per cycle the
// update field gains jperp * (m[k-1] + m[k+1]) over a ring of R consecutive
// trials (k +- 1 mod R; with R = 2 the one neighbour counts twice, with R =
// 1 the replica itself), R any divisor of the trials; the energy, and so the
// best tracking, keeps the base field.  A kernel of its own beside the
// classical one; it shares plateau_cycle.cuh's sign table, wide loads and
// cluster launch.
//
// A ring's update needs every replica's spins of cycle c, so a ring is one
// thread-block cluster of CS blocks (CS in 1, 2, 4, 8, 16; the wrapper
// chooses it, ssa_update.ring_cluster_size), launched with
// cudaLaunchKernelEx on a grid of (T/R * CS, B).  Block q of the cluster
// owns a slice of whole 32-column words (Nw words split as evenly as
// possible): for its columns it computes the field of all R replicas over
// every k, and it alone steps their xorshift lanes, their Itanh and their
// words of m_packed and best_m_packed.  The ring's spins of column k are RW
// = ceil(R / 32) words, [RW][N] (bit t of word w = replica 32w + t, 1 =
// +1), double-buffered, 8 * RW * N B.  Where that fits a block's shared
// memory with the rest, every block keeps a copy: after the pass that
// completes a word a block writes it into the next buffer of every block of
// the cluster through distributed shared memory.  Where it does not (8 * RW
// * N B above ~150 KB: N = 16384 at R = 64), the cluster keeps one copy in
// global memory (`words`), each block stores its own columns there and
// reads every column through L2 (ld/st.global.cg), and the best words live
// in best_m_packed itself (that variant reads J with scalar loads: it is the
// large-N path, and one variant fewer is built); the wrapper chooses by
// size, never on failure.
// Either way cluster.sync() closes the cycle: nothing of cycle c+1 is
// visible before it, and in cycle c+1 a block writes only its own columns of
// the old buffer, which only that block's fold of cycle c reads.  The energy
// fold: each block sums its columns' share of h.m + m.field per replica,
// writes it into every peer's [parity][CS][R] array, and after the barrier
// every block adds the CS shares in rank order, so H, the running best and
// the "better" flags come out identical everywhere; each block then ballots
// its own columns into its best words.  The per-replica arrays (best
// energies, flags, per-warp and per-block shares) are sized by R in dynamic
// shared memory.  Integer sums make all of it bit-identical to the plain
// version whatever CS is.
//
// Inside a block, THREADS threads split the block's columns (4 per
// thread, CT threads across a column tile) and k (THREADS / CT
// k-ranges); the k-ranges' partial fields meet in shared memory before the
// update.  Where N % 4 == 0 a thread's 4 columns are neighbours, read with
// one vector load per k (a quarter of the L2 requests of 4 scalar loads);
// otherwise they are CT apart.  One pass over J accumulates RING_G
// replicas, which lie in one word (ring.cuh): per column and k one float
// fma per replica, the replica's sign read as +-1.0f from a table built
// once per pass from the pass's word (two 16-byte shared-memory broadcasts
// per k), so the sign flip costs no instruction in the inner loop.  The
// Trotter neighbours of a pass's replicas lie in its word, except the one
// before its first and the one after its last (across a word boundary, or
// around the ring from R-1 to 0): those two are read once per column.
// Every operand is an integer below 2^24 and the sums are exact in any
// order, as in the classical kernel.
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
static_assert(RING_G == GROUP, "a ring pass fills one sign-table row");

// A word of the ring's spins: from shared memory, or (gw) from the
// cluster's copy in global memory through L2.
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p, bool gw) {
  return gw ? __ldcg(p) : *p;
}

// The ints of a ring block's per-replica arrays: best energies, flags,
// per-warp shares [R][WARPS] and the cluster's shares [2][CS][R].
__host__ __device__ __forceinline__ size_t ring_head_ints(int R, int cs) {
  return (size_t)R * (2 + WARPS + 2 * cs);
}

// GW: the ring's words in global memory (`words`), else in shared memory.
template <typename JT, bool VEC, bool GW>
__global__ void __launch_bounds__(THREADS, 1)
ring_kernel(const uint32_t* __restrict__ mp_in, const int* __restrict__ it_in,
            const JT* __restrict__ J, const int* __restrict__ h,
            const uint32_t* __restrict__ rng_in, int i0, int jperp,
            const int* __restrict__ bh_in, const uint32_t* __restrict__ bmp_in,
            uint32_t* __restrict__ mp_out, int* __restrict__ it_out,
            uint32_t* __restrict__ rng_out, int* __restrict__ bh_out,
            uint32_t* __restrict__ bmp_out, uint32_t* __restrict__ words, int T, int N,
            int n_cycles, int n_rnd, int eligible, int R, int CT) {
  constexpr int G = RING_G;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, ring = blockIdx.x / CS;
  const int t0 = ring * R;  // first trial of this cluster's ring
  const size_t RN = (size_t)T * N;
  const size_t row0 = (size_t)b * T + t0;
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;
  const int Nw = (N + 31) >> 5, RW = (R + 31) >> 5;
  const int w_lo = q * Nw / CS, nwq = (q + 1) * Nw / CS - w_lo;  // this block's words
  const int c_lo = w_lo * 32, c_hi = min(N, (w_lo + nwq) * 32);   // and columns
  const int KG = THREADS / CT, TW = 4 * CT;
  const int kg = tid / CT, ct = tid % CT;
  constexpr bool gw = GW;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* work = reinterpret_cast<float*>(smem_raw);  // [WORK]
  int* bh_s = reinterpret_cast<int*>(work + WORK);   // [R]
  int* better_s = bh_s + R;                          // [R]
  int* eps = better_s + R;                           // [R][WARPS]
  int* part = eps + R * WARPS;                       // [2][CS][R]
  // The ring's spin words [RW][N], double-buffered, and the best words of
  // this block's slice, trial t's at best_w[t * bst]: in shared memory, the
  // words at the same offset in every block of the cluster (the peers' pushes
  // land there), or (gw) the cluster's copy in `words` and the best words in
  // best_m_packed.
  uint32_t* s_cur;
  uint32_t* best_w;
  int bst;
  if (gw) {
    s_cur = words + ((size_t)b * (T / R) + ring) * 2 * RW * N;
    best_w = bmp_out + row0 * Nw + w_lo;
    bst = Nw;
  } else {
    s_cur = reinterpret_cast<uint32_t*>(part + 2 * CS * R);
    best_w = s_cur + 2 * (size_t)RW * N;  // [R][nwq]
    bst = nwq;
  }
  uint32_t* s_nxt = s_cur + (size_t)RW * N;

  // Prologue: the ring's words of every column (gw: this block's columns of
  // the cluster's copy); this block's columns' Itanh and lanes copied to the
  // outputs, where the cycles update them; its best words.
  const int j_lo = gw ? c_lo : 0, nj = (gw ? c_hi : N) - j_lo;
  for (int e = tid; e < RW * nj; e += THREADS) {
    const int wi = e / nj, j = j_lo + e % nj;
    const int tb = 32 * wi, te = min(R, tb + 32);
    uint32_t word = 0;
    for (int t = tb; t < te; ++t)
      word |= ((mp_in[(row0 + t) * Nw + (j >> 5)] >> (j & 31)) & 1u) << (t - tb);
    if (gw)
      __stcg(s_cur + (size_t)wi * N + j, word);
    else
      s_cur[(size_t)wi * N + j] = word;
  }
  for (int j = c_lo + tid; j < c_hi; j += THREADS) {
    for (int t = 0; t < R; ++t) {
      const size_t e = (row0 + t) * N + j;
      it_out[e] = it_in[e];
      const size_t l = lane0 + (size_t)t * N + j;
#pragma unroll
      for (int r = 0; r < 4; ++r) rng_out[l + r * RN] = rng_in[l + r * RN];
    }
  }
  for (int e = tid; e < R * nwq; e += THREADS)
    best_w[(e / nwq) * bst + e % nwq] = bmp_in[(row0 + e / nwq) * Nw + w_lo + e % nwq];
  for (int t = tid; t < R; t += THREADS) bh_s[t] = bh_in[row0 + t];
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
      const int sh = g & 31;                        // the pass's first bit of its word
      const uint32_t* sc = s_cur + (size_t)(g >> 5) * N;  // the pass's word of each column
      uint32_t* sn = s_nxt + (size_t)(g >> 5) * N;
      const bool word_done = sh + G == 32 || g + G >= R;  // the pass completes its word
      // The neighbours outside the pass: before its first replica and after
      // its last (around the ring at 0 and R-1).
      const int k_prev = g == 0 ? R - 1 : g - 1, k_next = g + G >= R ? 0 : g + G;
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
        for (int k0 = 0; k0 < N; k0 += KC) {
          const int kn = min(KC, N - k0);
          __syncthreads();  // the previous users of `work` are done
          sign_table(work, sc + k0, kn, sh, gw);  // bit t: replica g + t
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
              for (int i = 0; i < 4; ++i) x[i] = ok[i] ? to_f32(Jk[i * CT]) : 0.f;
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
        for (int u = tid; u < TW && tile + u < c_hi; u += THREADS) {
          const int j = tile + u;
          const int hj = hb[j];
          const uint32_t word_j = ld_word(sc + j, gw);
          const uint32_t wj = word_j >> sh;  // bit t: replica g + t
          // The pass's lanes and Itanh of column j, all loaded before any
          // store, so the loads of the RING_G replicas overlap.
          uint32_t x[G], y[G], z[G], w[G];
          int itj[G];
          uint32_t prev = 0, next = 0;
          if (!last) {  // from the pass's word where they lie in it (every ring <= 32)
            prev = (k_prev >> 5 == g >> 5 ? word_j
                    : ld_word(s_cur + (size_t)(k_prev >> 5) * N + j, gw)) >> (k_prev & 31);
            next = (k_next >> 5 == g >> 5 ? word_j
                    : ld_word(s_cur + (size_t)(k_next >> 5) * N + j, gw)) >> (k_next & 31);
          }
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
            ep[t] += (((wj >> t) & 1u) ? 1 : -1) * (hj + fi);
            if (!last) {
              const uint32_t bp = t == 0 ? prev : wj >> (t - 1);
              const uint32_t bn = (t == G - 1 || k == R - 1) ? next : wj >> (t + 1);
              const int coup = ((bp & 1u) ? 1 : -1) + ((bn & 1u) ? 1 : -1);
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
              up |= (uint32_t)(I >= 0) << (sh + t);
            }
          }
          if (!last) {
            const uint32_t word = (sh == 0 ? 0u : ld_word(sn + j, gw)) | up;
            if (gw)
              __stcg(sn + j, word);
            else if (!word_done)
              sn[j] = word;
            else
              for (int p = 0; p < CS; ++p) *cluster.map_shared_rank(sn + j, p) = word;
          }
        }
      }
      if (fold) {
#pragma unroll
        for (int t = 0; t < G; ++t) {
          const int v = warp_sum(ep[t]);
          if (lane == 0 && g + t < R) eps[(g + t) * WARPS + warp] = v;
        }
      }
    }

    if (fold) {
      __syncthreads();
      for (int t = warp; t < R; t += WARPS) {  // this block's share of replica t, to every peer
        const int v = warp_sum(lane < WARPS ? eps[t * WARPS + lane] : 0);
        if (lane < CS) *cluster.map_shared_rank(part + (par * CS + q) * R + t, lane) = v;
      }
    }
    cluster.sync();  // cycle c+1's words and the energy shares are everywhere
    if (fold) {
      for (int t = tid; t < R; t += THREADS) {
        int v = 0;
        for (int p = 0; p < CS; ++p) v += part[(par * CS + p) * R + t];
        const int H = -v / 2;  // the sum is even: exact
        const int better = H < bh_s[t];
        if (better) bh_s[t] = H;
        better_s[t] = better;
      }
      __syncthreads();
      for (int t = 0; t < R; ++t) {
        if (!better_s[t]) continue;
        const uint32_t* st = s_cur + (size_t)(t >> 5) * N;
        for (int w = warp; w < nwq; w += WARPS) {
          const int k = ((w_lo + w) << 5) + lane;
          const uint32_t word =
              __ballot_sync(0xffffffffu, k < N && ((ld_word(st + k, gw) >> (t & 31)) & 1u));
          if (lane == 0) best_w[t * bst + w] = word;
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
    const uint32_t* st = s_cur + (size_t)(t >> 5) * N;
    for (int w = warp; w < nwq; w += WARPS) {
      const int k = ((w_lo + w) << 5) + lane;
      const uint32_t word =
          __ballot_sync(0xffffffffu, k < N && ((ld_word(st + k, gw) >> (t & 31)) & 1u));
      if (lane == 0) mp_out[(row0 + t) * Nw + w_lo + w] = word;
    }
  }
  if (!gw) {
    for (int e = tid; e < R * nwq; e += THREADS)
      bmp_out[(row0 + e / nwq) * Nw + w_lo + e % nwq] = best_w[e];
  }
  if (q == 0) {
    for (int t = tid; t < R; t += THREADS) bh_out[row0 + t] = bh_s[t];
  }
}

// Shared memory of a ring block: the work area and the per-replica arrays;
// unless the words are in global memory, the best words of its slice and
// the ring's two word buffers too (ssa_update._ring_smem mirrors it).
size_t ring_smem(int N, int R, int cs, bool gw) {
  const int Nw = (N + 31) / 32, nwq = (Nw + cs - 1) / cs, RW = (R + 31) / 32;
  const size_t head = sizeof(float) * WORK + sizeof(int) * ring_head_ints(R, cs);
  return gw ? head : head + sizeof(uint32_t) * ((size_t)R * nwq + 2 * (size_t)RW * N);
}

// The ring kernel of J type JT: with the words in shared memory, vector
// loads of J where `vec`; with the words in global memory (the large-N
// path) scalar loads, which take any N, so that no fourth variant is built.
template <typename JT>
auto ring_kernel_for(bool vec, bool gw) {
  return gw ? ring_kernel<JT, false, true> : vec ? ring_kernel<JT, true, false>
                                                  : ring_kernel<JT, false, false>;
}

template <typename JT>
int launch_ring(const void* mp_in, const void* it_in, const void* J, const void* h,
                const void* rng_in, int i0, int jperp, const void* bh_in, const void* bmp_in,
                void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out,
                void* words, int B, int T, int N, int n_cycles, int n_rnd, int eligible, int R,
                int cs, cudaStream_t stream) {
  auto kernel = ring_kernel_for<JT>(plateau::vector_loads<JT>(N, J), words != nullptr);
  const size_t smem = ring_smem(N, R, cs, words != nullptr);
  cudaError_t e = plateau::cluster_attributes(kernel, smem, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  plateau::cluster_launch_config(&cfg, &attr, T / R, B, cs, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(mp_in),
                         static_cast<const int*>(it_in), static_cast<const JT*>(J),
                         static_cast<const int*>(h), static_cast<const uint32_t*>(rng_in), i0,
                         jperp, static_cast<const int*>(bh_in),
                         static_cast<const uint32_t*>(bmp_in), static_cast<uint32_t*>(mp_out),
                         static_cast<int*>(it_out), static_cast<uint32_t*>(rng_out),
                         static_cast<int*>(bh_out), static_cast<uint32_t*>(bmp_out),
                         static_cast<uint32_t*>(words), T, N, n_cycles, n_rnd, eligible, R,
                         plateau::column_threads(N, cs));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of `cs` blocks the card runs at once, for K1's
// classical kernel (n_replicas == 0) or its ring mode with rings of
// n_replicas (`global`: the words in global memory), J of type `j_type`
// (jtype.cuh); 0 when none fits.  Negative: a CUDA error code, negated.
extern "C" int repro_plateau_max_clusters(int N, int n_replicas, int cs, int j_type,
                                          int global) {
  const bool vec = N % 4 == 0;
  return jtype::dispatch(j_type, -static_cast<int>(cudaErrorInvalidValue), [&](auto tag) {
    using JT = typename decltype(tag)::type;
    if (n_replicas)
      return plateau::max_active_clusters(ring_kernel_for<JT>(vec, global != 0), cs,
                                          ring_smem(N, n_replicas, cs, global != 0));
    return plateau::max_active_clusters(
        vec ? plateau_kernel<JT, true> : plateau_kernel<JT, false>, cs, plateau_smem(N, cs));
  });
}

// `words`: nullptr for the ring's words in shared memory, else a buffer of
// B * (T / n_replicas) * 2 * ceil(n_replicas / 32) * N words, [B][ring][2][RW][N]
// (ssa_update._ring_global_words).
extern "C" int repro_ssa_plateau_packed_ring(const void* mp_in, const void* it_in,
                                             const void* J, const void* h,
                                             const void* rng_in, int i0, int jperp,
                                             const void* bh_in, const void* bmp_in,
                                             void* mp_out, void* it_out, void* rng_out,
                                             void* bh_out, void* bmp_out, void* words, int B,
                                             int T, int N, int n_cycles, int n_rnd,
                                             int eligible, int j_type, int n_replicas,
                                             int cluster_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n_replicas < 1 || T % n_replicas || cluster_size < 1 || cluster_size > MAX_CS)
    return invalid;
  return jtype::dispatch(j_type, invalid, [&](auto tag) {
    using JT = typename decltype(tag)::type;
    return launch_ring<JT>(mp_in, it_in, J, h, rng_in, i0, jperp, bh_in, bmp_in, mp_out, it_out,
                           rng_out, bh_out, bmp_out, words, B, T, N, n_cycles, n_rnd, eligible,
                           n_replicas, cluster_size, s);
  });
}

extern "C" int repro_ssa_plateau_packed(const void* mp_in, const void* it_in, const void* J,
                                        const void* h, const void* rng_in, int i0,
                                        const void* bh_in, const void* bmp_in, void* mp_out,
                                        void* it_out, void* rng_out, void* bh_out,
                                        void* bmp_out, int B, int R, int N, int n_cycles,
                                        int n_rnd, int eligible, int j_type, int cluster_size,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (cluster_size < 1 || cluster_size > MAX_CS) return invalid;
  return jtype::dispatch(j_type, invalid, [&](auto tag) {
    using JT = typename decltype(tag)::type;
    auto run = plateau::vector_loads<JT>(N, J) ? launch<JT, true> : launch<JT, false>;
    return run(mp_in, it_in, J, h, rng_in, i0, bh_in, bmp_in, mp_out, it_out, rng_out, bh_out,
               bmp_out, B, R, N, n_cycles, n_rnd, eligible, cluster_size, s);
  });
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
