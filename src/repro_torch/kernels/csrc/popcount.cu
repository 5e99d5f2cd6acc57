// K2 — a whole HA-SSA plateau chain (C cycles with a per-cycle I0 and fold
// write-enable) in one launch, with the XNOR-popcount field, for B
// problems x R trials.  Integer arithmetic only: no float anywhere.
//
// Replaces: src/repro/kernels/ssa_update.py:_plateau_popcount_kernel
// (wrappers ssa_plateau_popcount_batched / ssa_plateau_popcount), in both
// its modes: the classical kernel (popcount_chain_kernel) and the SSQA
// ring mode (jperp_sched, n_replicas > 0; popcount_ring_kernel).  Per
// cycle c:
//   field = h + base + sum_b 2^(b+1) * popcount(XNOR(m, sign) & mags[b]);
//   if fold_sched[c] > 0, fold H = -(h.m + m.field)/2 of the state current
//   at c into the running best (strict <: the first minimum is kept; the
//   best words are that state's words);
//   step the xorshift128 lanes (t = x ^ (x << 11);
//   w' = (w ^ (w >> 19)) ^ (t ^ (t >> 8))) and take the MSB of w' as +-1
//   noise; Itanh = clamp(field + n_rnd*r + Itanh, -i0_sched[c],
//   i0_sched[c]-1); m = sign(Itanh).
// The ring mode adds jperp_sched[c] * (m[k-1] + m[k+1]) over a ring of R
// consecutive trials (k +- 1 mod R; with R = 2 the one neighbour counts
// twice) to the update; the energy, and so the best tracking, keeps the
// base field.  After the loop, fold_sched[C] folds the final state with
// one more field, so a launch evaluates C+1 fields.  Spins enter and leave
// as 32-bit words, bit k of word w = spin 32w+k; output words have 0 in
// every bit >= N (the JAX kernel's are 0 there too for n_rnd >= 1).
//
// What bounds it on the H100: R*N*Nw*nb*(C+1) popcounts (7.57e9 at K2000:
// R = 100, N = 2000, Nw = 63, nb = 1, C = 600), at 16 popc per SM per clock
// on 132 SMs at 1.98 GHz: 1.81 ms; the ring mode adds 2*R*N*C integer adds
// of the coupling.  The bytes are small: the planes are (1+nb)*N*Nw*4 B =
// 1.0 MB at K2000, the state a few MB.  Operations bound it, and the
// popcount pipe is the scarce unit: per word and trial a thread issues one
// LOP3 (XNOR-AND), one POPC and one add, and POPC issues at a quarter of
// the other two's rate.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py; ab_time.py against the earlier design, one block per 2
// trials): 4.1 ms at K2000 in clusters of 8 (13 groups, 104 blocks;
// earlier 9.3), 2.3x the bound; the ring mode 4.3 ms at 96 trials in rings
// of 8 (96 blocks; one block per ring took 30.6) and 5.3 ms in rings of 16
// (60.3).  The popcount loop runs near the POPC rate of the 104 SMs it
// has; the rest is the update and the cluster barrier of each of the 601
// cycles (PERF.md).
//
// Design.  Every cycle needs all N fields of a trial before the next, so a
// unit of trials (a group of GROUP = 8 trials in the classical mode, the
// last one ragged; a ring of R replicas in the ring mode) is one
// thread-block cluster of CS blocks (CS in 1, 2, 4, 8, 16; ssa_update.py
// chooses it), on a grid of (units * CS, B), launched with
// cudaLaunchKernelEx through plateau_cycle.cuh's cluster helpers.  Block q
// owns a slice of whole 32-column words (plateau::block_slice): it alone
// computes the field rows of its columns for the unit's trials, steps
// their Itanh and noise, and writes their state and best words.
// - Every block keeps the unit's words [Nw][RS] (word w of every trial side
//   by side, RS = the trials rounded up to 8: two 16-byte shared loads give
//   word w of a pass of 8 trials), double-buffered.  Each word of the
//   planes a thread reads serves the 8 trials of a pass.  New words are
//   warp ballots over the warp's 32 columns (tail bits 0), pushed as 32
//   bytes into every peer's next buffer through distributed shared memory;
//   cluster.sync() closes the cycle, and nothing of cycle c+1 is visible
//   before it.  In cycle c+1 a peer writes only its own words of my old
//   buffer, which my fold of cycle c does not read; my fold's copy of my
//   own words ends in a block barrier before my warps overwrite them.
// - Three variants of the block, by what fits its shared memory (the
//   wrapper takes the first that fits, by repro_popcount_smem, never on
//   failure).  RESIDENT: the block's slice of the planes, [1+nb][Nw]
//   [32*nwq] (129 KB at K2000 in clusters of 8), and the Itanh and four
//   lane words of its columns (20 B per trial and column) are copied into
//   shared memory once, in the prologue (cp.async), and the state is
//   written back once, in the epilogue: the chain touches no global memory
//   but the schedules.  STREAMED (CS <= 4 at K2000, large N*nb, rings of
//   32): the same loop with the planes read from global memory ([Nw][N]
//   per plane, so a warp's loads of word w fall on 128 consecutive bytes)
//   and the state in the output tensors, updated in place each cycle.
//   GLOBAL (where even the unit's words do not fit: above ~74,600 spins for
//   a group of 8): the unit's words too live in global memory, one copy
//   per cluster, read through L2 (ld.global.cg) after the barrier, and the
//   best words in the output; shared memory holds only the fixed part, so
//   N is bounded by the device's memory alone.
// - Inside a block, THREADS threads own one column each (CT column threads,
//   a power of two covering the widest slice) and split the words into
//   THREADS / CT ranges when the slice is narrower than the block; the
//   ranges' partial counts meet in shared memory before the update.
// - The energy fold: each block sums its columns' share of h.m + m.field per
//   trial and writes it into every peer's [parity][CS][UT] array (UT: the
//   unit's trials, 8 or the ring's R, any size; its warps take a trial
//   each in turn);
//   after the barrier every block adds the CS shares in rank order, so H,
//   the running best and the "better" flags are the same in every block.
// - Idle trials of a ragged last group read as -1 (their words are 0);
//   nothing of theirs is read, written or folded, and they are never better.
#include "plateau_cycle.cuh"
#include "ring.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using plateau::GROUP;
using plateau::MAX_CS;
using plateau::Slice;
using plateau::THREADS;
using plateau::WARPS;
using plateau::warp_sum;

static_assert(RING_G == GROUP, "a ring pass is one group of trials");

// The word ranges' partial counts, in ints; a block's shared memory starts
// with its per-trial arrays (Layout::HEAD) and these.
constexpr int WORK_INTS = THREADS * GROUP;

// What a block keeps in shared memory, most first; the wrapper takes the
// first that fits (ssa_update.POPCOUNT_VARIANTS, in this order).
enum Variant : int {
  RESIDENT = 0,  // the unit's words, the slice's best words, planes and state
  STREAMED = 1,  // the unit's words and the slice's best words
  GLOBAL = 2,    // neither: the words in ChainArgs::words, the best words in bmp_out
};

// What the kernel is given.  Pointers start at the tensors' origins.
struct ChainArgs {
  const uint32_t* mp_in;
  const int* it_in;
  const uint32_t* signT;  // (B, Nw, N): each plane stored [Nw][N]
  const uint32_t* magsT;  // (B, nb, Nw, N)
  const int* base;
  const int* h;
  const uint32_t* rng_in;
  const int* i0_sched;
  const int* jperp_sched;  // ring mode only
  const int* fold_sched;
  const int* bh_in;
  const uint32_t* bmp_in;
  uint32_t* mp_out;
  int* it_out;
  uint32_t* rng_out;
  int* bh_out;
  uint32_t* bmp_out;
  uint32_t* words;  // GLOBAL: the units' words, [B][units][2][Nw][RS]
  int T, N, nb, n_cycles, n_rnd;
  int UT;  // trials per unit: GROUP, or the ring's R
  int CT;  // column threads
};

// Shared-memory layout of a block, in 32-bit words from the start.  HEAD:
// the unit's per-trial arrays, sized by its UT trials (any ring size) and
// rounded up to 16 bytes: the running best energies and flags [UT], the
// per-warp energy shares [UT][WARPS] and the cluster's shares by parity
// [2][cs][UT].
struct Layout {
  int Nw, NWQ, NC, UT, RS, HEAD;
  __host__ __device__ Layout(int N, int cs, int ut)
      : Nw((N + 31) >> 5), NWQ(0), NC(0), UT(ut), RS((ut + GROUP - 1) / GROUP * GROUP),
        HEAD((ut * (2 + WARPS + 2 * cs) + 3) / 4 * 4) {
    NWQ = (Nw + cs - 1) / cs;  // the most words a block owns
    NC = 32 * NWQ;
  }
  __host__ __device__ size_t spins() const { return HEAD + WORK_INTS; }  // [2][Nw][RS]
  __host__ __device__ size_t best() const { return spins() + 2 * (size_t)Nw * RS; }
  __host__ __device__ size_t planes() const {  // after the best words [UT][NWQ], 16-B aligned
    return best() + ((size_t)UT * NWQ + 3) / 4 * 4;
  }
  __host__ __device__ size_t state(int nb) const {  // Itanh [UT][NC], lanes [4][UT][NC]
    return planes() + (size_t)(1 + nb) * Nw * NC;
  }
  __host__ __device__ size_t bytes(int nb, int v) const {
    return 4 * (v == RESIDENT ? state(nb) + 5 * (size_t)UT * NC
                : v == STREAMED ? planes()
                                : spins());
  }
  // 32-bit words of ChainArgs::words for `units` units of B problems (GLOBAL).
  __host__ __device__ size_t global_words(int units, int B) const {
    return (size_t)B * units * 2 * Nw * RS;
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A unit's spin words: from shared memory, or (GW) from global memory
// through L2, where a peer's stores of the last cycle are.
template <bool GW>
__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) {
  if constexpr (GW) return __ldcg(p);
  return *p;
}

template <bool GW>
__device__ __forceinline__ uint4 ld_words4(const uint32_t* p) {
  if constexpr (GW) return __ldcg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// acc[t] += the popcount field's count of words [wb, we) for trial g + t
// of column u: sign words at sg[w * pw], magnitude plane p at mg[p * pp +
// w * pw], the unit's spin words at s[w * RS + g + t].  With NB = 1 the
// plane loop has a constant trip count and unrolls.
template <int NB, bool GW>
__device__ __forceinline__ void count_words(int (&acc)[GROUP], const uint32_t* sg,
                                            const uint32_t* mg, size_t pw, size_t pp, int nb,
                                            const uint32_t* s, int RS, int g, int wb, int we) {
#pragma unroll 4
  for (int w = wb; w < we; ++w) {
    const uint32_t sw = sg[w * pw];
    const uint4 m0 = ld_words4<GW>(s + w * RS + g);
    const uint4 m1 = ld_words4<GW>(s + w * RS + g + 4);
    const uint32_t x[GROUP] = {~(m0.x ^ sw), ~(m0.y ^ sw), ~(m0.z ^ sw), ~(m0.w ^ sw),
                               ~(m1.x ^ sw), ~(m1.y ^ sw), ~(m1.z ^ sw), ~(m1.w ^ sw)};
    for (int p = 0; p < (NB ? NB : nb); ++p) {
      const uint32_t mk = mg[p * pp + w * pw];
#pragma unroll
      for (int t = 0; t < GROUP; ++t) acc[t] += __popc(x[t] & mk) << p;
    }
  }
}

// The chain of one unit on this block's cluster.  NB is the number of
// magnitude planes when it is known at compile time (1: every
// +-1-weight instance), 0 when it is taken from a.nb; V the Variant.
template <int NB, bool RING, int V>
__device__ __forceinline__ void run_chain(const ChainArgs& a) {
  constexpr bool RES = V == RESIDENT, GW = V == GLOBAL;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int nb = NB ? NB : a.nb;
  const int N = a.N, UT = a.UT, CT = a.CT;
  const Layout L(N, CS, UT);
  const int Nw = L.Nw, RS = L.RS, NC = L.NC;
  const Slice sl = plateau::block_slice(N, CS, q);
  const int ncols = sl.c_hi - sl.c_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / CS) * UT;  // the unit's first trial
  const int nt = min(UT, a.T - t0);       // its live trials; the rest are idle
  const size_t RN = (size_t)a.T * N;
  const size_t row0 = (size_t)b * a.T + t0;
  const size_t lane0 = (size_t)b * 4 * RN + (size_t)t0 * N;
  const int nwb = sl.nwq;  // this block's words

  extern __shared__ __align__(16) uint32_t smem[];
  int* bh_s = reinterpret_cast<int*>(smem);  // [UT]
  int* better_s = bh_s + UT;                 // [UT]
  int* eps = better_s + UT;                  // [UT][WARPS]
  int* part = eps + UT * WARPS;              // [2][CS][UT]
  int* work = reinterpret_cast<int*>(smem) + L.HEAD;  // [WORK_INTS]
  // The unit's words [Nw][RS] (bit k = column 32w+k), double-buffered: a
  // copy in every block, or (GW) one in global memory for the cluster.
  // The best words of this block's slice: trial t's at best_w[t * bst].
  uint32_t* s_cur;
  uint32_t* best_w;
  int bst;
  if (GW) {
    s_cur = a.words + ((size_t)b * (gridDim.x / CS) + blockIdx.x / CS) * 2 * Nw * RS;
    best_w = a.bmp_out + row0 * Nw + sl.w_lo;
    bst = Nw;
  } else {
    s_cur = smem + L.spins();
    best_w = smem + L.best();
    bst = nwb;
  }
  uint32_t* s_nxt = s_cur + (size_t)Nw * RS;

  // Where the planes and the state of this block's columns live: shared
  // memory (RES) or global memory.  Column u of the slice is index u.
  const uint32_t* sgn;  // word w of the sign plane at sgn[w * pw]
  const uint32_t* mag;  // plane p, word w at mag[p * pp + w * pw]
  size_t pw, pp;
  int* its;        // Itanh of trial t at its[t * ts]
  uint32_t* lns;   // lane l of trial t at lns[l * ls + t * ts]
  size_t ts, ls;
  const uint32_t* sg_g = a.signT + (size_t)b * Nw * N + sl.c_lo;
  const uint32_t* mg_g = a.magsT + (size_t)b * nb * Nw * N + sl.c_lo;
  if (RES) {
    uint32_t* pl = smem + L.planes();
    its = reinterpret_cast<int*>(smem + L.state(nb));
    lns = reinterpret_cast<uint32_t*>(its) + (size_t)UT * NC;
    sgn = pl;
    mag = pl + (size_t)Nw * NC;
    pw = NC;
    pp = (size_t)Nw * NC;
    ts = NC;
    ls = (size_t)UT * NC;
  } else {
    its = a.it_out + row0 * N + sl.c_lo;
    lns = a.rng_out + lane0 + sl.c_lo;
    sgn = sg_g;
    mag = mg_g;
    pw = N;
    pp = (size_t)Nw * N;
    ts = N;
    ls = RN;
  }

  // Prologue: the unit's words (idle trials 0; GW: this block's words of
  // the cluster's copy), this block's best words, and its columns' planes
  // and state, to shared memory (RES) or the state copied to the outputs,
  // where the cycles update it.
  const int w_first = GW ? sl.w_lo : 0, n_own = GW ? nwb : Nw;
  for (int e = tid; e < n_own * RS; e += THREADS) {
    const int w = w_first + e / RS, t = e % RS;
    s_cur[w * RS + t] = t < nt ? a.mp_in[(row0 + t) * Nw + w] : 0u;
    s_nxt[w * RS + t] = 0u;
  }
  for (int e = tid; e < nt * nwb; e += THREADS)
    best_w[(e / nwb) * bst + e % nwb] = a.bmp_in[(row0 + e / nwb) * Nw + sl.w_lo + e % nwb];
  for (int t = tid; t < UT; t += THREADS) bh_s[t] = t < nt ? a.bh_in[row0 + t] : 0;
  if (RES) {
    uint32_t* pl = smem + L.planes();
    for (int p = 0; p <= nb; ++p) {
      const uint32_t* src = p == 0 ? sg_g : mg_g + (size_t)(p - 1) * Nw * N;
      for (int e = tid; e < Nw * NC; e += THREADS) {
        const int w = e / NC, u = e % NC;
        uint32_t* dst = pl + (size_t)p * Nw * NC + e;
        if (u < ncols)
          cp_async4(dst, src + (size_t)w * N + u);
        else
          *dst = 0u;
      }
    }
    for (int e = tid; e < nt * ncols; e += THREADS) {
      const int t = e / ncols, u = e % ncols;
      cp_async4(its + t * ts + u, a.it_in + (row0 + t) * N + sl.c_lo + u);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        cp_async4(lns + l * ls + t * ts + u, a.rng_in + lane0 + l * RN + (size_t)t * N + sl.c_lo + u);
    }
    cp_async_wait_all();
  } else {
    for (int e = tid; e < nt * ncols; e += THREADS) {
      const size_t t = e / ncols, u = e % ncols;
      its[t * ts + u] = a.it_in[(row0 + t) * N + sl.c_lo + u];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        lns[l * ls + t * ts + u] = a.rng_in[lane0 + l * RN + t * N + sl.c_lo + u];
    }
  }
  cluster.sync();  // every block runs before any writes into a peer

  const int KG = THREADS / CT, kg = tid / CT, ct = tid % CT;
  const int wb = kg * Nw / KG, we = (kg + 1) * Nw / KG;  // this thread's word range
  const int* hb = a.h + (size_t)b * N;
  const int* bs = a.base + (size_t)b * N;
  // The schedules of the next cycle, loaded a cycle ahead.
  int fold_n = a.fold_sched[0];
  int i0_n = a.n_cycles > 0 ? a.i0_sched[0] : 0;
  int jp_n = RING && a.n_cycles > 0 ? a.jperp_sched[0] : 0;

  for (int c = 0; c <= a.n_cycles; ++c) {
    const bool last = (c == a.n_cycles);  // the epilogue field: no update
    const bool fold = fold_n > 0;
    if (last && !fold) break;
    const int i0 = i0_n, jperp = jp_n;
    if (!last) {
      fold_n = a.fold_sched[c + 1];
      if (c + 1 < a.n_cycles) {
        i0_n = a.i0_sched[c + 1];
        if (RING) jp_n = a.jperp_sched[c + 1];
      }
    }
    const int par = c & 1;
    for (int g = 0; g < UT; g += GROUP) {  // a pass of 8 trials (one, classical)
      int ep[GROUP];
#pragma unroll
      for (int t = 0; t < GROUP; ++t) ep[t] = 0;
      for (int tile = sl.c_lo; tile < sl.c_hi; tile += CT) {
        const int j0 = tile + (ct & ~31);  // the warp's first column: a word of the slice
        const bool live = j0 < sl.c_hi;    // the same for the whole warp
        const int u = tile - sl.c_lo + ct, j = tile + ct;
        const bool valid = j < sl.c_hi;
        int acc[GROUP];
#pragma unroll
        for (int t = 0; t < GROUP; ++t) acc[t] = 0;
        int hj = 0, cj = 0;
        if (valid) {
          if (kg == 0) {
            hj = hb[j];
            cj = hj + bs[j];
          }
          count_words<NB, GW>(acc, sgn + u, mag + u, pw, pp, nb, s_cur, RS, g, wb, we);
        }
        if (KG > 1) {  // the word ranges' partial counts meet
#pragma unroll
          for (int t = 0; t < GROUP; ++t) work[(kg * GROUP + t) * CT + ct] = acc[t];
          __syncthreads();
          if (kg == 0) {
            for (int p = 1; p < KG; ++p)
#pragma unroll
              for (int t = 0; t < GROUP; ++t) acc[t] += work[(p * GROUP + t) * CT + ct];
          }
        }
        if (kg == 0 && live) {
          const uint32_t* wj = s_cur + (j0 >> 5) * RS;  // the words of columns j0 .. j0+31
          // The lanes and Itanh of (trial, column j).  From global memory
          // (streamed) those of the pass's 8 trials are all loaded before
          // any store, so the loads overlap; from shared memory (RES) each
          // trial's as it is updated, which measured faster on an H100.
          uint32_t xs[GROUP], ys[GROUP], zs[GROUP], ws[GROUP];
          int itv[GROUP];
          auto load_state = [&](int t) {
            const size_t l = (size_t)(g + t) * ts + u;
            xs[t] = lns[l];
            ys[t] = lns[l + ls];
            zs[t] = lns[l + 2 * ls];
            ws[t] = lns[l + 3 * ls];
            itv[t] = its[l];
          };
          if (!RES) {
#pragma unroll
            for (int t = 0; t < GROUP; ++t)
              if (!last && valid && g + t < nt) load_state(t);
          }
          uint32_t words[GROUP];
#pragma unroll
          for (int t = 0; t < GROUP; ++t) {
            const int k = g + t;  // the trial of the unit
            const int f = cj + 2 * acc[t];
            const bool on = valid && k < nt;
            if (fold && on) ep[t] += (((ld_word<GW>(wj + k) >> lane) & 1u) ? 1 : -1) * (hj + f);
            bool up = false;
            if (!last && on) {
              if (RES) load_state(t);
              const size_t l = (size_t)k * ts + u;
              const uint32_t tt = xs[t] ^ (xs[t] << 11);
              const uint32_t wn = (ws[t] ^ (ws[t] >> 19)) ^ (tt ^ (tt >> 8));
              lns[l] = ys[t];
              lns[l + ls] = zs[t];
              lns[l + 2 * ls] = ws[t];
              lns[l + 3 * ls] = wn;
              const int r = (wn >> 31) ? 1 : -1;
              int coup = 0;
              if (RING) {
                const int kp = k == 0 ? UT - 1 : k - 1, kn = k == UT - 1 ? 0 : k + 1;
                coup = (((ld_word<GW>(wj + kp) >> lane) & 1u) ? 1 : -1) +
                       (((ld_word<GW>(wj + kn) >> lane) & 1u) ? 1 : -1);
              }
              const int I = min(max(f + jperp * coup + a.n_rnd * r + itv[t], -i0), i0 - 1);
              its[l] = I;
              up = I >= 0;
            }
            words[t] = __ballot_sync(0xffffffffu, up);
          }
          const uint4 w0 = make_uint4(words[0], words[1], words[2], words[3]);
          const uint4 w1 = make_uint4(words[4], words[5], words[6], words[7]);
          if (GW) {  // the pass's 8 words of this word index, to the cluster's copy
            if (!last && lane == 0) {
              uint4* dst = reinterpret_cast<uint4*>(s_nxt + (j0 >> 5) * RS + g);
              __stcg(dst, w0);
              __stcg(dst + 1, w1);
            }
          } else if (!last && lane < CS) {  // ... to peer `lane`
            uint4* dst = reinterpret_cast<uint4*>(
                cluster.map_shared_rank(s_nxt + (j0 >> 5) * RS + g, lane));
            dst[0] = w0;
            dst[1] = w1;
          }
        }
        if (KG > 1) __syncthreads();  // `work` is free for the next tile
      }
      if (fold) {
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          const int v = warp_sum(ep[t]);
          if (lane == 0 && g + t < UT) eps[(g + t) * WARPS + warp] = v;
        }
      }
    }

    if (fold) {
      __syncthreads();
      for (int t = warp; t < UT; t += WARPS) {  // this block's share of trial t, to every peer
        const int v = warp_sum(lane < WARPS ? eps[t * WARPS + lane] : 0);
        if (lane < CS) *cluster.map_shared_rank(part + (par * CS + q) * UT + t, lane) = v;
      }
    }
    cluster.sync();  // cycle c+1's words and the energy shares are everywhere
    if (fold) {
      for (int t = tid; t < UT; t += THREADS) {
        int v = 0;
        for (int p = 0; p < CS; ++p) v += part[(par * CS + p) * UT + t];
        const int H = -v / 2;  // the sum is even: exact
        const int better = t < nt && H < bh_s[t];
        if (better) bh_s[t] = H;
        better_s[t] = better;
      }
      __syncthreads();
      bool copied = false;
      for (int t = 0; t < nt; ++t) {
        if (better_s[t]) {
          for (int w = tid; w < nwb; w += THREADS)
            best_w[t * bst + w] = ld_word<GW>(s_cur + (sl.w_lo + w) * RS + t);
          copied = true;
        }
      }
      // Read before cycle c+1's words overwrite this buffer (the same for
      // every thread: better_s is shared).
      if (copied) __syncthreads();
    }
    if (!last) {
      uint32_t* tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = tmp;
    }
  }

  // Epilogue: this block's words and best words, and (RES) its state.
  __syncthreads();
  for (int e = tid; e < nt * nwb; e += THREADS) {
    const int t = e / nwb, w = e % nwb;
    a.mp_out[(row0 + t) * Nw + sl.w_lo + w] = ld_word<GW>(s_cur + (sl.w_lo + w) * RS + t);
    if (!GW) a.bmp_out[(row0 + t) * Nw + sl.w_lo + w] = best_w[t * bst + w];
  }
  if (q == 0) {
    for (int t = tid; t < nt; t += THREADS) a.bh_out[row0 + t] = bh_s[t];
  }
  if (RES) {
    for (int e = tid; e < nt * ncols; e += THREADS) {
      const size_t t = e / ncols, u = e % ncols;
      a.it_out[(row0 + t) * N + sl.c_lo + u] = its[t * ts + u];
#pragma unroll
      for (int l = 0; l < 4; ++l)
        a.rng_out[lane0 + l * RN + t * N + sl.c_lo + u] = lns[l * ls + t * ts + u];
    }
  }
}

template <int NB, int V>
__global__ void __launch_bounds__(THREADS, 1) popcount_chain_kernel(const ChainArgs a) {
  run_chain<NB, false, V>(a);
}

template <int NB, int V>
__global__ void __launch_bounds__(THREADS, 1) popcount_ring_kernel(const ChainArgs a) {
  run_chain<NB, true, V>(a);
}

using Kernel = void (*)(const ChainArgs);

template <int V>
Kernel kernel_of(bool ring, int nb) {
  if (ring) return nb == 1 ? popcount_ring_kernel<1, V> : popcount_ring_kernel<0, V>;
  return nb == 1 ? popcount_chain_kernel<1, V> : popcount_chain_kernel<0, V>;
}

// The kernel of a mode, plane count and variant; nullptr for a variant
// that is none of Variant's.
Kernel kernel_for(bool ring, int nb, int v) {
  return v == RESIDENT ? kernel_of<RESIDENT>(ring, nb)
       : v == STREAMED ? kernel_of<STREAMED>(ring, nb)
       : v == GLOBAL   ? kernel_of<GLOBAL>(ring, nb)
                       : nullptr;
}

int units_of(int T, int n_replicas) {
  return n_replicas ? T / n_replicas : (T + GROUP - 1) / GROUP;
}

// Column threads of a block: one column each, a power of two of at least a
// warp covering the widest slice, at most THREADS; the rest split the words.
int column_threads(int N, int cs) {
  const int cols = Layout(N, cs, GROUP).NC;
  int ct = 32;
  while (ct < THREADS && ct < cols) ct *= 2;
  return ct;
}

int launch(ChainArgs a, int B, int n_replicas, int cs, int variant, cudaStream_t stream) {
  const bool ring = n_replicas > 0;
  const Kernel kernel = kernel_for(ring, a.nb, variant);
  if (a.nb < 1 || n_replicas < 0 || (ring && a.T % n_replicas) || cs < 1 || cs > MAX_CS ||
      kernel == nullptr || (variant == GLOBAL && a.words == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.UT = ring ? n_replicas : GROUP;
  a.CT = column_threads(a.N, cs);
  const int units = units_of(a.T, n_replicas);
  const size_t smem = Layout(a.N, cs, a.UT).bytes(a.nb, variant);
  cudaError_t e = plateau::cluster_attributes(kernel, smem, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  plateau::cluster_launch_config(&cfg, &attr, units, B, cs, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory of one block of `variant` (n_replicas 0: the
// classical kernel), the one home of the layout: the wrapper picks the
// variant by it.
extern "C" long long repro_popcount_smem(int N, int nb, int n_replicas, int cs, int variant) {
  return static_cast<long long>(
      Layout(N, cs, n_replicas ? n_replicas : GROUP).bytes(nb, variant));
}

// 32-bit words of the `words` buffer that the GLOBAL variant needs for B
// problems of T trials.
extern "C" long long repro_popcount_global_words(int N, int n_replicas, int T, int B) {
  return static_cast<long long>(Layout(N, 1, n_replicas ? n_replicas : GROUP)
                                    .global_words(units_of(T, n_replicas), B));
}

// How many clusters of `cs` blocks the card runs at once, for the
// classical kernel (n_replicas == 0) or the ring mode with rings of
// n_replicas; 0 when none fits.  Negative: a CUDA error code, negated.
extern "C" int repro_popcount_max_clusters(int N, int n_replicas, int nb, int cs, int variant) {
  const Kernel kernel = kernel_for(n_replicas > 0, nb, variant);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int ut = n_replicas ? n_replicas : GROUP;
  return plateau::max_active_clusters(kernel, cs, Layout(N, cs, ut).bytes(nb, variant));
}

extern "C" int repro_ssa_plateau_popcount_ring(
    const void* mp_in, const void* it_in, const void* signT, const void* magsT,
    const void* base, const void* h, const void* rng_in, const void* i0_sched,
    const void* jperp_sched, const void* fold_sched, const void* bh_in, const void* bmp_in,
    void* mp_out, void* it_out, void* rng_out, void* bh_out, void* bmp_out, void* words,
    int B, int T, int N, int nb, int n_cycles, int n_rnd, int n_replicas, int cluster_size,
    int variant, void* stream) {
  if (n_replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ChainArgs a{static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
                    static_cast<const uint32_t*>(signT), static_cast<const uint32_t*>(magsT),
                    static_cast<const int*>(base), static_cast<const int*>(h),
                    static_cast<const uint32_t*>(rng_in), static_cast<const int*>(i0_sched),
                    static_cast<const int*>(jperp_sched), static_cast<const int*>(fold_sched),
                    static_cast<const int*>(bh_in), static_cast<const uint32_t*>(bmp_in),
                    static_cast<uint32_t*>(mp_out), static_cast<int*>(it_out),
                    static_cast<uint32_t*>(rng_out), static_cast<int*>(bh_out),
                    static_cast<uint32_t*>(bmp_out), static_cast<uint32_t*>(words),
                    T, N, nb, n_cycles, n_rnd, 0, 0};
  return launch(a, B, n_replicas, cluster_size, variant, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_ssa_plateau_popcount(
    const void* mp_in, const void* it_in, const void* signT, const void* magsT,
    const void* base, const void* h, const void* rng_in, const void* i0_sched,
    const void* fold_sched, const void* bh_in, const void* bmp_in, void* mp_out,
    void* it_out, void* rng_out, void* bh_out, void* bmp_out, void* words, int B, int R,
    int N, int nb, int n_cycles, int n_rnd, int cluster_size, int variant, void* stream) {
  const ChainArgs a{static_cast<const uint32_t*>(mp_in), static_cast<const int*>(it_in),
                    static_cast<const uint32_t*>(signT), static_cast<const uint32_t*>(magsT),
                    static_cast<const int*>(base), static_cast<const int*>(h),
                    static_cast<const uint32_t*>(rng_in), static_cast<const int*>(i0_sched),
                    nullptr, static_cast<const int*>(fold_sched),
                    static_cast<const int*>(bh_in), static_cast<const uint32_t*>(bmp_in),
                    static_cast<uint32_t*>(mp_out), static_cast<int*>(it_out),
                    static_cast<uint32_t*>(rng_out), static_cast<int*>(bh_out),
                    static_cast<uint32_t*>(bmp_out), static_cast<uint32_t*>(words),
                    R, N, nb, n_cycles, n_rnd, 0, 0};
  return launch(a, B, 0, cluster_size, variant, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
