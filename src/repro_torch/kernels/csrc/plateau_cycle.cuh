// The cycle loop of the two classical plateau kernels, K1 (plateau.cu:
// noise stepped in-kernel, packed spins) and K4 (plateau_pregen.cu: noise
// read from a pregenerated buffer, dense spins), and what K1's SSQA ring
// mode (plateau.cu, ring_kernel) shares with it: the sign table, the wide
// loads of J and the cluster launch.
//
// Per cycle c: field = m @ J + h; at c >= 1, when `eligible`, fold H =
// -(h.m + m.field)/2 into the running best (strict <: the first minimum
// is kept); Itanh = clamp(field + n_rnd*r + Itanh, -I0, I0-1); m =
// sign(Itanh).  After the loop one more field folds the final state.
//
// Exactness: J, h and the spins are integers, and every partial sum of a
// field is an integer below 2^24 in magnitude, so the float32 sums (J of
// any of jtype.cuh's types, widened on load) are exact in any order; the energy is
// reduced in int32, exact too (the sum is even and far below 2^31).
//
// Design.  A group of GROUP trials of one problem is one thread-block
// cluster of CS blocks (CS in 1, 2, 4, 8, 16; ssa_update.py chooses it),
// on a grid of (ceil(R / GROUP) * CS, B); the trials of a ragged last
// group past R are idle: their spins read as -1, nothing of theirs is
// written.  Block q of the cluster owns a slice of whole 32-column words
// (Nw split as evenly as possible): it alone computes their field for the
// group's trials over every k, steps their Itanh and their noise, and
// writes their state and best.  Every block keeps the group's spins of
// every column j as the bits of one word (bit t = trial t, 1 = +1),
// double-buffered; after its update a block writes its new words into the
// next buffer of every block of the cluster through distributed shared
// memory, and cluster.sync() closes the cycle: nothing of cycle c+1 is
// visible before it.  In cycle c+1 a peer writes only its own columns of
// my old buffer, which my fold of cycle c does not read.  The energy fold:
// each block sums its columns' share of h.m + m.field per trial and writes
// it into every peer's [parity][CS][GROUP] array; after the barrier every
// block adds the CS shares in rank order, so H, the running best and the
// "better" flags are the same in every block.
//
// Inside a block, THREADS threads split the block's columns (4 a thread,
// CT threads across a column tile) and k (THREADS / CT k-ranges); the
// k-ranges' partial fields meet in shared memory before the update.  Where
// N % 4 == 0 a thread's 4 columns are neighbours, read with one 16-byte
// load per k; otherwise they are CT apart.  The sign of trial t at k is
// read as +-1.0f from a table built once per chunk of KC k from the spin
// words, so each term is one fma.
//
// The kernel supplies what differs as an `IO` object; `Slice` is the
// block's columns:
//   uint32_t io.spins(int j)      the group's spins of column j as a word,
//                                 from the inputs (prologue, every j);
//   void io.begin(sl, extra)      the prologue of the block's columns:
//                                 carried state to the outputs (all
//                                 threads; `extra` is its shared memory);
//   void io.noise(j, c, r)        the +-1 noise r[t] of trials t < nt at
//                                 column j, cycle c (the owning thread,
//                                 once per (j, c), in cycle order);
//   void io.store_best(t, s, sl)  trial t improved: its spins, bit t of
//                                 s[j], to the best store of the block's
//                                 columns (all threads);
//   void io.finish(s, sl)         the final spins and best of the block's
//                                 columns to the outputs (all threads).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "jtype.cuh"

namespace plateau {

// Trials per group in the classical kernels, and spins per sign-table row.
constexpr int GROUP = 8;
// Threads per block of the cluster kernels; 256 leave each thread up to
// 255 registers for its 32 accumulators and 8 unrolled k steps.
constexpr int THREADS = 256;
// Blocks per cluster at most (16 is a non-portable size on Hopper).
constexpr int MAX_CS = 16;
// k per sign-table chunk.
constexpr int KC = 2048;

constexpr int WARPS = THREADS / 32;
constexpr int WORK = KC * GROUP;  // floats: the sign table, or the k-range partials
static_assert(WORK >= 4 * GROUP * THREADS, "k-range partials fit the table");
static_assert(GROUP == 8, "a sign-table row is two float4");

using jtype::load4;
using jtype::to_f32;
using jtype::vector_loads;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Bit t of w as +-1.0f (1 = +1).
__device__ __forceinline__ float sign_of(uint32_t w, int t) {
  return __int_as_float(0xbf800000u ^ (((w >> t) & 1u) << 31));
}

// The sign table of a chunk of kn k: row k holds bits shift .. shift + 7
// of s[k] as +-1.0f (two 16-byte shared-memory broadcasts per k for its
// readers).  `gw`: s lies in global memory, written by the cluster's other
// blocks before its barrier, and is read through L2.  Called by the whole
// block.
__device__ __forceinline__ void sign_table(float* work, const uint32_t* s, int kn, int shift,
                                           bool gw = false) {
  for (int k = threadIdx.x; k < kn; k += THREADS) {
    const uint32_t w = (gw ? __ldcg(s + k) : s[k]) >> shift;
    float4* p = reinterpret_cast<float4*>(work + k * GROUP);
    p[0] = make_float4(sign_of(w, 0), sign_of(w, 1), sign_of(w, 2), sign_of(w, 3));
    p[1] = make_float4(sign_of(w, 4), sign_of(w, 5), sign_of(w, 6), sign_of(w, 7));
  }
}

// The field partials of one column tile of the classical loop: acc[i][t] =
// the sum over this thread's k-range of sign(trial t at k) * J[k][col_i],
// over every chunk of KC k.  Columns: with VEC four neighbours, col + i
// (one vector load per k); otherwise col + i * CT.  Called by the whole
// block.  (The ring mode keeps its own copy of this loop, with the pass's
// shift: sharing it moved the ring's time by 1% on an H100.)
template <typename JT, bool VEC>
__device__ __forceinline__ void tile_field(float (&acc)[4][GROUP], float* work,
                                           const uint32_t* s, const JT* __restrict__ Jb,
                                           int N, int col, const bool (&ok)[4], int CT) {
  const int KG = THREADS / CT, kg = threadIdx.x / CT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < GROUP; ++t) acc[i][t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += KC) {
    const int kn = min(KC, N - k0);
    __syncthreads();  // the previous users of `work` are done
    sign_table(work, s + k0, kn, 0);
    __syncthreads();
    const int kb = kg * kn / KG, ke = (kg + 1) * kn / KG;
    const JT* Jk = Jb + (size_t)(k0 + kb) * N + col;
#pragma unroll 8
    for (int k = kb; k < ke; ++k, Jk += N) {
      const float4 s0 = *reinterpret_cast<const float4*>(work + k * GROUP);
      const float4 s1 = *reinterpret_cast<const float4*>(work + k * GROUP + 4);
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
}

// The block's columns: words [w_lo, w_lo + nwq), columns [c_lo, c_hi).
struct Slice {
  int w_lo, nwq, c_lo, c_hi;
};

__device__ __forceinline__ Slice block_slice(int N, int CS, int q) {
  const int Nw = (N + 31) >> 5;
  const int w_lo = q * Nw / CS, nwq = (q + 1) * Nw / CS - w_lo;
  return Slice{w_lo, nwq, w_lo * 32, min(N, (w_lo + nwq) * 32)};
}

// One plateau of the group (trials t < nt of one problem) on this block's
// cluster.  J and h are the problem's; it_in/it_out, bh_in/bh_out start at
// the group's first trial (Itanh rows N apart).  The dynamic shared memory
// is work[WORK] floats, two spin buffers of N words and the IO's `extra`.
template <typename JT, bool VEC, typename IO>
__device__ __forceinline__ void run_group(IO& io, const JT* __restrict__ J,
                                          const int* __restrict__ h,
                                          const int* __restrict__ it_in, int* __restrict__ it,
                                          const int* __restrict__ bh_in, int* __restrict__ bh_out,
                                          int nt, int N, int i0, int n_cycles, int n_rnd,
                                          int eligible, int CT) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* work = reinterpret_cast<float*>(smem_raw);                  // [WORK]
  uint32_t* s_cur = reinterpret_cast<uint32_t*>(work + WORK);        // [N], bit t = trial t
  uint32_t* s_nxt = s_cur + N;                                        // [N]
  __shared__ int bh_s[GROUP];
  __shared__ int better_s[GROUP];
  __shared__ int eps[GROUP][WARPS];
  __shared__ int part[2][MAX_CS][GROUP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Slice sl = block_slice(N, CS, q);
  const int TW = 4 * CT, ct = tid % CT;

  // Prologue: every column's spins of the group into word j; this block's
  // columns' Itanh (and the IO's state) copied to the outputs, where the
  // cycles update them.
  for (int j = tid; j < N; j += THREADS) s_cur[j] = io.spins(j);
  for (int j = sl.c_lo + tid; j < sl.c_hi; j += THREADS) {
    for (int t = 0; t < nt; ++t) it[(size_t)t * N + j] = it_in[(size_t)t * N + j];
  }
  io.begin(sl, s_nxt + N);
  if (tid < GROUP) bh_s[tid] = tid < nt ? bh_in[tid] : 0;
  cluster.sync();  // every block runs before any writes into a peer

  for (int c = 0; c <= n_cycles; ++c) {
    const bool last = (c == n_cycles);  // the epilogue field: no update
    const bool fold = eligible && (c > 0 || last);
    if (last && !fold) break;
    const int par = c & 1;
    int ep[GROUP];
#pragma unroll
    for (int t = 0; t < GROUP; ++t) ep[t] = 0;
    for (int tile = sl.c_lo; tile < sl.c_hi; tile += TW) {
      const int col = tile + (VEC ? 4 * ct : ct);
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ok[i] = col + (VEC ? i : i * CT) < sl.c_hi;
      float acc[4][GROUP];
      tile_field<JT, VEC>(acc, work, s_cur, J, N, col, ok, CT);
      __syncthreads();  // the table's readers are done: `work` takes the partials
      const int kg = tid / CT, KG = THREADS / CT;
#pragma unroll
      for (int t = 0; t < GROUP; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          work[(kg * GROUP + t) * TW + (VEC ? 4 * ct + i : i * CT + ct)] = acc[i][t];
      __syncthreads();
      for (int u = tid; u < TW && tile + u < sl.c_hi; u += THREADS) {
        const int j = tile + u;
        const int hj = h[j];
        const uint32_t wj = s_cur[j];
        // Itanh and the noise of column j, all loaded before any store.
        int itj[GROUP], r[GROUP];
        if (!last) {
#pragma unroll
          for (int t = 0; t < GROUP; ++t)
            if (t < nt) itj[t] = it[(size_t)t * N + j];
          io.noise(j, c, r);
        }
        uint32_t up = 0;
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          float f = 0.f;
          for (int p = 0; p < KG; ++p) f += work[(p * GROUP + t) * TW + u];
          const int fi = __float2int_rz(f) + hj;
          ep[t] += (((wj >> t) & 1u) ? 1 : -1) * (hj + fi);
          if (!last && t < nt) {
            const int I = min(max(fi + n_rnd * r[t] + itj[t], -i0), i0 - 1);
            it[(size_t)t * N + j] = I;
            up |= (uint32_t)(I >= 0) << t;
          }
        }
        if (!last) {
          for (int p = 0; p < CS; ++p) *cluster.map_shared_rank(s_nxt + j, p) = up;
        }
      }
    }

    if (fold) {
#pragma unroll
      for (int t = 0; t < GROUP; ++t) {
        const int v = warp_sum(ep[t]);
        if (lane == 0) eps[t][warp] = v;
      }
      __syncthreads();
      if (warp == 0) {  // this block's share of each trial's energy, to every peer
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          const int v = warp_sum(lane < WARPS ? eps[t][lane] : 0);
          if (lane < CS) *cluster.map_shared_rank(&part[par][q][t], lane) = v;
        }
      }
    }
    cluster.sync();  // cycle c+1's words and the energy shares are everywhere
    if (fold) {
      if (warp == 0 && lane < GROUP) {
        int v = 0;
        for (int p = 0; p < CS; ++p) v += part[par][p][lane];
        const int H = -v / 2;  // the sum is even: exact
        const int better = lane < nt && H < bh_s[lane];
        if (better) bh_s[lane] = H;
        better_s[lane] = better;
      }
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        if (better_s[t]) io.store_best(t, s_cur, sl);
      }
    }
    if (!last) {
      uint32_t* tmp = s_cur;
      s_cur = s_nxt;
      s_nxt = tmp;
    }
  }

  __syncthreads();
  io.finish(s_cur, sl);
  if (q == 0 && tid < nt) bh_out[tid] = bh_s[tid];
}

// ---------------------------------------------------------------------------
// Host side, shared by the cluster kernels' launches.

// Column threads of a block: its widest slice, 4 columns a thread, a power
// of two of at least a warp; the rest of the threads split k.
inline int column_threads(int N, int cs) {
  const int Nw = (N + 31) / 32;
  const int cols = 32 * ((Nw + cs - 1) / cs);
  int ct = 32;
  while (ct < THREADS && 4 * ct < cols) ct *= 2;
  return ct;
}

// The attributes a cluster launch of `kernel` needs: `smem` bytes of
// dynamic shared memory and, above 8 blocks, the non-portable size.
template <typename K>
cudaError_t cluster_attributes(K kernel, size_t smem, int cs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

inline void cluster_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                                  int n_clusters, int B, int cs, size_t smem,
                                  cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_clusters * cs, B);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of `cs` blocks of `kernel` (`smem` bytes each) the card
// runs at once; 0 when none fits.  Negative: a CUDA error code, negated.
template <typename K>
int max_active_clusters(K kernel, int cs, size_t smem) {
  cudaError_t e = cluster_attributes(kernel, smem, cs);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch_config(&cfg, &attr, 1, 1, cs, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a size that does not fit is an answer, not a fault
    return 0;
  }
  return n;
}

}  // namespace plateau
