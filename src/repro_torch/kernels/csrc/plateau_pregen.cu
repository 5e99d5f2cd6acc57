// K4 — one constant-I0 plateau of C cycles of the HA-SSA spin update with
// pregenerated noise, in one launch, for B problems x R trials.
//
// Replaces: src/repro/kernels/ssa_update.py:_plateau_kernel (wrappers
// ssa_plateau_batched / ssa_plateau).  Per cycle c: field = m @ J + h; at
// c >= 1, when `eligible`, fold H = -(h.m + m.field)/2 into the running
// best (strict <, so the first minimum is kept); Itanh = clamp(field +
// n_rnd*noise[c] + Itanh, -I0, I0-1); m = sign(Itanh).  After the loop one
// more field folds the final state.  State is dense: m float32 +-1, best_m
// int8 +-1, noise a (B, C, R, N) int8 +-1 buffer drawn before the launch.
//
// What bounds it on the H100: the arithmetic is 2·R·N²·(C+1) operations
// (8.1e10 at K2000: N = 2000, R = 100, C = 100), 1.2 ms at the float32
// CUDA-core peak of 67 TFLOP/s; the bytes it must move are J once, the
// state in and out and the noise buffer (R·N bytes a cycle, 20 MB at
// K2000), ~47 MB, 14 us at 3.35 TB/s.  Operations bound it in principle.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): about 4.1 ms at
// K2000 in clusters of 8 (104 blocks), as long as K1: the noise bytes are
// not what binds it.
//
// Design: K1's (plateau.cu), with the noise read instead of generated: the
// cycle loop is plateau_cycle.cuh's, a thread-block cluster per group of
// GROUP = 8 trials, J's columns split over its blocks, the group's spins
// exchanged through distributed shared memory as one word per column.
// This file supplies its IO: the spins come in and leave as floats, the
// block that owns a column reads its noise, one coalesced byte per (trial,
// column) and cycle, and writes its Itanh and best spins (int8) in the
// output tensors as they change.
#include "plateau_cycle.cuh"

#include <cstdint>

namespace {

using plateau::GROUP;
using plateau::Slice;
using plateau::THREADS;
using plateau::WORK;

// The group's dense spins, its noise read from the (C, R, N) buffer of the
// problem, its running best spins written to the int8 output as they
// improve.  Pointers start at the group's first trial (cycle 0 for the
// noise); rows N apart, cycles RN apart.
struct PregenIO {
  const float* m_in;
  float* m_out;
  const int8_t* buf;
  const int8_t* bm_in;
  int8_t* bm_out;
  size_t RN;
  int N, nt;

  __device__ __forceinline__ uint32_t spins(int j) const {
    uint32_t word = 0;
    for (int t = 0; t < nt; ++t) word |= (uint32_t)(m_in[(size_t)t * N + j] > 0.f) << t;
    return word;
  }

  __device__ __forceinline__ void begin(const Slice& sl, uint32_t*) {
    for (int j = sl.c_lo + threadIdx.x; j < sl.c_hi; j += THREADS) {
      for (int t = 0; t < nt; ++t) bm_out[(size_t)t * N + j] = bm_in[(size_t)t * N + j];
    }
  }

  __device__ __forceinline__ void noise(int j, int c, int (&r)[GROUP]) const {
    const int8_t* p = buf + (size_t)c * RN + j;
#pragma unroll
    for (int t = 0; t < GROUP; ++t)
      if (t < nt) r[t] = p[(size_t)t * N];
  }

  __device__ __forceinline__ void store_best(int t, const uint32_t* s, const Slice& sl) {
    for (int j = sl.c_lo + threadIdx.x; j < sl.c_hi; j += THREADS)
      bm_out[(size_t)t * N + j] = ((s[j] >> t) & 1u) ? 1 : -1;
  }

  __device__ __forceinline__ void finish(const uint32_t* s, const Slice& sl) {
    for (int j = sl.c_lo + threadIdx.x; j < sl.c_hi; j += THREADS) {
      for (int t = 0; t < nt; ++t) m_out[(size_t)t * N + j] = ((s[j] >> t) & 1u) ? 1.f : -1.f;
    }
  }
};

template <typename JT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
plateau_pregen_kernel(const float* __restrict__ m_in, const int* __restrict__ it_in,
                      const JT* __restrict__ J, const int* __restrict__ h,
                      const int8_t* __restrict__ noise, int i0,
                      const int* __restrict__ bh_in, const int8_t* __restrict__ bm_in,
                      float* __restrict__ m_out, int* __restrict__ it_out,
                      int* __restrict__ bh_out, int8_t* __restrict__ bm_out, int R, int N,
                      int n_cycles, int n_rnd, int eligible, int CT) {
  const int CS = (int)cooperative_groups::this_cluster().num_blocks();
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / CS) * GROUP;  // the group's first trial
  const int nt = min(GROUP, R - t0);          // its live trials; the rest are idle
  const size_t RN = (size_t)R * N;
  const size_t row0 = (size_t)b * R + t0;
  PregenIO io{m_in + row0 * N, m_out + row0 * N,
              noise + (size_t)b * n_cycles * RN + (size_t)t0 * N, bm_in + row0 * N,
              bm_out + row0 * N, RN, N, nt};
  plateau::run_group<JT, VEC>(io, J + (size_t)b * N * N, h + (size_t)b * N, it_in + row0 * N,
                              it_out + row0 * N, bh_in + row0, bh_out + row0, nt, N, i0,
                              n_cycles, n_rnd, eligible, CT);
}

// Shared memory of a block: the work area and the group's two spin buffers.
size_t pregen_smem(int N) { return sizeof(float) * WORK + sizeof(uint32_t) * 2 * (size_t)N; }

template <typename JT, bool VEC>
int launch(const void* m_in, const void* it_in, const void* J, const void* h,
           const void* noise, int i0, const void* bh_in, const void* bm_in, void* m_out,
           void* it_out, void* bh_out, void* bm_out, int B, int R, int N, int n_cycles,
           int n_rnd, int eligible, int cs, cudaStream_t stream) {
  auto kernel = plateau_pregen_kernel<JT, VEC>;
  const size_t smem = pregen_smem(N);
  cudaError_t e = plateau::cluster_attributes(kernel, smem, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  plateau::cluster_launch_config(&cfg, &attr, (R + GROUP - 1) / GROUP, B, cs, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(m_in),
                         static_cast<const int*>(it_in), static_cast<const JT*>(J),
                         static_cast<const int*>(h), static_cast<const int8_t*>(noise), i0,
                         static_cast<const int*>(bh_in), static_cast<const int8_t*>(bm_in),
                         static_cast<float*>(m_out), static_cast<int*>(it_out),
                         static_cast<int*>(bh_out), static_cast<int8_t*>(bm_out), R, N,
                         n_cycles, n_rnd, eligible, plateau::column_threads(N, cs));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of `cs` blocks the card runs at once, J of type `j_type`
// (jtype.cuh); 0 when none fits.  Negative: a CUDA error code, negated.
extern "C" int repro_plateau_pregen_max_clusters(int N, int cs, int j_type) {
  const bool vec = N % 4 == 0;
  return jtype::dispatch(j_type, -static_cast<int>(cudaErrorInvalidValue), [&](auto tag) {
    using JT = typename decltype(tag)::type;
    return plateau::max_active_clusters(
        vec ? plateau_pregen_kernel<JT, true> : plateau_pregen_kernel<JT, false>, cs,
        pregen_smem(N));
  });
}

extern "C" int repro_ssa_plateau(const void* m_in, const void* it_in, const void* J,
                                 const void* h, const void* noise, int i0, const void* bh_in,
                                 const void* bm_in, void* m_out, void* it_out, void* bh_out,
                                 void* bm_out, int B, int R, int N, int n_cycles, int n_rnd,
                                 int eligible, int j_type, int cluster_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (cluster_size < 1 || cluster_size > plateau::MAX_CS) return invalid;
  return jtype::dispatch(j_type, invalid, [&](auto tag) {
    using JT = typename decltype(tag)::type;
    auto run = plateau::vector_loads<JT>(N, J) ? launch<JT, true> : launch<JT, false>;
    return run(m_in, it_in, J, h, noise, i0, bh_in, bm_in, m_out, it_out, bh_out, bm_out, B, R,
               N, n_cycles, n_rnd, eligible, cluster_size, s);
  });
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
