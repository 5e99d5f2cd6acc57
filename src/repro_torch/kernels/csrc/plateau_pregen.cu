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
//
// Design: K1's (plateau.cu), with the noise read instead of generated:
// the cycle loop is plateau_cycle.cuh's.  One block per (problem, TR
// trials) streams the whole of J from L2 each cycle; the block's spins
// live in shared memory as floats, double-buffered.  Itanh lives in the
// output tensor and the best spins in theirs, each column touched only by
// the thread that owns it; the noise of cycle c is one coalesced byte per
// (trial, column), read once.
#include "plateau_cycle.cuh"

#include <algorithm>

namespace {

using plateau::DEFAULT_SMEM;
using plateau::MAX_THREADS;

// Noise read from the (C, R, N) buffer of the problem; the running best
// spins written to the int8 output as they improve.
template <int TR>
struct PregenIO {
  const int8_t* buf;  // cycle 0 of the block's first trial
  int8_t* best_m;     // the block's first trial
  size_t RN;
  int N;

  __device__ __forceinline__ int noise(int t, int j, int c) {
    return buf[(size_t)c * RN + (size_t)t * N + j];
  }

  __device__ __forceinline__ void store_best(int t, const float* m) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      best_m[(size_t)t * N + j] = m[j * TR + t] > 0.f ? 1 : -1;
    }
  }
};

template <typename JT, int TR>
__global__ void __launch_bounds__(MAX_THREADS)
plateau_pregen_kernel(const float* __restrict__ m_in, const int* __restrict__ it_in,
                      const JT* __restrict__ J, const int* __restrict__ h,
                      const int8_t* __restrict__ noise, int i0,
                      const int* __restrict__ bh_in, const int8_t* __restrict__ bm_in,
                      float* __restrict__ m_out, int* __restrict__ it_out,
                      int* __restrict__ bh_out, int8_t* __restrict__ bm_out, int R, int N,
                      int n_cycles, int n_rnd, int eligible) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_cur = reinterpret_cast<float*>(smem_raw);  // [N][TR]
  float* m_nxt = m_cur + (size_t)N * TR;              // [N][TR]
  __shared__ int bh_s[TR];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TR;
  const int nt = min(TR, R - t0);  // trials of this block; the rest are idle
  const size_t RN = (size_t)R * N;
  const size_t row0 = (size_t)b * R + t0;  // first (b, trial) row

  // Prologue: spins to shared memory; Itanh and the best spins to the
  // outputs (the thread that owns column j copies it, and is the only one
  // to touch it afterwards).
  for (int j = tid; j < N; j += nthr) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      float s = -1.f;
      if (t < nt) {
        const size_t e = (row0 + t) * N + j;
        s = m_in[e];
        it_out[e] = it_in[e];
        bm_out[e] = bm_in[e];
      }
      m_cur[j * TR + t] = s;
      m_nxt[j * TR + t] = s;
    }
  }
  if (tid < TR) bh_s[tid] = (tid < nt) ? bh_in[row0 + tid] : 0;
  __syncthreads();

  PregenIO<TR> io{noise + (size_t)b * n_cycles * RN + (size_t)t0 * N, bm_out + row0 * N, RN,
                  N};
  m_cur = plateau::run_cycles<JT, TR>(io, m_cur, m_nxt, J + (size_t)b * N * N,
                                      h + (size_t)b * N, it_out + row0 * N, bh_s, nt, N, i0,
                                      n_cycles, n_rnd, eligible);

  for (int j = tid; j < N; j += nthr) {
    for (int t = 0; t < nt; ++t) m_out[(row0 + t) * N + j] = m_cur[j * TR + t];
  }
  if (tid < nt) bh_out[row0 + tid] = bh_s[tid];
}

template <typename JT, int TR>
int launch(const void* m_in, const void* it_in, const void* J, const void* h,
           const void* noise, int i0, const void* bh_in, const void* bm_in, void* m_out,
           void* it_out, void* bh_out, void* bm_out, int B, int R, int N, int n_cycles,
           int n_rnd, int eligible, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)N * TR;
  auto kernel = plateau_pregen_kernel<JT, TR>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + TR - 1) / TR, B);
  const int threads = std::min(MAX_THREADS, (N + 31) / 32 * 32);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(m_in), static_cast<const int*>(it_in),
      static_cast<const JT*>(J), static_cast<const int*>(h),
      static_cast<const int8_t*>(noise), i0, static_cast<const int*>(bh_in),
      static_cast<const int8_t*>(bm_in), static_cast<float*>(m_out),
      static_cast<int*>(it_out), static_cast<int*>(bh_out), static_cast<int8_t*>(bm_out), R,
      N, n_cycles, n_rnd, eligible);
  return static_cast<int>(cudaGetLastError());
}

template <typename JT>
int launch_tr(int tr, const void* m_in, const void* it_in, const void* J, const void* h,
              const void* noise, int i0, const void* bh_in, const void* bm_in, void* m_out,
              void* it_out, void* bh_out, void* bm_out, int B, int R, int N, int n_cycles,
              int n_rnd, int eligible, cudaStream_t s) {
  switch (tr) {
    case 1:
      return launch<JT, 1>(m_in, it_in, J, h, noise, i0, bh_in, bm_in, m_out, it_out, bh_out,
                           bm_out, B, R, N, n_cycles, n_rnd, eligible, s);
    case 2:
      return launch<JT, 2>(m_in, it_in, J, h, noise, i0, bh_in, bm_in, m_out, it_out, bh_out,
                           bm_out, B, R, N, n_cycles, n_rnd, eligible, s);
    case 4:
      return launch<JT, 4>(m_in, it_in, J, h, noise, i0, bh_in, bm_in, m_out, it_out, bh_out,
                           bm_out, B, R, N, n_cycles, n_rnd, eligible, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_ssa_plateau(const void* m_in, const void* it_in, const void* J,
                                 const void* h, const void* noise, int i0, const void* bh_in,
                                 const void* bm_in, void* m_out, void* it_out, void* bh_out,
                                 void* bm_out, int B, int R, int N, int n_cycles, int n_rnd,
                                 int eligible, int j_bf16, int trials_per_block,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (j_bf16) {
    return launch_tr<__nv_bfloat16>(trials_per_block, m_in, it_in, J, h, noise, i0, bh_in,
                                    bm_in, m_out, it_out, bh_out, bm_out, B, R, N, n_cycles,
                                    n_rnd, eligible, s);
  }
  return launch_tr<float>(trials_per_block, m_in, it_in, J, h, noise, i0, bh_in, bm_in, m_out,
                          it_out, bh_out, bm_out, B, R, N, n_cycles, n_rnd, eligible, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
