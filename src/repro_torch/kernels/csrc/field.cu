// K3 — the local field, field = h + m @ J, with an int32 result.
//
// Replaces: src/repro/kernels/ssa_update.py:_field_kernel (wrapper
// local_field), the tiled Pallas matmul with an f32 accumulator.
//
// What bounds it on the H100: at the main path's shape (R = 100 trials,
// N = 2000) it does 2·R·N² = 8.0e8 operations on the float32 CUDA cores
// (67 TFLOP/s: 12 us) and must move R·N·4 + N²·4 + N·4 + R·N·4 bytes
// (17.6 MB at 3.35 TB/s: 5 us), so operations bound it.
//
// Design: a classic shared-memory tiled product.  A block of 256 threads
// owns a 32 (trials) x 64 (spins) output tile and walks K in steps of 32:
// the m tile and the J tile are staged in shared memory (J rows read
// coalesced, converted to float32 on the way in), and each thread keeps a
// 2 x 4 register tile of accumulators.  Every operand is an integer below
// 2^24, so float32 sums are exact in any order and the result is
// bit-identical to the TPU kernel.  The ragged edges (R % 32, N % 64,
// N % 32) are zero-filled on load and masked on store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BR = 32;        // output rows (trials) per block
constexpr int BN = 64;        // output columns (spins) per block
constexpr int BK = 32;        // depth of one staged step
constexpr int THREADS = 256;  // 16 x 16 threads, 2 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename JT>
__global__ void __launch_bounds__(THREADS)
local_field_kernel(const float* __restrict__ m, const JT* __restrict__ J,
                   const int* __restrict__ h, int* __restrict__ out, int R, int N) {
  __shared__ float Ms[BR][BK + 1];
  __shared__ __align__(16) float Js[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * BR, n0 = blockIdx.x * BN;
  float acc[2][4] = {};

  for (int k0 = 0; k0 < N; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BR * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gr = r0 + r, gc = k0 + c;
      Ms[r][c] = (gr < R && gc < N) ? m[(size_t)gr * N + gc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = n0 + c;
      Js[r][c] = (gr < N && gc < N) ? to_f32(J[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = Ms[ty * 2][kk];
      const float a1 = Ms[ty * 2 + 1][kk];
      const float4 b = *reinterpret_cast<const float4*>(&Js[kk][tx * 4]);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < R && c < N) out[(size_t)r * N + c] = __float2int_rz(acc[i][j]) + h[c];
    }
  }
}

}  // namespace

extern "C" int repro_local_field(const void* m, const void* J, const void* h, void* out,
                                 int R, int N, int j_bf16, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (R + BR - 1) / BR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const int* hi = static_cast<const int*>(h);
  int* o = static_cast<int*>(out);
  if (j_bf16) {
    local_field_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        mf, static_cast<const __nv_bfloat16*>(J), hi, o, R, N);
  } else {
    local_field_kernel<float><<<grid, THREADS, 0, s>>>(
        mf, static_cast<const float*>(J), hi, o, R, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
