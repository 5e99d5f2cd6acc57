// K3 — the local field, field = h + m @ J, with an int32 result, on the
// int8 tensor cores.
//
// Replaces: src/repro/kernels/ssa_update.py:_field_kernel (wrapper
// local_field), the tiled Pallas matmul with an f32 accumulator.
//
// Exactness contract (the TPU kernel's, which sums in float32): m is +-1, J
// is integer-valued, and every |J| and every partial sum of a row of m @ J,
// h added, is below 2^24 in magnitude.  Inside it this kernel's int32
// result equals the float32 one bit for bit; it needs no pass over J on the
// host to stay there.
//
// What bounds it on the H100: at the main path's shape (R = 100 trials,
// N = 2000, float32 J) it must move R·N·4 + N²·4 + N·4 + R·N·4 bytes
// (17.6 MB at 3.35 TB/s: 5.3 us).  The product, 2·R·N² = 8.0e8 operations,
// takes 0.4 us at the dense int8 tensor-core rate (1979 TOP/s) with one
// byte plane, so bytes bound it.  Measured on an H100 at 700 W
// (chip_smoke.py): about 0.03 ms, against torch.addmm's 0.047 ms in float32.
// That is ~6x the bound: each block keeps one stage of loads in flight at a
// time, so their latency, not the bytes or the MMAs, most likely sets it.
//
// Design.  m is converted to s8 on load.  J is loaded tile by tile (64 k x
// 128 columns) in its own type (any of jtype.cuh's: 16-, 8- or 4-byte
// vector loads of four values), each value read as an int32 (an int8
// sign-extended, a uint8 zero-extended, a float type truncated, exact: it
// holds an integer), and split into byte planes: plane p
// holds byte p of each value, J = sum_p plane_p · 2^(8p), every plane read
// as u8 except the top one, read as s8.  A tile whose |J| <= 127 everywhere
// needs one s8 plane (every G-set instance, K2000, G11, any int8 J); |J| <
// 2^15 two (a uint8 J of 128-255: a u8 plane under a zero s8 plane; int16),
// |J| < 2^23 three, and any int32 four.  The block decides a tile's count
// with __syncthreads_or over the staged values, so the choice is
// block-uniform, and plane p's int32 partial product is scaled by 2^(8p)
// (in int32, wrapping: the final sum fits, so it is exact).  The products
// run on mma.sync.m16n8k32 (.s32.s8.s8 / .s32.s8.u8).  Both operands lie in
// shared memory with k contiguous, as the fragments want it: J is transposed
// on its way in (a thread reads 4 rows of 4 columns with 16-byte loads, or
// of one column where N % 4 != 0, coalesced across the warp, and
// byte-transposes each column's 4 values into one word per plane), and an
// XOR swizzle of the word index keeps the staging stores and the fragment
// loads (nearly) free of bank conflicts.  Stages are double-buffered through
// registers: the next tile's loads are in flight while the tensor cores
// work on this one.
//
// Filling the card: a block owns 128 rows (8 m16 tiles; rows >= R skipped)
// by 128 columns, and a thread-block cluster of KS blocks (KS <= 8) splits K
// between them.  The wrapper chooses KS by the rule it also applies to K1's
// ring mode (ssa_update._cluster_size): the most, at least one stage each,
// whose clusters all run at once (repro_local_field_max_clusters, the
// occupancy query) with no more blocks than SMs, since a second wave of
// clusters would double the time.  R = 100, N = 2000 runs 16 column tiles
// x 6 = 96 blocks on an H100, where sixteen clusters of 8 do not all fit.
// The KS partial int32 tiles meet in distributed shared memory: each block
// sums a share of the rows over the cluster's blocks in rank order, adds h
// and writes the result.  No atomics, no scratch in device memory, one
// launch; integer sums make the result independent of the split.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "jtype.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;       // rows (trials) per block: 8 m16 tiles
constexpr int BN = 128;       // columns (spins) per block: 16 n8 tiles
constexpr int BK = 64;        // k per stage: two k32 MMA steps
constexpr int KW = BK / 4;    // 32-bit words of k per staged row
constexpr int THREADS = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int MAX_KS = 8;     // blocks per cluster (K splits), portable
constexpr int PLANE_WORDS = BN * KW;
constexpr int STAGE_WORDS = 4 * PLANE_WORDS + BM * KW;  // 4 J planes + m
constexpr int P_STRIDE = BN + 8;                         // partial tile row, int32
constexpr size_t SMEM = sizeof(uint32_t) * (2 * STAGE_WORDS > BM * P_STRIDE
                                                 ? 2 * STAGE_WORDS
                                                 : BM * P_STRIDE);

// Word w (0..15) of staged row `row`: rows are KW words, the word index
// XORed with bits 1-6 of the row.  A fragment load (8 rows g, 4 words t)
// and a staging store of 32 consecutive rows touch 32 banks; one of 32 rows
// 4 apart (the vector path's J) two lanes a bank, the least its parity
// allows.
__device__ __forceinline__ int sw(int row, int w) {
  const int x = ((((row >> 1) & 3) << 2) | ((row >> 3) & 3)) ^ (((row >> 5) & 3) << 2);
  return row * KW + (w ^ x);
}

using jtype::load4;
using jtype::to_int;

__device__ __forceinline__ void mma_ss(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_su(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 0..3 of four values, transposed: plane p's word holds byte p of v0,
// v1, v2, v3 (k = 4w .. 4w+3 of one column).
__device__ __forceinline__ void byte_planes(int v0, int v1, int v2, int v3, uint32_t (&p)[4]) {
  const uint32_t lo01 = __byte_perm(v0, v1, 0x5140), lo23 = __byte_perm(v2, v3, 0x5140);
  const uint32_t hi01 = __byte_perm(v0, v1, 0x7362), hi23 = __byte_perm(v2, v3, 0x7362);
  p[0] = __byte_perm(lo01, lo23, 0x5410);
  p[1] = __byte_perm(lo01, lo23, 0x7632);
  p[2] = __byte_perm(hi01, hi23, 0x5410);
  p[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One stage's operands in registers between its loads and its staging:
// j[e][i] = J[k0 + 4 * jword(e) + i][n0 + jrow(e)], e = 0..7, and
// m[e][i] = m[r0 + r][k0 + 4w + i], (r, w) = (f / KW, f % KW), f = tid + e * THREADS.
template <typename JT>
struct Stage {
  JT j[8][4];
  float m[BM * KW / THREADS][4];
};

// The J column (row of the staged, transposed tile) and k word of a
// thread's value group e.  The vector path (VEC) reads 4 columns of a row
// in one 16-byte load: 32 lanes cover a 128-column row; otherwise each
// thread owns one column and a warp reads 32 consecutive ones.
template <bool VEC>
__device__ __forceinline__ int jrow(int tid, int e) {
  return VEC ? 4 * (tid % 32) + e % 4 : tid % BN;
}
template <bool VEC>
__device__ __forceinline__ int jword(int tid, int e) {
  return VEC ? tid / 32 + 8 * (e / 4) : tid / BN + 2 * e;
}

template <typename JT, bool VEC>
__device__ __forceinline__ void load_stage(Stage<JT>& st, const float* __restrict__ m,
                                           const JT* __restrict__ J, int R, int N, int r0,
                                           int n0, int k0, int tid) {
  if (VEC) {  // N % 4 == 0: four columns are all in range or all out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + jrow<true>(tid, 4 * h), k = k0 + 4 * jword<true>(tid, 4 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        JT v[4] = {JT(0.f), JT(0.f), JT(0.f), JT(0.f)};
        if (n < N && k + i < N) load4(J + (size_t)(k + i) * N + n, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) st.j[4 * h + c][i] = v[c];
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + jrow<false>(tid, e), k = k0 + 4 * jword<false>(tid, e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st.j[e][i] = (n < N && k + i < N) ? J[(size_t)(k + i) * N + n] : JT(0.f);
    }
  }
#pragma unroll
  for (int e = 0; e < BM * KW / THREADS; ++e) {
    const int f = tid + e * THREADS;
    const int r = r0 + f / KW, k = k0 + 4 * (f % KW);
    if (r >= R) {
      st.m[e][0] = st.m[e][1] = st.m[e][2] = st.m[e][3] = 0.f;
    } else if (VEC && k + 4 <= N) {
      load4(m + (size_t)r * N + k, st.m[e]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) st.m[e][i] = (k + i < N) ? m[(size_t)r * N + k + i] : 0.f;
    }
  }
}

// Writes a loaded stage into shared memory and returns the number of byte
// planes its J tile needs (block-uniform; one barrier when it is 1).
template <typename JT, bool VEC>
__device__ __forceinline__ int stage_to_smem(const Stage<JT>& st, uint32_t* buf, int tid) {
  uint32_t* Ms = buf + 4 * PLANE_WORDS;
  uint32_t hi[8][3];
  int mag = 0;  // OR of v ^ (v >> 31): its top bit is the largest |v|'s
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = to_int(st.j[e][i]);
      mag |= v[i] ^ (v[i] >> 31);
    }
    uint32_t p[4];
    byte_planes(v[0], v[1], v[2], v[3], p);
    buf[sw(jrow<VEC>(tid, e), jword<VEC>(tid, e))] = p[0];
    hi[e][0] = p[1]; hi[e][1] = p[2]; hi[e][2] = p[3];
  }
#pragma unroll
  for (int e = 0; e < BM * KW / THREADS; ++e) {
    const int f = tid + e * THREADS;
    const int b0 = __float2int_rz(st.m[e][0]), b1 = __float2int_rz(st.m[e][1]);
    const int b2 = __float2int_rz(st.m[e][2]), b3 = __float2int_rz(st.m[e][3]);
    Ms[sw(f / KW, f % KW)] = __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                                         0x5410);
  }
  int np = 1;
  if (__syncthreads_or(mag > 127)) {
    np = 2;
    if (__syncthreads_or(mag > 32767)) np = __syncthreads_or(mag > 0x7fffff) ? 4 : 3;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int w = sw(jrow<VEC>(tid, e), jword<VEC>(tid, e));
#pragma unroll
      for (int p = 1; p < 4; ++p)
        if (p < np) buf[p * PLANE_WORDS + w] = hi[e][p - 1];
    }
    __syncthreads();
  }
  return np;
}

// The MMAs of one staged tile: warp (wr, wc) owns rows 32wr .. +31 (two m16
// tiles, `mt_ok` says which hold a row < R) and columns 64wc .. +63.
__device__ __forceinline__ void compute_stage(const uint32_t* buf, int np, int (&acc)[2][8][4],
                                              const bool (&mt_ok)[2], int wr, int wc, int g,
                                              int t) {
  const uint32_t* Ms = buf + 4 * PLANE_WORDS;
  uint32_t a[2][2][4];  // [k32 step][m tile][register]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 32 * wr + 16 * mt + g;
      a[kk][mt][0] = Ms[sw(r, 8 * kk + t)];
      a[kk][mt][1] = Ms[sw(r + 8, 8 * kk + t)];
      a[kk][mt][2] = Ms[sw(r, 8 * kk + 4 + t)];
      a[kk][mt][3] = Ms[sw(r + 8, 8 * kk + 4 + t)];
    }
  for (int p = 0; p < np; ++p) {
    const uint32_t* Jp = buf + p * PLANE_WORDS;
    const bool top = (p == np - 1);  // the s8 plane
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 64 * wc + 8 * nt + g;
      uint32_t b[2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        b[kk][0] = Jp[sw(c, 8 * kk + t)];
        b[kk][1] = Jp[sw(c, 8 * kk + 4 + t)];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!mt_ok[mt]) continue;
        if (p == 0) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (top) mma_ss(acc[mt][nt], a[kk][mt], b[kk][0], b[kk][1]);
            else mma_su(acc[mt][nt], a[kk][mt], b[kk][0], b[kk][1]);
          }
        } else {
          int part[4] = {0, 0, 0, 0};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (top) mma_ss(part, a[kk][mt], b[kk][0], b[kk][1]);
            else mma_su(part, a[kk][mt], b[kk][0], b[kk][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = (int)((uint32_t)acc[mt][nt][i] + ((uint32_t)part[i] << (8 * p)));
        }
      }
    }
  }
}

template <typename JT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
local_field_kernel(const float* __restrict__ m, const JT* __restrict__ J,
                   const int* __restrict__ h, int* __restrict__ out, int R, int N) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks(), split = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int n0 = (blockIdx.x / ks) * BN, r0 = blockIdx.y * BM;
  const int n_stages = (N + BK - 1) / BK;
  const int s_begin = split * n_stages / ks, s_end = (split + 1) * n_stages / ks;
  const bool mt_ok[2] = {r0 + 32 * wr < R, r0 + 32 * wr + 16 < R};

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  Stage<JT> st;
  if (s_begin < s_end) load_stage<JT, VEC>(st, m, J, R, N, r0, n0, s_begin * BK, tid);
  for (int s = s_begin; s < s_end; ++s) {
    uint32_t* buf = smem + ((s - s_begin) & 1) * STAGE_WORDS;
    const int np = stage_to_smem<JT, VEC>(st, buf, tid);
    if (s + 1 < s_end) load_stage<JT, VEC>(st, m, J, R, N, r0, n0, (s + 1) * BK, tid);
    compute_stage(buf, np, acc, mt_ok, wr, wc, g, t);
  }
  __syncthreads();  // the stage buffers become this block's partial tile

  int* P = reinterpret_cast<int*>(smem);  // [BM][P_STRIDE]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!mt_ok[mt]) continue;
    const int r = 32 * wr + 16 * mt + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 64 * wc + 8 * nt + 2 * t;
      *reinterpret_cast<int2*>(&P[r * P_STRIDE + c]) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(&P[(r + 8) * P_STRIDE + c]) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  cluster.sync();  // every block's partial tile is complete

  // Rows [lo, hi) of the tile: the sum of the cluster's partials, plus h.
  const int rows = min(BM, R - r0);
  const int lo = split * rows / ks, hi = (split + 1) * rows / ks;
  for (int e = tid; e < (hi - lo) * (BN / 4); e += THREADS) {
    const int r = lo + e / (BN / 4), c = 4 * (e % (BN / 4));
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < ks; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(cluster.map_shared_rank(P, q) +
                                                    r * P_STRIDE + c);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
    int* o = out + (size_t)(r0 + r) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + c + i < N) o[n0 + c + i] = s4[i] + h[n0 + c + i];
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

// Sets the kernel's shared-memory size, once per device and variant.
template <typename JT, bool VEC>
cudaError_t k3_config() {
  static bool done[64];  // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(local_field_kernel<JT, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (dev < 64) done[dev] = e == cudaSuccess;
  return e;
}

void k3_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int R, int N, int ks,
                      cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((N + BN - 1) / BN * ks, (R + BM - 1) / BM);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = SMEM;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename JT, bool VEC>
int launch(const float* m, const JT* J, const int* h, int* out, int R, int N, int ks,
           cudaStream_t s) {
  cudaError_t e = k3_config<JT, VEC>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  k3_launch_config(&cfg, &attr, R, N, ks, s);
  e = cudaLaunchKernelEx(&cfg, local_field_kernel<JT, VEC>, m, J, h, out, R, N);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename JT>
int launch_vec(const float* m, const JT* J, const int* h, int* out, int R, int N, int ks,
               cudaStream_t s) {
  // Vector loads of 4 values need aligned rows.
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(J) % (4 * sizeof(JT)) == 0)
    return launch<JT, true>(m, J, h, out, R, N, ks, s);
  return launch<JT, false>(m, J, h, out, R, N, ks, s);
}

template <typename JT, bool VEC>
int max_clusters(int ks) {
  cudaError_t e = k3_config<JT, VEC>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  k3_launch_config(&cfg, &attr, 1, BN, ks, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, local_field_kernel<JT, VEC>, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size that does not fit is an answer, not a fault
    return 0;
  }
  return n;
}

}  // namespace

// `splits`: the K splits, blocks per cluster (1 to MAX_KS); the wrapper
// chooses them (ssa_update._cluster_size, through the query below).  J of
// type `j_type` (jtype.cuh).
extern "C" int repro_local_field(const void* m, const void* J, const void* h, void* out,
                                 int R, int N, int j_type, int splits, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > MAX_KS) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return jtype::dispatch(j_type, invalid, [&](auto tag) {
    using JT = typename decltype(tag)::type;
    return launch_vec<JT>(static_cast<const float*>(m), static_cast<const JT*>(J),
                          static_cast<const int*>(h), static_cast<int*>(out), R, N, splits, s);
  });
}

// How many clusters of `splits` K3 blocks the card runs at once
// (cudaOccupancyMaxActiveClusters), J of type `j_type`; 0 when none fits.
// Negative: a CUDA error code, negated.
extern "C" int repro_local_field_max_clusters(int N, int splits, int j_type) {
  const int invalid = -static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > MAX_KS) return invalid;
  const bool vec = N % 4 == 0;
  return jtype::dispatch(j_type, invalid, [&](auto tag) {
    using JT = typename decltype(tag)::type;
    return vec ? max_clusters<JT, true>(splits) : max_clusters<JT, false>(splits);
  });
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
