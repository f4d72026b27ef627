// Batched Gauss-Jordan inverse of small SPD matrices, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lcqpow_tpu/ops/pallas_inverse.py:_gj_kernel
// (launched by spd_inverse_pallas).  Input and output are (B, m, m) float32,
// batch-first and row-major, m <= 48.  The inputs are Jacobi-scaled,
// regularized SPD matrices (ops/chol.py), so the elimination is unpivoted.
//
// What it computes, in the TPU kernel's order, for k = 0 .. m-1:
//   r = 1 / M[k,k];  rowM = M[k] * r;  rowI = I[k] * r;
//   f = M[:,k] with f[k] = 0;  M -= f (x) rowM;  I -= f (x) rowI;
//   row k <- rowM, rowI.
// Built with --fmad=false, so every product is rounded before the subtract,
// as in the plain PyTorch version (ops/gj_inverse.py:gj_inverse_plain); the
// two agree bit for bit, signed zeros included.
//
// What bounds it on an H100.  Bytes: each matrix is read once and written
// once (2 m^2 4 bytes) for about 2 m^3 operations, under 4 operations per
// byte at m = 14, far below the ~20 FP32 operations per byte where the
// card's 67 TFLOP/s would take over from its 3.35 TB/s.  At the solver's
// shapes (B = 4096, m = 8 or 14) the batch is 1-3 MB, a microsecond of
// memory time, so what is left is latency: the launch, one round trip to
// memory, and the chain of m dependent elimination steps of each matrix.
//
// Orders 1 <= m <= 32 (the solver's 8 and 14): rows in lanes, matrices in
// warps (gj_warp_kernel).
// - A matrix takes m consecutive lanes of one warp and lane i holds row i
//   in registers; a warp holds floor(32/m) matrices.  Blocks are small
//   (kWarps = 2 warps, measured a little faster than 4 at m = 14) and
//   many (1024 at (4096, 14)), so every SM holds several and its four
//   schedulers switch between warps to hide the step chain and the memory
//   latency, where a 256-thread block per matrix group left the card at
//   12-25% occupancy.
// - The pivot row moves between lanes by __shfl_sync.  There is no block
//   barrier and no shared memory: the m lanes of a matrix run in lockstep
//   in their warp.  Every lane reads the unscaled pivot row and computes
//   r = 1/p itself (the same IEEE operation on the same bits in every lane),
//   so no lane waits for a serial pivot phase and the row's shuffles overlap
//   the division.  (Letting the pivot lane scale its row first and shuffle
//   the scaled row takes fewer instructions but was measured slower: every
//   shuffle then waits for the division.)
// - Each lane loads its row straight from device memory into registers
//   with 16- or 8-byte vector loads where m and the pointers allow it, and
//   stores its row of the inverse the same way.  A warp's matrices are
//   contiguous, so its loads cover one contiguous span and every warp
//   overlaps its memory traffic with the other warps' elimination.
// - In place: lane i keeps m values, not the 2m of [M | I].  Column k of M
//   is dead after step k and column k of I is e_k until step k, so slot k
//   takes I[:,k] at step k.  The zeros of I's not yet pivoted columns are
//   not stored but their signs are: bit j of `neg` is the sign of I[i,j],
//   updated by the IEEE rules of the products and differences that the
//   plain version computes on them, so the slot-k value -0/+0 - f*r is the
//   plain version's to the bit.
// Lanes past the last matrix of a warp (28-31 at m = 14) and matrices past
// the end of the batch run the same instructions on identity rows, inside
// the full shuffle mask, and store nothing.
//
// Orders 33 <= m <= 48 (off the solver's main path) keep the block design
// (gj_block_kernel): a group of m threads per matrix, floor(256/m) matrices
// per block staged through shared memory, the pivot row published through
// shared memory between two block barriers per step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;  // warps per block
constexpr int kWarpMaxM = 32;

// ---- warp design, 1 <= m <= 32 -------------------------------------------

// Floats per vector load and store of an m-float row: rows start at
// multiples of 4m bytes.
template <int M>
constexpr int natural_vec() {
  return M % 4 == 0 ? 4 : (M % 2 == 0 ? 2 : 1);
}

template <int M, int V>
__device__ __forceinline__ void load_row(float (&a)[M], const float* row) {
  if constexpr (V == 4) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row)[q];
      a[4 * q] = x.x;
      a[4 * q + 1] = x.y;
      a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
  } else if constexpr (V == 2) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(row)[q];
      a[2 * q] = x.x;
      a[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) a[j] = row[j];
  }
}

template <int M, int V>
__device__ __forceinline__ void store_row(float* row, const float (&a)[M]) {
  if constexpr (V == 4) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  } else if constexpr (V == 2) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q)
      reinterpret_cast<float2*>(row)[q] = make_float2(a[2 * q], a[2 * q + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) row[j] = a[j];
  }
}

__device__ __forceinline__ unsigned sign_mask(float x) {
  return (__float_as_uint(x) >> 31) ? kFull : 0u;
}

template <int M, int V>
__global__ void __launch_bounds__(kWarps * 32)
gj_warp_kernel(const float* __restrict__ S, float* __restrict__ out,
               int batch) {
  constexpr int G = 32 / M;  // matrices per warp
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * G;
  if (first >= batch) return;  // the whole warp: no shuffle is left waiting
  const int g = lane / M;        // matrix within the warp; G for idle lanes
  const int i = lane - g * M;    // row within the matrix
  const bool valid = g < G && first + g < batch;
  // Idle lanes shuffle from group 0, so they divide by a real pivot.
  const int src0 = g < G ? g * M : 0;
  const long long row_off = (first * M + lane) * M;

  float a[M];
  if (valid) {
    load_row<M, V>(a, S + row_off);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) a[j] = (j == i) ? 1.0f : 0.0f;
  }
  unsigned neg = 0u;  // bit j: I[i,j] is -0 (j not yet pivoted, j != i)

#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int src = src0 + k;
    const bool piv = (i == k);
    const float f = a[k];
    const float r = 1.0f / __shfl_sync(kFull, f, src);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j == k) continue;
      const float t = __shfl_sync(kFull, a[j], src) * r;
      a[j] = piv ? t : a[j] - f * t;
    }
    const unsigned nk = __shfl_sync(kFull, neg, src);
    const unsigned sr = sign_mask(r);
    // Row k: rowI[k] = 1 * r, and rowI[j] = I[k,j] * r is a zero of sign
    // nk_j ^ sr.  Row i != k: I[i,k] - f * r, and I[i,j] - f * rowI[j] is
    // -0 only for -0 minus +0.
    const float zk = ((neg >> k) & 1u) ? -0.0f : 0.0f;
    a[k] = piv ? r : zk - f * r;
    neg = piv ? (nk ^ sr) : (neg & ~(nk ^ sr ^ sign_mask(f)));
  }

  if (valid) store_row<M, V>(out + row_off, a);
}

template <int M>
cudaError_t launch_warp(const float* S, float* out, int batch,
                        cudaStream_t stream) {
  constexpr int G = 32 / M;
  constexpr int V = natural_vec<M>();
  const long long warps = (static_cast<long long>(batch) + G - 1) / G;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  const auto addr = reinterpret_cast<std::uintptr_t>(S) |
                    reinterpret_cast<std::uintptr_t>(out);
  if (V > 1 && addr % (4 * V) == 0) {
    gj_warp_kernel<M, V><<<blocks, kWarps * 32, 0, stream>>>(S, out, batch);
  } else {
    gj_warp_kernel<M, 1><<<blocks, kWarps * 32, 0, stream>>>(S, out, batch);
  }
  return cudaGetLastError();
}

// ---- block design, 33 <= m <= 48 ------------------------------------------

constexpr int kThreads = 256;

// a[k] for a runtime k, without leaving registers (a constant k folds away).
template <int M>
__device__ __forceinline__ float pick(const float (&a)[M], int k) {
  float out = a[0];
#pragma unroll
  for (int j = 1; j < M; ++j) out = (j == k) ? a[j] : out;
  return out;
}

// Elimination step k for row i of one matrix; piv holds the group's
// published pivot row [rowM | rowI].
template <int M>
__device__ __forceinline__ void gj_step(float (&a)[M], float (&inv)[M],
                                        float* piv, int i, int k) {
  if (i == k) {
    const float r = 1.0f / pick<M>(a, k);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      a[j] = a[j] * r;
      inv[j] = inv[j] * r;
      piv[j] = a[j];
      piv[M + j] = inv[j];
    }
  }
  __syncthreads();
  if (i != k) {
    const float f = pick<M>(a, k);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      a[j] = a[j] - f * piv[j];
      inv[j] = inv[j] - f * piv[M + j];
    }
  }
  // The next pivot row must not overwrite this one before every row of the
  // group has read it.
  __syncthreads();
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gj_block_kernel(const float* __restrict__ S, float* __restrict__ out,
                int batch) {
  constexpr int kMats = kThreads / M;  // matrices per block
  static_assert(kMats * M * M * 4 + kMats * 2 * M * 4 <= 48 * 1024,
                "static shared memory over 48 KB");
  __shared__ float tile[kMats * M * M];
  __shared__ float piv[kMats][2 * M];

  const int tid = threadIdx.x;
  const int local = tid / M;  // matrix within the block
  const int i = tid - local * M;  // row within the matrix
  const long long first = static_cast<long long>(blockIdx.x) * kMats;
  const long long left = static_cast<long long>(batch) - first;
  const int nmat = left < kMats ? static_cast<int>(left) : kMats;
  const long long base = first * M * M;
  const int nvals = nmat * M * M;

  for (int idx = tid; idx < nvals; idx += kMats * M) tile[idx] = S[base + idx];
  __syncthreads();

  const bool valid = local < nmat;
  float a[M];
  float inv[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float e = (j == i) ? 1.0f : 0.0f;
    a[j] = valid ? tile[(local * M + i) * M + j] : e;
    inv[j] = e;
  }

#pragma unroll 1
  for (int k = 0; k < M; ++k) gj_step<M>(a, inv, piv[local], i, k);

  if (valid) {
#pragma unroll
    for (int j = 0; j < M; ++j) tile[(local * M + i) * M + j] = inv[j];
  }
  __syncthreads();
  for (int idx = tid; idx < nvals; idx += kMats * M) out[base + idx] = tile[idx];
}

template <int M>
cudaError_t launch_block(const float* S, float* out, int batch,
                         cudaStream_t stream) {
  constexpr int kMats = kThreads / M;
  const int blocks = (batch + kMats - 1) / kMats;
  gj_block_kernel<M><<<blocks, kMats * M, 0, stream>>>(S, out, batch);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch(const float* S, float* out, int batch,
                   cudaStream_t stream) {
  if constexpr (M <= kWarpMaxM) {
    return launch_warp<M>(S, out, batch, stream);
  } else {
    return launch_block<M>(S, out, batch, stream);
  }
}

}  // namespace

// C interface for ctypes.  S and out are device pointers to (batch, m, m)
// contiguous float32; stream is a cudaStream_t.  Returns the cudaError_t of
// the launch (0 on success); checks nothing else: the Python wrapper
// validates dtype, shape, contiguity and device first.
extern "C" int gj_inverse_f32(const void* S, void* out, int batch, int m,
                              void* stream) {
  if (batch <= 0) return 0;
  const float* s = static_cast<const float*>(S);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
#define GJ_CASE(M) \
  case M:          \
    return static_cast<int>(launch<M>(s, o, batch, st));
    GJ_CASE(1) GJ_CASE(2) GJ_CASE(3) GJ_CASE(4) GJ_CASE(5) GJ_CASE(6)
    GJ_CASE(7) GJ_CASE(8) GJ_CASE(9) GJ_CASE(10) GJ_CASE(11) GJ_CASE(12)
    GJ_CASE(13) GJ_CASE(14) GJ_CASE(15) GJ_CASE(16) GJ_CASE(17) GJ_CASE(18)
    GJ_CASE(19) GJ_CASE(20) GJ_CASE(21) GJ_CASE(22) GJ_CASE(23) GJ_CASE(24)
    GJ_CASE(25) GJ_CASE(26) GJ_CASE(27) GJ_CASE(28) GJ_CASE(29) GJ_CASE(30)
    GJ_CASE(31) GJ_CASE(32) GJ_CASE(33) GJ_CASE(34) GJ_CASE(35) GJ_CASE(36)
    GJ_CASE(37) GJ_CASE(38) GJ_CASE(39) GJ_CASE(40) GJ_CASE(41) GJ_CASE(42)
    GJ_CASE(43) GJ_CASE(44) GJ_CASE(45) GJ_CASE(46) GJ_CASE(47) GJ_CASE(48)
#undef GJ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
