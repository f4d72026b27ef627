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
// Orders 33 <= m <= 48 (circle-N20-512's 42: OptimizeOnCircle N = 20's
// predictor inverses, nV = 42): one matrix a warp, two rows a lane
// (gj_wide_kernel).
// - What bounds it.  Not bytes: B = 512 matrices at m = 48 move 9.4 MB,
//   2.8 us at 3.35 TB/s.  The chain of m dependent steps of one warp: each
//   step is the pivot's shuffle and division, then for each of the m - 1
//   other columns a shuffle, the scale by r and, in each row slot, a
//   multiply, a subtract and a select: ~350 issued instructions a step at
//   m = 42, ~0.3 us a step for a matrix alone.  And the grid's fill: at
//   B = 512 one warp a matrix gives the card's 528 schedulers about one
//   warp each, so the time is one warp's chain, not a throughput.  (A
//   block design with floor(256/m) matrices a block has 103 blocks for
//   132 SMs at (512, 48) and serializes each step between two block
//   barriers: 68 us.)
// - Lane i holds row i in slot a and row 32 + i in slot b; where
//   32 + i >= m, slot b is a zero row that runs the same instructions
//   inside the full shuffle mask, is never a pivot and is never stored.
//   Row k, the pivot of step k, is slot k / 32 of lane k % 32: two loops,
//   k < 32 and k >= 32, so the slot is a constant in each.
// - Rows are stored rotated: at step k position p holds column
//   (k + p) mod m, so the pivot column is always position 0 and a step
//   moves each result down one position.  Every register index is then a
//   constant in a loop over k that is not unrolled (two steps a trip).
//   With k unrolled too the code was ~240 KB a kernel at m = 42 and ran from
//   instruction fetch: 82 us at (512, 42) with L2 flushed, 46 us warm
//   (CUDA events).
// - The sign masks are 64 bits (columns up to 47) and shift with the
//   rows: bit p is the sign of the zero I[row, k + p], the same IEEE rules
//   as the warp design's.
// - No shared memory, no barrier, one warp a block; rows load and store
//   with 16- or 8-byte accesses where m and the pointers allow.
// Measured (tools/torch_gj_times.py, in turns with the block design, one
// process, kernel time by torch.profiler, L2 flushed / warm, NVIDIA H100
// 80GB HBM3, 700.00 W): (512, 42) 22.0 / 20.6 us against 53.4 / 51.0;
// (512, 48) 21.7 / 20.1 against 68.0 / 67.0; (4096, 48) 113 / 113
// against 351 / 351; one matrix (1, 42) 12.9 us against 49.9.  Measured
// slower (CUDA events, one call each, in turns) and not kept: two
// matrices over three warps with the pivot row in shared memory under a
// block barrier (+18-21% at B = 512), the pivot row through warp-private
// shared memory in place of the shuffles (+6-15%), each step's division
// started one step ahead (+3-6%), two warps a block (+0-8%).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;  // warps per block of the warp design
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

// ---- wide design, 33 <= m <= 48 ------------------------------------------

// A row of M floats moved with the widest access that the row's alignment
// allows: vec (4, 2 or 1 floats) is chosen once per launch and is the same
// in every thread, so the branch is uniform.
template <int M>
__device__ __forceinline__ void load_row_any(float (&a)[M], const float* row,
                                             int vec) {
  if constexpr (M % 4 == 0) {
    if (vec == 4) return load_row<M, 4>(a, row);
  }
  if constexpr (M % 2 == 0) {
    if (vec >= 2) return load_row<M, 2>(a, row);
  }
  load_row<M, 1>(a, row);
}

template <int M>
__device__ __forceinline__ void store_row_any(float* row, const float (&a)[M],
                                              int vec) {
  if constexpr (M % 4 == 0) {
    if (vec == 4) return store_row<M, 4>(row, a);
  }
  if constexpr (M % 2 == 0) {
    if (vec >= 2) return store_row<M, 2>(row, a);
  }
  store_row<M, 1>(row, a);
}

__device__ __forceinline__ unsigned long long sign_mask64(float x) {
  return (__float_as_uint(x) >> 31) ? ~0ull : 0ull;
}

// Elimination step k of the wide design on lane i's two rows, stored
// rotated: position p holds column (k + p) mod M, so the pivot column is
// always position 0 and the step's result shifts down by one position, a
// register rename with every index a constant in the loop over k, which
// stays a loop.  The sign masks shift the same way: bit p is the sign of the
// zero I[row, k + p], for the columns not yet pivoted.  kSlotB: row k is
// slot b of lane k - 32 (k >= 32), else slot a of lane k.
template <int M, bool kSlotB>
__device__ __forceinline__ void wide_step(float (&a)[M], float (&b)[M],
                                          unsigned long long& na,
                                          unsigned long long& nb, int i,
                                          int k) {
  const int src = kSlotB ? k - 32 : k;
  const bool pa = !kSlotB && i == k;
  const bool pb = kSlotB && i == k - 32;
  const float fa = a[0];
  const float fb = b[0];
  const float r = 1.0f / __shfl_sync(kFull, kSlotB ? fb : fa, src);
#pragma unroll
  for (int p = 1; p < M; ++p) {
    const float t = __shfl_sync(kFull, kSlotB ? b[p] : a[p], src) * r;
    a[p - 1] = pa ? t : a[p] - fa * t;
    b[p - 1] = pb ? t : b[p] - fb * t;
  }
  const unsigned long long nk = __shfl_sync(kFull, kSlotB ? nb : na, src);
  const unsigned long long sr = sign_mask64(r);
  const float za = (na & 1ull) ? -0.0f : 0.0f;
  const float zb = (nb & 1ull) ? -0.0f : 0.0f;
  a[M - 1] = pa ? r : za - fa * r;
  b[M - 1] = pb ? r : zb - fb * r;
  na = (pa ? (nk ^ sr) : (na & ~(nk ^ sr ^ sign_mask64(fa)))) >> 1;
  nb = (pb ? (nk ^ sr) : (nb & ~(nk ^ sr ^ sign_mask64(fb)))) >> 1;
}

// One matrix a block of one warp (blockIdx.x is the matrix).
template <int M>
__global__ void __launch_bounds__(32)
gj_wide_kernel(const float* __restrict__ S, float* __restrict__ out,
               int vec) {
  static_assert(kWarpMaxM < M && M <= 2 * kWarpMaxM, "two row slots");
  constexpr int H = M - 32;  // lanes 0 .. H-1 hold a second row
  const int i = threadIdx.x;
  const bool two = i < H;
  const long long base = static_cast<long long>(blockIdx.x) * M * M;

  // a: row i; b: row 32 + i, or a zero row past the matrix (never a pivot
  // source, never stored).
  float a[M];
  float b[M];
  load_row_any<M>(a, S + base + i * M, vec);
  if (two) {
    load_row_any<M>(b, S + base + (32 + i) * M, vec);
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) b[j] = 0.0f;
  }
  unsigned long long na = 0ull;
  unsigned long long nb = 0ull;

  // Two steps a trip, so each step's pivot shuffle and division can
  // overlap the previous step's last columns.
#pragma unroll 2
  for (int k = 0; k < 32; ++k) wide_step<M, false>(a, b, na, nb, i, k);
#pragma unroll 2
  for (int k = 32; k < M; ++k) wide_step<M, true>(a, b, na, nb, i, k);

  // After M steps of one position each, position p is column p again.
  store_row_any<M>(out + base + i * M, a, vec);
  if (two) store_row_any<M>(out + base + (32 + i) * M, b, vec);
}

template <int M>
cudaError_t launch_wide(const float* S, float* out, int batch,
                        cudaStream_t stream) {
  const auto addr = reinterpret_cast<std::uintptr_t>(S) |
                    reinterpret_cast<std::uintptr_t>(out);
  int vec = natural_vec<M>();
  while (vec > 1 && addr % (4 * vec) != 0) vec /= 2;
  gj_wide_kernel<M><<<batch, 32, 0, stream>>>(S, out, vec);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch(const float* S, float* out, int batch,
                   cudaStream_t stream) {
  if constexpr (M <= kWarpMaxM) {
    return launch_warp<M>(S, out, batch, stream);
  } else {
    return launch_wide<M>(S, out, batch, stream);
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
