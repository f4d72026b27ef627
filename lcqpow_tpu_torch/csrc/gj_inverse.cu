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
// two agree bit for bit.
//
// What bounds it on an H100: bytes.  Each matrix is read once and written
// once (2 * m^2 * 4 bytes) for about 2 m^3 operations, under 4 operations
// per byte at m = 14, far below the ~20 FP32 operations per byte where the
// card's 67 TFLOP/s would take over from its 3.35 TB/s.  At the solver's
// shapes (B = 4096, m = 8 or 14) the whole batch is a few MB, so a launch
// costs a few microseconds whatever the kernel does.
//
// What the design does about it: one group of m threads per matrix, thread i
// holding row i of [M | I] in registers (2m floats); floor(256/m) matrices
// per block.  The block's matrices are contiguous in memory, so they are
// staged through shared memory with coalesced loads and stores, and each
// matrix costs one read and one write of device memory.  At step k the pivot
// thread publishes its scaled row through shared memory.  m is a template
// parameter, so the loops over a row unroll and the rows stay in registers.
// The TPU kernel's lane-major (m, m, 512) tiling and its identity-padded
// tail lanes are not carried over: groups past the end of the batch load
// identity rows and store nothing.

#include <cuda_runtime.h>

namespace {

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
gj_inverse_kernel(const float* __restrict__ S, float* __restrict__ out,
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

  // Small orders (the solver's 8 and 14) unroll the step loop fully; larger
  // ones keep it rolled so that the 48 instantiations compile in seconds.
  if constexpr (M <= 16) {
#pragma unroll
    for (int k = 0; k < M; ++k) gj_step<M>(a, inv, piv[local], i, k);
  } else {
#pragma unroll 1
    for (int k = 0; k < M; ++k) gj_step<M>(a, inv, piv[local], i, k);
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < M; ++j) tile[(local * M + i) * M + j] = inv[j];
  }
  __syncthreads();
  for (int idx = tid; idx < nvals; idx += kMats * M) out[base + idx] = tile[idx];
}

template <int M>
cudaError_t launch(const float* S, float* out, int batch,
                   cudaStream_t stream) {
  constexpr int kMats = kThreads / M;
  const int blocks = (batch + kMats - 1) / kMats;
  gj_inverse_kernel<M><<<blocks, kMats * M, 0, stream>>>(S, out, batch);
  return cudaGetLastError();
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
