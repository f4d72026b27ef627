// Batched float32 matrix-vector products of small matrices, CUDA C++ for
// sm_90a: lcqpow_tpu_torch/ops/linalg.py's mv (out[b] = A[b] x[b]) and mtv
// (out[b] = A[b]' y[b]) for the solver's (B, m, n) shapes, with the bits of
// the cuBLAS gemv kernels that torch.matmul runs for them.
//
// No TPU kernel does this: the JAX package leaves its batched matvecs to
// XLA (vmap of A @ x), and the port's eager loop sent them to aten::bmm,
// whose cuBLAS gemv kernels (gemvx, gemv2N, gemvNSP) ran at 4-18% of the
// card's memory bound at these shapes (0.18-0.51 ms against 0.008-0.070 ms
// at B = 262,144) and took half of a traced call's device time.
//
// The bits.  Every output is a sum of K = n (mv) or m (mtv) products,
// K <= 14.  cuBLAS splits a batch into launches of at most 65535 lanes;
// for each launch it picks a kernel by the launch's size, and each kernel
// sums in an order of its own.  All of them were found (on an H100 with
// torch 2.11 + CUDA 12.8; pair probes, then random inputs bit for bit) to
// sum the same way: the K terms split into chains, each chain an FMA chain
// from +0 in ascending k (acc = fma(a_k, x_k, acc)), and the chains' sums
// added in a fixed tree.  Order below names the six ways; the wrapper
// (ops/linalg.py) picks one for the full 65535-lane launches and one for
// the remainder, and the kernel takes the first for lanes below `split`.
// The library is built with --fmad=false, so every fused multiply-add is
// written as __fmaf_rn and every add as __fadd_rn.
//
// What bounds it on an H100: bytes.  A lane's matrix (64-784 bytes) and
// vector are read once and its output written once: 8-70 us at B = 262,144
// and 3.35 TB/s, against about 0.2 floating-point operations a byte.  A
// thread per lane reading its own matrix with 4-byte loads would not
// coalesce.  So a block of 256 threads stages a tile of lanes (at most
// 40 KB) in shared memory with cp.async copies, global to shared without a
// register on the way, in which neighbouring threads copy neighbouring
// floats; then each thread computes (lane, row) outputs from shared memory
// (lane strides padded to an odd number of floats, so a warp's 32 lanes
// fall in 32 banks), stages them, and the block writes its outputs as one
// contiguous run.  Several tiles per SM keep one block's copies in flight
// while another computes.  A lane whose whole matrix is one 64-byte
// line (m n <= 16: the (2, 8) shape) is one thread's instead, reading its
// packed matrix and vector with 16-byte loads: a warp's loads then cover
// whole sectors, and there is no tile to fill and drain.  That is the
// only kernel of that shape: the wrapper sends (2, 8) operands that are
// not packed and 16-byte aligned to torch.matmul.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// The summation orders (ops/linalg.py names the same numbers).  Chains:
enum Order : int {
  kHalves = 0,     // [0, K/2), [K/2, K); c0 + c1
  kEvenOdd = 1,    // even k, odd k; c0 + c1
  kMod4 = 2,       // k = r mod 4, r = 0..3; (c0 + c2) + (c1 + c3)
  kQuads0213 = 3,  // [0,4), [4,8), [8,12), [12,K); (c0 + c2) + (c1 + c3)
  kQuadsSeq = 4,   // the same chains; ((c0 + c1) + c2) + c3
  kPairs8 = 5,     // [2i, 2i+2), i = 0..6; ((c0 + c4) + (c2 + c6)) +
                   // ((c1 + c5) + c3)
};

// Chain over k = LO, LO + STEP, ... < HI: FMA from +0.
template <int K, int LO, int HI, int STEP>
__device__ __forceinline__ float chain(const float (&a)[K],
                                       const float (&x)[K]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = LO; k < HI; k += STEP) acc = __fmaf_rn(a[k], x[k], acc);
  return acc;
}

template <int K>
__device__ __forceinline__ float dot(const float (&a)[K], const float (&x)[K],
                                     int order) {
  switch (order) {
    case kEvenOdd:
      return __fadd_rn(chain<K, 0, K, 2>(a, x), chain<K, 1, K, 2>(a, x));
    case kMod4:
      return __fadd_rn(
          __fadd_rn(chain<K, 0, K, 4>(a, x), chain<K, 2, K, 4>(a, x)),
          __fadd_rn(chain<K, 1, K, 4>(a, x), chain<K, 3, K, 4>(a, x)));
    case kQuads0213:
      if constexpr (K > 12) {
        return __fadd_rn(
            __fadd_rn(chain<K, 0, 4, 1>(a, x), chain<K, 8, 12, 1>(a, x)),
            __fadd_rn(chain<K, 4, 8, 1>(a, x), chain<K, 12, K, 1>(a, x)));
      }
      break;
    case kQuadsSeq:
      if constexpr (K > 12) {
        return __fadd_rn(
            __fadd_rn(
                __fadd_rn(chain<K, 0, 4, 1>(a, x), chain<K, 4, 8, 1>(a, x)),
                chain<K, 8, 12, 1>(a, x)),
            chain<K, 12, K, 1>(a, x));
      }
      break;
    case kPairs8:
      if constexpr (K == 14) {
        return __fadd_rn(
            __fadd_rn(
                __fadd_rn(chain<K, 0, 2, 1>(a, x), chain<K, 8, 10, 1>(a, x)),
                __fadd_rn(chain<K, 4, 6, 1>(a, x),
                          chain<K, 12, 14, 1>(a, x))),
            __fadd_rn(
                __fadd_rn(chain<K, 2, 4, 1>(a, x), chain<K, 10, 12, 1>(a, x)),
                chain<K, 6, 8, 1>(a, x)));
      }
      break;
    default:
      break;
  }
  return __fadd_rn(chain<K, 0, K / 2, 1>(a, x), chain<K, K / 2, K, 1>(a, x));
}

// Odd lane strides in shared memory: a warp's 32 lanes in 32 banks.
__host__ __device__ constexpr int odd(int x) { return x | 1; }

// Lanes a block: the largest power of two up to 256 whose tile of matrix
// and vector stays within 40 KB.
__host__ __device__ constexpr int tile_lanes(int m, int n, int k) {
  int lanes = 256;
  while (lanes > 32 && lanes * (m * n + k) * 4 > 40960) lanes /= 2;
  return lanes;
}

// A 4-byte copy from global to shared memory, in flight until the block
// waits on its group.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One thread a lane, for mv at m n <= 16 on packed, 16-byte aligned
// operands (launch checks): the matrix and the vector in 16-byte loads.
// The solver's pass moves far more than L2 holds between two products
// with one matrix, so the matrix is read evict-first (__ldcs): 65.6% of
// the bound at (262144, 2, 8) from a flushed L2 against 61.0% with
// __ldg (H100).
template <int M, int N>
__global__ void __launch_bounds__(kThreads)
    matvec_lane_kernel(const float* __restrict__ A,
                       const float* __restrict__ v, float* __restrict__ out,
                       int batch, int order_full, int order_rem, int split) {
  static_assert(M * N % 4 == 0 && N % 4 == 0 && M <= 4, "16-byte rows");
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  float a[M * N], x[N];
  const float4* a4 =
      reinterpret_cast<const float4*>(A + static_cast<long long>(b) * M * N);
#pragma unroll
  for (int q = 0; q < M * N / 4; ++q) {
    const float4 f = __ldcs(a4 + q);
    a[4 * q] = f.x, a[4 * q + 1] = f.y, a[4 * q + 2] = f.z, a[4 * q + 3] = f.w;
  }
  const float4* x4 =
      reinterpret_cast<const float4*>(v + static_cast<long long>(b) * N);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = __ldg(x4 + q);
    x[4 * q] = f.x, x[4 * q + 1] = f.y, x[4 * q + 2] = f.z, x[4 * q + 3] = f.w;
  }
  const int order = b < split ? order_full : order_rem;
  float o[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float row[N];
#pragma unroll
    for (int k = 0; k < N; ++k) row[k] = a[i * N + k];
    o[i] = dot<N>(row, x, order);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) out[static_cast<long long>(b) * M + i] = o[i];
}

// One block: lanes b0 .. b0 + LANES - 1.  TRANS false: out[b, i] =
// sum_j A[b, i, j] v[b, j] (mv); true: out[b, j] = sum_i A[b, i, j] v[b, i]
// (mtv).  A's last stride is 1; out is (B, R) contiguous.
template <int M, int N, bool TRANS>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const float* __restrict__ A, const float* __restrict__ v,
                  float* __restrict__ out, int batch, long long sA0,
                  long long sA1, long long sv0, long long sv1,
                  int order_full, int order_rem, int split) {
  constexpr int K = TRANS ? M : N;  // terms a sum
  constexpr int R = TRANS ? N : M;  // outputs a lane
  constexpr int MN = M * N;
  constexpr int LANES = tile_lanes(M, N, K);
  constexpr int AS = odd(MN), VS = odd(K), OS = odd(R);
  __shared__ float As[LANES * AS];
  __shared__ float Vs[LANES * VS];
  __shared__ float Os[LANES * OS];

  const int b0 = blockIdx.x * LANES;
  const int lanes = min(LANES, batch - b0);
  const int t = threadIdx.x;

  // Stage the tile: 4-byte cp.async copies, all in flight at once.
  for (int e = t; e < lanes * MN; e += kThreads) {
    const int l = e / MN, w = e - l * MN;
    const int i = w / N, j = w - i * N;
    copy4(&As[l * AS + w], A + (b0 + l) * sA0 + i * sA1 + j);
  }
  for (int e = t; e < lanes * K; e += kThreads) {
    const int l = e / K, k = e - l * K;
    copy4(&Vs[l * VS + k], v + (b0 + l) * sv0 + k * sv1);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // (lane, row) outputs, lane-minor so a warp reads 32 lanes' banks.
  for (int o = t; o < LANES * R; o += kThreads) {
    const int l = o % LANES, r = o / LANES;
    if (l >= lanes) continue;
    float a[K], x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[k] = TRANS ? As[l * AS + k * N + r] : As[l * AS + r * N + k];
      x[k] = Vs[l * VS + k];
    }
    Os[l * OS + r] = dot<K>(a, x, b0 + l < split ? order_full : order_rem);
  }
  __syncthreads();

  float* dst = out + static_cast<long long>(b0) * R;
  for (int e = t; e < lanes * R; e += kThreads) {
    const int l = e / R, r = e - l * R;
    dst[e] = Os[l * OS + r];
  }
}

template <int M, int N, bool TRANS>
cudaError_t launch(const float* A, const float* v, float* out, int batch,
                   long long sA0, long long sA1, long long sv0, long long sv1,
                   int order_full, int order_rem, int split,
                   cudaStream_t stream) {
  if constexpr (!TRANS && M * N <= 16) {
    const bool packed = sA0 == M * N && sA1 == N && sv0 == N && sv1 == 1 &&
                        reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(v) % 16 == 0;
    if (!packed) return cudaErrorInvalidValue;
    matvec_lane_kernel<M, N><<<(batch + kThreads - 1) / kThreads, kThreads,
                               0, stream>>>(A, v, out, batch, order_full,
                                            order_rem, split);
  } else {
    constexpr int lanes = tile_lanes(M, N, TRANS ? M : N);
    const int blocks = (batch + lanes - 1) / lanes;
    matvec_kernel<M, N, TRANS><<<blocks, kThreads, 0, stream>>>(
        A, v, out, batch, sA0, sA1, sv0, sv1, order_full, order_rem, split);
  }
  return cudaGetLastError();
}

}  // namespace

// out (batch, R) = per-lane A v (trans 0) or A' v (trans 1) for the
// (m, n, trans) the solver drives: (2, 8, 0), (8, 8, 0), (14, 8, 0),
// (14, 8, 1), (14, 14, 0).  Strides in elements; A's last stride is 1,
// and at (2, 8) both operands are packed and 16-byte aligned.  Lanes below
// `split` sum in order_full, the rest in order_rem.  Returns a cudaError_t
// (cudaErrorInvalidValue for another shape or unpacked (2, 8) operands).
extern "C" int matvec_f32(const void* A, const void* v, void* out, int batch,
                          int m, int n, int trans, long long sA0,
                          long long sA1, long long sv0, long long sv1,
                          int order_full, int order_rem, int split,
                          int device, void* stream) {
  if (batch <= 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* a = static_cast<const float*>(A);
  const float* x = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MATVEC_CASE(M, N, T)                                               \
  if (m == M && n == N && (trans != 0) == T)                               \
    err = launch<M, N, T>(a, x, o, batch, sA0, sA1, sv0, sv1, order_full, \
                          order_rem, split, s);                            \
  else
  MATVEC_CASE(2, 8, false)
  MATVEC_CASE(8, 8, false)
  MATVEC_CASE(14, 8, false)
  MATVEC_CASE(14, 8, true)
  MATVEC_CASE(14, 14, false)
  err = cudaErrorInvalidValue;
#undef MATVEC_CASE
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
