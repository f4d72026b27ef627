// The step perturbation of one homotopy pass for a whole fleet, CUDA C++
// for sm_90a: lcqpow_tpu_torch/prng.py:perturb_apply_plain in one launch
// (draw, apply and key carry).
//
// No TPU kernel does this: the JAX package draws with jax.random inside its
// jitted loop and adds the draw to the iterate (lcqpow_tpu/solver.py:496-499,
// a done lane keeping its key and iterate by the lax.cond at :515-518), all
// of which XLA fuses into the pass.  The port's loop is eager; this kernel
// is that whole step in one launch.
//
// What it computes, for each lane b with go[b] (keys as uint32 words held
// in int64, xk and x of type T, float or double):
//   key' = threefry(key, (0, 0)), sub = threefry(key, (0, 1))   split
//   k1 = threefry(sub, (0, 0)),   k2 = threefry(sub, (0, 1))    randint's
//   hi_j = threefry(k1, (0, j)),  lo_j = threefry(k2, (0, j))   64-bit words
//   r_j = -1 + ((hi_j mod 3) * m + lo_j mod 3) mod 3
//   x[b, j] = xk[b, j] + T(r_j) * T(eps)
// with m = (2^32 mod 3)^2 mod 3, as jax.random.split and
// jax.random.randint(sub, (n,), -1, 2) give them (JAX 0.9.0, partitionable
// Threefry, int64 draws).  A lane that is not going keeps its key and its
// iterate bit for bit (x = xk, -0 included).  A going lane's element goes
// through the add even when r = 0, so -0 becomes +0 there, as in the plain
// version.  The draw is integer-only, and the product T(r) * T(eps) is
// exact (r is -1, 0 or 1), so the one rounding is the add's: built with
// --fmad=false, the kernel and the plain version agree bit for bit.
//
// What bounds it on an H100: neither bytes nor operations.  At the
// solver's widths (B = 4096, n = 8, f32) it moves some 400 KB (keys in and
// out, the mask, xk in and x out), 0.12 us at 3.35 TB/s, and hashes
// (4 + 2n) times per going lane at some 80 integer operations a hash,
// 0.19 us at the card's integer rate.  Each thread's critical
// path is three dependent hashes (sub, then k1 and k2, then hi and lo) and
// one round trip to memory; with the launch that makes ~2 us, about what a
// one-lane launch takes.  So the device time is near its floor, and what a
// pass paid around the draw was host time: the eager cast, scale, add and
// two lane selects around a separate draw kernel, each an op launched from
// the host.  Design: this launch is the pass's whole perturbation, so the
// solver launches nothing else for it.  One thread per (lane, element), one
// wave of short independent threads; every thread of a lane recomputes the
// lane's key hashes in registers rather than waiting on a first warp (the
// hashes cost less than a barrier and a trip through shared memory), and
// the thread of element 0 writes the lane's key; each thread loads its xk
// element together with the key, before the chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMinVal = -1;
constexpr uint64_t kSpan = 3;  // maxval - minval for randint(-1, 2)
// randint's multiplier (2^32 mod span)^2 mod span.
constexpr uint64_t kMult =
    ((1ull << 32) % kSpan) * ((1ull << 32) % kSpan) % kSpan;

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32_p: 20 rounds over the count pair (x0, x1) under (k0, k1).
__device__ __forceinline__ Words threefry(Words k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + ks[0];
  uint32_t b = x1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {a, b};
}

__device__ __forceinline__ uint64_t word64(Words w) {
  return (static_cast<uint64_t>(w.a) << 32) | w.b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
perturb_apply_kernel(const long long* __restrict__ keys,
                     const bool* __restrict__ go,
                     const T* __restrict__ xk,
                     long long* __restrict__ keys_out,
                     T* __restrict__ x, int batch, int n, T eps) {
  const int per_lane = n > 0 ? n : 1;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= batch * per_lane) return;
  const int lane = t / per_lane;
  const int j = t - lane * per_lane;
  const Words key = {static_cast<uint32_t>(keys[2 * lane]),
                     static_cast<uint32_t>(keys[2 * lane + 1])};
  // Loaded before the hash chain, so that its trip to memory overlaps the
  // chain instead of following it.
  const T xv = j < n ? xk[t] : T(0);
  if (!go[lane]) {
    if (j < n) x[t] = xv;
    if (j == 0) {
      keys_out[2 * lane] = key.a;
      keys_out[2 * lane + 1] = key.b;
    }
    return;
  }
  if (j == 0) {
    const Words next = threefry(key, 0u, 0u);
    keys_out[2 * lane] = next.a;
    keys_out[2 * lane + 1] = next.b;
  }
  if (j >= n) return;
  const Words sub = threefry(key, 0u, 1u);
  const Words k1 = threefry(sub, 0u, 0u);
  const Words k2 = threefry(sub, 0u, 1u);
  const uint64_t hi = word64(threefry(k1, 0u, static_cast<uint32_t>(j)));
  const uint64_t lo = word64(threefry(k2, 0u, static_cast<uint32_t>(j)));
  const uint64_t off = ((hi % kSpan) * kMult + lo % kSpan) % kSpan;
  const T r = static_cast<T>(kMinVal + static_cast<long long>(off));
  x[t] = xv + r * eps;
}

template <typename T>
void launch(const void* keys, const void* go, const void* xk, void* keys_out,
            void* x, int batch, int n, double eps, cudaStream_t stream) {
  const long long threads =
      static_cast<long long>(batch) * (n > 0 ? n : 1);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  perturb_apply_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const long long*>(keys), static_cast<const bool*>(go),
      static_cast<const T*>(xk), static_cast<long long*>(keys_out),
      static_cast<T*>(x), batch, n, static_cast<T>(eps));
}

}  // namespace

// keys (batch, 2) int64, go (batch,) bool and xk (batch, n) float
// (f64 == 0) or double (f64 != 0) in; keys_out (batch, 2) and x (batch, n)
// out; all contiguous on card `device`, launched on `stream`.  Switches the
// thread's current card to `device` for the launch only when it is another,
// and back.  Returns the cudaError_t of the launch (0 on success); checks
// nothing else: the Python wrapper (prng.perturbation) validates shapes,
// types and the card.
extern "C" int threefry_perturb_apply(const void* keys, const void* go,
                                      const void* xk, void* keys_out,
                                      void* x, int batch, int n, double eps,
                                      int f64, int device, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(keys, go, xk, keys_out, x, batch, n, eps, s);
  } else {
    launch<float>(keys, go, xk, keys_out, x, batch, n, eps, s);
  }
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
