// The step perturbation's per-pass draw for a whole fleet, CUDA C++ for
// sm_90a: lcqpow_tpu_torch/prng.py:perturb_step_plain in one launch.
//
// No TPU kernel does this: the JAX package draws with jax.random inside its
// jitted loop (lcqpow_tpu/solver.py:496-499), which XLA fuses into the pass.
// The port's loop is eager, and the plain PyTorch version of the same
// Threefry-2x32 arithmetic takes some 750 small ops a pass; this kernel
// takes one launch.
//
// What it computes, for each lane b with active[b] (keys as uint32 words
// held in int64, r as int64):
//   key' = threefry(key, (0, 0)), sub = threefry(key, (0, 1))   split
//   k1 = threefry(sub, (0, 0)),   k2 = threefry(sub, (0, 1))    randint's
//   hi_j = threefry(k1, (0, j)),  lo_j = threefry(k2, (0, j))   64-bit words
//   r[b, j] = -1 + ((hi_j mod 3) * m + lo_j mod 3) mod 3
// with m = (2^32 mod 3)^2 mod 3
// as jax.random.split and jax.random.randint(sub, (n,), -1, 2) give them
// (JAX 0.9.0, partitionable Threefry, int64 draws).  A lane that is not
// active keeps its key and gets r = 0.  Integer operations only, so the
// kernel and the plain version agree bit for bit.
//
// What bounds it on an H100.  The inputs and outputs are a few hundred
// kilobytes at the solver's shapes (B = 4096, n = 8: 64 KiB of keys in and
// out, 256 KiB of r), a tenth of a microsecond at 3.35 TB/s; the hashes are
// (4 + 2n) per lane of about 80 integer operations each, a fifth of a
// microsecond at the card's integer rate.  So the launch and one round trip
// to memory bound it.  Design: one thread per (lane, element), so a pass is
// one wave of short independent threads; every thread of a lane recomputes
// the lane's four key hashes in registers rather than waiting on a first
// warp (four hashes cost less than a barrier and a trip through shared
// memory), and the thread of element 0 writes the lane's new key.

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

__global__ void __launch_bounds__(kThreads)
perturb_step_kernel(const long long* __restrict__ keys,
                    const bool* __restrict__ active,
                    long long* __restrict__ keys_out,
                    long long* __restrict__ r, int batch, int n) {
  const int per_lane = n > 0 ? n : 1;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= batch * per_lane) return;
  const int lane = t / per_lane;
  const int j = t - lane * per_lane;
  const Words key = {static_cast<uint32_t>(keys[2 * lane]),
                     static_cast<uint32_t>(keys[2 * lane + 1])};
  if (!active[lane]) {
    if (j < n) r[t] = 0;
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
  r[t] = kMinVal + static_cast<long long>(off);
}

}  // namespace

// keys (batch, 2) int64 and active (batch,) bool in; keys_out (batch, 2)
// and r (batch, n) int64 out; all contiguous on the current card.  Returns
// the cudaError_t of the launch (0 on success); checks nothing else: the
// Python wrapper (prng.perturb_step) validates shapes and types.
extern "C" int threefry_perturb_step(const void* keys, const void* active,
                                     void* keys_out, void* r, int batch,
                                     int n, void* stream) {
  const long long threads =
      static_cast<long long>(batch) * (n > 0 ? n : 1);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  perturb_step_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const bool*>(active),
      static_cast<long long*>(keys_out), static_cast<long long*>(r), batch,
      n);
  return static_cast<int>(cudaGetLastError());
}
