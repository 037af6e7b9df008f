// Gumbel noise from JAX's threefry2x32 stream, for sm_90a: the RANSAC
// hypotheses' draws of the port, keyed as the reference keys them.
//
// Replaces no Pallas kernel: the reference's draws are jax.random calls
// that XLA fuses (threefry2x32 hash, the uniform's bit trick, two logs).
// It was added because the port's step is bound by the host's launches
// (PERF.md section 5): the plain version (utils/prng.py) is ~170 small
// launches a draw, this one launch for every draw of a frame.
//
// One launch writes F = P x J fields of N float32 values each, field
// (p, j) from the key
//   k = fold(... fold(fold(keys[p], index[p]), path[j][0]) ..., path[j][L-1])
// (fold(k, d) is the hash of the counter pair (0, d) under k: JAX's
// fold_in, and split(k, n)[d] in partitionable mode; index is optional),
// value i = -log(-log(u)), u the uniform in [tiny, 1) of the 32 bits
// h1 ^ h2 of the hash of (0, i) under k: jax.random.gumbel(k, shape) with
// jax_threefry_partitionable (jax 0.9's default). The logs are the twin's
// float64 series (utils/prng.py::log_f32), each operation rounded as the
// twin's (no contraction), so kernel and twin agree bit for bit.
//
// What bounds it on an H100: operations. Per value one 20-round hash (~120
// int32 operations) and two float64 logs (~30 operations each) against 4
// bytes written: 1.57M values (the default path's four 512 x 768 fields)
// are ~190 M int32 and ~94 M float64 operations, ~11 us at the int32 rate
// against 1.9 us of writes. Design: simple, one thread per value (4
// values a thread, strided by the block), the block's key derived once by
// its first thread into shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxFolds = 16;   // path entries of all fields together

struct Paths {
  int count;   // J, fields per key
  int len;     // L, folds per field after the index (padded with -1)
  int data[kMaxFolds];
};

__device__ __forceinline__ void rounds(uint32_t& x1, uint32_t& x2, int a, int b, int c, int d) {
  x1 += x2; x2 = __funnelshift_l(x2, x2, a); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, b); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, c); x2 ^= x1;
  x1 += x2; x2 = __funnelshift_l(x2, x2, d); x2 ^= x1;
}

// Threefry-2x32, 20 rounds, JAX's schedule: (x1, x2) <- hash of (x1, x2).
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1; x2 += k2;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k2; x2 += k3 + 1u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k3; x2 += k1 + 2u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k1; x2 += k2 + 3u;
  rounds(x1, x2, 17, 29, 16, 24); x1 += k2; x2 += k3 + 4u;
  rounds(x1, x2, 13, 15, 26, 6);  x1 += k3; x2 += k1 + 5u;
}

// utils/prng.py::log_f32: log(x) = e ln2 + 2 atanh(s), s = (m - 1)/(m + 1),
// m in [sqrt(1/2), sqrt(2)), 9 terms of the series, in float64, rounded
// to float32 at the end.
__device__ __forceinline__ float log_f32(float x) {
  int e;
  double m = frexp(static_cast<double>(x), &e);
  if (m < 0x1.6a09e667f3bcdp-1) {
    m = m * 2.0;
    e -= 1;
  }
  const double s = __ddiv_rn(__dsub_rn(m, 1.0), __dadd_rn(m, 1.0));
  const double s2 = __dmul_rn(s, s);
  double p = 0x1.e1e1e1e1e1e1ep-5;
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.1111111111111p-4);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.3b13b13b13b14p-4);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.745d1745d1746p-4);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.c71c71c71c71cp-4);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.2492492492492p-3);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.999999999999ap-3);
  p = __dadd_rn(__dmul_rn(p, s2), 0x1.5555555555555p-2);
  p = __dadd_rn(__dmul_rn(p, s2), 1.0);
  const double r = __dadd_rn(__dmul_rn(static_cast<double>(e), 0x1.62e42fefa39efp-1),
                             __dmul_rn(2.0 * s, p));
  return __double2float_rn(r);
}

// jax.random.gumbel's value of 32 random bits: u = max(tiny, f * (1 - tiny)
// + tiny) with f = [1, 2) from the top 23 bits, minus 1 (1 - tiny is 1 in
// float32), then -log(-log(u)).
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float tiny = 0x1.0p-126f;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, 1.0f), tiny));
  return -log_f32(-log_f32(u));
}

__global__ void __launch_bounds__(kThreads)
threefry_gumbel_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ index,
                       Paths paths, int n, float* __restrict__ out) {
  __shared__ uint32_t key[2];
  const int field = blockIdx.y;
  const int p = field / paths.count;
  const int j = field - p * paths.count;
  if (threadIdx.x == 0) {
    uint32_t k1 = static_cast<uint32_t>(keys[2 * p]);
    uint32_t k2 = static_cast<uint32_t>(keys[2 * p + 1]);
    for (int l = -1; l < paths.len; ++l) {
      const int d = l < 0 ? 0 : paths.data[j * paths.len + l];
      if ((l < 0 && index == nullptr) || d < 0) continue;   // no index; padding
      uint32_t x1 = 0u;
      uint32_t x2 = static_cast<uint32_t>(l < 0 ? index[p] : d);
      threefry(k1, k2, x1, x2);
      k1 = x1;
      k2 = x2;
    }
    key[0] = k1;
    key[1] = k2;
  }
  __syncthreads();
  const uint32_t k1 = key[0], k2 = key[1];
  float* o = out + static_cast<int64_t>(field) * n;
  const int first = blockIdx.x * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = first + e * kThreads;
    if (i < n) {
      uint32_t x1 = 0u, x2 = static_cast<uint32_t>(i);
      threefry(k1, k2, x1, x2);
      o[i] = gumbel_of(x1 ^ x2);
    }
  }
}

}  // namespace

// out (P, J, n) float32 from keys (P, 2) int32 (the uint32 words' bits),
// index (P,) int32 or null, and J paths of L folds each (path, J x L
// values, -1 where a shorter path has no fold). Returns the launch's
// cudaError_t (0 on success).
extern "C" int threefry_gumbel(const void* keys, const void* index, int P, int J, int L,
                               const int* path, int n, void* out, void* stream) {
  if (P < 1 || J < 1 || L < 0 || J * L > kMaxFolds || n < 1 || P * J > 65535 ||
      n > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Paths paths{};
  paths.count = J;
  paths.len = L;
  for (int i = 0; i < J * L; ++i) paths.data[i] = path[i];
  const dim3 grid((n + kThreads * kPerThread - 1) / (kThreads * kPerThread), P * J);
  threefry_gumbel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(index), paths, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
