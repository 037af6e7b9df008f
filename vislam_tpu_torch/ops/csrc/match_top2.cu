// Descriptor matching core: squared-L2 distances + row top-2 + column
// argmin, fused, for sm_90a.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/match_kernel.py
// (match_top2_pallas: _kernel / _make_gated_kernel, _distances,
// _reduce_top2). For A (K, D) and B (N, D) float32 descriptors, D = 128
// (SIFT) or 256 (BRIEF), with validity masks it computes, for every pair,
//   d = max(|a|^2 + |b|^2 - 2 a.b, 0)       (the reference's formula)
//   d = 1e9 where either row is invalid, or (gated) where the predicted
//       position of row a lies farther than r from keypoint b
// and reduces without ever storing the K x N matrix:
//   min1[i], arg1[i]  row minimum and its first column
//   min2[i]           minimum over the row with column arg1[i] removed (a
//                     tie at min1 therefore gives min2 == min1)
//   colarg[j]         first row reaching the column minimum
//
// What bounds it on an H100: neither bandwidth (2 x 768 x 1 KB in at
// D = 256) nor the card's peak: 2*K*N*D = 302 MFLOP at K = N = 768, D = 256
// is microseconds of CUDA core work, so a simple kernel is latency- and
// occupancy-bound (48 blocks at K = 768). Design: each 128-thread block
// owns 16 A rows held in shared memory and streams B through shared memory
// in 32-column tiles (row stride D + 1 floats, so the 32 lanes of a warp
// read 32 banks). At D = 256 the two buffers take 49 KB, above the 48 KB
// of static shared memory, so they are dynamic shared memory. Each warp
// owns 4 rows, each lane one column of the tile; a lane keeps a running
// (min1, arg1, min2) per row over its columns in increasing order, and the
// lanes merge by warp shuffles at the end. The column argmin across blocks
// is one 64-bit atomicMin per column and block on
// (float bits of d) << 32 | row, exact because d >= 0 and ordered to give
// the first row on ties; a second small kernel unpacks the row. BRIEF
// distances are exact multiples of 1/64, so exact ties are common: every
// comparison above breaks them to the first index, as the reference does.
// Float32 only; bf16 inputs and a leading window batch come with the
// window track matcher. No tensor cores, no TMA: right and simple first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;              // A rows per block
constexpr int WARPS = 4;
constexpr int RPW = ROWS / WARPS;     // rows per warp
constexpr int COLS = 32;              // B columns per tile, one per lane
constexpr int THREADS = WARPS * 32;
constexpr float BIG = 1e9f;

__device__ __forceinline__ unsigned long long col_key(float d, int row) {
  // d >= 0: clearing the sign bit maps -0 to +0 so the bits order like d.
  const unsigned int bits = __float_as_uint(d) & 0x7fffffffu;
  return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned int>(row);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS + COLS) * (D + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
                  const float* __restrict__ uv_pred, const float* __restrict__ uv_b,
                  float r2, int gated, int K, int N,
                  float* __restrict__ min1, float* __restrict__ min2,
                  int* __restrict__ arg1, unsigned long long* __restrict__ colkey) {
  extern __shared__ float smem[];
  float (*sA)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);                // ROWS
  float (*sB)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + ROWS * (D + 1));  // COLS
  __shared__ float sqA[ROWS], puA[ROWS], pvA[ROWS];
  __shared__ int okA[ROWS];
  __shared__ unsigned long long sCol[COLS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * ROWS;

  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sA[r][d] = (r0 + r < K) ? A[(size_t)(r0 + r) * D + d] : 0.f;
  }
  __syncthreads();
  if (tid < ROWS) {
    const int row = r0 + tid;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += sA[tid][d] * sA[tid][d];
    sqA[tid] = s;
    okA[tid] = (row < K) && ma[row];
    puA[tid] = (gated && row < K) ? uv_pred[2 * row] : 0.f;
    pvA[tid] = (gated && row < K) ? uv_pred[2 * row + 1] : 0.f;
  }

  float m1[RPW], m2[RPW];
  int a1[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m1[rr] = INFINITY;
    m2[rr] = INFINITY;
    a1[rr] = 0;
  }

  for (int c0 = 0; c0 < N; c0 += COLS) {
    for (int i = tid; i < COLS * D; i += THREADS) {
      const int c = i / D, d = i % D;
      sB[c][d] = (c0 + c < N) ? Bm[(size_t)(c0 + c) * D + d] : 0.f;
    }
    if (tid < COLS) sCol[tid] = ~0ull;
    __syncthreads();

    const int col = c0 + lane;
    if (col < N) {
      float sqb = 0.f;
      for (int d = 0; d < D; ++d) sqb += sB[lane][d] * sB[lane][d];
      const bool okB = mb[col] != 0;
      const float bu = gated ? uv_b[2 * col] : 0.f;
      const float bv = gated ? uv_b[2 * col + 1] : 0.f;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int lr = warp * RPW + rr;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += sA[lr][d] * sB[lane][d];
        float dist = fmaxf(sqA[lr] + sqb - 2.f * dot, 0.f);
        if (!(okA[lr] && okB)) dist = BIG;
        if (gated) {
          const float du = puA[lr] - bu, dv = pvA[lr] - bv;
          if (!(du * du + dv * dv <= r2)) dist = BIG;
        }
        if (dist < m1[rr]) {
          m2[rr] = m1[rr];
          m1[rr] = dist;
          a1[rr] = col;
        } else if (dist < m2[rr]) {
          m2[rr] = dist;
        }
        if (r0 + lr < K) atomicMin(&sCol[lane], col_key(dist, r0 + lr));
      }
    }
    __syncthreads();
    if (tid < COLS && c0 + tid < N) atomicMin(&colkey[c0 + tid], sCol[tid]);
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    float v1 = m1[rr], v2 = m2[rr];
    int i1 = a1[rr];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i1, off);
      if (o1 < v1 || (o1 == v1 && oi < i1)) {
        v2 = fminf(v1, o2);
        v1 = o1;
        i1 = oi;
      } else {
        v2 = fminf(v2, o1);
      }
    }
    const int row = r0 + warp * RPW + rr;
    if (lane == 0 && row < K) {
      min1[row] = v1;
      min2[row] = fminf(v2, BIG);
      arg1[row] = i1;
    }
  }
}

__global__ void unpack_colarg_kernel(const unsigned long long* __restrict__ colkey,
                                     int* __restrict__ colarg, int N) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < N) colarg[j] = static_cast<int>(colkey[j] & 0xffffffffull);
}

template <int D>
cudaError_t launch(const float* a, const float* b, const unsigned char* ma,
                   const unsigned char* mb, const float* uv_pred, const float* uv_b,
                   float r2, int gated, float* min1, float* min2, int* arg1,
                   unsigned long long* colkey, int K, int N, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(match_top2_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes<D>()));
  if (e != cudaSuccess) return e;
  match_top2_kernel<D><<<(K + ROWS - 1) / ROWS, THREADS, smem_bytes<D>(), s>>>(
      a, b, ma, mb, uv_pred, uv_b, r2, gated, K, N, min1, min2, arg1, colkey);
  return cudaGetLastError();
}

}  // namespace

// a (K, D), b (N, D) float32 with D = 128 or 256; ma (K,), mb (N,) bool as
// bytes; uv_pred (K, 2), uv_b (N, 2) float32, read only when gated != 0; r2 the squared
// gate radius. Outputs min1, min2 (K,) float32, arg1 (K,) int32, colarg
// (N,) int32; colkey (N,) is 8-byte scratch. All contiguous device
// buffers. Launches on `stream` and returns the first CUDA error (0 on
// success); never synchronises.
extern "C" int match_top2(const float* a, const float* b,
                          const unsigned char* ma, const unsigned char* mb,
                          const float* uv_pred, const float* uv_b, float r2,
                          int gated, float* min1, float* min2, int* arg1,
                          int* colarg, unsigned long long* colkey, int K, int N,
                          int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(colkey, 0xFF, sizeof(unsigned long long) * N, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = D == 128 ? launch<128>(a, b, ma, mb, uv_pred, uv_b, r2, gated, min1, min2, arg1,
                             colkey, K, N, s)
               : launch<256>(a, b, ma, mb, uv_pred, uv_b, r2, gated, min1, min2, arg1,
                             colkey, K, N, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  unpack_colarg_kernel<<<(N + 255) / 256, 256, 0, s>>>(colkey, colarg, N);
  return static_cast<int>(cudaGetLastError());
}
