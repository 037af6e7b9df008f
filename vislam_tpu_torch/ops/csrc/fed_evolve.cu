// One explicit step of Perona-Malik diffusion (a step of a FED cycle), for
// sm_90a; the wrapper launches it once per step.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/fed_kernel.py
// (_fed_evolve_batched / _kernel). Each step, on a float32 field L:
//   sm    = Gaussian blur of L (radius 2, sigma 1), along x then along y
//   gx,gy = Scharr gradients of sm (unit gain, /32)
//   g     = 1 / (1 + (gx^2 + gy^2) / k^2)
//   flux  = sum over the 4 neighbours n of 0.5 (g + g_n) (L_n - L)
//   L'    = L + tau * flux
//
// Borders: the TPU kernel edge-pads the image once by 4n for an n-step
// cycle and evolves the padded block; its output equals "extend the image
// by its edge values, then evolve on an unbounded domain". Here every
// field is addressed in image coordinates (the image at [0, H) x [0, W)):
// a step reads `src`, which covers [sy, sy + sH) x [sx, sx + sW), clamping
// each read into it, and writes `dst`, covering [dy, dy + dH) x [dx, dx +
// dW). The first step reads the image itself, so clamping is the edge
// extension; step s of n writes the image extended by 4 (n - s), the part
// the remaining steps read (each reads 4 px around what it writes), so no
// later read clamps, and the last step writes the image's own (H, W).
//
// What bounds it on an H100: memory. Each step reads and writes the field
// once (8 B/px) against ~80 flop/px; a frame's 12 steps (cycles of 4 and
// 8 at 480x752, each on the shrinking extended domain) move ~37 MB. The
// design keeps the step's intermediate fields (blur, gradients,
// conductivity) out of device memory: each 256-thread block owns one 32x32
// output tile, stages the tile plus a 4-px halo
// (blur 2 + Scharr 1 + flux 1) of L in shared memory and runs the step
// there. k is read from device memory, one per batch element, so the host
// never waits for it; the batch rides the grid's z. Fusing the whole cycle
// per tile would need a 4n-px halo (32 px for n = 8, ~9x redundant work on
// 32-px tiles): a later design.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int LS = TILE + 8;   // 40: L on [-4, 36)^2
constexpr int HB = TILE + 4;   // 36: blurred field on [-2, 34)^2
constexpr int GS = TILE + 2;   // 34: conductivity on [-1, 33)^2

// float32 Gaussian taps, radius 2, sigma 1, normalised to sum 1 (numpy's
// float32 values of the reference's _gauss_taps(2, 1.0)).
__constant__ float kBlur[5] = {5.448868871e-02f, 2.442013621e-01f, 4.026199579e-01f,
                               2.442013621e-01f, 5.448868871e-02f};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
fed_step_kernel(const float* __restrict__ src, int sy, int sx, int sH, int sW,
                float* __restrict__ dst, int dy, int dx, int dH, int dW,
                const float* __restrict__ k, float tau) {
  __shared__ float sL[LS * LS];
  __shared__ float sH_[LS * HB];   // blurred along x: rows [-4, 36), cols [-2, 34)
  __shared__ float sSm[HB * HB];
  __shared__ float sG[GS * GS];

  const int b = blockIdx.z;
  const int ty = blockIdx.y * TILE, tx = blockIdx.x * TILE;  // dst-local tile origin
  const float* S = src + (size_t)b * sH * sW;
  const float kk = k[b];
  const float k2 = kk * kk;
  const int tid = threadIdx.x;

  // 1. Stage L around the tile, reads clamped into src.
  for (int i = tid; i < LS * LS; i += THREADS) {
    const int iy = dy + ty - 4 + i / LS - sy;   // src-local row
    const int ix = dx + tx - 4 + i % LS - sx;
    sL[i] = S[(size_t)clampi(iy, 0, sH - 1) * sW + clampi(ix, 0, sW - 1)];
  }
  __syncthreads();
  // 2. Blur along x, then along y.
  for (int i = tid; i < LS * HB; i += THREADS) {
    const int r = i / HB, c = i % HB;
    const float* p = sL + r * LS + c;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 5; ++q) a += kBlur[q] * p[q];
    sH_[i] = a;
  }
  __syncthreads();
  for (int i = tid; i < HB * HB; i += THREADS) {
    const int r = i / HB, c = i % HB;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 5; ++q) a += kBlur[q] * sH_[(r + q) * HB + c];
    sSm[i] = a;
  }
  __syncthreads();
  // 3. Scharr gradients of the blurred field and the conductivity.
  for (int i = tid; i < GS * GS; i += THREADS) {
    const int r = i / GS, c = i % GS;
    const float* p = sSm + (r + 1) * HB + (c + 1);
    const float gx = (3.f * (p[-HB + 1] - p[-HB - 1]) + 10.f * (p[1] - p[-1])
                      + 3.f * (p[HB + 1] - p[HB - 1])) * (1.f / 32.f);
    const float gy = (3.f * (p[HB - 1] - p[-HB - 1]) + 10.f * (p[HB] - p[-HB])
                      + 3.f * (p[HB + 1] - p[-HB + 1])) * (1.f / 32.f);
    sG[i] = 1.f / (1.f + (gx * gx + gy * gy) / k2);
  }
  __syncthreads();
  // 4. Flux over the 4 neighbours (right, left, down, up) and the update.
  float* D = dst + (size_t)b * dH * dW;
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    if (ty + r >= dH || tx + c >= dW) continue;
    const float* L = sL + (r + 4) * LS + (c + 4);
    const float* g = sG + (r + 1) * GS + (c + 1);
    const float Lc = L[0], gc = g[0];
    float flux = 0.f;
    flux += 0.5f * (gc + g[1]) * (L[1] - Lc);
    flux += 0.5f * (gc + g[-1]) * (L[-1] - Lc);
    flux += 0.5f * (gc + g[GS]) * (L[LS] - Lc);
    flux += 0.5f * (gc + g[-GS]) * (L[-LS] - Lc);
    D[(size_t)(ty + r) * dW + tx + c] = Lc + tau * flux;
  }
}

}  // namespace

// One FED step for a batch of B fields. src (B, sH, sW) covers image
// coordinates [sy, sy + sH) x [sx, sx + sW); dst (B, dH, dW) covers
// [dy, dy + dH) x [dx, dx + dW); k (B,) the contrast parameters; all
// contiguous float32 device buffers, src and dst distinct. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int fed_step(const float* src, int sy, int sx, int sH, int sW, float* dst,
                        int dy, int dx, int dH, int dW, const float* k, float tau,
                        int B, void* stream) {
  const dim3 grid((dW + TILE - 1) / TILE, (dH + TILE - 1) / TILE, B);
  fed_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, sy, sx, sH, sW, dst, dy, dx, dH, dW, k, tau);
  return static_cast<int>(cudaGetLastError());
}
