// Shi-Tomasi corner response + 5x5 non-max suppression, fused, for sm_90a.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/harris_kernel.py
// (_harris_nms_batched / _kernel / _response_vmem, detector="shi_tomasi").
// For each pixel of a (B, H, W) float32 image batch it computes
//   gx, gy   Scharr 3x3 gradients (unit gain, /32)
//   a, b, c  the structure tensor gx^2, gx*gy, gy^2, each blurred by a
//            separable Gaussian (radius 3, sigma 1.5)
//   resp     the min eigenvalue (a+c)/2 - sqrt(((a-c)/2)^2 + b^2 + 1e-12)
//   nms      resp where resp >= max(resp over its 5x5 window), else -inf
// and writes resp and nms, both (B, H, W) float32.
//
// Boundary semantics are XLA's SAME padding, stage by stage: pixels outside
// the image read 0 for the gradient and blur stencils, and do not take
// part in the NMS window (reduce_window pads with -inf).
//
// What bounds it on an H100: memory. One read of the level (4 B/px) and two
// writes (8 B/px); the ~120 flop/px of stencil arithmetic is far below the
// card's ratio of flops to bytes. The design keeps every intermediate field
// out of device memory: each 256-thread block owns one 32x32 output tile,
// stages the tile plus a 6-px halo (Scharr 1 + blur 3 + NMS 2) of the image
// in shared memory, and runs the whole stencil chain there (47 KB static
// shared memory, the image buffer reused for the response). The batch rides
// the grid's z dimension. Right and simple first: no vectorised loads,
// no register tiling.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;            // output tile side
constexpr int HALO = 6;             // scharr 1 + blur 3 + nms 2
constexpr int IMG = TILE + 2 * HALO;  // 44: staged image, offset -6
constexpr int PRD = TILE + 10;      // 42: gradient products, offset -5
constexpr int RSP = TILE + 4;       // 36: response, offset -2
constexpr int THREADS = 256;

// float32 Gaussian taps, radius 3, sigma 1.5, normalised to sum 1 (the
// reference's _make_gauss() values, as numpy computes them in float32).
__constant__ float kGauss[7] = {
    3.663284704e-02f, 1.112807542e-01f, 2.167453319e-01f, 2.706821561e-01f,
    2.167453319e-01f, 1.112807542e-01f, 3.663284704e-02f};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

__global__ void __launch_bounds__(THREADS)
shi_tomasi_nms_kernel(const float* __restrict__ img, float* __restrict__ nms,
                      float* __restrict__ resp, int H, int W) {
  __shared__ float s_img[IMG * IMG];        // image; later the response
  __shared__ float s_prd[3][PRD * PRD];     // gx*gx, gx*gy, gy*gy
  __shared__ float s_vbl[3][RSP * PRD];     // products blurred along y

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const float* im = img + (size_t)b * plane;
  const int tid = threadIdx.x;

  // 1. Stage the image tile with its halo; outside the image reads 0.
  for (int i = tid; i < IMG * IMG; i += THREADS) {
    const int gy = y0 - HALO + i / IMG, gx = x0 - HALO + i % IMG;
    s_img[i] = inside(gy, gx, H, W) ? im[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // 2. Scharr gradients and their products on [-5, 37)^2 (0 outside the image).
  for (int i = tid; i < PRD * PRD; i += THREADS) {
    const int ly = i / PRD, lx = i % PRD;
    float xx = 0.f, xy = 0.f, yy = 0.f;
    if (inside(y0 - 5 + ly, x0 - 5 + lx, H, W)) {
      const float* p = s_img + (ly + 1) * IMG + (lx + 1);
      const float gx = (3.f * (p[-IMG + 1] - p[-IMG - 1]) + 10.f * (p[1] - p[-1])
                        + 3.f * (p[IMG + 1] - p[IMG - 1])) * (1.f / 32.f);
      const float gy = (3.f * (p[IMG - 1] - p[-IMG - 1]) + 10.f * (p[IMG] - p[-IMG])
                        + 3.f * (p[IMG + 1] - p[-IMG + 1])) * (1.f / 32.f);
      xx = gx * gx;
      xy = gx * gy;
      yy = gy * gy;
    }
    s_prd[0][i] = xx;
    s_prd[1][i] = xy;
    s_prd[2][i] = yy;
  }
  __syncthreads();

  // 3. Gaussian along y: rows [-2, 34), columns [-5, 37).
  for (int i = tid; i < RSP * PRD; i += THREADS) {
    const int ly = i / PRD, lx = i % PRD;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int r = (ly + k) * PRD + lx;
      a0 += kGauss[k] * s_prd[0][r];
      a1 += kGauss[k] * s_prd[1][r];
      a2 += kGauss[k] * s_prd[2][r];
    }
    s_vbl[0][i] = a0;
    s_vbl[1][i] = a1;
    s_vbl[2][i] = a2;
  }
  __syncthreads();

  // 4. Gaussian along x and the min eigenvalue on [-2, 34)^2; -inf outside
  //    the image so those pixels drop out of the NMS window.
  for (int i = tid; i < RSP * RSP; i += THREADS) {
    const int ly = i / RSP, lx = i % RSP;
    float r = -INFINITY;
    if (inside(y0 - 2 + ly, x0 - 2 + lx, H, W)) {
      float a = 0.f, bb = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int q = ly * PRD + lx + k;
        a += kGauss[k] * s_vbl[0][q];
        bb += kGauss[k] * s_vbl[1][q];
        c += kGauss[k] * s_vbl[2][q];
      }
      const float half_tr = 0.5f * (a + c);
      const float half_df = 0.5f * (a - c);
      r = half_tr - sqrtf(half_df * half_df + bb * bb + 1e-12f);
    }
    s_img[i] = r;
  }
  __syncthreads();

  // 5. 5x5 NMS (resp >= window max) and both outputs.
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    const int ly = i / TILE, lx = i % TILE;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float c = s_img[(ly + 2) * RSP + lx + 2];
    float m = c;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy)
#pragma unroll
      for (int dx = 0; dx < 5; ++dx)
        m = fmaxf(m, s_img[(ly + dy) * RSP + lx + dx]);
    const size_t o = (size_t)b * plane + (size_t)gy * W + gx;
    resp[o] = c;
    nms[o] = (c >= m) ? c : -INFINITY;
  }
}

}  // namespace

// img, nms, resp: contiguous (B, H, W) float32 device buffers. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int shi_tomasi_nms(const float* img, float* nms, float* resp,
                              int B, int H, int W, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  shi_tomasi_nms_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, nms, resp, H, W);
  return static_cast<int>(cudaGetLastError());
}
