// Detector response + 5x5 non-max suppression, fused, for sm_90a; one
// kernel templated on the response family.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/harris_kernel.py
// (_harris_nms_batched / _kernel / _response_vmem), all six families. For
// each pixel of a (B, H, W) float32 image batch it computes the response
//   shi_tomasi  min eigenvalue of the Gaussian(r3, s1.5)-blurred structure
//               tensor of the Scharr gradients
//   harris      det - 0.04 tr^2 of the same tensor
//   dog         |G(r3, s1) - G(r4, s1.6)|
//   hessian     gxx * gyy - gxy^2, iterated Scharr of G(r3, s1.5)
//   fast        FAST-16 score: max over starts of the min over a 9-arc of
//               ring - centre (bright) or centre - ring (dark)
//   _gradmag2   |Scharr G(r3, s1)|^2 (the KAZE contrast statistic)
// and writes resp and, except for _gradmag2, nms = resp where resp >=
// max(resp over its 5x5 window), else -inf.
//
// Borders (the wrapper's docstring says why): shi_tomasi, harris, dog and
// hessian read 0 outside the image at every stage (XLA's SAME padding);
// fast reads 0 outside the image; _gradmag2 zero-pads the image once and
// runs every stage on the extended domain (the TPU kernel's semantics).
// Pixels outside the image do not take part in an NMS window.
//
// What bounds it on an H100: memory. One read of the level (4 B/px) and up
// to two writes (8 B/px) against ~100-300 flop/px of stencil arithmetic,
// far below the card's ratio of flops to bytes. The design keeps every
// intermediate field out of device memory: each 256-thread block owns one
// 32x32 output tile, stages the tile plus the family's halo (its stencil
// chain + NMS 2) in shared memory and runs the whole chain there. The
// largest family (the structure tensor, three staged fields) needs 52 KB,
// above the 48 KB of static shared memory, so the buffers are dynamic
// shared memory sized per family (the limit set once per family and
// device). The batch rides the grid's z. Right and simple first: no
// vectorised loads, no register tiling.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "smem_once.cuh"

namespace {

enum Family : int { SHI_TOMASI = 0, HARRIS = 1, DOG = 2, HESSIAN = 3, FAST = 4, GRADMAG2 = 5 };

constexpr int TILE = 32;             // output tile side
constexpr int THREADS = 256;
constexpr int RSP = TILE + 4;        // response on [-2, 34)^2 (NMS radius 2)

// float32 Gaussian taps, normalised to sum 1, as numpy computes them in
// float32 for the reference (np.exp(-0.5 (x / sigma)^2) / sum).
__constant__ float kG15r3[7] = {
    3.663284704e-02f, 1.112807542e-01f, 2.167453319e-01f, 2.706821561e-01f,
    2.167453319e-01f, 1.112807542e-01f, 3.663284704e-02f};
__constant__ float kG10r3[7] = {
    4.433047958e-03f, 5.400557816e-02f, 2.420362234e-01f, 3.990502656e-01f,
    2.420362234e-01f, 5.400557816e-02f, 4.433047958e-03f};
__constant__ float kG16r4[9] = {
    1.100200415e-02f, 4.317514598e-02f, 1.146435291e-01f, 2.059770972e-01f,
    2.504044771e-01f, 2.059770972e-01f, 1.146435291e-01f, 4.317514598e-02f,
    1.100200415e-02f};
// FAST-16 ring, (dv, du) per sample, clockwise from 12 o'clock.
__constant__ int kRing[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3}, {2, 2}, {3, 1},
    {3, 0}, {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// Scharr 3x3 (unit gain, /32) at p in a buffer of row stride s.
__device__ __forceinline__ float scharr_x(const float* p, int s) {
  return (3.f * (p[-s + 1] - p[-s - 1]) + 10.f * (p[1] - p[-1])
          + 3.f * (p[s + 1] - p[s - 1])) * (1.f / 32.f);
}
__device__ __forceinline__ float scharr_y(const float* p, int s) {
  return (3.f * (p[s - 1] - p[-s - 1]) + 10.f * (p[s] - p[-s])
          + 3.f * (p[s + 1] - p[-s + 1])) * (1.f / 32.f);
}

// s (n x n) = image on [y0 - halo, .. + n) x [x0 - halo, .. + n), 0 outside.
__device__ void stage(const float* im, int H, int W, int y0, int x0, int halo,
                      int n, float* s) {
  for (int i = threadIdx.x; i < n * n; i += THREADS) {
    const int gy = y0 - halo + i / n, gx = x0 - halo + i % n;
    s[i] = inside(gy, gx, H, W) ? im[(size_t)gy * W + gx] : 0.f;
  }
}

// dst (rows x cols) [r][c] = sum_k taps[k] * src[r][c + k] (src stride ss).
template <int R>
__device__ void blur_x(const float* src, int ss, float* dst, int rows, int cols,
                       const float* taps) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    const float* p = src + r * ss + c;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) a += taps[k] * p[k];
    dst[i] = a;
  }
}

// dst (rows x cols) [r][c] = sum_k taps[k] * src[r + k][c] (src stride
// cols); with `mask`, 0 where (gy0 + r, gx0 + c) lies outside the image.
template <int R>
__device__ void blur_y(const float* src, float* dst, int rows, int cols,
                       const float* taps, bool mask, int gy0, int gx0, int H, int W) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    float a = 0.f;
    if (!mask || inside(gy0 + r, gx0 + c, H, W)) {
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k) a += taps[k] * src[(r + k) * cols + c];
    }
    dst[i] = a;
  }
}

// ---- shi_tomasi / harris: halo 6 (Scharr 1 + blur 3 + NMS 2).
constexpr int ST_IMG = TILE + 12;    // 44, offset -6
constexpr int ST_PRD = TILE + 10;    // 42, offset -5
constexpr int ST_SMEM = RSP * RSP + ST_IMG * ST_IMG + 3 * ST_PRD * ST_PRD + 3 * RSP * ST_PRD;

template <int FAM>
__device__ void structure_response(const float* im, int H, int W, int y0, int x0,
                                   float* s_resp, float* w) {
  float* s_img = w;                              // ST_IMG^2
  float* s_prd = s_img + ST_IMG * ST_IMG;        // 3 x ST_PRD^2: gx gx, gx gy, gy gy
  float* s_vbl = s_prd + 3 * ST_PRD * ST_PRD;    // 3 x RSP x ST_PRD, blurred along y
  stage(im, H, W, y0, x0, 6, ST_IMG, s_img);
  __syncthreads();
  // Gradients and their products on [-5, 37)^2, 0 outside the image.
  for (int i = threadIdx.x; i < ST_PRD * ST_PRD; i += THREADS) {
    const int ly = i / ST_PRD, lx = i % ST_PRD;
    float xx = 0.f, xy = 0.f, yy = 0.f;
    if (inside(y0 - 5 + ly, x0 - 5 + lx, H, W)) {
      const float* p = s_img + (ly + 1) * ST_IMG + (lx + 1);
      const float gx = scharr_x(p, ST_IMG), gy = scharr_y(p, ST_IMG);
      xx = gx * gx;
      xy = gx * gy;
      yy = gy * gy;
    }
    s_prd[i] = xx;
    s_prd[ST_PRD * ST_PRD + i] = xy;
    s_prd[2 * ST_PRD * ST_PRD + i] = yy;
  }
  __syncthreads();
  // Gaussian along y: rows [-2, 34), columns [-5, 37).
  for (int f = 0; f < 3; ++f)
    blur_y<3>(s_prd + f * ST_PRD * ST_PRD, s_vbl + f * RSP * ST_PRD, RSP, ST_PRD, kG15r3,
              false, 0, 0, H, W);
  __syncthreads();
  // Gaussian along x and the response on [-2, 34)^2; -inf outside the image.
  for (int i = threadIdx.x; i < RSP * RSP; i += THREADS) {
    const int ly = i / RSP, lx = i % RSP;
    float r = -INFINITY;
    if (inside(y0 - 2 + ly, x0 - 2 + lx, H, W)) {
      float a = 0.f, b = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int q = ly * ST_PRD + lx + k;
        a += kG15r3[k] * s_vbl[q];
        b += kG15r3[k] * s_vbl[RSP * ST_PRD + q];
        c += kG15r3[k] * s_vbl[2 * RSP * ST_PRD + q];
      }
      if (FAM == HARRIS) {
        const float tr = a + c;
        r = (a * c - b * b) - 0.04f * tr * tr;
      } else {
        const float half_tr = 0.5f * (a + c);
        const float half_df = 0.5f * (a - c);
        r = half_tr - sqrtf(half_df * half_df + b * b + 1e-12f);
      }
    }
    s_resp[i] = r;
  }
}

// ---- dog: halo 6 (blur 4 + NMS 2).
constexpr int DG_IMG = TILE + 12;    // 44, offset -6
constexpr int DG_SMEM = RSP * RSP + DG_IMG * DG_IMG + 2 * DG_IMG * RSP;

__device__ void dog_response(const float* im, int H, int W, int y0, int x0,
                             float* s_resp, float* w) {
  float* s_img = w;                         // DG_IMG^2
  float* s_h1 = s_img + DG_IMG * DG_IMG;    // DG_IMG x RSP: rows -6.., cols -2..
  float* s_h2 = s_h1 + DG_IMG * RSP;
  stage(im, H, W, y0, x0, 6, DG_IMG, s_img);
  __syncthreads();
  blur_x<3>(s_img + 1, DG_IMG, s_h1, DG_IMG, RSP, kG10r3);
  blur_x<4>(s_img, DG_IMG, s_h2, DG_IMG, RSP, kG16r4);
  __syncthreads();
  for (int i = threadIdx.x; i < RSP * RSP; i += THREADS) {
    const int ly = i / RSP, lx = i % RSP;
    float r = -INFINITY;
    if (inside(y0 - 2 + ly, x0 - 2 + lx, H, W)) {
      float b1 = 0.f, b2 = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) b1 += kG10r3[k] * s_h1[(ly + 1 + k) * RSP + lx];
#pragma unroll
      for (int k = 0; k < 9; ++k) b2 += kG16r4[k] * s_h2[(ly + k) * RSP + lx];
      r = fabsf(b1 - b2);
    }
    s_resp[i] = r;
  }
}

// ---- hessian: halo 7 (blur 3 + Scharr 1 + Scharr 1 + NMS 2).
constexpr int HS_IMG = TILE + 14;    // 46, offset -7
constexpr int HS_SM = TILE + 8;      // 40, offset -4
constexpr int HS_G = TILE + 6;       // 38, offset -3
constexpr int HS_SMEM = RSP * RSP + HS_IMG * HS_IMG + HS_IMG * HS_SM + HS_SM * HS_SM
                        + 2 * HS_G * HS_G;

__device__ void hessian_response(const float* im, int H, int W, int y0, int x0,
                                 float* s_resp, float* w) {
  float* s_img = w;                          // HS_IMG^2
  float* s_h = s_img + HS_IMG * HS_IMG;      // HS_IMG x HS_SM: rows -7.., cols -4..
  float* s_sm = s_h + HS_IMG * HS_SM;        // HS_SM^2, 0 outside the image
  float* s_gx = s_sm + HS_SM * HS_SM;        // HS_G^2, 0 outside the image
  float* s_gy = s_gx + HS_G * HS_G;
  stage(im, H, W, y0, x0, 7, HS_IMG, s_img);
  __syncthreads();
  blur_x<3>(s_img, HS_IMG, s_h, HS_IMG, HS_SM, kG15r3);
  __syncthreads();
  blur_y<3>(s_h, s_sm, HS_SM, HS_SM, kG15r3, true, y0 - 4, x0 - 4, H, W);
  __syncthreads();
  for (int i = threadIdx.x; i < HS_G * HS_G; i += THREADS) {
    const int ly = i / HS_G, lx = i % HS_G;
    float gx = 0.f, gy = 0.f;
    if (inside(y0 - 3 + ly, x0 - 3 + lx, H, W)) {
      const float* p = s_sm + (ly + 1) * HS_SM + (lx + 1);
      gx = scharr_x(p, HS_SM);
      gy = scharr_y(p, HS_SM);
    }
    s_gx[i] = gx;
    s_gy[i] = gy;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RSP * RSP; i += THREADS) {
    const int ly = i / RSP, lx = i % RSP;
    float r = -INFINITY;
    if (inside(y0 - 2 + ly, x0 - 2 + lx, H, W)) {
      const int q = (ly + 1) * HS_G + (lx + 1);
      const float gxx = scharr_x(s_gx + q, HS_G);
      const float gxy = scharr_y(s_gx + q, HS_G);
      const float gyy = scharr_y(s_gy + q, HS_G);
      r = gxx * gyy - gxy * gxy;
    }
    s_resp[i] = r;
  }
}

// ---- fast: halo 5 (ring 3 + NMS 2).
constexpr int FS_IMG = TILE + 10;    // 42, offset -5
constexpr int FS_SMEM = RSP * RSP + FS_IMG * FS_IMG;

__device__ __forceinline__ float arc_score(const float* d) {
  float best = -INFINITY;
#pragma unroll
  for (int s0 = 0; s0 < 16; ++s0) {
    float m = d[s0];
#pragma unroll
    for (int s = 1; s < 9; ++s) m = fminf(m, d[(s0 + s) & 15]);
    best = fmaxf(best, m);
  }
  return best;
}

__device__ void fast_response(const float* im, int H, int W, int y0, int x0,
                              float* s_resp, float* w) {
  float* s_img = w;
  stage(im, H, W, y0, x0, 5, FS_IMG, s_img);
  __syncthreads();
  for (int i = threadIdx.x; i < RSP * RSP; i += THREADS) {
    const int ly = i / RSP, lx = i % RSP;
    float r = -INFINITY;
    if (inside(y0 - 2 + ly, x0 - 2 + lx, H, W)) {
      const float* p = s_img + (ly + 3) * FS_IMG + (lx + 3);
      const float c = p[0];
      float bright[16], dark[16];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        bright[s] = p[kRing[s][0] * FS_IMG + kRing[s][1]] - c;
        dark[s] = -bright[s];
      }
      r = fmaxf(arc_score(bright), arc_score(dark));
    }
    s_resp[i] = r;
  }
}

// ---- _gradmag2: halo 4 (blur 3 + Scharr 1), no NMS, resp only.
constexpr int GM_IMG = TILE + 8;     // 40, offset -4
constexpr int GM_SM = TILE + 2;      // 34, offset -1
constexpr int GM_SMEM = GM_IMG * GM_IMG + GM_IMG * GM_SM + GM_SM * GM_SM;

__device__ void gradmag2(const float* im, float* resp, int H, int W, int y0, int x0,
                         float* w) {
  float* s_img = w;                          // GM_IMG^2
  float* s_h = s_img + GM_IMG * GM_IMG;      // GM_IMG x GM_SM: rows -4.., cols -1..
  float* s_sm = s_h + GM_IMG * GM_SM;        // GM_SM^2, not masked: the domain extends
  stage(im, H, W, y0, x0, 4, GM_IMG, s_img);
  __syncthreads();
  blur_x<3>(s_img, GM_IMG, s_h, GM_IMG, GM_SM, kG10r3);
  __syncthreads();
  blur_y<3>(s_h, s_sm, GM_SM, GM_SM, kG10r3, false, 0, 0, H, W);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int ly = i / TILE, lx = i % TILE;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float* p = s_sm + (ly + 1) * GM_SM + (lx + 1);
    const float dx = scharr_x(p, GM_SM), dy = scharr_y(p, GM_SM);
    resp[(size_t)gy * W + gx] = dx * dx + dy * dy;
  }
}

template <int FAM>
constexpr int smem_floats() {
  return FAM == SHI_TOMASI || FAM == HARRIS ? ST_SMEM
       : FAM == DOG                         ? DG_SMEM
       : FAM == HESSIAN                     ? HS_SMEM
       : FAM == FAST                        ? FS_SMEM
                                            : GM_SMEM;
}

template <int FAM>
__global__ void __launch_bounds__(THREADS)
response_nms_kernel(const float* __restrict__ img, float* __restrict__ nms,
                    float* __restrict__ resp, int H, int W) {
  extern __shared__ float smem[];
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const float* im = img + (size_t)blockIdx.z * plane;
  if constexpr (FAM == GRADMAG2) {
    gradmag2(im, resp + (size_t)blockIdx.z * plane, H, W, y0, x0, smem);
    return;
  } else {
    float* s_resp = smem;               // RSP^2, -inf outside the image
    float* w = smem + RSP * RSP;
    if constexpr (FAM == SHI_TOMASI || FAM == HARRIS) {
      structure_response<FAM>(im, H, W, y0, x0, s_resp, w);
    } else if constexpr (FAM == DOG) {
      dog_response(im, H, W, y0, x0, s_resp, w);
    } else if constexpr (FAM == HESSIAN) {
      hessian_response(im, H, W, y0, x0, s_resp, w);
    } else {
      fast_response(im, H, W, y0, x0, s_resp, w);
    }
    __syncthreads();
    // 5x5 NMS (resp >= window max) and both outputs.
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
      const int ly = i / TILE, lx = i % TILE;
      const int gy = y0 + ly, gx = x0 + lx;
      if (gy >= H || gx >= W) continue;
      const float c = s_resp[(ly + 2) * RSP + lx + 2];
      float m = c;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
          m = fmaxf(m, s_resp[(ly + dy) * RSP + lx + dx]);
      const size_t o = (size_t)blockIdx.z * plane + (size_t)gy * W + gx;
      resp[o] = c;
      nms[o] = (c >= m) ? c : -INFINITY;
    }
  }
}

template <int FAM>
int launch(const float* img, float* nms, float* resp, int B, int H, int W,
           cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * smem_floats<FAM>();
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t e = set_smem_once(
      configured, reinterpret_cast<const void*>(response_nms_kernel<FAM>), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  response_nms_kernel<FAM><<<grid, THREADS, bytes, s>>>(img, nms, resp, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// family: the Family enum (the wrapper's FAMILIES order). img, resp (and
// nms, unused for _gradmag2): contiguous (B, H, W) float32 device buffers.
// Launches on `stream` and returns the first CUDA error (0 on success);
// never synchronises.
extern "C" int response_nms(int family, const float* img, float* nms, float* resp,
                            int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case SHI_TOMASI: return launch<SHI_TOMASI>(img, nms, resp, B, H, W, s);
    case HARRIS: return launch<HARRIS>(img, nms, resp, B, H, W, s);
    case DOG: return launch<DOG>(img, nms, resp, B, H, W, s);
    case HESSIAN: return launch<HESSIAN>(img, nms, resp, B, H, W, s);
    case FAST: return launch<FAST>(img, nms, resp, B, H, W, s);
    case GRADMAG2: return launch<GRADMAG2>(img, nms, resp, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
