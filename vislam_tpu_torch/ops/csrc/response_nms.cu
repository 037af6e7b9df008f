// Detector response + 5x5 non-max suppression, fused, for sm_90a; one
// kernel templated on the response family and the tile height.
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
// to two writes (8 B/px) against 45-329 flop/px; fast alone is bound by
// its operations. The first design (32x32 tiles, one pixel per thread and
// phase, five phases) made ~100 shared-memory accesses per output pixel
// for shi_tomasi and ran at 12% of the bound at 480x752, 5% at 240x376
// (96 blocks for 132 SMs).
//
// This design. A 256-thread block owns a TH x 32 output tile; TH is chosen
// at launch from the grid it gives: 32 where that makes >= 264 blocks (two
// per SM), else 16 where that does, else 8 (the most blocks): 32 at
// 480x752 and 8 at 240x376, 360 blocks each. It stages the tile's image
// rows plus the family's halo, columns [x0 - 8, x0 + 40), once, by 16-byte
// cp.async copies whose zero fill gives the zero border (rows of
// 4-float-aligned width; other widths load scalars). A TMA 2-D tile would
// zero-fill the same border but needs a tensor map per image shape and
// pointer, made on the host for every call; cp.async needs none. Then
// register tiling:
//  - vertical passes: each thread owns one column and a strip of rows (as
//    few as give one round of the block's threads, at least 4) and slides
//    the vertical taps in registers (the Scharr products and their 7-tap
//    blur; dog's two blurs; hessian's blur and its Scharr chain; the FAST
//    ring);
//  - horizontal passes: each thread computes 4 neighbouring outputs of a
//    row from one run of 16-byte shared loads (10-12 values per field);
//  - separable NMS: a 5-wide row max of 4 outputs from 8 values into
//    shared memory, then a 5-tall column max sliding in registers, which
//    writes resp and nms as coalesced rows. Max is exact in any order.
// fast takes its 9-arc minima by doubling (pairs, fours, eights, one more
// sample: 64 min for 16 arcs, not 128) and the dark score as minus the
// least 9-arc maximum, with no negated copy of the ring. Shared-memory
// accesses per output pixel of shi_tomasi: ~32 (was ~100). nvcc: 28-60
// registers per instance, no spills.
//
// Graph-replayed on an H100 80GB HBM3 at 700 W, against the first design
// measured beside it (PERF.md, runs 9 and 13): shi_tomasi 5.9-6.1 us at
// 480x752 and 3.3 at 240x376 (0.53-0.54x per frame), fast 9.4 and 4.4,
// _gradmag2 3.3; every family 0.48-0.68x. The floor under them: 0.9 us
// for a graph-replayed 4-byte fill, 1.8 us for a 480x752 copy. The
// response phases take 46-75% of a block's time (PERF.md, run 15).
// Tried on the card and dropped (PERF.md): 384 threads for
// 32-row tiles; the structure tensor's products once per pixel in their
// own phase (a shared-memory round trip costlier than the products it
// saves); the eigenvalue's square root as q * rsqrt(q) (it broke ties
// among zero responses of a one-row image); 2-row strips on 8-row tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "smem_once.cuh"

namespace {

enum Family : int { SHI_TOMASI = 0, HARRIS = 1, DOG = 2, HESSIAN = 3, FAST = 4, GRADMAG2 = 5 };

constexpr int TW = 32;             // output tile width
constexpr int THREADS = 256;
constexpr int SCW = TW + 16;       // staged image columns [x0 - 8, x0 + 40)
constexpr int RPW = TW + 4;        // response columns [-2, 34) (NMS radius 2)

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

struct Tile {
  const float* im;   // this image of the batch
  int H, W, y0, x0;  // image size, tile origin
  __device__ bool inside(int ty, int tx) const {   // tile-relative pixel
    const int y = y0 + ty, x = x0 + tx;
    return y >= 0 && y < H && x >= 0 && x < W;
  }
};

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// s (ROWS x SCW): image rows [y0 - HALO, ..), columns [x0 - 8, x0 + 40), 0
// outside the image; ends with a barrier.
template <int ROWS, int HALO>
__device__ void stage_image(const Tile& t, float* s) {
  constexpr int CH = SCW / 4;
  const bool vec = (t.W & 3) == 0 && (reinterpret_cast<uintptr_t>(t.im) & 15) == 0;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = 4 * (i - r * CH);
    const int gy = t.y0 - HALO + r, gx = t.x0 - 8 + c;
    float* d = s + r * SCW + c;
    const bool row_in = gy >= 0 && gy < t.H;
    if (vec) {
      // x0 and W are multiples of 4: a chunk is wholly in or out.
      const bool ok = row_in && gx >= 0 && gx < t.W;
      cp_async16(d, ok ? t.im + (size_t)gy * t.W + gx : t.im, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = row_in && gx + j >= 0 && gx + j < t.W ? t.im[(size_t)gy * t.W + gx + j] : 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Rows per strip of a pass over rows x cols: the fewest (at least lo; 4
// where a strip reads halo rows, so that they stay a small share) that
// give every column's strips one round of the block's T threads.
__host__ __device__ constexpr int strip_rows(int rows, int cols, int T, int lo = 4) {
  int r = lo;
  while (r < rows && cols * ((rows + r - 1) / r) > T) ++r;
  return r;
}

// Calls f(c, a) for strips [a, a + R) of rows [0, rows) of every column c
// in [0, cols), one per thread at a time, neighbouring threads on
// neighbouring columns; the last strip is moved up to end at `rows`.
template <int R, class F>
__device__ __forceinline__ void for_strips(int rows, int cols, F f) {
  const int n = (rows + R - 1) / R;
  for (int i = threadIdx.x; i < n * cols; i += blockDim.x) {
    const int s = i / cols;
    f(i - s * cols, min(s * R, rows - R));
  }
}

// Calls f(r, c) for every row r in [0, rows) and every 4-column group c =
// 0, 4, .. < 4 * groups.
template <class F>
__device__ __forceinline__ void for_groups(int rows, int groups, F f) {
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int r = i / groups;
    f(r, 4 * (i - r * groups));
  }
}

// v[0 .. 4N) = p[0 .. 4N), p 16-byte aligned: N shared loads of 16 bytes.
template <int N>
__device__ __forceinline__ void load4(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int N>
__device__ __forceinline__ float taps(const float* k, const float* v) {
  float a = 0.f;
#pragma unroll
  for (int q = 0; q < N; ++q) a += k[q] * v[q];
  return a;
}

// Scharr (unit gain, /32) from three columns l, m, r of rows i .. i + 2;
// the *32 forms leave out the 1 / 32.
__device__ __forceinline__ float scharr_x3(const float* l, const float* r, int i) {
  return (3.f * (r[i] - l[i]) + 10.f * (r[i + 1] - l[i + 1]) + 3.f * (r[i + 2] - l[i + 2]))
         * (1.f / 32.f);
}
__device__ __forceinline__ float scharr_x32(const float* l, const float* r, int i) {
  return 3.f * (r[i] - l[i]) + 10.f * (r[i + 1] - l[i + 1]) + 3.f * (r[i + 2] - l[i + 2]);
}
__device__ __forceinline__ float scharr_y32(const float* l, const float* m, const float* r,
                                            int i) {
  return 3.f * (l[i + 2] - l[i]) + 10.f * (m[i + 2] - m[i]) + 3.f * (r[i + 2] - r[i]);
}
__device__ __forceinline__ float scharr_y3(const float* l, const float* m, const float* r,
                                           int i) {
  return (3.f * (l[i + 2] - l[i]) + 10.f * (m[i + 2] - m[i]) + 3.f * (r[i + 2] - r[i]))
         * (1.f / 32.f);
}

template <int TH>
struct Nms {
  static constexpr int RH = TH + 4;                       // response rows [-2, TH + 2)
  static constexpr int FLOATS = RH * RPW + RH * TW;       // response + row max
};

// 5x5 NMS of s_resp (RH x RPW, -inf outside the image) and both outputs:
// a 5-wide row max into s_row, a 5-tall column max sliding in registers.
template <int TH>
__device__ void nms_out(const Tile& t, const float* s_resp, float* s_row, float* resp,
                        float* nms) {
  constexpr int RH = Nms<TH>::RH;
  for_groups(RH, TW / 4, [&](int r, int c) {
    float v[8], m[4];
    load4<2>(s_resp + r * RPW + c, v);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      m[u] = fmaxf(fmaxf(fmaxf(v[u], v[u + 1]), fmaxf(v[u + 2], v[u + 3])), v[u + 4]);
    store4(s_row + r * TW + c, m);
  });
  __syncthreads();
  constexpr int R = strip_rows(TH, TW, THREADS, 1);
  for_strips<R>(TH, TW, [&](int c, int a) {
    float v[R + 4];
#pragma unroll
    for (int i = 0; i < R + 4; ++i) v[i] = s_row[(a + i) * TW + c];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!t.inside(a + i, c)) continue;
      const float ctr = s_resp[(a + i + 2) * RPW + c + 2];
      const float m = fmaxf(fmaxf(fmaxf(v[i], v[i + 1]), fmaxf(v[i + 2], v[i + 3])), v[i + 4]);
      const size_t o = (size_t)(t.y0 + a + i) * t.W + t.x0 + c;
      resp[o] = ctr;
      nms[o] = ctr >= m ? ctr : -INFINITY;
    }
  });
}

// ---- shi_tomasi / harris: halo 6 (Scharr 1 + blur 3 + NMS 2).
template <int TH>
struct St {
  static constexpr int IMG = TH + 12;   // image rows [-6, TH + 6)
  static constexpr int PW = 44;         // product columns [-5, 37) (42) + 2 of padding
  static constexpr int FLOATS = IMG * SCW + 3 * Nms<TH>::RH * PW + Nms<TH>::FLOATS;
};

template <int FAM, int TH>
__device__ void structure_response(const Tile& t, float* w, float* s_resp) {
  constexpr int RH = Nms<TH>::RH, IMG = St<TH>::IMG, PW = St<TH>::PW;
  float* s_img = w;
  float* s_p = s_img + IMG * SCW;   // 3 x RH x PW: gx gx, gx gy, gy gy blurred along y
  stage_image<IMG, 6>(t, s_img);
  // Products at rows a - 5 .. a + R (tile rows) of column pc, 0 outside
  // the image, then the 7-tap blur along y into rows a - 2 .. (s_p rows a ..).
  // The gradients stay unscaled (32 gx, 32 gy): the blurred products are
  // scaled by 1 / 1024 where they are read, which is exact (a power of 2).
  constexpr int R = strip_rows(RH, 42, THREADS);
  for_strips<R>(RH, 42, [&](int col, int a) {
    const int pc = col - 5;                         // tile column
    const float* p = s_img + a * SCW + pc + 8;      // image row a - 6, column pc
    float l[R + 8], m[R + 8], r[R + 8];
#pragma unroll
    for (int i = 0; i < R + 8; ++i) {
      l[i] = p[i * SCW - 1];
      m[i] = p[i * SCW];
      r[i] = p[i * SCW + 1];
    }
    float xx[R + 6], xy[R + 6], yy[R + 6];
#pragma unroll
    for (int i = 0; i < R + 6; ++i) {               // product at tile row a - 5 + i
      const float gx = scharr_x32(l, r, i), gy = scharr_y32(l, m, r, i);
      const bool in = t.inside(a - 5 + i, pc);
      xx[i] = in ? gx * gx : 0.f;
      xy[i] = in ? gx * gy : 0.f;
      yy[i] = in ? gy * gy : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int o = (a + i) * PW + col;
      s_p[o] = taps<7>(kG15r3, xx + i);
      s_p[RH * PW + o] = taps<7>(kG15r3, xy + i);
      s_p[2 * RH * PW + o] = taps<7>(kG15r3, yy + i);
    }
  });
  __syncthreads();
  // The 7-tap blur along x and the response, 4 columns at a time.
  for_groups(RH, RPW / 4, [&](int r, int c) {
    float a[12], b[12], d[12], out[4];
    load4<3>(s_p + r * PW + c, a);
    load4<3>(s_p + RH * PW + r * PW + c, b);
    load4<3>(s_p + 2 * RH * PW + r * PW + c, d);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float sa = taps<7>(kG15r3, a + u) * (1.f / 1024.f),
                  sb = taps<7>(kG15r3, b + u) * (1.f / 1024.f),
                  sc = taps<7>(kG15r3, d + u) * (1.f / 1024.f);
      float v;
      if (FAM == HARRIS) {
        const float tr = sa + sc;
        v = (sa * sc - sb * sb) - 0.04f * tr * tr;
      } else {
        const float half_tr = 0.5f * (sa + sc);
        const float half_df = 0.5f * (sa - sc);
        v = half_tr - sqrtf(half_df * half_df + sb * sb + 1e-12f);
      }
      out[u] = t.inside(r - 2, c + u - 2) ? v : -INFINITY;
    }
    store4(s_resp + r * RPW + c, out);
  });
}

// ---- dog: halo 6 (blur 4 + NMS 2).
template <int TH>
struct Dg {
  static constexpr int IMG = TH + 12;   // image rows [-6, TH + 6)
  static constexpr int VW = 48;         // columns [-6, 38) (44) + padding
  static constexpr int FLOATS = IMG * SCW + 2 * Nms<TH>::RH * VW + Nms<TH>::FLOATS;
};

template <int TH>
__device__ void dog_response(const Tile& t, float* w, float* s_resp) {
  constexpr int RH = Nms<TH>::RH, IMG = Dg<TH>::IMG, VW = Dg<TH>::VW;
  float* s_img = w;
  float* s_v1 = s_img + IMG * SCW;   // RH x VW: G(r3, s1) along y
  float* s_v2 = s_v1 + RH * VW;      // G(r4, s1.6) along y
  stage_image<IMG, 6>(t, s_img);
  constexpr int R = strip_rows(RH, 44, THREADS);
  for_strips<R>(RH, 44, [&](int col, int a) {
    const float* p = s_img + a * SCW + col + 2;     // image row a - 6, column col - 6
    float v[R + 8];
#pragma unroll
    for (int i = 0; i < R + 8; ++i) v[i] = p[i * SCW];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s_v1[(a + i) * VW + col] = taps<7>(kG10r3, v + i + 1);
      s_v2[(a + i) * VW + col] = taps<9>(kG16r4, v + i);
    }
  });
  __syncthreads();
  for_groups(RH, RPW / 4, [&](int r, int c) {
    float a[12], b[12], out[4];
    load4<3>(s_v1 + r * VW + c, a);
    load4<3>(s_v2 + r * VW + c, b);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float v = fabsf(taps<7>(kG10r3, a + u + 1) - taps<9>(kG16r4, b + u));
      out[u] = t.inside(r - 2, c + u - 2) ? v : -INFINITY;
    }
    store4(s_resp + r * RPW + c, out);
  });
}

// ---- hessian: halo 7 (blur 3 + Scharr 1 + Scharr 1 + NMS 2).
template <int TH>
struct Hs {
  static constexpr int IMG = TH + 14;   // image rows [-7, TH + 7)
  static constexpr int SMR = TH + 8;    // blurred rows [-4, TH + 4)
  static constexpr int VW = 48;         // columns [-7, 39) (46) + padding
  static constexpr int SMW = 40;        // columns [-4, 36)
  static constexpr int GR = TH + 6;     // gradient rows [-3, TH + 3)
  static constexpr int GW = 40;         // columns [-3, 35) (38) + padding
  static constexpr int FLOATS = IMG * SCW + SMR * VW + SMR * SMW + 2 * GR * GW
                                + Nms<TH>::FLOATS;
};

template <int TH>
__device__ void hessian_response(const Tile& t, float* w, float* s_resp) {
  constexpr int RH = Nms<TH>::RH, IMG = Hs<TH>::IMG, SMR = Hs<TH>::SMR, VW = Hs<TH>::VW,
                SMW = Hs<TH>::SMW, GR = Hs<TH>::GR, GW = Hs<TH>::GW;
  float* s_img = w;
  float* s_v = s_img + IMG * SCW;    // SMR x VW: blurred along y
  float* s_sm = s_v + SMR * VW;      // SMR x SMW: blurred, 0 outside the image
  float* s_gx = s_sm + SMR * SMW;    // GR x GW, 0 outside the image
  float* s_gy = s_gx + GR * GW;
  stage_image<IMG, 7>(t, s_img);
  {
    constexpr int R = strip_rows(SMR, 46, THREADS);
    for_strips<R>(SMR, 46, [&](int col, int a) {
      const float* p = s_img + a * SCW + col + 1;   // image row a - 7, column col - 7
      float v[R + 6];
#pragma unroll
      for (int i = 0; i < R + 6; ++i) v[i] = p[i * SCW];
#pragma unroll
      for (int i = 0; i < R; ++i) s_v[(a + i) * VW + col] = taps<7>(kG15r3, v + i);
    });
  }
  __syncthreads();
  for_groups(SMR, SMW / 4, [&](int r, int c) {
    float v[12], out[4];
    load4<3>(s_v + r * VW + c, v);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[u] = t.inside(r - 4, c + u - 4) ? taps<7>(kG15r3, v + u) : 0.f;
    store4(s_sm + r * SMW + c, out);
  });
  __syncthreads();
  {
    constexpr int R = strip_rows(GR, 38, THREADS);
    for_strips<R>(GR, 38, [&](int col, int a) {
      const float* p = s_sm + a * SMW + col;        // blurred row a - 4, column col - 4
      float l[R + 2], m[R + 2], r[R + 2];
#pragma unroll
      for (int i = 0; i < R + 2; ++i) {
        l[i] = p[i * SMW];
        m[i] = p[i * SMW + 1];
        r[i] = p[i * SMW + 2];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool in = t.inside(a + i - 3, col - 3);
        s_gx[(a + i) * GW + col] = in ? scharr_x3(l, r, i) : 0.f;
        s_gy[(a + i) * GW + col] = in ? scharr_y3(l, m, r, i) : 0.f;
      }
    });
  }
  __syncthreads();
  {
    constexpr int R = strip_rows(RH, RPW, THREADS);
    for_strips<R>(RH, RPW, [&](int col, int a) {
      const float* px = s_gx + a * GW + col;        // gradient row a - 3, column col - 3
      const float* py = s_gy + a * GW + col;
      float xl[R + 2], xm[R + 2], xr[R + 2], yl[R + 2], ym[R + 2], yr[R + 2];
#pragma unroll
      for (int i = 0; i < R + 2; ++i) {
        xl[i] = px[i * GW];
        xm[i] = px[i * GW + 1];
        xr[i] = px[i * GW + 2];
        yl[i] = py[i * GW];
        ym[i] = py[i * GW + 1];
        yr[i] = py[i * GW + 2];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float gxx = scharr_x3(xl, xr, i), gxy = scharr_y3(xl, xm, xr, i),
                    gyy = scharr_y3(yl, ym, yr, i);
        s_resp[(a + i) * RPW + col] =
            t.inside(a + i - 2, col - 2) ? gxx * gyy - gxy * gxy : -INFINITY;
      }
    });
  }
}

// ---- fast: halo 5 (ring 3 + NMS 2).
template <int TH>
struct Fs {
  static constexpr int IMG = TH + 10;   // image rows [-5, TH + 5)
  static constexpr int FLOATS = IMG * SCW + Nms<TH>::FLOATS;
};

// max over the 16 starts of the min over the 9-arc from it (MIN = true), or
// min over starts of the max (MIN = false), by doubling.
template <bool MIN>
__device__ __forceinline__ float arc9(const float* d) {
  auto op = [](float a, float b) { return MIN ? fminf(a, b) : fmaxf(a, b); };
  float m2[16], m4[16], best = 0.f;
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = op(d[s], d[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = op(m2[s], m2[(s + 2) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float m9 = op(op(m4[s], m4[(s + 4) & 15]), d[(s + 8) & 15]);
    best = s == 0 ? m9 : (MIN ? fmaxf(best, m9) : fminf(best, m9));
  }
  return best;
}

template <int TH>
__device__ void fast_response(const Tile& t, float* w, float* s_resp) {
  constexpr int RH = Nms<TH>::RH, IMG = Fs<TH>::IMG;
  // FAST-16 ring, (dv, du) per sample, clockwise from 12 o'clock; a local
  // constant, so that unrolled code addresses each sample at a fixed offset.
  constexpr int kRing[16][2] = {
      {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3}, {2, 2}, {3, 1},
      {3, 0}, {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};
  float* s_img = w;
  stage_image<IMG, 5>(t, s_img);
  // Rows of a strip share their ring samples: the compiler keeps the
  // column window in registers across the unrolled rows.
  constexpr int R = strip_rows(RH, RPW, THREADS);
  for_strips<R>(RH, RPW, [&](int col, int a) {
    const float* p = s_img + (a + 3) * SCW + col + 6;   // centre: tile (a - 2, col - 2)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* q = p + i * SCW;
      const float c = q[0];
      float d[16];
#pragma unroll
      for (int s = 0; s < 16; ++s) d[s] = q[kRing[s][0] * SCW + kRing[s][1]] - c;
      // bright: max over arcs of min(ring - c); dark: max over arcs of
      // min(c - ring) = -(min over arcs of max(ring - c)).
      const float v = fmaxf(arc9<true>(d), -arc9<false>(d));
      s_resp[(a + i) * RPW + col] = t.inside(a + i - 2, col - 2) ? v : -INFINITY;
    }
  });
}

// ---- _gradmag2: halo 4 (blur 3 + Scharr 1), no NMS, resp only.
template <int TH>
struct Gm {
  static constexpr int IMG = TH + 8;    // image rows [-4, TH + 4)
  static constexpr int SMR = TH + 2;    // blurred rows [-1, TH + 1)
  static constexpr int VW = 44;         // columns [-4, 38) (42) + padding
  static constexpr int SMW = 36;        // columns [-1, 35)
  static constexpr int FLOATS = IMG * SCW + SMR * VW + SMR * SMW;
};

template <int TH>
__device__ void gradmag2(const Tile& t, float* w, float* resp) {
  constexpr int IMG = Gm<TH>::IMG, SMR = Gm<TH>::SMR, VW = Gm<TH>::VW, SMW = Gm<TH>::SMW;
  float* s_img = w;
  float* s_v = s_img + IMG * SCW;   // SMR x VW, blurred along y
  float* s_sm = s_v + SMR * VW;     // SMR x SMW, not masked: the domain extends
  stage_image<IMG, 4>(t, s_img);
  {
    constexpr int R = strip_rows(SMR, 42, THREADS);
    for_strips<R>(SMR, 42, [&](int col, int a) {
      const float* p = s_img + a * SCW + col + 4;   // image row a - 4, column col - 4
      float v[R + 6];
#pragma unroll
      for (int i = 0; i < R + 6; ++i) v[i] = p[i * SCW];
#pragma unroll
      for (int i = 0; i < R; ++i) s_v[(a + i) * VW + col] = taps<7>(kG10r3, v + i);
    });
  }
  __syncthreads();
  for_groups(SMR, SMW / 4, [&](int r, int c) {
    float v[12], out[4];
    load4<3>(s_v + r * VW + c, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) out[u] = taps<7>(kG10r3, v + u);
    store4(s_sm + r * SMW + c, out);
  });
  __syncthreads();
  constexpr int R = strip_rows(TH, TW, THREADS, 1);
  for_strips<R>(TH, TW, [&](int c, int a) {
    const float* p = s_sm + a * SMW + c;            // blurred row a - 1, column c - 1
    float l[R + 2], m[R + 2], r[R + 2];
#pragma unroll
    for (int i = 0; i < R + 2; ++i) {
      l[i] = p[i * SMW];
      m[i] = p[i * SMW + 1];
      r[i] = p[i * SMW + 2];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!t.inside(a + i, c)) continue;
      const float dx = scharr_x3(l, r, i), dy = scharr_y3(l, m, r, i);
      resp[(size_t)(t.y0 + a + i) * t.W + t.x0 + c] = dx * dx + dy * dy;
    }
  });
}

template <int FAM, int TH>
constexpr int smem_floats() {
  return FAM == SHI_TOMASI || FAM == HARRIS ? St<TH>::FLOATS
       : FAM == DOG                         ? Dg<TH>::FLOATS
       : FAM == HESSIAN                     ? Hs<TH>::FLOATS
       : FAM == FAST                        ? Fs<TH>::FLOATS
                                            : Gm<TH>::FLOATS;
}

template <int FAM, int TH>
__global__ void __launch_bounds__(THREADS)
response_nms_kernel(const float* __restrict__ img, float* __restrict__ nms,
                    float* __restrict__ resp, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const size_t plane = (size_t)H * W;
  const Tile t{img + blockIdx.z * plane, H, W, (int)blockIdx.y * TH, (int)blockIdx.x * TW};
  resp += blockIdx.z * plane;
  if constexpr (FAM == GRADMAG2) {
    gradmag2<TH>(t, smem, resp);
  } else {
    float* s_resp = smem;                       // RH x RPW, -inf outside the image
    float* s_row = s_resp + Nms<TH>::RH * RPW;  // RH x TW, the row max
    float* w = s_row + Nms<TH>::RH * TW;
    if constexpr (FAM == SHI_TOMASI || FAM == HARRIS) {
      structure_response<FAM, TH>(t, w, s_resp);
    } else if constexpr (FAM == DOG) {
      dog_response<TH>(t, w, s_resp);
    } else if constexpr (FAM == HESSIAN) {
      hessian_response<TH>(t, w, s_resp);
    } else {
      fast_response<TH>(t, w, s_resp);
    }
    __syncthreads();
    nms_out<TH>(t, s_resp, s_row, resp, nms + blockIdx.z * plane);
  }
}

template <int FAM, int TH>
int launch(const float* img, float* nms, float* resp, int B, int H, int W, cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * smem_floats<FAM, TH>();
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t e = set_smem_once(
      configured, reinterpret_cast<const void*>(response_nms_kernel<FAM, TH>), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  response_nms_kernel<FAM, TH><<<grid, THREADS, bytes, s>>>(img, nms, resp, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM>
int smem_rows(int tile_rows) {
  return tile_rows == 32   ? (int)sizeof(float) * smem_floats<FAM, 32>()
         : tile_rows == 16 ? (int)sizeof(float) * smem_floats<FAM, 16>()
         : tile_rows == 8  ? (int)sizeof(float) * smem_floats<FAM, 8>()
                           : -1;
}

template <int FAM>
int launch_rows(int tile_rows, const float* img, float* nms, float* resp, int B, int H, int W,
                cudaStream_t s) {
  switch (tile_rows) {
    case 32: return launch<FAM, 32>(img, nms, resp, B, H, W, s);
    case 16: return launch<FAM, 16>(img, nms, resp, B, H, W, s);
    case 8: return launch<FAM, 8>(img, nms, resp, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Tile rows for a (B, H, W) launch: the tallest tile that still gives two
// blocks per SM of an H100 (132 SMs), else 8 (the most blocks).
int auto_rows(int B, int H, int W) {
  const long cols = (W + TW - 1) / TW;
  if (B * cols * ((H + 31) / 32) >= 2 * 132) return 32;
  if (B * cols * ((H + 15) / 16) >= 2 * 132) return 16;
  return 8;
}

}  // namespace

// family: the Family enum (the wrapper's FAMILIES order). img, resp (and
// nms, unused for _gradmag2): contiguous (B, H, W) float32 device buffers.
// tile_rows: 8, 16 or 32, or 0 for the launch's own choice from (B, H, W).
// Launches on `stream` and returns the first CUDA error (0 on success);
// never synchronises.
extern "C" int response_nms(int family, const float* img, float* nms, float* resp, int B,
                            int H, int W, int tile_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int th = tile_rows ? tile_rows : auto_rows(B, H, W);
  switch (family) {
    case SHI_TOMASI: return launch_rows<SHI_TOMASI>(th, img, nms, resp, B, H, W, s);
    case HARRIS: return launch_rows<HARRIS>(th, img, nms, resp, B, H, W, s);
    case DOG: return launch_rows<DOG>(th, img, nms, resp, B, H, W, s);
    case HESSIAN: return launch_rows<HESSIAN>(th, img, nms, resp, B, H, W, s);
    case FAST: return launch_rows<FAST>(th, img, nms, resp, B, H, W, s);
    case GRADMAG2: return launch_rows<GRADMAG2>(th, img, nms, resp, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block of `family` at `tile_rows` (bytes), or
// -1 for an unknown pair.
extern "C" int response_nms_smem_bytes(int family, int tile_rows) {
  switch (family) {
    case SHI_TOMASI: return smem_rows<SHI_TOMASI>(tile_rows);
    case HARRIS: return smem_rows<HARRIS>(tile_rows);
    case DOG: return smem_rows<DOG>(tile_rows);
    case HESSIAN: return smem_rows<HESSIAN>(tile_rows);
    case FAST: return smem_rows<FAST>(tile_rows);
    case GRADMAG2: return smem_rows<GRADMAG2>(tile_rows);
    default: return -1;
  }
}
