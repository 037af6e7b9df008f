// A FED cycle of Perona-Malik diffusion, up to 3 explicit steps fused per
// launch by temporal blocking, for sm_90a.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/fed_kernel.py
// (_fed_evolve_batched / _kernel), which runs the whole cycle on a row
// block resident in VMEM. Each step, on a float32 field L:
//   sm    = Gaussian blur of L (radius 2, sigma 1)
//   gx,gy = Scharr gradients of sm (unit gain, /32)
//   g     = 1 / (1 + (gx^2 + gy^2) / k^2)
//   flux  = sum over the 4 neighbours n of 0.5 (g + g_n) (L_n - L)
//   L'    = L + tau * flux
//
// Borders: the TPU kernel edge-pads the image once by 4n for an n-step
// cycle and evolves the padded block; its output equals "extend the image
// by its edge values, then evolve on an unbounded domain". Here every
// field is addressed in image coordinates (the image at [0, H) x [0, W)):
// a launch reads `src`, covering [sy, sy + sH) x [sx, sx + sW), clamping
// each read into it, and writes `dst`, covering [dy, dy + dH) x [dx, dx +
// dW). The wrapper's schedule (ops/fed_kernel.py `fed_schedule`) splits the
// n steps into launches of at most 3: the first reads the image itself, so
// clamping is the edge extension; a launch that leaves m steps to run
// writes the image extended by 4m, the part the later launches read, so no
// later read clamps; the last writes the image's own (H, W).
//
// What bounds it on an H100: operations, 61 float32 flop per pixel and
// step against 8 bytes per pixel for the whole cycle: 1.3 us for the 4-step
// cycle at 480x752, 2.6 us for the 8-step one. The first design (one launch
// per step, one pixel per thread and phase, four phases) took 26.0 and
// 56.0 us graph-replayed on an H100 80GB HBM3 at 700 W (PERF.md): each
// step paid a launch and ~37 scalar shared-memory reads per pixel.
//
// This design: temporal blocking. A 256-thread block owns a 32 x 32 output
// tile and stages it plus a halo of 4 px per fused step (blur 2 + Scharr 1
// + flux 1) once, by 16-byte cp.async copies (edge chunks, which clamp, by
// scalar loads); it runs its steps in shared memory and registers on a
// region that shrinks 4 px per step, and writes the tile once. The
// schedule gives n = 4 two launches of 2 steps and n = 8 three of 3, 3
// and 2. Blur and Scharr fold into two separable 7-tap filters, so a step
// is two phases, each on groups of 4 columns (16-byte shared loads and
// stores) by strips of 4 rows, and two barriers:
//   along y  A = s7 and B = d7 of L along y, sliding in registers;
//   update   each strip computes g for its rows and one row above and
//            below, at its 4 columns and one either side, from three
//            16-byte loads of a row of A and of B (g never goes through
//            shared memory), then L + tau * flux into the fourth field.
// Four fields (L, A, B, the new L) of (32 + 8 s) x (40 + 8 s) floats: 30,
// 42 and 56 KB at 1, 2 and 3 steps. Registers are capped at 64 (4 blocks
// per SM), so that the first launches' extended domains (up to 425
// blocks) run in one wave; under that cap nvcc spills 16 B at 2 steps,
// none at 1 or 3. Graph-replayed at 480x752: 15.2-15.4 us for n = 4 and
// 32.0-32.4 us for n = 8, 0.584-0.586x and 0.571-0.578x of the first
// design measured beside it (PERF.md, runs 9 and 13), ~8% of the bound.
// Per launch, staging takes 1.3-2.1 us and each step's update 1.4-2.5
// us, the pass along y 0.5-0.8 (PERF.md, run 15).
//
// Chosen on the card over (PERF.md): 1 or 4 steps per launch (1 pays a
// launch per step, ~1 us each; 4 pays ~1.8x the work of the unfused steps
// in halo); 32 x 64 tiles (2 blocks per SM: faster at n = 8, slower at
// n = 4, the frame's sum within 1%) and 16 x 64 tiles; a third phase
// storing g; 1-, 2- and 8-row strips; 512-thread blocks; warp
// shuffles for the neighbour columns. Not taken: a persistent kernel with
// a grid-wide barrier between steps, which would pass the field through
// L2 at every step as the first design did and needs a cooperative launch
// inside a CUDA graph; fusing a whole 8-step cycle, whose 32-px halo is
// ~4x the tile's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_once.cuh"

namespace {

constexpr int MAX_STEPS = 3;   // steps one launch fuses at most
constexpr int PAD = 4;         // floats on each side of a staged row
// A block: a TH x TW output tile, T threads, strips of R rows, at least
// MINB blocks per SM (registers capped to fit).
constexpr int TH = 32, TW = 32, R = 4, T = 256, MINB = 4;

// Gaussian tap at offset i (radius 2, sigma 1): numpy's float32 values of
// the reference's _gauss_taps(2, 1.0), normalised to sum 1.
__host__ __device__ constexpr float blur_tap(int i) {
  constexpr float kBlur[5] = {5.448868871e-02f, 2.442013621e-01f, 4.026199579e-01f,
                              2.442013621e-01f, 5.448868871e-02f};
  return i < -2 || i > 2 ? 0.f : kBlur[i + 2];
}

// The blur followed by Scharr's smoothing (3, 10, 3) / 32 (s7) or by its
// difference (-1, 0, 1) (d7) along one axis, as one 7-tap filter at offset
// u in -3..3: gx = s7 along y then d7 along x of L, gy = d7 along y then s7
// along x (the same function as blur, blur, Scharr; float32 round-off apart).
__host__ __device__ constexpr float s7(int u) {
  return (3.f * blur_tap(u + 1) + 10.f * blur_tap(u) + 3.f * blur_tap(u - 1)) * (1.f / 32.f);
}
__host__ __device__ constexpr float d7(int u) {
  return blur_tap(u - 1) - blur_tap(u + 1);
}

// The two filters on v[0..6] (offsets -3..3), folded by their symmetry.
__device__ __forceinline__ float sym7(const float* v) {
  constexpr float k0 = s7(0), k1 = s7(1), k2 = s7(2), k3 = s7(3);
  return k0 * v[3] + k1 * (v[2] + v[4]) + k2 * (v[1] + v[5]) + k3 * (v[0] + v[6]);
}
__device__ __forceinline__ float anti7(const float* v) {
  constexpr float k1 = d7(1), k2 = d7(2), k3 = d7(3);
  return k1 * (v[4] - v[2]) + k2 * (v[5] - v[1]) + k3 * (v[6] - v[0]);
}

struct Taus {
  float t[MAX_STEPS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}

// v[0..4) = p[0..4) and back, p 16-byte aligned shared memory.
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Calls f(c, a) for every 4-column group c (c0 <= c < c1, step 4; c0 and
// c1 multiples of 4) and every strip of R rows [a, a + R) of [r0, r1), one
// per thread at a time, neighbouring threads on neighbouring groups. The
// last strip is moved up to end at r1 (every region is at least R rows
// tall); a row it shares with the strip above is computed twice, to the
// same value.
template <class F>
__device__ __forceinline__ void for_strips(int r0, int r1, int c0, int c1, F f) {
  const int ng = (c1 - c0) / 4;
  const int ns = (r1 - r0 + R - 1) / R;
  for (int i = threadIdx.x; i < ng * ns; i += T) {
    const int s = i / ng;
    f(c0 + 4 * (i - s * ng), min(r0 + s * R, r1 - R));
  }
}

// Fields are SH rows of SWP = SW + 2 PAD floats; column c at PAD + c.

// Phase 1, along y in registers: A = s7 of L and B = d7 of L over rows
// [r0, r1) of the groups of [c0, c1).
template <int SWP>
__device__ void along_y(const float* L, float* A, float* B, int r0, int r1, int c0, int c1) {
  for_strips(r0, r1, c0, c1, [&](int c, int a) {
    float w[R + 6][4];
#pragma unroll
    for (int i = 0; i < R + 6; ++i) ld4(L + (a - 3 + i) * SWP + PAD + c, w[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s[4], d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float col[7];
#pragma unroll
        for (int t = 0; t < 7; ++t) col[t] = w[i + t][u];
        s[u] = sym7(col);
        d[u] = anti7(col);
      }
      st4(A + (a + i) * SWP + PAD + c, s);
      st4(B + (a + i) * SWP + PAD + c, d);
    }
  });
}

// G at columns c - 1 .. c + 4 (g[0..6)) from A and B at c - 4 .. c + 7.
__device__ __forceinline__ void conductivity6(const float* a, const float* b, float k2,
                                              float* g) {
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const float gx = anti7(a + u), gy = sym7(b + u);
    g[u] = __fdividef(k2, k2 + (gx * gx + gy * gy));
  }
}

// The flux and update of 4 pixels (L0 = l1[0..4), its row above l0 and
// below l2, its left neighbour ll and right lr; g likewise). flux sums
// 0.5 (g + g_n) (L_n - L) over right, left, down, up as the reference does,
// with the 0.5 moved into tau (exact: a power of 2).
__device__ __forceinline__ void update4(const float* l0, const float* l1, const float* l2,
                                        float ll, float lr, const float* g0, const float* g1,
                                        const float* g2, float gl, float gr, float half_tau,
                                        float* v) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float L0 = l1[u], G0 = g1[u];
    const float Lr = u < 3 ? l1[u + 1] : lr, Gr = u < 3 ? g1[u + 1] : gr;
    const float Ll = u > 0 ? l1[u - 1] : ll, Gl = u > 0 ? g1[u - 1] : gl;
    float f = (G0 + Gr) * (Lr - L0);
    f += (G0 + Gl) * (Ll - L0);
    f += (G0 + g2[u]) * (l2[u] - L0);
    f += (G0 + g0[u]) * (l0[u] - L0);
    v[u] = L0 + half_tau * f;
  }
}

// Phase 2, the update over rows [r0, r1) of the groups of [c0, c1): each
// strip computes g at its rows a - 1 .. a + R and columns c - 1 .. c + 4
// from three 16-byte loads of each row of A and B, keeps it in registers
// with its L, reads its neighbour columns' L from shared memory, and hands
// the 4 new values of each row to out(r, c, v).
template <int SWP, class Out>
__device__ void conduct_update(const float* L, const float* A, const float* B, int r0, int r1,
                               int c0, int c1, float k2, float half_tau, Out out) {
  for_strips(r0, r1, c0, c1, [&](int c, int a) {
    float l[R + 2][4], g[R + 2][6];
#pragma unroll
    for (int i = 0; i < R + 2; ++i) {
      const int o = (a - 1 + i) * SWP + PAD + c;
      float ra[12], rb[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {   // columns c - 4 .. c + 7
        ld4(A + o - 4 + 4 * q, ra + 4 * q);
        ld4(B + o - 4 + 4 * q, rb + 4 * q);
      }
      conductivity6(ra, rb, k2, g[i]);
      ld4(L + o, l[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* Lr = L + (a + i) * SWP + PAD + c;
      float v[4];
      update4(l[i], l[i + 1], l[i + 2], Lr[-1], Lr[4], g[i] + 1, g[i + 1] + 1, g[i + 2] + 1,
              g[i + 1][0], g[i + 1][5], half_tau, v);
      out(a + i, c, v);
    }
  });
}

template <int S>
__global__ void __launch_bounds__(T, MINB)
fed_kernel(const float* __restrict__ src, int sy, int sx, int sH, int sW,
           float* __restrict__ dst, int dy, int dx, int dH, int dW,
           const float* __restrict__ k, Taus taus) {
  constexpr int h = 4 * S;
  constexpr int SH = TH + 2 * h, SW = TW + 2 * h, SWP = SW + 2 * PAD;
  extern __shared__ __align__(16) float smem[];
  float* L = smem;
  float* A = L + SH * SWP;
  float* B = A + SH * SWP;
  float* Ln = B + SH * SWP;

  const int b = blockIdx.z;
  const int ty = blockIdx.y * TH, tx = blockIdx.x * TW;   // dst-local tile origin
  const float* Sb = src + (size_t)b * sH * sW;
  const float kk = k[b];
  const float k2 = kk * kk;
  // Staged (r, c) is src-local (oy + r, ox + c). The schedule makes ox a
  // multiple of 4; with sW too, a 4-float chunk lies wholly inside or
  // wholly outside the source's columns.
  const int oy = dy + ty - h - sy, ox = dx + tx - h - sx;
  const bool vec = ((sW | ox) & 3) == 0 && (reinterpret_cast<uintptr_t>(Sb) & 15) == 0;
  constexpr int chunks = SW / 4;
  for (int i = threadIdx.x; i < SH * chunks; i += T) {
    const int r = i / chunks, c = 4 * (i - r * chunks);
    const float* row = Sb + (size_t)clampi(oy + r, 0, sH - 1) * sW;
    float* d = L + r * SWP + PAD + c;
    if (vec && ox + c >= 0 && ox + c + 4 <= sW) {
      cp_async16(d, row + ox + c);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = row[clampi(ox + c + j, 0, sW - 1)];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float* D = dst + (size_t)b * dH * dW;
  auto to_shared = [&](int r, int c, const float* v) { st4(Ln + r * SWP + PAD + c, v); };
  auto to_global = [&](int r, int c, const float* v) {
    const int gy = ty + r - h;
    if (gy >= dH) return;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (tx + c - h + u < dW) D[(size_t)gy * dW + tx + c - h + u] = v[u];
  };
  // Before step j (1-based) L is valid on [e, S - e), e = 4 (j - 1). A and
  // B are computed on rows [e + 3, SH - e - 3) (the column groups of
  // [e, SW - e)), the new L on [e + 4, S - e - 4): the next step's L, or at
  // the last step the tile itself.
#pragma unroll
  for (int j = 1; j <= S; ++j) {
    const int e = 4 * (j - 1);
    along_y<SWP>(L, A, B, e + 3, SH - e - 3, e, SW - e);
    __syncthreads();
    const float half_tau = 0.5f * taus.t[j - 1];
    if (j < S) {
      conduct_update<SWP>(L, A, B, e + 4, SH - e - 4, e + 4, SW - e - 4, k2, half_tau,
                          to_shared);
      __syncthreads();
      float* t = L;
      L = Ln;
      Ln = t;
    } else {
      conduct_update<SWP>(L, A, B, h, h + TH, h, h + TW, k2, half_tau, to_global);
    }
  }
}

template <int S>
constexpr size_t smem_bytes() {
  return 4 * sizeof(float) * (TH + 8 * S) * (TW + 8 * S + 2 * PAD);
}

template <int S>
int launch(const float* src, int sy, int sx, int sH, int sW, float* dst, int dy, int dx,
           int dH, int dW, const float* k, const Taus& taus, int B, cudaStream_t s) {
  static std::atomic<unsigned long long> configured{0};
  const cudaError_t e =
      set_smem_once(configured, reinterpret_cast<const void*>(fed_kernel<S>), smem_bytes<S>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((dW + TW - 1) / TW, (dH + TH - 1) / TH, B);
  fed_kernel<S><<<grid, T, smem_bytes<S>(), s>>>(src, sy, sx, sH, sW, dst, dy, dx, dH, dW, k,
                                                 taus);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `steps` (1..3) FED steps with step sizes taus[0..steps) for a batch of B
// fields. src (B, sH, sW) covers image coordinates [sy, sy + sH) x [sx, sx +
// sW); dst (B, dH, dW) covers [dy, dy + dH) x [dx, dx + dW), at least 4 *
// steps inside src on every side unless src is the image itself; k (B,)
// the contrast parameters; all contiguous float32 device buffers, src and
// dst distinct. Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int fed_steps(const float* src, int sy, int sx, int sH, int sW, float* dst, int dy,
                         int dx, int dH, int dW, const float* k, const float* taus, int steps,
                         int B, void* stream) {
  if (steps < 1 || steps > MAX_STEPS) return static_cast<int>(cudaErrorInvalidValue);
  Taus t{};
  for (int i = 0; i < steps; ++i) t.t[i] = taus[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
    case 1: return launch<1>(src, sy, sx, sH, sW, dst, dy, dx, dH, dW, k, t, B, s);
    case 2: return launch<2>(src, sy, sx, sH, sW, dst, dy, dx, dH, dW, k, t, B, s);
    default: return launch<3>(src, sy, sx, sH, sW, dst, dy, dx, dH, dW, k, t, B, s);
  }
}

// Dynamic shared memory of one block fusing `steps` steps (bytes), or -1
// outside 1..3.
extern "C" int fed_steps_smem_bytes(int steps) {
  return steps == 1   ? (int)smem_bytes<1>()
         : steps == 2 ? (int)smem_bytes<2>()
         : steps == 3 ? (int)smem_bytes<3>()
                      : -1;
}
