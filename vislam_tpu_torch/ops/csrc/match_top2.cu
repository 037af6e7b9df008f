// Descriptor matching core: squared-L2 distances + row top-2 + column
// argmin, fused, for sm_90a.
//
// Replaces the Pallas TPU kernel vislam_tpu/ops/match_kernel.py:120 (gated)
// and :126 (ungated), match_top2_pallas (_kernel / _make_gated_kernel,
// _distances, _reduce_top2). For A (K, D) and B (N, D) float32 descriptors,
// D = 128 (SIFT) or 256 (BRIEF), with validity masks it computes, for every
// pair,
//   d = max(|a|^2 + |b|^2 - 2 a.b, 0)       (the reference's formula)
//   d = 1e9 where either row is invalid, or (gated) where the predicted
//       position of row a lies farther than r from keypoint b
// and reduces without ever storing the K x N matrix:
//   min1[i], arg1[i]  row minimum and its first column
//   min2[i]           minimum over the row with column arg1[i] removed (a
//                     tie at min1 therefore gives min2 == min1)
//   colarg[j]         first row reaching the column minimum
//
// Bound on an H100: the arithmetic. a.b is 2 K N D flop (151 MFLOP at
// K = N = 768, D = 128; 302 MFLOP at D = 256); at float32 accuracy the
// tensor cores do it as 3xTF32, 3 x 2 K N D at 495 TFLOP/s: 0.92 us
// (1.83 us). The rest, 7 float32 operations per pair ungated (13 gated:
// the distance, the row top-2 and column compares, the disc test) at
// 67 TFLOP/s, adds 0.06 us (0.11 us): 0.98 us (1.89 us) ungated. The
// bytes, 4 D (K + N) in (0.8 MB; 1.6 MB), take 0.24 us (0.47 us) at
// 3.35 TB/s. A batch of pairs multiplies the operations by its size. The
// window match reads the bfloat16 window bank's
// values widened to float32, so its a.b needs one bfloat16 pass, 2 W K N D
// at 989 TFLOP/s: at W = 10, K = N = 768, D = 128, 1.53 us plus 0.62 us of
// the rest, 2.14 us; its 4.5 MB take 1.33 us. On such operands two of the
// three TF32 products this kernel makes multiply zeros (the low halves).
// chip_smoke.py computes these per call.
//
// Design. A 2-D grid of 32 x 64 output tiles (rows of A x rows of B):
// 24 x 12 = 288 blocks at K = N = 768 and 16 x 8 = 128 at K = N = 512 (the
// first version ran K / 16 = 48 and 32 blocks). Each 256-thread block stages
// its 32 A rows and 64 B rows, full D, in shared memory with cp.async 16-byte
// copies, one commit group per 32 floats of D, so the products on the first
// columns of D start while the rest is in flight. Rows are padded to D + 4
// floats: the fragment loads of a warp (8 rows x 4 columns) hit 32 banks.
// D = 128 takes 50.7 KB and D = 256 99.8 KB, dynamic shared memory, set once
// per template instance and device. |a|^2 and |b|^2 are summed from the
// fragment values as they are loaded for the tensor cores (no second pass
// over shared memory), then over the 4 lanes of a quad: once per staged row
// and warp using it (4 warps share an A row, 2 a B row), never per (block,
// column) pair.
//
// a.b runs on the tensor cores, mma.sync m16n8k8 TF32, in the 3xTF32 split:
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a.b = hi.hi + (hi.lo
// + lo.hi), the small terms summed in their own float32 accumulator. That
// keeps float32 accuracy (the dropped lo.lo is ~2^-22 relative); one TF32
// pass would not, and would reorder near-tied SIFT matches. BRIEF's +-1/16
// entries are exact in TF32 (lo = 0) and every partial sum is a multiple of
// 2^-8 below 1, so D = 256 distances are exact, as in the plain twin. Each
// of the 8 warps owns 16 rows x 16 columns (two n8 fragments): the kernel is
// latency-bound (a block's loads, products and epilogue run one after the
// other), and 8 warps halve each warp's serial work and hide more latency
// than 4.
//
// Epilogue in registers: each thread holds 2 rows x 4 columns of d; a row's
// (min1, arg1, min2) merges over the thread's columns, the 4 lanes of a quad
// (shuffles) and the 4 warps along the columns (shared memory), and goes to
// a partial buffer, one entry per (column tile, row). A column's (d, row)
// key (float bits << 32 | row, exact since d >= 0, smaller row first on
// ties) reduces over the 8 row groups by shuffles and the 2 warps by a
// shared 64-bit atomicMin, then one global atomicMin per column and block.
// Per row strip and per column strip a counter finds the last block to
// finish; it merges the row partials (its 8 warps an eighth of the column
// tiles each, then one warp the 8 results), or unpacks the column keys.
// Every merge keeps the first index on exact ties, as the reference does
// (BRIEF distances are multiples of 1/64, so exact ties are common).
//
// Launches per call: 2, a small kernel that resets the column keys and the
// counters, then the match kernel (the first version made 3: a memset, the
// kernel, and a kernel unpacking the column keys).
//
// Batch. One call also matches a batch of pairs: the grid's third
// dimension runs over the batch entries z. B, its mask, (gated) its
// keypoint positions uv_b and every output advance by one entry's size per
// z; A, its mask and (gated) its predicted positions uv_pred are read from
// group z / a_group. So a_group = batch shares one A with the whole batch
// (the window-track match of one sequence, vislam_tpu/engine/refine.py:36-63:
// the anchor keyframe against each of the W window slots, a vmapped XLA
// match in the reference), a_group = 1 gives every pair its own A (the
// per-frame match and the gated rescue of B sequences stepped together,
// vislam_tpu/engine/batch.py:139-161), and a_group = W the window match of
// B sequences (B anchors, B x W slots). Each entry has its own column keys,
// row partials and counters in the scratch, all reset by the one reset
// launch, so a batched call is 2 launches in every mode, gated or not.
//
// Times it replaces (NVIDIA H100 80GB HBM3, 700 W, back-to-back launches):
// 186.9 / 185.8 us ungated and 197.1 / 195.9 us gated at K = 768, D = 128;
// 344.5 / 343.9 us ungated at D = 256 (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "smem_once.cuh"

namespace {

constexpr int BM = 32;                // A rows per block
constexpr int BN = 64;                // B rows (distance matrix columns) per block
constexpr int WARPS = 8;              // 2 along the rows x 4 along the columns
constexpr int THREADS = 32 * WARPS;
constexpr int NFRAG = 2;              // n8 fragments per warp: 16 columns
constexpr int PAD = 4;                // floats of padding per staged row
constexpr int CHUNK = 32;             // floats of D per cp.async group
constexpr float BIG = 1e9f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM + BN) * (D + PAD);
}

__device__ __forceinline__ unsigned long long col_key(float d, int row) {
  // d >= 0: clearing the sign bit maps -0 to +0 so the bits order like d.
  const unsigned int bits = __float_as_uint(d) & 0x7fffffffu;
  return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned int>(row);
}

// Two smallest values of a set of columns and the first column reaching the
// smallest.
struct Top2 {
  float m1, m2;
  int a1;
};

// Top2 of the union of two disjoint column sets; exact in any order.
__device__ __forceinline__ Top2 merge(Top2 p, Top2 q) {
  if (q.m1 < p.m1 || (q.m1 == p.m1 && q.a1 < p.a1)) return {q.m1, fminf(p.m1, q.m2), q.a1};
  return {p.m1, fminf(p.m2, q.m1), p.a1};
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Wait until at most n commit groups are pending (n is a constant once the
// caller's loop is unrolled).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__global__ void reset_kernel(unsigned long long* __restrict__ colkey, int n_keys,
                             int* __restrict__ counts, int n_counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_keys) colkey[i] = ~0ull;
  if (i < n_counts) counts[i] = 0;
}

// Grid (column tiles, row tiles, batch). For each batch entry, rowpart
// (column tiles, K) holds each block's row partials as (m1 bits, m2 bits,
// a1, 0); counts holds one counter per row strip, then one per column
// strip. Entry z reads A, ma and uv_pred of group z / a_group.
template <int D>
__global__ void __launch_bounds__(THREADS)
match_top2_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const uint8_t* __restrict__ ma, const uint8_t* __restrict__ mb,
                  const float* __restrict__ uv_pred, const float* __restrict__ uv_b,
                  float r2, int gated, int K, int N, int a_group,
                  float* __restrict__ min1, float* __restrict__ min2,
                  int* __restrict__ arg1, int* __restrict__ colarg,
                  unsigned long long* __restrict__ colkey, int4* __restrict__ rowpart,
                  int* __restrict__ counts) {
  constexpr int LD = D + PAD;
  constexpr int NCH = D / CHUNK;
  extern __shared__ __align__(16) float smem[];   // BM rows of A, then BN rows of B
  static_assert(BM == 32, "a row strip's merge runs one row per lane");
  __shared__ float puA[BM], pvA[BM], puB[BN], pvB[BN];
  __shared__ bool okA[BM], okB[BN];
  __shared__ Top2 sRow[WARPS][BM];
  __shared__ unsigned long long sCol[BN];
  __shared__ int sLastRow, sLastCol;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;           // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  {  // this block's batch entry and its group of A
    const size_t e = blockIdx.z, grp = blockIdx.z / a_group;
    A += grp * K * D;
    ma += grp * K;
    Bm += e * N * D;
    mb += e * N;
    if (gated) {
      uv_pred += grp * K * 2;
      uv_b += e * N * 2;
    }
    min1 += e * K;
    min2 += e * K;
    arg1 += e * K;
    colarg += e * N;
    colkey += e * N;
    rowpart += e * gridDim.x * K;
    counts += e * (gridDim.x + gridDim.y);
  }

#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    for (int i = tid; i < (BM + BN) * (CHUNK / 4); i += THREADS) {
      const int r = i / (CHUNK / 4), q = i % (CHUNK / 4);
      const bool isA = r < BM;
      const int src = isA ? r0 + r : c0 + r - BM;
      const bool valid = src < (isA ? K : N);
      const float* base = isA ? A : Bm;
      cp_async16(smem + r * LD + c * CHUNK + q * 4,
                 valid ? base + (size_t)src * D + c * CHUNK + q * 4 : base, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (tid < BM) {
    const int row = r0 + tid;
    okA[tid] = row < K && ma[row];
    puA[tid] = (gated && row < K) ? uv_pred[2 * row] : 0.f;
    pvA[tid] = (gated && row < K) ? uv_pred[2 * row + 1] : 0.f;
  } else if (tid < BM + BN) {
    const int lc = tid - BM, col = c0 + lc;
    okB[lc] = col < N && mb[col];
    puB[lc] = (gated && col < N) ? uv_b[2 * col] : 0.f;
    pvB[lc] = (gated && col < N) ? uv_b[2 * col + 1] : 0.f;
    sCol[lc] = ~0ull;
  }

  // |a|^2 of rows g, g + 8 and |b|^2 of columns 8j + g, summed from the
  // fragment values as they are loaded (this lane's 2 of every 8 in D).
  float acc[NFRAG][4] = {}, acc_lo[NFRAG][4] = {}, sqa[2] = {}, sqb[NFRAG] = {};
  const float* sA = smem + (wm * 16) * LD;
  const float* sB = smem + (BM + wn * 16) * LD;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait(NCH - 1 - c);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 8) {
      const int k = c * CHUNK + kk;
      const float x[4] = {sA[g * LD + k + t], sA[(g + 8) * LD + k + t],
                          sA[g * LD + k + t + 4], sA[(g + 8) * LD + k + t + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split(x[q], ah[q], al[q]);
      sqa[0] += x[0] * x[0] + x[2] * x[2];
      sqa[1] += x[1] * x[1] + x[3] * x[3];
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        const float y0 = sB[(8 * j + g) * LD + k + t], y1 = sB[(8 * j + g) * LD + k + t + 4];
        uint32_t bh[2], bl[2];
        split(y0, bh[0], bl[0]);
        split(y1, bh[1], bl[1]);
        sqb[j] += y0 * y0 + y1 * y1;
        mma_tf32(acc_lo[j], al, bh);
        mma_tf32(acc_lo[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }

  // The quad's 4 lanes hold the rest of D.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sqa[0] += __shfl_xor_sync(0xffffffffu, sqa[0], off);
    sqa[1] += __shfl_xor_sync(0xffffffffu, sqa[1], off);
#pragma unroll
    for (int j = 0; j < NFRAG; ++j) sqb[j] += __shfl_xor_sync(0xffffffffu, sqb[j], off);
  }

  // This thread's d: rows wm*16 + g (+8), columns wn*16 + 8j + 2t (+1).
  Top2 part[2] = {{INFINITY, INFINITY, INT_MAX}, {INFINITY, INFINITY, INT_MAX}};
  unsigned long long ckey[NFRAG][2];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
    ckey[j][0] = ckey[j][1] = ~0ull;
    // |b|^2 of columns 8j + 2t (+1) from the lanes holding them.
    const float sqb_c[2] = {__shfl_sync(0xffffffffu, sqb[j], 8 * t),
                            __shfl_sync(0xffffffffu, sqb[j], 8 * t + 4)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int lr = wm * 16 + g + 8 * h, lc = wn * 16 + 8 * j + 2 * t + (e & 1);
      const int row = r0 + lr, col = c0 + lc;
      const float dot = acc[j][e] + acc_lo[j][e];
      float d = fmaxf(__fsub_rn(__fadd_rn(sqa[h], sqb_c[e & 1]), 2.f * dot), 0.f);
      if (!(okA[lr] && okB[lc])) d = BIG;
      if (gated) {
        const float du = puA[lr] - puB[lc], dv = pvA[lr] - pvB[lc];
        if (!(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2)) d = BIG;
      }
      if (col < N) part[h] = merge(part[h], Top2{d, INFINITY, col});
      if (row < K) ckey[j][e & 1] = min(ckey[j][e & 1], col_key(d, row));
    }
  }

  // Rows: the quad's 4 lanes, then the four warps along the columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const Top2 o = {__shfl_xor_sync(0xffffffffu, part[h].m1, off),
                      __shfl_xor_sync(0xffffffffu, part[h].m2, off),
                      __shfl_xor_sync(0xffffffffu, part[h].a1, off)};
      part[h] = merge(part[h], o);
    }
  }
  if (wn > 0 && t == 0) {
    sRow[wn][wm * 16 + g] = part[0];
    sRow[wn][wm * 16 + g + 8] = part[1];
  }
  // Columns: the 8 row groups of the warp, then the two warps along the rows.
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int off = 4; off <= 16; off <<= 1)
        ckey[j][p] = min(ckey[j][p], __shfl_xor_sync(0xffffffffu, ckey[j][p], off));
      if (g == 0) atomicMin(&sCol[wn * 16 + 8 * j + 2 * t + p], ckey[j][p]);
    }
  }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 16 + g + 8 * h, row = r0 + lr;
      Top2 m = part[h];
#pragma unroll
      for (int w = 1; w < WARPS / 2; ++w) m = merge(m, sRow[w][lr]);
      if (row < K)
        rowpart[(size_t)blockIdx.x * K + row] =
            make_int4(__float_as_int(m.m1), __float_as_int(m.m2), m.a1, 0);
    }
  }
  if (tid < BN && c0 + tid < N) atomicMin(&colkey[c0 + tid], sCol[tid]);

  // The last block of a row strip merges its rows' partials (warp w the
  // column tiles w, w + 8, ..., then warp 0 the 8 results); the last block
  // of a column strip unpacks its columns.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sLastRow = atomicAdd(&counts[blockIdx.y], 1) == (int)gridDim.x - 1;
    sLastCol = atomicAdd(&counts[gridDim.y + blockIdx.x], 1) == (int)gridDim.y - 1;
  }
  __syncthreads();
  if (sLastRow) {
    __threadfence();
    const int row = r0 + lane;
    Top2 m = {INFINITY, INFINITY, INT_MAX};
    if (row < K) {
      for (int c = warp; c < (int)gridDim.x; c += WARPS) {
        const int4 v = __ldcg(rowpart + (size_t)c * K + row);
        m = merge(m, Top2{__int_as_float(v.x), __int_as_float(v.y), v.z});
      }
    }
    sRow[warp][lane] = m;
    __syncthreads();
    if (warp == 0 && row < K) {
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = merge(m, sRow[w][lane]);
      min1[row] = m.m1;
      min2[row] = fminf(m.m2, BIG);
      arg1[row] = m.a1;
    }
  }
  if (sLastCol && tid < BN && c0 + tid < N) {
    __threadfence();
    colarg[c0 + tid] = static_cast<int>(__ldcg(colkey + c0 + tid) & 0xffffffffull);
  }
}

// The scratch layout, each region batch entries one after the other:
// colkey (N x 8 B each), rowpart (16-aligned, column tiles x K x 16 B
// each), counts (row tiles + column tiles, 4 B each).
struct Layout {
  int row_tiles, col_tiles;
  size_t rowpart, counts, bytes;
};

Layout layout(int K, int N, int batch) {
  Layout l;
  l.row_tiles = (K + BM - 1) / BM;
  l.col_tiles = (N + BN - 1) / BN;
  l.rowpart = (sizeof(unsigned long long) * N * batch + 15) / 16 * 16;
  l.counts = l.rowpart + sizeof(int4) * (size_t)l.col_tiles * K * batch;
  l.bytes = l.counts + sizeof(int) * (size_t)(l.row_tiles + l.col_tiles) * batch;
  return l;
}

template <int D>
cudaError_t launch(const float* a, const float* b, const unsigned char* ma,
                   const unsigned char* mb, const float* uv_pred, const float* uv_b,
                   float r2, int gated, float* min1, float* min2, int* arg1, int* colarg,
                   char* scratch, const Layout& l, int K, int N, int batch, int a_group,
                   cudaStream_t s) {
  static std::atomic<unsigned long long> configured{0};
  cudaError_t e = set_smem_once(configured, reinterpret_cast<const void*>(match_top2_kernel<D>),
                                smem_bytes<D>());
  if (e != cudaSuccess) return e;
  auto* colkey = reinterpret_cast<unsigned long long*>(scratch);
  auto* counts = reinterpret_cast<int*>(scratch + l.counts);
  const int n_keys = N * batch, n_counts = (l.row_tiles + l.col_tiles) * batch;
  const int reset_n = n_keys > n_counts ? n_keys : n_counts;
  reset_kernel<<<(reset_n + 255) / 256, 256, 0, s>>>(colkey, n_keys, counts, n_counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  match_top2_kernel<D><<<dim3(l.col_tiles, l.row_tiles, batch), THREADS, smem_bytes<D>(), s>>>(
      a, b, ma, mb, uv_pred, uv_b, r2, gated, K, N, a_group, min1, min2, arg1, colarg, colkey,
      reinterpret_cast<int4*>(scratch + l.rowpart), counts);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch match_top2 needs for K rows, N columns and `batch`
// pairs.
extern "C" size_t match_top2_scratch_bytes(int K, int N, int batch) {
  return layout(K, N, batch).bytes;
}

// `batch` pairs (a, b): b (batch, N, D) float32 with D = 128 or 256, a
// (batch / a_group, K, D), entry z paired with a's group z / a_group
// (a_group divides batch), both 16-byte aligned; ma (batch / a_group, K),
// mb (batch, N) bool as bytes; uv_pred (batch / a_group, K, 2), uv_b
// (batch, N, 2) float32, read only when gated != 0; r2 the squared gate
// radius. Outputs min1, min2 (batch, K) float32, arg1 (batch, K) int32,
// colarg (batch, N) int32; scratch: match_top2_scratch_bytes(K, N, batch)
// bytes, 16-byte aligned. All contiguous device buffers. Two launches on
// `stream`; returns the first CUDA error (0 on success); never
// synchronises.
extern "C" int match_top2(const float* a, const float* b,
                          const unsigned char* ma, const unsigned char* mb,
                          const float* uv_pred, const float* uv_b, float r2,
                          int gated, float* min1, float* min2, int* arg1,
                          int* colarg, void* scratch, size_t scratch_bytes, int K, int N,
                          int D, int batch, int a_group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != 128 && D != 256) || K < 1 || N < 1 || batch < 1 || batch > 65535 ||
      a_group < 1 || batch % a_group != 0 || (size_t)N * batch > INT_MAX / 2 ||
      (size_t)K * (batch / a_group) > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(K, N, batch);
  if (scratch_bytes < l.bytes || l.row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  char* sc = static_cast<char*>(scratch);
  const cudaError_t e =
      D == 128 ? launch<128>(a, b, ma, mb, uv_pred, uv_b, r2, gated, min1, min2, arg1, colarg,
                             sc, l, K, N, batch, a_group, s)
               : launch<256>(a, b, ma, mb, uv_pred, uv_b, r2, gated, min1, min2, arg1, colarg,
                             sc, l, K, N, batch, a_group, s);
  return static_cast<int>(e);
}
