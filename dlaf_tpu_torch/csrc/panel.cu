// Hand-written Hopper (sm_90a) kernels for the blocked Cholesky panel.
//
// They replace the Pallas kernels of dlaf_tpu/tile_ops/pallas_panel.py:
//   potrf_kernel  <- _fused_potrf (:187), the MICRO=8 right-looking ladder
//   trinv_kernel  <- _tri_inv_lower (:229), run at grid step 0 there
//   gemm_kernel   <- the strip product of _fused_solve_rows (:296),
//                    _fused_factor_solve_rows (:442) and _fused_step_lower
//                    (:508), and the step's masked slab
//
// The TPU kernels keep the tile, its inverse and the solved leading strip
// block in VMEM across a grid that runs in order. On this card a block has
// at most 227 KB of shared memory and blocks run in no order, so:
//   * the factor runs on ONE block of 512 threads with the whole lower
//     triangle resident in shared memory (rows packed, each padded to a
//     multiple of 8 floats: 135 KB at d = 256). Its work is small (d^3/3
//     = 5.6 MFLOP at d = 256) and its column steps form a dependent chain,
//     so latency, block barriers and shared-memory traffic bound it, not
//     bytes or flops. Per 8-wide micro-panel it takes three barriers: one
//     warp factors the 8 x 8 diagonal block in registers, in the ladder's
//     rsqrt-scaled column order; every row below replays the same eight
//     column steps on its own thread against the saved diagonal columns;
//     micro-panels go in pairs, and one rank-16 update of the trailing
//     triangle per pair, in 8 x 4 register blocks, halves the trailing
//     triangle's shared-memory traffic against rank-8 updates. `a` is
//     read once (f32 by cp.async), `out` and the f32 `w` written once;
//   * the inverse runs on ONE block of 512 threads with the triangle
//     resident in shared memory in the same packed layout, inverted in
//     place by recursive doubling (d^3/3 FMAs from shared memory in about
//     a dozen barrier-separated phases, 4 x 4 register tiles; see
//     trinv_kernel). The substitution's chain of d/8 block rows that read
//     the growing inverse from global memory is gone;
//   * the strip product and the slab update are separate launches on the
//     same stream, tiled over many blocks, reading what the one-block
//     launches wrote;
//   * nothing is padded in memory: every kernel takes its extents and
//     leading dimensions and masks the ragged edge itself (the factor pads
//     the tile to a multiple of 8 with the identity inside shared memory,
//     as the reference pads with blkdiag(A, I)).
// Storage is float or __nv_bfloat16; all arithmetic is in f32. Build without
// --use_fast_math: the NaN-prefix failure contract depends on rsqrtf of a
// non-positive pivot giving NaN or inf, and on NaN * 0 staying NaN.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MICRO = 8;
constexpr int PANEL_MAX = 256;
constexpr int POTRF_THREADS = 512;
constexpr int TRINV_THREADS = 512, TRINV_WARPS = TRINV_THREADS / 32;
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Packed lower-triangle layout of the factor's shared memory: row i
// starts at row_off(i) and holds (i | 7) + 1 floats, so every 4-aligned
// run of 4 columns is a 16-byte aligned float4 and an 8-row block of the
// diagonal stays inside its rows.
__device__ __forceinline__ int row_off(int i) {
  const int a = i >> 3, b = i & 7;
  return 32 * a * (a + 1) + 8 * b * (a + 1);
}

// One element of the tile into shared memory: f32 asynchronously
// (cp.async, waited for once), bf16 through a register.
__device__ __forceinline__ void to_smem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void to_smem(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

constexpr int TRI_FLOATS = 32 * (PANEL_MAX / 8) * (PANEL_MAX / 8 + 1);  // row_off(PANEL_MAX)
constexpr int LP_COLS = 2 * MICRO;  // the micro-panel pair of a rank-16 update
constexpr int POTRF_SMEM = (TRI_FLOATS + LP_COLS * PANEL_MAX + MICRO * MICRO + MICRO) * 4;
// the inverse: the packed triangle and the W of one doubling level (at
// most d8 b / 2 floats, b <= d8 / 2)
constexpr int TRINV_SMEM = (TRI_FLOATS + PANEL_MAX * PANEL_MAX / 4) * 4;

// Factor the 8-wide micro-panel at column j0 in place (the diagonal block
// by warp 0, then one thread per row below), its columns also into
// lp[(c0 + k) * PANEL_MAX + row]. Two block barriers.
__device__ __forceinline__ void micro_panel(float* x, float* lp, float* dcol, float* rs, int j0,
                                            int c0, int d8) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    // every lane factors the whole 8 x 8 diagonal block in registers in
    // the ladder's column order (no shuffles on the chain); lane r < 8
    // then stores row j0 + r
    float P[MICRO][MICRO];
#pragma unroll
    for (int r = 0; r < MICRO; ++r) {
      const float4* row = reinterpret_cast<const float4*>(x + row_off(j0 + r) + j0);
      const float4 u = row[0], v4 = row[1];
      const float q[MICRO] = {u.x, u.y, u.z, u.w, v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int c = 0; c < MICRO; ++c) P[r][c] = c <= r ? q[c] : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < MICRO; ++jj) {
      const float r = rsqrtf(P[jj][jj]);
      float v[MICRO];
#pragma unroll
      for (int c = jj; c < MICRO; ++c) v[c] = P[c][jj] * r;
      // rows r >= jj (rows above jj take v = 0 and change no lower entry)
#pragma unroll
      for (int row = jj; row < MICRO; ++row) {
#pragma unroll
        for (int c = 0; c <= row; ++c)
          if (c != jj) P[row][c] -= v[row] * (c > jj ? v[c] : 0.f);
        P[row][jj] = v[row];
      }
      if (lane == 0) rs[jj] = r;
#pragma unroll
      for (int c = jj + 1; c < MICRO; ++c)
        if (c == lane) dcol[jj * MICRO + c] = v[c];
    }
#pragma unroll
    for (int r = 0; r < MICRO; ++r)
      if (r == lane) {
        float* row = x + row_off(j0 + r) + j0;
#pragma unroll
        for (int c = 0; c <= r; ++c) row[c] = P[r][c];
      }
  }
  __syncthreads();
  // the rows below, one thread each: the same eight column steps
  for (int i = j0 + MICRO + tid; i < d8; i += POTRF_THREADS) {
    float4* row = reinterpret_cast<float4*>(x + row_off(i) + j0);
    const float4 u = row[0], v4 = row[1];
    float p[MICRO] = {u.x, u.y, u.z, u.w, v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int jj = 0; jj < MICRO; ++jj) {
      const float v = p[jj] * rs[jj];
#pragma unroll
      for (int c = 0; c < MICRO; ++c) p[c] -= v * (c > jj ? dcol[jj * MICRO + c] : 0.f);
      p[jj] = v;
    }
    row[0] = make_float4(p[0], p[1], p[2], p[3]);
    row[1] = make_float4(p[4], p[5], p[6], p[7]);
#pragma unroll
    for (int c = 0; c < MICRO; ++c) lp[(c0 + c) * PANEL_MAX + i] = p[c];
  }
  __syncthreads();
}

// Lower Cholesky factor of the (d, d) tile `a` (row stride lda; only its
// lower triangle is read). `w`, unless null, is an f32 (d, d) buffer that
// gets the factor (strict upper zero). `out` gets the factor in the lower
// triangle and `a`'s strict upper triangle passed through.
//
// Micro-panels go in pairs: factor panel J, apply its rank-8 update to
// panel J+1's columns only, factor panel J+1, then apply both as one
// rank-16 update to the rest of the trailing triangle, in 8 x 4 register
// blocks. The reference applies rank-8 updates after every panel; the sums
// are the same, in another order.
//
// Failure contract (the reference ladder's, pallas_panel.py:145-149): a
// non-positive pivot gives NaN or inf through rsqrtf; the column step
// subtracts v * 0 from the row's earlier micro-panel columns, so a
// non-finite v turns them to NaN (NaN * 0), and the trailing updates then
// carry NaN into every later column.
template <typename T>
__global__ void __launch_bounds__(POTRF_THREADS)
potrf_kernel(const T* __restrict__ a, int lda, T* __restrict__ out, int ldo,
             float* __restrict__ w, int d) {
  extern __shared__ __align__(16) float sm[];
  float* x = sm;                         // the packed lower triangle
  float* lp = x + TRI_FLOATS;            // lp[k * PANEL_MAX + i]: factored column k of the pair
  float* dcol = lp + LP_COLS * PANEL_MAX;  // dcol[jj * MICRO + c]: diagonal column jj at its step
  float* rs = dcol + MICRO * MICRO;      // rs[jj]: rsqrt of pivot jj
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d8 = (d + MICRO - 1) / MICRO * MICRO;

  // the lower triangle, identity-padded to d8 (the rest of each 8-padded
  // row zero), a warp per row
  for (int i = warp; i < d8; i += POTRF_THREADS / 32) {
    float* row = x + row_off(i);
#pragma unroll
    for (int c = 0; c < PANEL_MAX / 32; ++c) {
      const int j = lane + 32 * c;
      if (j > (i | 7)) break;
      if (i < d && j <= i)
        to_smem(row + j, a + (size_t)i * lda + j);
      else
        row[j] = i == j ? 1.f : 0.f;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int j0 = 0; j0 < d8; j0 += 2 * MICRO) {
    const int j1 = j0 + MICRO, j2 = j1 + MICRO;
    micro_panel(x, lp, dcol, rs, j0, 0, d8);
    if (j1 >= d8) break;
    // panel J's rank-8 update of panel J+1's columns [j1, j2), rows >= j1:
    // a thread per (row, 4-column half)
    for (int t = tid; t < 2 * (d8 - j1); t += POTRF_THREADS) {
      const int i = j1 + (t >> 1), h = 4 * (t & 1);
      float4* px = reinterpret_cast<float4*>(x + row_off(i) + j1 + h);
      float4 v = *px;
#pragma unroll
      for (int k = 0; k < MICRO; ++k) {
        const float li = lp[k * PANEL_MAX + i];
        v.x -= li * lp[k * PANEL_MAX + j1 + h];
        v.y -= li * lp[k * PANEL_MAX + j1 + h + 1];
        v.z -= li * lp[k * PANEL_MAX + j1 + h + 2];
        v.w -= li * lp[k * PANEL_MAX + j1 + h + 3];
      }
      *px = v;
    }
    __syncthreads();
    micro_panel(x, lp, dcol, rs, j1, MICRO, d8);
    // rank-16 update of the trailing triangle [j2, d8) in 8 x 4 blocks;
    // block row r has 2 (r + 1) of them
    const int nr = (d8 - j2) / 8;
    for (int q = tid; q < nr * (nr + 1); q += POTRF_THREADS) {
      int r = static_cast<int>((sqrtf(4.f * q + 1.f) - 1.f) * 0.5f);
      while (r * (r + 1) > q) --r;
      while ((r + 1) * (r + 2) <= q) ++r;
      const int i0 = j2 + 8 * r, c0 = j2 + 4 * (q - r * (r + 1));
      float4 xr[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
        xr[rr] = *reinterpret_cast<const float4*>(x + row_off(i0 + rr) + c0);
#pragma unroll
      for (int k = 0; k < LP_COLS; ++k) {
        const float4 la = *reinterpret_cast<const float4*>(lp + k * PANEL_MAX + i0);
        const float4 lb = *reinterpret_cast<const float4*>(lp + k * PANEL_MAX + i0 + 4);
        const float4 lj = *reinterpret_cast<const float4*>(lp + k * PANEL_MAX + c0);
        const float li[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          xr[rr].x -= li[rr] * lj.x;
          xr[rr].y -= li[rr] * lj.y;
          xr[rr].z -= li[rr] * lj.z;
          xr[rr].w -= li[rr] * lj.w;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
        *reinterpret_cast<float4*>(x + row_off(i0 + rr) + c0) = xr[rr];
    }
    __syncthreads();
  }

  // out (and w), 8 rows per warp at a time: the rows' strict upper parts
  // of `a` are loaded first, so their latency overlaps the other stores
  for (int i0 = 8 * warp; i0 < d; i0 += 8 * (POTRF_THREADS / 32)) {
    T up[8][PANEL_MAX / 32];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < PANEL_MAX / 32; ++c) {
        const int i = i0 + r, j = lane + 32 * c;
        if (i < d && j > i && j < d) up[r][c] = a[(size_t)i * lda + j];
      }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + r;
      if (i >= d) break;
      const float* row = x + row_off(i);
#pragma unroll
      for (int c = 0; c < PANEL_MAX / 32; ++c) {
        const int j = lane + 32 * c;
        if (j >= d) break;
        const float f = j <= i ? row[j] : 0.f;
        if (w != nullptr) w[(size_t)i * d + j] = f;
        if (j <= i)
          st(out + (size_t)i * ldo + j, f);
        else
          out[(size_t)i * ldo + j] = up[r][c];
      }
    }
  }
}

// ---- the triangular inverse -------------------------------------------
//
// Recursive doubling on the packed triangle, in place in shared memory:
// first every 8 x 8 diagonal block is inverted (by substitution, one
// thread per column, all blocks at once); then for b = 8, 16, ..., 128
// every pair of neighbouring inverted b-blocks [X11 0; T21 X22] becomes
// one inverted 2b-block through
//     W = T21 X11 (b2 x b, into a scratch), X21 = -X22 W (over T21),
// all pairs of a level in one barrier-separated phase on the whole block.
// Every product runs over the structurally non-zero range only (k >= c in
// T21 X11, q <= i in X22 W), in 4 x 4 register tiles whose first chunk is
// masked triangularly: a structural zero is never multiplied, so a NaN in
// a row of the triangle reaches exactly the rows of the inverse that
// depend on it (that row and every later one), as in the reference's
// blocked substitution. Its diagonal 8 x 8 blocks are the reference's own
// substitution, upper half included (a NaN pivot's column pattern).

// The g-th work unit of a phase, with every odd round of NWARPS units
// walked backwards: units are ordered by cost, so a warp's two rounds
// even out.
__device__ __forceinline__ int balanced(int u, int n, int nwarps) {
  const int j = u / nwarps;
  if ((j & 1) == 0) return u;
  const int lo = j * nwarps, hi = min(lo + nwarps, n) - 1;
  return lo + hi - u;
}

// W[i0 .. i0+3][c0 .. c0+3] = T21 X11 over k in [c, b), T21 the rows R2 ..
// and columns C1 .. of x, X11 the inverted b-block at (C1, C1).
__device__ __forceinline__ void trinv_tile_w(const float* x, float* w, int b, int C1, int R2,
                                             int i0, int c0) {
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* trow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) trow[r] = x + row_off(R2 + i0 + r) + C1;
  {
    // k = c0 .. c0+3: X11[k][c] is a structural zero for k < c
    float tv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(trow[r] + c0);
      tv[r][0] = v.x, tv[r][1] = v.y, tv[r][2] = v.z, tv[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(x + row_off(C1 + c0 + kk) + C1 + c0);
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c <= kk; ++c) acc[r][c] = fmaf(tv[r][kk], xv[c], acc[r][c]);
    }
  }
  for (int k = c0 + 4; k < b; k += 4) {
    float tv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(trow[r] + k);
      tv[r][0] = v.x, tv[r][1] = v.y, tv[r][2] = v.z, tv[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(x + row_off(C1 + k + kk) + C1 + c0);
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(tv[r][kk], xv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(w + (i0 + r) * b + c0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// X21[i0 .. i0+3][c0 .. c0+3] = -(X22 W) over q in [0, i], written over
// T21 (rows R2 .., columns C1 .. of x); X22 the inverted block at (R2, R2).
__device__ __forceinline__ void trinv_tile_x(float* x, const float* w, int b, int C1, int R2,
                                             int i0, int c0) {
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* xrow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) xrow[r] = x + row_off(R2 + i0 + r) + R2;
  for (int q = 0; q <= i0; q += 4) {
    float xv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xrow[r] + q);
      xv[r][0] = v.x, xv[r][1] = v.y, xv[r][2] = v.z, xv[r][3] = v.w;
    }
    const bool last = q == i0;  // X22[i][q] is a structural zero for q > i
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float4 v = *reinterpret_cast<const float4*>(w + (q + qq) * b + c0);
      const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (last && r < qq) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r][qq], wv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(x + row_off(R2 + i0 + r) + C1 + c0) =
        make_float4(-acc[r][0], -acc[r][1], -acc[r][2], -acc[r][3]);
}

// Inverse of the lower triangle of `t` (row stride ldt; unit diagonal when
// `unit`) into the f32 (d, d) row-major `inv`, zero above the diagonal 8 x 8
// blocks (whose upper halves are 0 unless a pivot is not finite). The
// triangle is read once (f32 by cp.async), identity-padded to d8 in the
// factor's packed layout, inverted in place, and `inv` written once.
template <typename T>
__global__ void __launch_bounds__(TRINV_THREADS, 1)
trinv_kernel(const T* __restrict__ t, int ldt, int unit, float* __restrict__ inv, int d) {
  extern __shared__ __align__(16) float sm[];
  float* x = sm;                 // the packed lower triangle
  float* wsc = x + TRI_FLOATS;   // W of every pair of a level: pair p at p b^2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d8 = (d + MICRO - 1) / MICRO * MICRO;

  for (int i = warp; i < d8; i += TRINV_WARPS) {
    float* row = x + row_off(i);
#pragma unroll
    for (int c = 0; c < PANEL_MAX / 32; ++c) {
      const int j = lane + 32 * c;
      if (j > (i | 7)) break;
      if (i < d && j <= i && !(unit && j == i))
        to_smem(row + j, t + (size_t)i * ldt + j);
      else
        row[j] = i == j ? 1.f : 0.f;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // the 8 x 8 diagonal blocks, 8 threads each (thread c: column c), by the
  // reference's substitution dinv[i] = (e_i - blk[i, :i] dinv[:i]) /
  // blk[i, i] over the whole block row: its upper half comes out 0, or NaN
  // from a non-finite pivot (0 / NaN), as the reference's does, and is
  // written out with the inverse; the doubling below never reads it
  {
    const int blk = tid >> 3, c = tid & 7, j0 = MICRO * blk;
    float v[MICRO];
    if (j0 < d8) {
      float D[MICRO][MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int k = 0; k <= i; ++k) D[i][k] = x[row_off(j0 + i) + j0 + k];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        float s = i == c ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < i; ++k) s -= D[i][k] * v[k];
        v[i] = s / D[i][i];
      }
    }
    __syncwarp();
    if (j0 < d8) {
#pragma unroll
      for (int i = 0; i < MICRO; ++i) x[row_off(j0 + i) + j0 + c] = v[i];
    }
  }
  __syncthreads();

  for (int b = MICRO; b < d8; b *= 2) {
    const int np = (d8 + 2 * b - 1) / (2 * b), nc = b / 4;
    // W = T21 X11: a warp takes gw column groups x gh row groups, the
    // cost falling with the column (k runs from c to b)
    {
      const int gw = min(8, nc), gh = 32 / gw, ng = nc / gw, nq = (nc + gh - 1) / gh;
      const int n = np * ng * nq;
      for (int u = warp; u < n; u += TRINV_WARPS) {
        const int v = balanced(u, n, TRINV_WARPS);
        const int g = v % ng, q = (v / ng) % nq, p = v / (ng * nq);
        const int C1 = 2 * p * b, R2 = C1 + b;
        const int ig = q * gh + lane / gw, cg = g * gw + lane % gw;
        if (R2 < d8 && 4 * ig < min(b, d8 - R2))
          trinv_tile_w(x, wsc + p * b * b, b, C1, R2, 4 * ig, 4 * cg);
      }
    }
    __syncthreads();
    // X21 = -X22 W: a warp takes whole row groups, the cost rising with the row
    {
      const int gw = min(32, nc), gh = 32 / gw, nq = (nc + gh - 1) / gh;
      const int n = np * nq;
      for (int u = warp; u < n; u += TRINV_WARPS) {
        const int v = balanced(u, n, TRINV_WARPS);
        const int q = v % nq, p = v / nq;
        const int C1 = 2 * p * b, R2 = C1 + b;
        const int ig = q * gh + lane / gw, cg = lane % gw;
        if (R2 < d8 && 4 * ig < min(b, d8 - R2))
          trinv_tile_x(x, wsc + p * b * b, b, C1, R2, 4 * ig, 4 * cg);
      }
    }
    __syncthreads();
  }

  // the lower triangle and the diagonal blocks' upper halves; zeros above
  for (int i = warp; i < d; i += TRINV_WARPS) {
    const float* row = x + row_off(i);
    for (int j = lane; j < d; j += 32) inv[(size_t)i * d + j] = j <= (i | 7) ? row[j] : 0.f;
  }
}

// Shared-memory tiled f32 product over (M, N) output tiles of BM x BN:
//   acc(i, j) = sum_k A(i, k) B(k, j),  B(k, j) = transB ? B[j, k] : B[k, j]
// SLAB=false: out(i, j) = acc (and out32(i, j) = acc when out32 is given).
// SLAB=true:  out(i, j) = C(i, j) - (i >= j ? acc : 0), the step's masked
//             trailing column update.
template <typename TA, typename TO, bool SLAB>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TA* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
            int transB, const TO* __restrict__ C, int ldc, TO* __restrict__ out, int ldo,
            float* __restrict__ out32, int ld32, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += GEMM_THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? ld(A + (size_t)gr * lda + gk) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      int c, kk;
      if (transB) {
        c = idx / BK;
        kk = idx % BK;
      } else {
        kk = idx / BN;
        c = idx % BN;
      }
      const int gc = col0 + c, gk = k0 + kk;
      float v = 0.f;
      if (gc < N && gk < K) v = transB ? B[(size_t)gc * ldb + gk] : B[(size_t)gk * ldb + gc];
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        bv[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      if constexpr (SLAB) {
        float v = ld(C + (size_t)r * ldc + c);
        if (r >= c) v -= acc[i][j];
        st(out + (size_t)r * ldo + c, v);
      } else {
        st(out + (size_t)r * ldo + c, acc[i][j]);
        if (out32 != nullptr) out32[(size_t)r * ld32 + c] = acc[i][j];
      }
    }
  }
}

// Opt in to a kernel's dynamic shared memory, once per device.
template <typename K>
void opt_in(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
}

template <typename T>
int potrf_t(const void* a, int lda, void* out, int ldo, void* work, int d, cudaStream_t s) {
  static bool done[64] = {};
  opt_in(potrf_kernel<T>, POTRF_SMEM, done);
  potrf_kernel<T><<<1, POTRF_THREADS, POTRF_SMEM, s>>>(static_cast<const T*>(a), lda,
                                                       static_cast<T*>(out), ldo,
                                                       static_cast<float*>(work), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int trinv_t(const void* t, int ldt, int unit, void* inv, int d, cudaStream_t s) {
  static bool done[64] = {};
  opt_in(trinv_kernel<T>, TRINV_SMEM, done);
  trinv_kernel<T><<<1, TRINV_THREADS, TRINV_SMEM, s>>>(static_cast<const T*>(t), ldt, unit,
                                                       static_cast<float*>(inv), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int strip_t(const void* b, int ldb, const void* inv, int trans, void* out, int ldo,
            void* out32, int ld32, int m, int d, cudaStream_t s) {
  const dim3 grid((d + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T, T, false><<<grid, GEMM_THREADS, 0, s>>>(
      static_cast<const T*>(b), ldb, static_cast<const float*>(inv), d, trans, nullptr, 0,
      static_cast<T*>(out), ldo, static_cast<float*>(out32), ld32, m, d, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int slab_t(const void* p32, int ldp, const void* c, int ldc, void* out, int ldo, int m,
           int w, int d, cudaStream_t s) {
  const dim3 grid((w + BN - 1) / BN, (m + BM - 1) / BM);
  const float* p = static_cast<const float*>(p32);
  gemm_kernel<float, T, true><<<grid, GEMM_THREADS, 0, s>>>(
      p, ldp, p, ldp, 1, static_cast<const T*>(c), ldc, static_cast<T*>(out), ldo, nullptr,
      0, m, w, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32 storage, 1 = bfloat16 storage.
extern "C" {

int dlaf_potrf(int dtype, const void* a, int lda, void* out, int ldo, void* work, int d,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? potrf_t<float>(a, lda, out, ldo, work, d, s)
                    : potrf_t<__nv_bfloat16>(a, lda, out, ldo, work, d, s);
}

// dtype 2: the triangle is an f32 working copy (the step's factor).
int dlaf_trinv(int dtype, const void* t, int ldt, int unit, void* inv, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? trinv_t<__nv_bfloat16>(t, ldt, unit, inv, d, s)
                    : trinv_t<float>(t, ldt, unit, inv, d, s);
}

int dlaf_strip(int dtype, const void* b, int ldb, const void* inv, int trans, void* out,
               int ldo, void* out32, int ld32, int m, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? strip_t<float>(b, ldb, inv, trans, out, ldo, out32, ld32, m, d, s)
                    : strip_t<__nv_bfloat16>(b, ldb, inv, trans, out, ldo, out32, ld32, m, d, s);
}

int dlaf_slab(int dtype, const void* p32, int ldp, const void* c, int ldc, void* out,
              int ldo, int m, int w, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? slab_t<float>(p32, ldp, c, ldc, out, ldo, m, w, d, s)
                    : slab_t<__nv_bfloat16>(p32, ldp, c, ldc, out, ldo, m, w, d, s);
}

}  // extern "C"
