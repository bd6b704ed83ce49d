// Hand-written Hopper (sm_90a) kernels for the blocked Cholesky panel.
//
// They replace the Pallas kernels of dlaf_tpu/tile_ops/pallas_panel.py:
//   potrf_kernel  <- _fused_potrf (:187), the MICRO=8 right-looking ladder
//   trinv_kernel  <- _tri_inv_lower (:229), run at grid step 0 there
//   strip_kernel  <- the strip product of _fused_solve_rows (:296),
//                    _fused_factor_solve_rows (:442) and _fused_step_lower
//                    (:508)
//   slab_kernel   <- the step's masked slab update (_fused_step_lower)
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
//     same stream over many blocks, reading what the one-block launches
//     wrote: SIMT f32 products that run only the K chunks the inverse's
//     triangle reaches (see strip_kernel);
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MICRO = 8;
constexpr int PANEL_MAX = 256;
constexpr int POTRF_THREADS = 512;
constexpr int TRINV_THREADS = 512, TRINV_WARPS = TRINV_THREADS / 32;

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

// ---- the strip and slab products ----------------------------------------
//
// acc(r, c) = sum_k A(r, k) B(k, c) in f32 (fmaf on the SIMT units, as the
// reference's f32 dot), over m rows, n <= 256 columns and K <= 256:
//   strip_kernel: B(k, c) = transB ? inv[c][k] : inv[k][c], the triangular
//                 inverse; out = acc (and out32 = acc, the f32 copy of a
//                 bf16 step's panel);
//   slab_kernel:  B(k, c) = p[c][k] over the first w rows of the f32 panel
//                 p = A; out = C - (r >= c ? acc : 0), the step's masked
//                 trailing slab (a product above the mask never reaches out).
//
// What bounds them at the main path's shapes (m = 16128, d = 256): the FMAs
// and the shared-memory loads that feed them, not bytes (the strip's bytes
// take a third of its FMAs' time on the triangle at 67 TFLOP/s). An 8 x 8
// register tile reads one shared-memory byte a FMA, which at 128 bytes a
// clock an SM is as many bytes as the SM's 128 FMA lanes use: both pipes
// are full at once, so the work saved is the FMAs skipped. So:
//   * the block holds BM = 8 TM rows of A for the whole K (<= 256) in shared
//     memory (f32; bf16 converted on the way in). It arrives in 32-wide K
//     chunks, each one TMA box behind its own mbarrier, so a warp starts on
//     chunk 0 while the rest is in flight;
//   * each of the block's 4 warps owns 32-column groups of the output, a
//     64 x 32 (TM = 8) register tile, 8 x 8 accumulators a thread, and
//     streams its own groups' B through a private ring of NS stages of 32 x
//     32, one TMA box a stage: the warps share A but never wait for each
//     other after the start. Operands sit in 128-byte rows with the TMA's
//     128-byte swizzle, so the 8 rows (4 columns) a warp reads as float4
//     along k fall in different banks. transB = 0 (the inverse's columns,
//     which no map turns into rows) and unaligned rows take 4-byte
//     cp.async into the same layout instead;
//   * the inverse is zero above its 8 x 8 diagonal blocks (trinv_kernel),
//     so column c of the strip needs k <= (c | 7) (transB) or k >= (c & ~7):
//     a group runs only the K chunks that reach its columns, 9 of the dense
//     16 chunk products. Warp p takes groups 7 - p and p, 9 chunks whatever
//     p, so the four SM sub-partitions get equal work;
//   * the plain version's product is dense: a non-finite b(r, k) at a
//     skipped k makes every such column of row r NaN (0 * inf). The skip
//     keeps that: the block sums b(r, k) * 0 over each chunk of each row once
//     (0, or NaN exactly when the chunk holds a non-finite entry), and each
//     group adds its skipped chunks' sums to its rows;
//   * the epilogue goes 8 rows at a time through a per-warp scratch, so
//     that a warp writes (and, for the slab, reads C in) whole 128-byte
//     rows;
//   * the row tile shrinks (TM = 8, 4, 2, 1) until there is a block for
//     every SM, so a short strip still spreads over the card.

constexpr int PW = 32;                    // column group width and K chunk (128 bytes of f32)
constexpr int KCH = PANEL_MAX / PW;       // K chunks at most
constexpr int PWARPS = 4, PTHREADS = 32 * PWARPS;
constexpr int TILE = PW * PW;             // floats of one B stage (32 columns x 32 k)
constexpr int SROW = PW + 4;              // epilogue scratch row stride (floats)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 128-byte rows of 32 floats, 16-byte quad q of row r at quad q ^ (r & 7):
// the layout the TMA's 128-byte swizzle writes, read by float4 without bank
// conflicts from 8 rows (A) or 4 (B) at once
__device__ __forceinline__ int swz(int r, int k) { return r * PW + ((((k >> 2) ^ r) & 7) << 2) + (k & 3); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of `bar` with this parity. A lost copy (a fault in this
// kernel) would spin forever and hold the card: after 2^24 polls, far beyond
// any real wait, it traps and the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  int spins = 0;
  do {
    if (++spins > (1 << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One box (32 floats of k from k0, rows from row0) of a 2-D f32 map into
// `dst` (1024-byte aligned), 128-byte swizzle, zero past the map's edges.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row0)
      : "memory");
}

template <typename TA, typename TO>
struct ProductArgs {
  const TA* a;   // (m, K) rows, stride lda
  int lda;
  const float* b;  // the inverse (strip) or the f32 panel (slab), stride ldb
  int ldb, transb;
  const TO* c;   // the slab's input (slab only)
  int ldc;
  TO* out;
  int ldo;
  float* out32;  // the strip's f32 copy, or null
  int ld32, m, n, k;
  int tma_a;  // A through map_a (f32, 16-byte aligned rows), else through registers
  int tma_b;  // B through map_b (rows of B, 16-byte aligned), else by cp.async
  int vec_o;  // 16-byte rows of out (and out32, C): vector epilogue
};

__host__ __device__ constexpr int stages_of(int tm) { return tm >= 8 ? 2 : tm == 4 ? 3 : 4; }
__host__ __device__ constexpr int product_smem(int tm) {
  return 1024 +
         (8 * tm * PANEL_MAX + PWARPS * stages_of(tm) * TILE + PWARPS * 8 * SROW + 8 * tm * KCH) * 4 +
         (KCH + 1 + PWARPS * stages_of(tm)) * 8;
}

// The block's BM rows of A into As, f32, chunk t (BM swizzled rows of 32 k)
// at As + t BM PW, behind abar[t]: by the TMA (zero past m and K), or
// through registers (bf16 converted) and one block barrier, after which
// thread 0 completes every chunk's phase.
template <typename TA, typename TO, int BM>
__device__ __forceinline__ void load_a(const ProductArgs<TA, TO>& p, const CUtensorMap* map,
                                       float* As, uint64_t* abar, int row0, int nk) {
  const int tid = threadIdx.x;
  if (p.tma_a) {
    if (tid == 0)
      for (int t = 0; t < nk; ++t) {
        mbar_expect_tx(abar + t, BM * PW * 4);
        tma_load(As + t * BM * PW, map, abar + t, PW * t, row0);
      }
    return;
  }
  for (int idx = tid; idx < BM * nk * PW; idx += PTHREADS) {
    const int t = idx / (BM * PW), r = idx / PW % BM, k = idx % PW, gr = row0 + r;
    const bool in = gr < p.m && PW * t + k < p.k;
    As[t * BM * PW + swz(r, k)] = in ? ld(p.a + (size_t)gr * p.lda + PW * t + k) : 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < nk; ++t) mbar_arrive(abar + t);
}

// One warp: its columns [PW g, PW g + PW) x K chunk ch of B into a stage as
// swizzled [column][k]: lane 0 by the TMA (map_b over B's rows, completion
// on bar), or every lane by 4-byte cp.async, one group (transB = 0 reads
// the inverse's columns, which no map can turn into rows).
template <typename TA, typename TO>
__device__ __forceinline__ void load_b(const ProductArgs<TA, TO>& p, const CUtensorMap* map,
                                       float* dst, uint64_t* bar, int g, int ch, int lane) {
  if (p.tma_b) {
    if (lane == 0) {
      mbar_expect_tx(bar, TILE * 4);
      tma_load(dst, map, bar, PW * ch, PW * g);
    }
    return;
  }
#pragma unroll 4
  for (int e = 0; e < PW; ++e) {
    // transB: lanes along k of one column; else along the columns of one k
    const int c = p.transb ? e : lane, kk = p.transb ? lane : e;
    const int gc = PW * g + c, k = PW * ch + kk;
    const bool in = gc < p.n && k < p.k;
    const float* src = p.transb ? p.b + (size_t)gc * p.ldb + k : p.b + (size_t)k * p.ldb + gc;
    cp_async4(dst + swz(c, kk), in ? src : p.b, in ? 4 : 0);
  }
  cp_commit();
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows r (block-relative r0 .. r0 + 8 of the warp's piece) and columns c0 ..
// c0 + 3 of the output from the warp's scratch row: out = v (strip, and
// out32) or out = C - (r >= c ? v : 0) (slab); 16-byte accesses where the
// rows allow them.
template <typename TA, typename TO, bool SLAB>
__device__ __forceinline__ void put4(const ProductArgs<TA, TO>& p, int r, int c0, float4 v) {
  if (r >= p.m) return;
  const float w[4] = {v.x, v.y, v.z, v.w};
  if (p.vec_o && c0 + 3 < p.n) {
    if constexpr (SLAB) {
      const float4 c = ld4(p.c + (size_t)r * p.ldc + c0);
      const float cv[4] = {c.x, c.y, c.z, c.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = r >= c0 + e ? cv[e] - w[e] : cv[e];
      st4(p.out + (size_t)r * p.ldo + c0, make_float4(o[0], o[1], o[2], o[3]));
    } else {
      st4(p.out + (size_t)r * p.ldo + c0, v);
      if (p.out32 != nullptr) st4(p.out32 + (size_t)r * p.ld32 + c0, v);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + e;
    if (c >= p.n) break;
    if constexpr (SLAB) {
      const float cv = ld(p.c + (size_t)r * p.ldc + c);
      st(p.out + (size_t)r * p.ldo + c, r >= c ? cv - w[e] : cv);
    } else {
      st(p.out + (size_t)r * p.ldo + c, w[e]);
      if (p.out32 != nullptr) p.out32[(size_t)r * p.ld32 + c] = w[e];
    }
  }
}

template <typename TA, typename TO, bool SLAB, int TM>
__device__ __forceinline__ void product(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        const ProductArgs<TA, TO>& p) {
  constexpr int BM = 8 * TM, NS = stages_of(TM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* Bs = As + KCH * BM * PW;                       // [warp][stage][PW columns][PW k]
  float* Ss = Bs + PWARPS * NS * TILE;                  // [warp][8 rows][SROW]
  float* Zs = Ss + PWARPS * 8 * SROW;                   // [BM rows][KCH]
  uint64_t* abar = reinterpret_cast<uint64_t*>(Zs + BM * KCH);  // [KCH]
  uint64_t* zbar = abar + KCH;
  uint64_t* bbar = zbar + 1;                            // [warp][stage]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 2, tx = lane & 3;              // rows ty + 8 i, columns tx + 4 j
  const int row0 = blockIdx.x * BM, nk = (p.k + PW - 1) / PW, ng = (p.n + PW - 1) / PW;
  if (tid == 0) {
    for (int q = 0; q < KCH + 1 + PWARPS * NS; ++q) mbar_init(abar + q, q == KCH ? PTHREADS : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (lane == 0 && p.tma_a)
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map_a)) : "memory");
  if (lane == 0 && p.tma_b)
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map_b)) : "memory");
  __syncthreads();
  // the strip: Zs[r][t] = sum over chunk t of b(r, k) * 0 (0, or NaN where
  // the chunk holds a non-finite entry), a share a thread, after a warp's
  // third chunk (all of A is in by then) or before its first epilogue, for
  // the skipped chunks of every group's epilogue
  bool zdone = SLAB;
  auto zshare = [&] {
    for (int t = 0; t < nk; ++t) mbar_wait(abar + t, 0);
    for (int idx = tid; idx < BM * nk; idx += PTHREADS) {
      const int r = idx / nk, t = idx % nk;
      float z = 0.f;
#pragma unroll
      for (int kq = 0; kq < PW / 4; ++kq) {
        const float4 v = ld4(As + t * BM * PW + r * PW + ((kq ^ r) & 7) * 4);
        z = fmaf(v.x, 0.f, fmaf(v.y, 0.f, fmaf(v.z, 0.f, fmaf(v.w, 0.f, z))));
      }
      Zs[r * KCH + t] = z;
    }
    mbar_arrive(zbar);
    zdone = true;
  };

  // this warp's two groups, the long one first, and their K chunk ranges
  // (a group past n, or one that needs no chunk, has an empty range)
  int g_[2], lo_[2], hi_[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int g = q == 0 ? KCH - 1 - warp : warp;
    int lo, hi;
    if constexpr (SLAB) {
      lo = 0;
      hi = PW * g > row0 + BM - 1 ? 0 : nk;   // wholly above the mask: C only
    } else {
      lo = p.transb ? 0 : min(g, nk);
      hi = p.transb ? min(g + 1, nk) : nk;
    }
    g_[q] = g < ng ? g : -1;
    lo_[q] = g < ng ? lo : 0;
    hi_[q] = g < ng ? hi : 0;
  }
  const int g0 = g_[0], g1 = g_[1], lo0 = lo_[0], lo1 = lo_[1], hi0 = hi_[0], hi1 = hi_[1];
  const int n0 = hi0 - lo0, items = n0 + hi1 - lo1;
  float* Bw = Bs + warp * NS * TILE;
  uint64_t* bw = bbar + warp * NS;
  // the warp's ring of NS B stages (the cp.async form commits one group a
  // stage, empty past the last item, so that wait_group counts stages)
  auto issue = [&](int it) {
    if (it < items) {
      const bool first = it < n0;
      load_b(p, map_b, Bw + (it % NS) * TILE, bw + it % NS, first ? g0 : g1,
             first ? lo0 + it : lo1 + it - n0, lane);
    } else if (!p.tma_b) {
      cp_commit();
    }
  };
#pragma unroll
  for (int it = 0; it < NS; ++it) issue(it);
  load_a<TA, TO, BM>(p, map_a, As, abar, row0, nk);

  int it = 0;
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    const int g = q ? g1 : g0, lo = q ? lo1 : lo0, hi = q ? hi1 : hi0;
    if (g < 0) continue;
    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int ch = lo; ch < hi; ++ch, ++it) {
      mbar_wait(abar + ch, 0);
      if (p.tma_b) {
        mbar_wait(bw + it % NS, (it / NS) & 1);
      } else {
        cp_wait<NS - 1>();
        __syncwarp();
      }
      // row r = ty + 8 i of the chunk (swizzle r & 7 = ty), column c = tx +
      // 4 j of the stage (swizzle tx + 4 (j & 1))
      const float* ap = As + ch * BM * PW + ty * PW;
      const float* bp = Bw + (it % NS) * TILE + tx * PW;
#pragma unroll
      for (int kq = 0; kq < PW / 4; ++kq) {
        const int oa = (kq ^ ty) << 2, ob0 = (kq ^ tx) << 2, ob1 = (kq ^ (tx + 4)) << 2;
        float4 bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bp + 4 * j * PW + (j & 1 ? ob1 : ob0));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(ap + 8 * i * PW + oa);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
          }
        }
      }
      __syncwarp();   // every lane is done with this stage before it refills
      issue(it + NS);
      if constexpr (!SLAB)
        if (!zdone && it == 2) zshare();
    }
    // the dense product's NaN where b has a non-finite entry in a skipped
    // chunk of the row
    float z[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) z[i] = 0.f;
    if constexpr (!SLAB) {
      if (!zdone) zshare();
      mbar_wait(zbar, 0);
      const int s_lo = p.transb ? hi : 0, s_hi = p.transb ? nk : lo;
      for (int t = s_lo; t < s_hi; ++t)
#pragma unroll
        for (int i = 0; i < TM; ++i) z[i] += Zs[(ty + 8 * i) * KCH + t];
    }
    // 8 rows at a time through the warp's scratch, so that each lane writes
    // 16 bytes of a row: whole 128-byte rows a warp instruction
    float* Sw = Ss + warp * 8 * SROW;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) Sw[ty * SROW + tx + 4 * j] = acc[i][j] + z[i];
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = (lane >> 3) + 4 * e, cq = 4 * (lane & 7);
        put4<TA, TO, SLAB>(p, row0 + 8 * i + rr, PW * g + cq, ld4(Sw + rr * SROW + cq));
      }
      __syncwarp();
    }
  }
  if (!zdone) zshare();   // a warp without columns still owes its share
  // no copy into this block's shared memory outlives it (a slab tile above
  // the mask reads no chunk)
  for (int t = 0; t < nk; ++t) mbar_wait(abar + t, 0);
}

template <typename T, int TM>
__global__ void __launch_bounds__(PTHREADS)
strip_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ ProductArgs<T, T> p) {
  product<T, T, false, TM>(&map_a, &map_b, p);
}

template <typename T, int TM>
__global__ void __launch_bounds__(PTHREADS)
slab_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ ProductArgs<float, T> p) {
  product<float, T, true, TM>(&map_a, &map_b, p);
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

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = n > 0 ? n : 1;
    if (dev >= 0 && dev < 64) sms[dev] = n;
  }
  return n;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 2-D map over `rows` f32 rows of k (stride ld), boxes of 32 k x `box_rows`
// rows, 128-byte swizzle, zero fill past the edges.
bool make_map(CUtensorMap* map, const float* ptr, int k, int rows, int ld, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {PW, static_cast<cuuint32_t>(box_rows)}, elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr, int ld) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && (ld & 3) == 0;
}

template <typename TA, typename TO, bool SLAB, int TM>
int launch_product(ProductArgs<TA, TO> p, cudaStream_t s) {
  static bool done[64] = {};
  constexpr int BM = 8 * TM;
  CUtensorMap map_a{}, map_b{};
  if (p.tma_a &&
      !make_map(&map_a, reinterpret_cast<const float*>(p.a), p.k, p.m, p.lda, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma_b && !make_map(&map_b, p.b, p.k, p.n, p.ldb, PW))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p.m + BM - 1) / BM;
  if constexpr (SLAB) {
    opt_in(slab_kernel<TO, TM>, product_smem(TM), done);
    slab_kernel<TO, TM><<<blocks, PTHREADS, product_smem(TM), s>>>(map_a, map_b, p);
  } else {
    opt_in(strip_kernel<TA, TM>, product_smem(TM), done);
    strip_kernel<TA, TM><<<blocks, PTHREADS, product_smem(TM), s>>>(map_a, map_b, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row tile: the largest whose blocks still cover every SM.
template <typename TA, typename TO, bool SLAB>
int product_t(const ProductArgs<TA, TO>& p, cudaStream_t s) {
  const int sms = sm_count();
  if (p.m >= 64 * sms) return launch_product<TA, TO, SLAB, 8>(p, s);
  if (p.m >= 32 * sms) return launch_product<TA, TO, SLAB, 4>(p, s);
  if (p.m >= 16 * sms) return launch_product<TA, TO, SLAB, 2>(p, s);
  return launch_product<TA, TO, SLAB, 1>(p, s);
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
  const ProductArgs<T, T> p{static_cast<const T*>(b), ldb, static_cast<const float*>(inv), d,
                            trans, nullptr, 0, static_cast<T*>(out), ldo,
                            static_cast<float*>(out32), ld32, m, d, d,
                            sizeof(T) == 4 && aligned16(b, ldb), trans && aligned16(inv, d),
                            aligned16(out, ldo) && (out32 == nullptr || aligned16(out32, ld32))};
  return product_t<T, T, false>(p, s);
}

template <typename T>
int slab_t(const void* p32, int ldp, const void* c, int ldc, void* out, int ldo, int m,
           int w, int d, cudaStream_t s) {
  const float* pp = static_cast<const float*>(p32);
  const bool vec = aligned16(p32, ldp);
  const ProductArgs<float, T> p{pp, ldp, pp, ldp, 1, static_cast<const T*>(c), ldc,
                                static_cast<T*>(out), ldo, nullptr, 0, m, w, d, vec, vec,
                                aligned16(out, ldo) && aligned16(c, ldc)};
  return product_t<float, T, true>(p, s);
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
