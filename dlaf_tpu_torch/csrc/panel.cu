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
//   * the factor and the inverse run on ONE block each, over f32 working
//     copies in global memory (256 KiB at d=256, resident in the 50 MB L2);
//     only the current d x 8 micro-panel (or the 8 x 8 diagonal block of the
//     inverse) is staged in shared memory;
//   * the strip product and the slab update are separate launches on the
//     same stream, tiled over many blocks, reading what the one-block
//     launches wrote;
//   * nothing is padded: every kernel takes its extents and leading
//     dimensions and masks the ragged edge itself.
// Storage is float or __nv_bfloat16; all arithmetic is in f32. Build without
// --use_fast_math: the NaN-prefix failure contract depends on rsqrtf of a
// non-positive pivot giving NaN or inf.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MICRO = 8;
constexpr int PANEL_MAX = 256;
constexpr int FACTOR_THREADS = 512;
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lower Cholesky factor of the (d, d) tile `a` (row stride lda; only its
// lower triangle is read). `w` is an f32 (d, d) working copy that holds the
// factor on return (strict upper zero). `out` gets the factor in the lower
// triangle and `a`'s strict upper triangle passed through.
template <typename T>
__global__ void __launch_bounds__(FACTOR_THREADS)
potrf_kernel(const T* __restrict__ a, int lda, T* __restrict__ out, int ldo,
             float* __restrict__ w, int d) {
  __shared__ float P[PANEL_MAX][MICRO + 1];
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int idx = tid; idx < d * d; idx += nth) {
    const int i = idx / d, j = idx - i * d;
    w[idx] = i >= j ? ld(a + (size_t)i * lda + j) : 0.f;
  }
  __syncthreads();
  for (int j0 = 0; j0 < d; j0 += MICRO) {
    const int mw = min(MICRO, d - j0), rows = d - j0;
    for (int idx = tid; idx < rows * mw; idx += nth) {
      const int r = idx / mw, c = idx - r * mw;
      P[r][c] = w[(size_t)(j0 + r) * d + j0 + c];
    }
    __syncthreads();
    // rsqrt-scaled column steps inside the micro-panel. The rank-1 update
    // reaches every other column of the micro-panel's lower triangle, the
    // earlier columns with a zero multiplier: a failed pivot's NaN or inf
    // then turns them to NaN (NaN * 0), the reference ladder's pattern
    // (pallas_panel.py:147-148).
    for (int c = 0; c < mw; ++c) {
      const float rs = rsqrtf(P[c][c]);
      __syncthreads();
      for (int r = c + tid; r < rows; r += nth) P[r][c] *= rs;
      __syncthreads();
      for (int idx = tid; idx < (rows - c) * mw; idx += nth) {
        const int r = c + idx / mw, cc = idx % mw;
        if (cc != c && r >= cc) P[r][cc] -= P[r][c] * (cc > c ? P[cc][c] : 0.f);
      }
      __syncthreads();
    }
    for (int idx = tid; idx < rows * mw; idx += nth) {
      const int r = idx / mw, c = idx - r * mw;
      w[(size_t)(j0 + r) * d + j0 + c] = P[r][c];
    }
    // rank-mw update of the trailing lower triangle
    const int t = rows - mw;
    for (int idx = tid; idx < t * t; idx += nth) {
      const int i = idx / t, j = idx - i * t;
      if (i >= j) {
        float s = 0.f;
        for (int k = 0; k < mw; ++k) s += P[mw + i][k] * P[mw + j][k];
        w[(size_t)(j0 + mw + i) * d + j0 + mw + j] -= s;
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < d * d; idx += nth) {
    const int i = idx / d, j = idx - i * d;
    if (i >= j)
      st(out + (size_t)i * ldo + j, w[idx]);
    else
      out[(size_t)i * ldo + j] = a[(size_t)i * lda + j];
  }
}

// Inverse of the lower triangle of `t` (row stride ldt; unit diagonal when
// `unit`) into the f32 (d, d) row-major `inv`, strict upper zero. Blocked
// substitution: each MICRO-wide diagonal block is inverted by substitution,
// then its block row below the inverted prefix is -Dinv (R Xprefix).
template <typename T>
__global__ void __launch_bounds__(FACTOR_THREADS)
trinv_kernel(const T* __restrict__ t, int ldt, int unit, float* __restrict__ inv, int d) {
  __shared__ float D[MICRO][MICRO + 1];
  __shared__ float DI[MICRO][MICRO + 1];
  __shared__ float tmp[MICRO][PANEL_MAX];
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int j0 = 0; j0 < d; j0 += MICRO) {
    const int mw = min(MICRO, d - j0);
    if (tid < MICRO * MICRO) {
      const int r = tid / MICRO, c = tid % MICRO;
      float v = 0.f;
      if (r < mw && c <= r) v = (unit && r == c) ? 1.f : ld(t + (size_t)(j0 + r) * ldt + j0 + c);
      D[r][c] = v;
    }
    __syncthreads();
    if (tid < mw) {
      const int c = tid;
      for (int i = 0; i < mw; ++i) {
        float s = i == c ? 1.f : 0.f;
        for (int k = 0; k < i; ++k) s -= D[i][k] * DI[k][c];
        DI[i][c] = s / D[i][i];
      }
    }
    __syncthreads();
    if (j0 > 0) {
      for (int idx = tid; idx < mw * j0; idx += nth) {
        const int q = idx / j0, c = idx - q * j0;
        float s = 0.f;
        for (int k = c; k < j0; ++k)
          s += ld(t + (size_t)(j0 + q) * ldt + k) * inv[(size_t)k * d + c];
        tmp[q][c] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < mw * j0; idx += nth) {
        const int r = idx / j0, c = idx - r * j0;
        float s = 0.f;
        for (int q = 0; q <= r; ++q) s += DI[r][q] * tmp[q][c];
        inv[(size_t)(j0 + r) * d + c] = -s;
      }
    }
    const int tail = d - j0;
    for (int idx = tid; idx < mw * tail; idx += nth) {
      const int r = idx / tail, c = idx - r * tail;
      inv[(size_t)(j0 + r) * d + j0 + c] = c < mw ? DI[r][c] : 0.f;
    }
    __syncthreads();
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

template <typename T>
int potrf_t(const void* a, int lda, void* out, int ldo, void* work, int d, cudaStream_t s) {
  potrf_kernel<T><<<1, FACTOR_THREADS, 0, s>>>(static_cast<const T*>(a), lda,
                                               static_cast<T*>(out), ldo,
                                               static_cast<float*>(work), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int trinv_t(const void* t, int ldt, int unit, void* inv, int d, cudaStream_t s) {
  trinv_kernel<T><<<1, FACTOR_THREADS, 0, s>>>(static_cast<const T*>(t), ldt, unit,
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
