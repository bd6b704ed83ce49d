// Hand-written Hopper (sm_90a) kernel for the distributed Cholesky's
// predicated trailing update.
//
// It replaces masked_trailing_update of dlaf_tpu/tile_ops/pallas_kernels.py
// (_update_kernel, pallas_call at :69): for every tile pair (r, c) of a
// rank's trailing block
//     a[r, c] -= vr[r] @ vc[c]^T
// under the pair's mode: 0 skip, 1 the whole tile, 2 its lower triangle
// (i >= j), 3 its upper triangle (i <= j). Products accumulate in f32 FMA,
// no TF32 (the reference's dot is preferred_element_type=float32); bf16
// storage is widened to f32 on load and rounded once on store.
//
// What bounds it: the operations. At the main path's first step on one rank
// of a 2x2 grid (N=16384, nb=256: 32 x 32 pairs, 465 full and 31 diagonal)
// the live pairs need 496 x 2 nb^3 = 16.6 GFLOP, 0.25 ms at the card's
// 67 TFLOP/s f32, against about 0.28 GB of bytes (each live tile of a read
// and written once, the panels read once), 0.08 ms at 3.35 TB/s.
//
// Design. The TPU kernel runs one grid step per tile pair, in order, and
// predicates the MXU dot with pl.when. Here:
//   * one block of 256 threads computes a 128 x 128 sub-tile of one pair:
//     the grid is (sub-tiles of a tile, C, R); a block reads its pair's
//     mode and returns at once for mode 0, or when its sub-tile lies wholly
//     outside the pair's triangle (mode 2 above, mode 3 below the diagonal),
//     so dead pairs cost one load;
//   * K is walked in chunks of 8: both operands' 128 x 8 slices are staged
//     in shared memory (k-major, so each thread reads two float4 of each
//     per k), and every thread accumulates an 8 x 8 register tile with
//     fmaf, in the order k = 0 .. nb-1;
//   * the update is in place: `a` is the rank's trailing block as a strided
//     view of its shard (tile (r, c) at a + r*a_rs + c*a_cs, rows of nb),
//     so the block is never copied; only elements inside the pair's mask
//     are written. nb need not be a multiple of anything: loads and stores
//     are masked at the tile edge.
// The panels vr (R, nb, nb) and vc (C, nb, nb) are contiguous, rows
// K-contiguous (the wrapper makes transposed panels contiguous).
// wgmma, TMA and a persistent grid are later work.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Row (or column) offset inside the block tile of a thread's register
// element e (0..7): two groups of 4, 64 apart.
__device__ __forceinline__ int off(int t, int e) { return (e < 4 ? 0 : 64) + t * 4 + (e & 3); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_update_kernel(T* __restrict__ a, long long a_rs, long long a_cs,
                     const T* __restrict__ vr, const T* __restrict__ vc,
                     const int* __restrict__ mode_tab, int C, int nb, int nsub) {
  const int r = blockIdx.z, c = blockIdx.y;
  const int mode = mode_tab[r * C + c];
  if (mode == 0) return;
  const int i0 = (blockIdx.x / nsub) * BM, j0 = (blockIdx.x % nsub) * BN;
  if (mode == 2 && j0 > i0 + BM - 1) return;  // wholly above the diagonal
  if (mode == 3 && i0 > j0 + BN - 1) return;  // wholly below it
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const T* A = vr + (long long)r * nb * nb;
  const T* B = vc + (long long)c * nb * nb;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < nb; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int row = idx / BK, kk = idx % BK, gk = k0 + kk;
      const int gi = i0 + row, gj = j0 + row;
      As[kk][row] = (gi < nb && gk < nb) ? ld(A + (long long)gi * nb + gk) : 0.f;
      Bs[kk][row] = (gj < nb && gk < nb) ? ld(B + (long long)gj * nb + gk) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* out = a + r * a_rs + c * a_cs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i0 + off(ty, i);
    if (gi >= nb) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = j0 + off(tx, j);
      if (gj >= nb || (mode == 2 && gi < gj) || (mode == 3 && gi > gj)) continue;
      T* p = out + (long long)gi * nb + gj;
      st(p, ld(p) - acc[i][j]);
    }
  }
}

template <typename T>
int launch(void* a, long long a_rs, long long a_cs, const void* vr, const void* vc,
           const void* mode, int R, int C, int nb, cudaStream_t s) {
  const int nsub = (nb + BM - 1) / BM;
  const dim3 grid(nsub * nsub, C, R);
  masked_update_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<T*>(a), a_rs, a_cs, static_cast<const T*>(vr), static_cast<const T*>(vc),
      static_cast<const int*>(mode), C, nb, nsub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16. a: tile (r, c) at a + r*a_rs + c*a_cs
// (elements), each tile (nb, nb) with rows of nb; vr (R, nb, nb) and vc
// (C, nb, nb) contiguous; mode (R, C) int32 contiguous.
int dlaf_masked_update(int dtype, void* a, long long a_rs, long long a_cs, const void* vr,
                       const void* vc, const void* mode, int R, int C, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || nb <= 0) return 0;
  return dtype == 0 ? launch<float>(a, a_rs, a_cs, vr, vc, mode, R, C, nb, s)
                    : launch<__nv_bfloat16>(a, a_rs, a_cs, vr, vc, mode, R, C, nb, s);
}

}  // extern "C"
