// Hand-written Hopper (sm_90a) kernel for the Ozaki int8 slice products.
//
// It replaces two Pallas kernels of dlaf_tpu/tile_ops/pallas_ozaki.py:
//   dlaf_oz_product <- fused_slice_product (:112, call :133)
//   dlaf_oz_syrk    <- fused_slice_syrk (:249, call :269)
// Both compute, for every output element (i, j) and every shift d < s,
// the exact integer group sum
//     p_d(i, j) = sum_{t <= d} A_t[i, :] . B_{d-t}[j, :]
// of int8 slices (both operands K-contiguous rows), and fold the groups
// into a float32 pair (hi, lo) in the exact order of the reference's
// _fold_body (pallas_ozaki.py:63-99): phi = (float)p, plo = (float)(p -
// (int)phi), a two-sum of hi with phi 2^-7(d+2), and lo += err + plo
// 2^-7(d+2). The multiplications are by powers of two and exact, and the
// file is built with -fmad=false besides, so the result is bit for bit the
// plain version's.
//
// What bounds it: the s(s+1)/2 int8 products, 2 M N K operations each
// (1979 TOP/s int8 dense on an H100), against s (M + N) K bytes of slices
// and 8 M N bytes of output. At the Cholesky's shapes (K = 256, s = 8) the
// operations bound it. The TPU kernel keeps all slices of a 256-row tile in
// VMEM and folds each group as soon as it is complete. A block here has
// far less fast memory, so:
//   * one block (8 warps) computes a 64 x 64 output tile; each warp a
//     32 x 16 sub-tile with mma.sync m16n8k32 s8 x s8 -> s32 tensor-core
//     products;
//   * K is walked in chunks of 32; for each chunk the block stages ALL s
//     slices of its 64 A rows and 64 B rows in shared memory (16-byte
//     chunks XOR-swizzled against bank conflicts) and issues every pair
//     product of that chunk, so each slice byte is read from global memory
//     once per tile;
//   * the s group sums stay in int32 registers for the whole K walk (exact:
//     |p| <= s K 2^12 < 2^27 for K <= 1024), and the fold runs once at the
//     end, in the order d = 0 .. s-1, so hi and lo are written once.
// The syrk entry runs the same body with B = A. Tiles whose 256-row block
// lies strictly above the block diagonal write zeros and return, which is
// the reference's output contract (its predicated 256-block grid). K must
// be a multiple of 32 (the wrapper zero-pads, which is exact); M and N are
// masked at the loads and the store. wgmma and TMA are later work.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, KC = 32, THREADS = 256;
constexpr int WM = 32, WN = 16;          // warp tile; 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
constexpr int SLICE_BITS = 7;
constexpr int MAX_SLICES = 9;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of (row, k) in a staged (64, KC) slice tile: two 16-byte
// chunks per row, the chunk index XORed with bit 2 of the row so that the
// 8 rows one fragment load touches fall on distinct banks.
__device__ __forceinline__ int swz(int row, int kbyte) {
  return row * KC + ((((kbyte >> 4) ^ (row >> 2)) & 1) << 4) + (kbyte & 15);
}

__device__ __forceinline__ unsigned ld32(const int8_t* tile, int row, int kbyte) {
  return *reinterpret_cast<const unsigned*>(tile + swz(row, kbyte));
}

// Stage all S slices of `rows` rows starting at `row0` (K-contiguous, row
// stride K, slice stride `sstride` bytes), columns [k0, k0 + KC), into
// `dst`; rows at or past `nrows` are zero.
template <int S>
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* __restrict__ src,
                                      long long sstride, int row0, int nrows, int K,
                                      int k0) {
  for (int idx = threadIdx.x; idx < S * BM * 2; idx += THREADS) {
    const int t = idx / (BM * 2), rem = idx % (BM * 2);
    const int row = rem >> 1, chunk = rem & 1;
    int4 v = make_int4(0, 0, 0, 0);
    const int g = row0 + row;
    if (g < nrows)
      v = *reinterpret_cast<const int4*>(src + t * sstride + (long long)g * K + k0 +
                                         chunk * 16);
    *reinterpret_cast<int4*>(dst + t * BM * KC + swz(row, chunk * 16)) = v;
  }
}

__device__ __forceinline__ void fold(float& hi, float& lo, int p, int d) {
  // exact power of two 2^-7(d+2) (d <= 8: exponent >= -77, normal)
  const float scale = __int_as_float((127 - SLICE_BITS * (d + 2)) << 23);
  const float phi = __int2float_rn(p);
  const float plo = __int2float_rn(p - __float2int_rz(phi));
  const float b = __fmul_rn(phi, scale);
  const float s = __fadd_rn(hi, b);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  hi = s;
  lo = __fadd_rn(lo, __fadd_rn(err, __fmul_rn(plo, scale)));
}

// hi/lo (M, N) row-major with row stride ldo. `syrk_block` > 0: zero the
// tiles whose syrk_block-row block lies strictly above the block diagonal.
template <int S>
__global__ void __launch_bounds__(THREADS)
slice_fold_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N,
                  int K, float* __restrict__ hi_out, float* __restrict__ lo_out, int ldo,
                  int syrk_block) {
  __shared__ __align__(16) int8_t As[S * BM * KC];
  __shared__ __align__(16) int8_t Bs[S * BN * KC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (syrk_block > 0 && n0 / syrk_block > m0 / syrk_block) {
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = m0 + idx / BN, c = n0 + idx % BN;
      if (r < M && c < N) {
        hi_out[(long long)r * ldo + c] = 0.f;
        lo_out[(long long)r * ldo + c] = 0.f;
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = (warp >> 2) * WM, wc = (warp & 3) * WN;
  const long long sa = (long long)M * K, sb = (long long)N * K;

  int acc[S][MT][NT][4];
#pragma unroll
  for (int d = 0; d < S; ++d)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    stage<S>(As, A, sa, m0, M, K, k0);
    stage<S>(Bs, B, sb, n0, N, K, k0);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int8_t* at = As + t * BM * KC;
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wr + i * 16 + g;
        af[i][0] = ld32(at, r, tig * 4);
        af[i][1] = ld32(at, r + 8, tig * 4);
        af[i][2] = ld32(at, r, 16 + tig * 4);
        af[i][3] = ld32(at, r + 8, 16 + tig * 4);
      }
#pragma unroll
      for (int u = 0; u < S - t; ++u) {
        const int8_t* bt = Bs + u * BN * KC;
        unsigned bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wc + j * 8 + g;
          bf[j][0] = ld32(bt, c, tig * 4);
          bf[j][1] = ld32(bt, c, 16 + tig * 4);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[t + u][i][j], af[i], bf[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wr + i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = n0 + wc + j * 8 + tig * 2 + (e & 1);
        float hi = 0.f, lo = 0.f;
#pragma unroll
        for (int d = 0; d < S; ++d) fold(hi, lo, acc[d][i][j][e], d);
        if (r < M && c < N) {
          hi_out[(long long)r * ldo + c] = hi;
          lo_out[(long long)r * ldo + c] = lo;
        }
      }
}

template <int S>
int launch(const void* a, const void* b, int m, int n, int k, void* hi, void* lo,
           int syrk_block, cudaStream_t st) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  slice_fold_kernel<S><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), m, n, k,
      static_cast<float*>(hi), static_cast<float*>(lo), n, syrk_block);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int s, const void* a, const void* b, int m, int n, int k, void* hi, void* lo,
             int syrk_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  switch (s) {
    case 1: return launch<1>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 2: return launch<2>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 3: return launch<3>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 4: return launch<4>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 5: return launch<5>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 6: return launch<6>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 7: return launch<7>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 8: return launch<8>(a, b, m, n, k, hi, lo, syrk_block, st);
    case 9: return launch<9>(a, b, m, n, k, hi, lo, syrk_block, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static_assert(MAX_SLICES * (BM + BN) * KC <= 48 * 1024, "static shared memory");

}  // namespace

extern "C" {

// ia: (s, m, k) int8; ibt: (s, n, k) int8 (B transposed: K-contiguous rows);
// k a multiple of 32. hi, lo: (m, n) float32.
int dlaf_oz_product(int s, const void* ia, const void* ibt, int m, int n, int k, void* hi,
                    void* lo, void* stream) {
  return dispatch(s, ia, ibt, m, n, k, hi, lo, 0, stream);
}

// ia: (s, m, k) int8; hi, lo: (m, m) float32, valid on the 256-row blocks
// on and below the block diagonal, zero above.
int dlaf_oz_syrk(int s, const void* ia, int m, int k, int block, void* hi, void* lo,
                 void* stream) {
  return dispatch(s, ia, ia, m, m, k, hi, lo, block, stream);
}

}  // extern "C"
