// Hand-written Hopper (sm_90a) kernel for the Ozaki int8 slice products.
//
// It replaces three Pallas kernels of dlaf_tpu/tile_ops/pallas_ozaki.py:
//   dlaf_oz_product <- fused_slice_product (:112, call :133)
//   dlaf_oz_syrk    <- fused_slice_syrk (:249, call :269)
//   dlaf_oz_masked  <- masked_slice_product (:185, call :208)
// All compute, for every output element (i, j) and every shift d < s,
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
// the reference's output contract (its predicated 256-block grid). The
// masked entry runs it once per tile pair (r, c) of a distributed trailing
// update: grid z walks the R x C pairs, A is row tile r of ia (s, R, bm,
// K), B row tile c of ib (s, C, bn, K), the output the (bm, bn) pair block
// of hi/lo (R, C, bm, bn); a block whose pair has mode 0 writes zeros and
// returns, so dead pairs skip all their int8 products. Its bound at the
// distributed main path's first step on one rank of a 2x2 grid (N=16384,
// bm = bn = K = 256, s = 8): 496 live pairs x 36 x 2 x 256^3 = 6.0e14
// operations, 0.30 ms at 1979 TOP/s. K must
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
// Pairs (masked entry): blockIdx.z is the pair p = r * C + c; A, B and the
// outputs advance by r * a_pair, c * b_pair and p * o_pair elements, and a
// pair whose mode[p] is 0 is written as zeros. Other entries: one pair,
// mode null. sa, sb: the slice strides of A and B.
template <int S>
__global__ void __launch_bounds__(THREADS)
slice_fold_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N,
                  int K, long long sa, long long sb, float* __restrict__ hi_out,
                  float* __restrict__ lo_out, int ldo, int syrk_block,
                  const int* __restrict__ mode, int C, long long a_pair, long long b_pair,
                  long long o_pair) {
  __shared__ __align__(16) int8_t As[S * BM * KC];
  __shared__ __align__(16) int8_t Bs[S * BN * KC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int pair = blockIdx.z;
  A += (pair / C) * a_pair;
  B += (pair % C) * b_pair;
  hi_out += pair * o_pair;
  lo_out += pair * o_pair;
  if ((syrk_block > 0 && n0 / syrk_block > m0 / syrk_block) ||
      (mode != nullptr && mode[pair] == 0)) {
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

// One launch over R x C pairs (R = C = 1, mode null: one product) of
// (m, n) outputs each; slices of A (B) strided by m_all * k (n_all * k).
struct Args {
  const void *a, *b;
  int m, n, k;
  long long sa, sb;
  void *hi, *lo;
  int syrk_block;
  const void* mode;
  int R, C;
};

template <int S>
int launch(const Args& g, cudaStream_t st) {
  const dim3 grid((g.n + BN - 1) / BN, (g.m + BM - 1) / BM, g.R * g.C);
  slice_fold_kernel<S><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(g.a), static_cast<const int8_t*>(g.b), g.m, g.n, g.k, g.sa,
      g.sb, static_cast<float*>(g.hi), static_cast<float*>(g.lo), g.n, g.syrk_block,
      static_cast<const int*>(g.mode), g.C, (long long)g.m * g.k, (long long)g.n * g.k,
      (long long)g.m * g.n);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int s, const Args& g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.m <= 0 || g.n <= 0 || g.R <= 0 || g.C <= 0) return 0;
  switch (s) {
    case 1: return launch<1>(g, st);
    case 2: return launch<2>(g, st);
    case 3: return launch<3>(g, st);
    case 4: return launch<4>(g, st);
    case 5: return launch<5>(g, st);
    case 6: return launch<6>(g, st);
    case 7: return launch<7>(g, st);
    case 8: return launch<8>(g, st);
    case 9: return launch<9>(g, st);
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
  const Args g{ia, ibt, m, n, k, (long long)m * k, (long long)n * k, hi, lo, 0, nullptr, 1, 1};
  return dispatch(s, g, stream);
}

// ia: (s, m, k) int8; hi, lo: (m, m) float32, valid on the 256-row blocks
// on and below the block diagonal, zero above.
int dlaf_oz_syrk(int s, const void* ia, int m, int k, int block, void* hi, void* lo,
                 void* stream) {
  const Args g{ia, ia, m, m, k, (long long)m * k, (long long)m * k, hi, lo, block, nullptr, 1, 1};
  return dispatch(s, g, stream);
}

// ia: (s, R, bm, k) int8; ib: (s, C, bn, k) int8 (both K-contiguous rows);
// k a multiple of 32; mode: (R, C) int32, 0 = pair skipped (zeros). hi, lo:
// (R, C, bm, bn) float32.
int dlaf_oz_masked(int s, const void* ia, const void* ib, const void* mode, int R, int C,
                   int bm, int bn, int k, void* hi, void* lo, void* stream) {
  const Args g{ia, ib, bm, bn, k, (long long)R * bm * k, (long long)C * bn * k, hi, lo, 0, mode,
               R, C};
  return dispatch(s, g, stream);
}

}  // extern "C"
