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
// the live pairs need about 16.1 GFLOP (the diagonal pairs' triangles
// only), 0.24 ms at the card's 67 TFLOP/s f32, against about 0.28 GB of
// bytes (each live tile of a read and written once, the panels read
// once), 0.08 ms at 3.35 TB/s.
//
// Design. The TPU kernel runs one grid step per tile pair, in order, and
// predicates the MXU dot with pl.when. Here the unit of work is a 128 x 128
// sub-tile of a pair, and only live sub-tiles are visited:
//   * a one-block plan kernel ranks the pairs of the device-side mode table
//     (a block-wide scan of each pair's live sub-tile count: all of them
//     for mode 1, those on or below (mode 2) or above (mode 3) the pair's
//     diagonal) and writes the list of live sub-tiles, each with its mode;
//     no host data and no host sync;
//   * the update kernel is persistent, one block of 256 threads per SM
//     (an 8 x 8 register tile a thread, rows and columns in two groups of
//     4, 64 apart; up to 255 registers, so a k quad's fragments of both
//     operands stay in registers), block b taking items b, b + grid, ...
//     of the list: dead pairs cost nothing and the tail is one partial
//     wave;
//   * each block streams the K chunks (32 deep) of its items through a
//     4-stage ring of 16-byte cp.async copies, one barrier per chunk, the
//     chunks of its next item loading while the current item's last chunks
//     and its epilogue run. A panel with K-contiguous rows is staged as it
//     lies, row-major, and read by float4 of 4 k; a transposed panel (as
//     uplo 'U' passes its row panel; a flag per operand) is staged
//     k-major, and read by float4 of 4 rows; both layouts are free of bank
//     conflicts for the copies and the reads (see Layout). Every thread
//     accumulates with fmaf in the order k = 0 .. nb-1. bf16 panels, and
//     f32 ones that 16-byte copies cannot read (nb not a multiple of 4, or
//     unaligned), are staged k-major element by element (widened through
//     registers, or by 4-byte copies);
//   * the decoded items wait in a small ring in shared memory, so the
//     epilogue depends on no global load but the tile of `a` itself, which
//     is prefetched into L2 when the item's first chunk is issued; its
//     read-modify-write goes by float4 (4 bf16), four rows' loads in flight
//     at once, masked per element only at the ragged edge and where the
//     pair's diagonal crosses a 4-wide group.
// The update is in place: `a` is the rank's trailing block as a strided
// view of its shard (tile (r, c) at a + r*a_rs + c*a_cs, rows of nb), so
// the block is never copied; only elements inside the pair's mask are
// written. nb need not be a multiple of anything: copies past the tile's
// edge or past K fill zeros, and the epilogue masks the ragged edge.
// Tensor cores would need TF32 or a split-TF32 form, which changes the
// arithmetic.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256, NWARPS = THREADS / 32;
constexpr int LDK = BM + 4;                       // one k row of a K_MAJOR operand
constexpr int LDR = BK + 4;                       // one row of a ROW_MAJOR operand
constexpr int OP_FLOATS = BK * LDK > BM * LDR ? BK * LDK : BM * LDR;  // either layout
constexpr int STAGE_FLOATS = 2 * OP_FLOATS;       // A then B
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int PLAN_THREADS = 1024;
// decoded items awaiting their epilogue: the load cursor is at most STAGES
// items ahead of the compute cursor's
constexpr int RING = STAGES + 1;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Row (or column) offset inside the block tile of a thread's register
// element e (0..7): two groups of 4, 64 apart.
__device__ __forceinline__ int off(int t, int e) { return (e < 4 ? 0 : 64) + t * 4 + (e & 3); }

__device__ __forceinline__ int live_subtiles(int mode, int nsub) {
  return mode == 1 ? nsub * nsub : (mode == 2 || mode == 3) ? nsub * (nsub + 1) / 2 : 0;
}

__device__ __forceinline__ bool keep(int mode, int i, int j) {
  return mode == 1 || (mode == 2 && i >= j) || (mode == 3 && i <= j);
}

// ---- the plan: the list of live sub-tiles --------------------------------

// list[0] = the number of items; list[1 + q] = ((pair * nsub + si) * nsub + sj)
// * 4 + mode.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ mode_tab, int np, int nsub, int* __restrict__ list) {
  __shared__ int warp_sum[PLAN_THREADS / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < np; base += PLAN_THREADS) {
    const int i = base + tid;
    const int mode = i < np ? mode_tab[i] : 0;
    const int n = live_subtiles(mode, nsub);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane], wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(~0u, wi, o);
        if (lane >= o) wi += y;
      }
      warp_sum[lane] = wi - w;  // exclusive prefix of the warps
    }
    __syncthreads();
    int at = 1 + carry + warp_sum[warp] + incl - n;
    if (mode == 1) {
      for (int si = 0; si < nsub; ++si)
        for (int sj = 0; sj < nsub; ++sj) list[at++] = ((i * nsub + si) * nsub + sj) * 4 + 1;
    } else if (mode == 2 || mode == 3) {
      for (int si = 0; si < nsub; ++si)
        for (int sj = mode == 2 ? 0 : si; sj <= (mode == 2 ? si : nsub - 1); ++sj)
          list[at++] = ((i * nsub + si) * nsub + sj) * 4 + mode;
    }
    __syncthreads();
    if (tid == PLAN_THREADS - 1) carry += warp_sum[warp] + incl;
    __syncthreads();
  }
  if (tid == 0) list[0] = carry;
}

// ---- the update -----------------------------------------------------------

// How an operand sits in a stage: K_MAJOR s[k * LDK + row]; ROW_MAJOR
// s[slot(row) * LDR + k], rows padded by one 16-byte quad and permuted so
// that rows 4 t + e (a thread's group) for t = 0 .. 31 lie in consecutive
// slots: a quarter warp's float4 reads at one k quad, and its 16-byte
// copies of one row, then hit distinct banks, and every address is affine
// in k.
enum Layout { K_MAJOR = 0, ROW_MAJOR = 1 };
__device__ __forceinline__ int slot(int row) { return (row & 3) * (BM / 4) + (row >> 2); }

template <typename T>
struct Params {
  T* a;
  long long a_rs, a_cs;
  const T* vr;
  const T* vc;
  const int* list;
  int C, nb, nsub, trans, vec, ovec;  // vec: float4 epilogue; ovec: 16-byte operand copies
};

struct Item {
  int r, c, i0, j0, mode;
};

// This block's n-th list entry (its code), and an entry decoded.
template <typename T>
__device__ __forceinline__ int code_of(const Params<T>& p, int n) {
  return __ldg(p.list + 1 + static_cast<int>(blockIdx.x + n * gridDim.x));
}
template <typename T>
__device__ __forceinline__ Item item_of(const Params<T>& p, int code) {
  const int ns2 = p.nsub * p.nsub, q = code >> 2, pair = q / ns2, sub = q - pair * ns2;
  return {pair / p.C, pair % p.C, (sub / p.nsub) * BM, (sub % p.nsub) * BN, code & 3};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage K chunk k0 .. k0+BK of the 128 operand rows from row0 of the
// (nb, nb) f32 panel v, rows K-contiguous, ROW_MAJOR by 16-byte copies
// (nb a multiple of 4; zeros past nb): a warp copies 4 rows of 128 bytes.
__device__ __forceinline__ void stage_rows(float* s, const float* v, int row0, int k0, int nb) {
#pragma unroll
  for (int e = 0; e < BM * BK / 4 / THREADS; ++e) {
    const int idx = threadIdx.x + THREADS * e, row = idx / (BK / 4), kq = idx % (BK / 4);
    const int gr = row0 + row, gk = k0 + 4 * kq;
    const bool in = gr < nb && gk < nb;
    cp_async16(s + slot(row) * LDR + 4 * kq, in ? v + (size_t)gr * nb + gk : v, in);
  }
}

// The same chunk K_MAJOR. trans: v holds the operand transposed (v[k][row]),
// already k-major: 16-byte copies where `vec`. Otherwise a transpose on the
// way by 4-byte copies, a warp covering 8 k x 4 rows so that the reads are
// 32-byte row segments and the shared-memory writes hit 32 distinct banks.
__device__ __forceinline__ void stage(float* s, const float* v, int row0, int k0, int nb,
                                      int trans, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (trans && vec) {
#pragma unroll
    for (int e = 0; e < BK * BM / 4 / THREADS; ++e) {
      const int k = warp + NWARPS * e, row = 4 * lane, gk = k0 + k, gr = row0 + row;
      const bool in = gk < nb && gr < nb;
      cp_async16(s + k * LDK + row, in ? v + (size_t)gk * nb + gr : v, in);
    }
  } else if (trans) {
#pragma unroll 4
    for (int e = 0; e < BK * BM / THREADS; ++e) {
      const int k = warp + NWARPS * (e / 4), row = lane + 32 * (e & 3);
      const int gk = k0 + k, gr = row0 + row;
      const bool in = gk < nb && gr < nb;
      cp_async4(s + k * LDK + row, in ? v + (size_t)gk * nb + gr : v, in);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < BK * BM / THREADS; ++e) {
      const int u = warp + NWARPS * e;  // (row group, k group)
      const int k = 8 * (u % (BK / 8)) + (lane & 7), row = 4 * (u / (BK / 8)) + (lane >> 3);
      const int gk = k0 + k, gr = row0 + row;
      const bool in = gk < nb && gr < nb;
      cp_async4(s + k * LDK + row, in ? v + (size_t)gr * nb + gk : v, in);
    }
  }
}

// bf16: K_MAJOR, widened through registers (no copy widens).
__device__ __forceinline__ void stage(float* s, const __nv_bfloat16* v, int row0, int k0, int nb,
                                      int trans, int) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int e = 0; e < BK * BM / THREADS; ++e) {
    int k, row;
    if (trans) {
      k = warp + NWARPS * (e / 4);
      row = lane + 32 * (e & 3);
    } else {
      const int u = warp + NWARPS * e;
      k = 8 * (u % (BK / 8)) + (lane & 7);
      row = 4 * (u / (BK / 8)) + (lane >> 3);
    }
    const int gk = k0 + k, gr = row0 + row;
    float x = 0.f;
    if (gk < nb && gr < nb) x = ld(trans ? v + (size_t)gk * nb + gr : v + (size_t)gr * nb + gk);
    s[k * LDK + row] = x;
  }
}

template <int L, typename T>
__device__ __forceinline__ void stage_op(float* s, const T* v, int row0, int k0, int nb,
                                         int trans, int ovec) {
  if constexpr (L == ROW_MAJOR)
    stage_rows(s, v, row0, k0, nb);
  else
    stage(s, v, row0, k0, nb, trans, ovec);
}

// Fragments of one k quad: the rows (or columns) off(t, 0..7) of a staged
// operand, f[e][kk] for k = 4 kq + kk.
template <int L>
__device__ __forceinline__ void frag4(const float* s, int kq, int t, float (&f)[8][4]) {
  if constexpr (L == ROW_MAJOR) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 v = *reinterpret_cast<const float4*>(s + slot(off(t, e)) * LDR + 4 * kq);
      f[e][0] = v.x, f[e][1] = v.y, f[e][2] = v.z, f[e][3] = v.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(s + (4 * kq + kk) * LDK + 64 * g + 4 * t);
        f[4 * g][kk] = v.x, f[4 * g + 1][kk] = v.y, f[4 * g + 2][kk] = v.z,
                  f[4 * g + 3][kk] = v.w;
      }
  }
}

// acc += A B^T over one stage, k ascending for every accumulator: per k
// quad, both operands' fragments, then 64 independent FMAs for each k.
// The k quads are unrolled whole where an operand is ROW_MAJOR, by two
// otherwise (each measured the faster for its layouts).
template <int LA, int LB>
__device__ __forceinline__ void mma_quad(const float* As, const float* Bs, int kq,
                                         float (&acc)[8][8], int tx, int ty) {
  float a[8][4], b[8][4];
  frag4<LA>(As, kq, ty, a);
  frag4<LB>(Bs, kq, tx, b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
}
template <int LA, int LB>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          float (&acc)[8][8], int tx, int ty) {
  if constexpr (LA == ROW_MAJOR || LB == ROW_MAJOR) {
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) mma_quad<LA, LB>(As, Bs, kq, acc, tx, ty);
  } else {
#pragma unroll 2
    for (int kq = 0; kq < BK / 4; ++kq) mma_quad<LA, LB>(As, Bs, kq, acc, tx, ty);
  }
}

template <int LA, int LB, typename T>
__device__ __forceinline__ void issue(const Params<T>& p, float* s, const Item& it, int k0) {
  const size_t tile = (size_t)p.nb * p.nb;
  stage_op<LA>(s, p.vr + it.r * tile, it.i0, k0, p.nb, p.trans & 1, p.ovec);
  stage_op<LB>(s + OP_FLOATS, p.vc + it.c * tile, it.j0, k0, p.nb, p.trans >> 1, p.ovec);
}

// This item's sub-tile of `a` into L2 (128-byte lines), so that the
// epilogue, some K chunks later, reads it from there.
template <typename T>
__device__ __forceinline__ void prefetch_tile(const Params<T>& p, const Item& it) {
  const T* base = p.a + it.r * p.a_rs + it.c * p.a_cs;
  const int rows = min(BM, p.nb - it.i0);
  const int bytes = min(BN, p.nb - it.j0) * static_cast<int>(sizeof(T));
  const int lines = (bytes + 127) / 128 + 1;  // a row need not start on a line
  for (int e = threadIdx.x; e < rows * lines; e += THREADS) {
    const int r = e / lines, l = e - r * lines;
    const char* row = reinterpret_cast<const char*>(base + (long long)(it.i0 + r) * p.nb + it.j0);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row + min(128 * l, bytes - 1)));
  }
}

__device__ __forceinline__ float4 load4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* q) {
  uint2 u = *reinterpret_cast<const uint2*>(q);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* q, float4 v) { *reinterpret_cast<float4*>(q) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* q, float4 v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(q) = u;
}

// a[r, c] -= acc inside the pair's mask, then acc = 0. Four rows at a time:
// their 4-wide groups that lie wholly inside the tile and the mask are
// loaded together, then updated by float4 (4 bf16); the others (the ragged
// edge, groups the pair's diagonal crosses) element by element.
template <typename T>
__device__ __forceinline__ void epilogue(const Params<T>& p, const Item& it,
                                         float (&acc)[8][8], int tx, int ty) {
  const int mode = it.mode, nb = p.nb;
  T* out = p.a + it.r * p.a_rs + it.c * p.a_cs;
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += 4) {
    float4 old[4][2];
    bool fast[4][2];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = it.i0 + off(ty, i0 + ii), gj = it.j0 + off(tx, 4 * h);
        fast[ii][h] = p.vec && gi < nb && gj + 3 < nb && keep(mode, gi, gj) &&
                      keep(mode, gi, gj + 3);
        if (fast[ii][h]) old[ii][h] = load4(out + (long long)gi * nb + gj);
      }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = it.i0 + off(ty, i0 + ii), gj = it.j0 + off(tx, 4 * h);
        const float v[4] = {acc[i0 + ii][4 * h], acc[i0 + ii][4 * h + 1],
                            acc[i0 + ii][4 * h + 2], acc[i0 + ii][4 * h + 3]};
        T* q = out + (long long)gi * nb + gj;
        if (fast[ii][h]) {
          const float4 o = old[ii][h];
          store4(q, make_float4(o.x - v[0], o.y - v[1], o.z - v[2], o.w - v[3]));
        } else if (gi < nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gj + e < nb && keep(mode, gi, gj + e)) st(q + e, ld(q + e) - v[e]);
        }
      }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i0 + ii][j] = 0.f;
  }
}

template <typename T, int LA, int LB>
__global__ void __launch_bounds__(THREADS, 1)
masked_update_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) float sm[];
  static_assert(BK % 32 == 0 && BM == 128 && BN == 128 && THREADS == 256, "tile shape");
  const int count = __ldg(p.list), bid = blockIdx.x, grid = gridDim.x;
  if (bid >= count) return;
  const int mine = (count - 1 - bid) / grid + 1;
  const int nk = (p.nb + BK - 1) / BK, total = mine * nk;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the load cursor runs STAGES - 1 chunks ahead of the compute cursor,
  // into the next item across the epilogue; the list entry after the one
  // it works on is already in flight, and the items it decoded wait in a
  // ring in shared memory for their epilogues
  __shared__ Item ring[RING];
  int li = 0, lk = 0, ls = 0, next = mine > 1 ? code_of(p, 1) : 0;
  Item lit = item_of(p, code_of(p, 0));
  if (tid == 0) ring[0] = lit;
  prefetch_tile(p, lit);
  auto advance = [&]() {
    ls = ls == STAGES - 1 ? 0 : ls + 1;
    if (++lk < nk) return;
    lk = 0;
    if (++li < mine) {
      lit = item_of(p, next);
      if (li + 1 < mine) next = code_of(p, li + 1);
      if (tid == 0) ring[li % RING] = lit;
      prefetch_tile(p, lit);
    }
  };
#pragma unroll
  for (int h = 0; h < STAGES - 1; ++h) {
    if (li < mine) {
      issue<LA, LB>(p, sm + ls * STAGE_FLOATS, lit, lk * BK);
      advance();
    }
    cp_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int ci = 0, ck = 0, cs = 0;
  for (int g = 0; g < total; ++g) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (li < mine) {
      issue<LA, LB>(p, sm + ls * STAGE_FLOATS, lit, lk * BK);
      advance();
    }
    cp_commit();
    const float* As = sm + cs * STAGE_FLOATS;
    mma_stage<LA, LB>(As, As + OP_FLOATS, acc, tx, ty);
    cs = cs == STAGES - 1 ? 0 : cs + 1;
    if (++ck < nk) continue;
    ck = 0;
    epilogue(p, ring[ci++ % RING], acc, tx, ty);
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename T, int LA, int LB>
void run(const Params<T>& p, cudaStream_t s) {
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !opted[dev]) {
    cudaFuncSetAttribute(masked_update_kernel<T, LA, LB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (dev >= 0 && dev < 64) opted[dev] = true;
  }
  masked_update_kernel<T, LA, LB><<<sm_count(), THREADS, SMEM_BYTES, s>>>(p);
}

template <typename T>
int launch(void* a, long long a_rs, long long a_cs, const void* vr, const void* vc,
           const void* mode, void* list, int R, int C, int nb, int trans, cudaStream_t s) {
  const int nsub = (nb + BM - 1) / BM;
  plan_kernel<<<1, PLAN_THREADS, 0, s>>>(static_cast<const int*>(mode), R * C, nsub,
                                         static_cast<int*>(list));
  // float4 (4 x bf16) epilogue and 16-byte operand copies where every
  // address they touch is aligned
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a), pr = reinterpret_cast<uintptr_t>(vr),
                  pc = reinterpret_cast<uintptr_t>(vc);
  const int vec = nb % 4 == 0 && a_rs % 4 == 0 && a_cs % 4 == 0 && pa % (4 * sizeof(T)) == 0;
  const int ovec = nb % 4 == 0 && pr % 16 == 0 && pc % 16 == 0;
  Params<T> p{static_cast<T*>(a), a_rs, a_cs, static_cast<const T*>(vr),
              static_cast<const T*>(vc), static_cast<const int*>(list), C, nb, nsub, trans, vec,
              ovec};
  if constexpr (sizeof(T) == 4) {
    // f32 panels with K-contiguous rows go ROW_MAJOR by 16-byte copies
    const bool ra = ovec && !(trans & 1), rb = ovec && !(trans & 2);
    if (ra && rb)
      run<T, ROW_MAJOR, ROW_MAJOR>(p, s);
    else if (ra)
      run<T, ROW_MAJOR, K_MAJOR>(p, s);
    else if (rb)
      run<T, K_MAJOR, ROW_MAJOR>(p, s);
    else
      run<T, K_MAJOR, K_MAJOR>(p, s);
  } else {
    run<T, K_MAJOR, K_MAJOR>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16. a: tile (r, c) at a + r*a_rs + c*a_cs
// (elements), each tile (nb, nb) with rows of nb; vr (R, nb, nb) and vc
// (C, nb, nb) contiguous, holding the operands themselves or their
// transposes (bit 0 of trans for vr, bit 1 for vc: then vr[r][k][i] is
// operand element (i, k));
// mode (R, C) int32 contiguous; list: 1 + R C ceil(nb/128)^2 int32 of
// scratch for the plan.
int dlaf_masked_update(int dtype, void* a, long long a_rs, long long a_cs, const void* vr,
                       const void* vc, const void* mode, void* list, int R, int C, int nb,
                       int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || nb <= 0) return 0;
  return dtype == 0 ? launch<float>(a, a_rs, a_cs, vr, vc, mode, list, R, C, nb, trans, s)
                    : launch<__nv_bfloat16>(a, a_rs, a_cs, vr, vc, mode, list, R, C, nb, trans, s);
}

}  // extern "C"
