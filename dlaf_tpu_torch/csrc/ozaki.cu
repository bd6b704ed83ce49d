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
// operations bound it, and only wgmma reaches the int8 rate. So:
//   * the reference's own loop order, shift outer: for d = 0 .. s-1 the
//     group sum p_d is ONE int32 accumulator, filled by the products
//     A_t B_{d-t} (t <= d) over all of K, then folded into hi (registers)
//     and lo (shared memory, in fragment order) before the next shift. A
//     thread holds 64 accumulators and 64 hi whatever s is, instead of s
//     accumulators; the cost is that every
//     operand slice is streamed once per product it takes part in, from L2
//     (the slices of the Cholesky's shapes are a few tens of MB, within the
//     50 MB L2), and that L2 bandwidth, not the tensor cores, then bounds
//     the syrk and the pair products;
//   * a block (one per SM, persistent) owns 128 x 128 output tiles in
//     turn: two consumer warpgroups, each a 64 x 128 half with
//     wgmma.mma_async m64n128k32 s8 x s8 -> s32, both operands read from
//     shared memory in the 128-byte swizzled K-major layout; the producer
//     warpgroup hands its registers to them (setmaxnreg 40 / 232);
//   * one producer warp feeds a ring of 5 stages (a 128 x 128-byte chunk
//     of one A slice and one B slice each) with TMA loads
//     (cp.async.bulk.tensor over a 3-D map (K, rows, slice), completion on
//     an mbarrier), walking (d, t, K chunk) while the consumers run the
//     products of earlier stages. TMA zero-fills past the K, M and N
//     edges, and zeros add nothing to an integer sum, so every stage runs
//     all four k32 steps;
//   * the fold converts p to (float)p and its remainder with FP32 adds on
//     the 14-bit halves of p (exact, see fold()) instead of the
//     quarter-rate conversion instructions;
//   * the block walks a list of work items, the live ones first so that
//     they spread evenly over the SMs: every tile of the product; for the
//     syrk the tiles whose 256-row block lies on or below the block
//     diagonal (the others are only written as zeros, the reference's
//     output contract); for the masked entry the tiles of every (r, c)
//     pair whose mode is non-zero (the others come out zero and do no
//     products). Each warp finds the live pairs itself with ballots over
//     the mode table, so the table never leaves the device, and keeps its
//     place in the list in shared memory between items.
// A: ia (s, M, K); B: ibt (s, N, K) (or A itself for the syrk); the masked
// entry reads tile pair (r, c) as rows r bm .. of ia viewed as (s, R bm, K)
// and rows c bn .. of ib viewed as (s, C bn, K); rows a tile reads past its
// pair belong to the next pair and only feed output rows that are never
// stored. K must be a multiple of 32 (the wrapper zero-pads, which is
// exact) and at most 1024, so |p| < 2^27 and the int32 sums are exact in
// any order. The slice count s (1..9) is a runtime argument: nothing in
// the kernel is sized by it.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// does not take, without launching).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;               // output tile of a block
constexpr int KC = 128;                         // K bytes per stage: one swizzle row
constexpr int STAGES = 5;
constexpr int CONSUMERS = 2;                     // warpgroups; wg w owns rows [64w, 64w+64)
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int THREADS = CONSUMER_THREADS + 128;  // and a producer warpgroup (one warp works)
constexpr int FRAG = 64;                         // m64n128 accumulators per thread
constexpr int SLICE_BITS = 7;
constexpr int MAX_SLICES = 9;
constexpr int K_MAX = 1024;
constexpr int STAGE_A = BM * KC, STAGE_BYTES = STAGE_A + BN * KC;
constexpr int LO_BYTES = BM * BN * 4;  // the consumers' lo, in fragment order
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + LO_BYTES + 2 * STAGES * 8;

enum Kind { PRODUCT = 0, SYRK = 1, PAIRS = 2 };

struct Params {
  int kind, s, M, N, K;       // M x N outputs (per pair); K a multiple of 32
  int ldo;
  int tiles_m, tiles_n;       // ceil(M / BM), ceil(N / BN)
  int block_tiles;            // syrk: the block edge in tiles
  const int* mode;            // pairs: (R, C) table; 0 = pair skipped
  int R, C;                   // pairs; 1 x 1 otherwise
  int a_pair_rows, b_pair_rows;   // map rows between consecutive pairs
  long long o_pair;           // output elements between consecutive pairs
  float* hi;
  float* lo;
};

// ---- shared memory, barriers, TMA and wgmma ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A pipeline
// that lost a stage (a fault in this kernel) would spin forever and hold
// the card; after 2^24 polls, far beyond any real wait of a few
// microseconds, it traps instead, and the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  int spins = 0;
  do {
    if (++spins > (1 << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box (KC bytes of K, 128 rows, one slice) of a 3-D map into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row, int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(slice)
      : "memory");
}

// wgmma descriptor of a K-major operand at `addr` (1024-byte aligned rows of
// 128 bytes, 128-byte swizzle): stride between 8-row groups 1024 bytes.
// Adding 2 advances it by 32 bytes of K (one k32 step).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A (64 x 32 bytes) . B (128 x 32 bytes)^T; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[FRAG], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep reads of the accumulators after the wgmma wait.
__device__ __forceinline__ void fence_acc(int (&d)[FRAG]) {
#pragma unroll
  for (int e = 0; e < FRAG; ++e) asm volatile("" : "+r"(d[e])::"memory");
}

// Exact float of an integer |v| < 2^22 without a conversion instruction.
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f);
}

__device__ __forceinline__ void fold(float& hi, float& lo, int p, int d) {
  // exact power of two 2^-7(d+2) (d <= 8: exponent >= -77, normal)
  const float scale = __int_as_float((127 - SLICE_BITS * (d + 2)) << 23);
  // phi = (float)p and plo = (float)(p - (int)phi), the reference's split,
  // on the FP32 pipes instead of the quarter-rate conversions: p = a 2^14
  // + b with 0 <= b < 2^14 and |a| < 2^13 (|p| < 2^27); both halves are
  // exact floats, their sum rounds once to (float)p, and Fast2Sum's error
  // term is p - phi exactly (|x| >= b whenever x != 0).
  const float x = __fmul_rn(small_int_to_float(p >> 14), 16384.f);
  const float fb = small_int_to_float(p & 0x3FFF);
  const float phi = __fadd_rn(x, fb);
  const float plo = __fsub_rn(fb, __fsub_rn(phi, x));
  const float b = __fmul_rn(phi, scale);
  const float s = __fadd_rn(hi, b);
  const float bb = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  hi = s;
  lo = __fadd_rn(lo, __fadd_rn(err, __fmul_rn(plo, scale)));
}

// ---- the work list --------------------------------------------------------

struct Item {
  int pair, tm, tn;
  bool live, valid;
};

// Forward-only position in the mode table, per liveness class.
struct Cursor {
  int base, before;
};

struct Work {
  int total, live;      // items; the first `live` of them are live
  Cursor live_c, dead_c;  // pairs: where the live and the dead searches stand
};

// The q-th cell (a, b), b <= a, of a lower triangle in row-major order.
__device__ __forceinline__ void tri(int q, int& a, int& b) {
  int r = static_cast<int>((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > q) --r;
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  a = r;
  b = q - r * (r + 1) / 2;
}

// Warp-collective: the target-th (0-based) pair whose liveness is `live`.
__device__ __forceinline__ int nth_pair(const Params& p, bool live, int target, Cursor& c) {
  const int np = p.R * p.C, lane = threadIdx.x & 31;
  for (;;) {
    const int i = c.base + lane;
    unsigned m = __ballot_sync(~0u, i < np && ((__ldg(p.mode + i) != 0) == live));
    const int n = __popc(m);
    if (target < c.before + n) {
      for (int k = target - c.before; k > 0; --k) m &= m - 1;
      return c.base + __ffs(m) - 1;
    }
    c.before += n;
    c.base += 32;
  }
}

// Warp-collective: the item counts of this launch.
__device__ __forceinline__ Work plan(const Params& p) {
  Work w{};
  const int per = p.tiles_m * p.tiles_n;
  if (p.kind == PRODUCT) {
    w.total = w.live = per;
  } else if (p.kind == SYRK) {
    const int tb = p.block_tiles, nb = (p.tiles_m + tb - 1) / tb;
    w.live = nb * (nb + 1) / 2 * tb * tb;
    w.total = nb * nb * tb * tb;
  } else {
    const int np = p.R * p.C, lane = threadIdx.x & 31;
    int live = 0;
    for (int base = 0; base < np; base += 32) {
      const int i = base + lane;
      live += __popc(__ballot_sync(~0u, i < np && __ldg(p.mode + i) != 0));
    }
    w.live = live * per;
    w.total = np * per;
  }
  return w;
}

// Warp-collective (q uniform): item q of the list. Items past the ragged
// edge of a syrk's last block are not valid and do nothing.
__device__ __forceinline__ Item item(const Params& p, Work& w, int q) {
  Item it;
  it.pair = 0;
  it.live = q < w.live;
  const int r = it.live ? q : q - w.live;
  if (p.kind == PRODUCT) {
    it.tm = q / p.tiles_n;
    it.tn = q % p.tiles_n;
  } else if (p.kind == SYRK) {
    const int tb = p.block_tiles, sub = r % (tb * tb);
    int a, b;
    tri(r / (tb * tb), a, b);
    // live: block (a, b) on or below the diagonal; dead: block (b, a + 1)
    const int bi = it.live ? a : b, bj = it.live ? b : a + 1;
    it.tm = bi * tb + sub / tb;
    it.tn = bj * tb + sub % tb;
  } else {
    const int per = p.tiles_m * p.tiles_n, sub = r % per;
    it.pair = it.live ? nth_pair(p, true, r / per, w.live_c) : nth_pair(p, false, r / per, w.dead_c);
    it.tm = sub / p.tiles_n;
    it.tn = sub % p.tiles_n;
  }
  it.valid = it.tm < p.tiles_m && it.tn < p.tiles_n;
  return it;
}

// ---- the kernel ----------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
slice_fold_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s: A at base + s STAGE_BYTES, B after
  const uint32_t bars = base + STAGES * STAGE_BYTES + LO_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMER_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // each warp's place in the work list lives in shared memory between
  // items, so that none of it holds a register across the product loop
  __shared__ Work sched[THREADS / 32];
  const int total = [&] {
    const Work w = plan(p);
    if ((threadIdx.x & 31) == 0) sched[threadIdx.x >> 5] = w;
    __syncwarp();
    return w.total;
  }();
  auto next = [&](int q) {
    Work w = sched[threadIdx.x >> 5];
    const Item it = item(p, w, q);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sched[threadIdx.x >> 5] = w;
    __syncwarp();
    return it;
  };
  const int nk = (p.K + KC - 1) / KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= CONSUMER_THREADS / 32) {
    // producer: one warp walks (d, t, K chunk) of every live item, one
    // stage each; its warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp != CONSUMER_THREADS / 32) return;
    int st = 0, phase = 0;
    for (int q = blockIdx.x; q < total; q += gridDim.x) {
      const Item it = next(q);
      if (!it.valid || !it.live) continue;
      const int ar = (it.pair / p.C) * p.a_pair_rows + it.tm * BM;
      const int br = (it.pair % p.C) * p.b_pair_rows + it.tn * BN;
      for (int d = 0; d < p.s; ++d)
        for (int t = 0; t <= d; ++t)
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(empty(st), phase ^ 1);
            if (lane == 0) {
              const uint32_t dst = base + st * STAGE_BYTES;
              mbar_expect_tx(full(st), STAGE_BYTES);
              tma_load(dst, &map_a, full(st), kc * KC, ar, t);
              tma_load(dst + STAGE_A, &map_b, full(st), kc * KC, br, d - t);
            }
            __syncwarp();
            if (++st == STAGES) {
              st = 0;
              phase ^= 1;
            }
          }
    }
    return;
  }

  // consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of the tile.
  // Across the product loop only the accumulators, hi and the pipeline's
  // position hold registers: lo, the list position and the item wait in
  // shared memory (`held`), so nothing spills.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  struct Held {
    int q, total, pair, tm, tn;
  };
  __shared__ Held held[CONSUMER_THREADS / 32];
  if (lane == 0) held[warp] = Held{static_cast<int>(blockIdx.x), total, 0, 0, 0};
  int acc[FRAG];
  float hi[FRAG];
  // lo[e * CONSUMER_THREADS]: this thread's lo of fragment element e
  float* const lo =
      reinterpret_cast<float*>(smem_raw + (base - raw) + STAGES * STAGE_BYTES) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < FRAG; ++e) acc[e] = 0;
  int st = 0, phase = 0;
  for (;;) {
    __syncwarp();
    const int q = held[warp].q;
    if (q >= held[warp].total) break;
    const Item it = next(q);
    if (lane == 0) {
      held[warp].q = q + gridDim.x;
      held[warp].pair = it.pair;
      held[warp].tm = it.tm;
      held[warp].tn = it.tn;
    }
    if (!it.valid) continue;
    const int shifts = it.live ? p.s : 0;
#pragma unroll
    for (int e = 0; e < FRAG; ++e) hi[e] = lo[e * CONSUMER_THREADS] = 0.f;
    for (int d = 0; d < shifts; ++d) {
      int pending = -1, scale_d = 0;
      for (int t = 0; t <= d; ++t)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(full(st), phase);
          const uint32_t src = base + st * STAGE_BYTES;
          const uint64_t da = desc(src + (threadIdx.x >> 7) * 64 * KC), db = desc(src + STAGE_A);
          // all four k32 steps: past K the stage holds TMA's zeros
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KC / 32; ++kk)
            wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk == 0 ? scale_d : 1);
          wgmma_commit();
          scale_d = 1;
          if (pending >= 0) {  // the previous stage's products are done
            wgmma_wait<1>();
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(empty(pending));
          }
          pending = st;
          if (++st == STAGES) {
            st = 0;
            phase ^= 1;
          }
        }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty(pending));
#pragma unroll
      for (int e = 0; e < FRAG; ++e) fold(hi[e], lo[e * CONSUMER_THREADS], acc[e], d);
    }
    // fragment element e = 4 j + 2 h + b: row + 8 h, column 8 j + b
    __syncwarp();
    const Held h = held[threadIdx.x >> 5];
    const int l = threadIdx.x & 31;
    const int row0 = h.tm * BM + (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
    const int col0 = h.tn * BN + 2 * (l & 3);
    float* ho = p.hi + h.pair * p.o_pair;
    float* lout = p.lo + h.pair * p.o_pair;
    const bool pairs_ok = (p.ldo & 1) == 0;
#pragma unroll
    for (int e = 0; e < FRAG; e += 2) {
      const int r = row0 + 8 * ((e >> 1) & 1), c = col0 + 8 * (e >> 2);
      if (r >= p.M || c >= p.N) continue;
      const long long o = static_cast<long long>(r) * p.ldo + c;
      if (pairs_ok && c + 1 < p.N) {
        *reinterpret_cast<float2*>(ho + o) = make_float2(hi[e], hi[e + 1]);
        *reinterpret_cast<float2*>(lout + o) =
            make_float2(lo[e * CONSUMER_THREADS], lo[(e + 1) * CONSUMER_THREADS]);
      } else {
        ho[o] = hi[e];
        lout[o] = lo[e * CONSUMER_THREADS];
        if (c + 1 < p.N) {
          ho[o + 1] = hi[e + 1];
          lout[o + 1] = lo[(e + 1) * CONSUMER_THREADS];
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

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

// 3-D map over int8 slices (s, rows, k), boxes of (KC bytes, 128 rows, 1),
// 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int k, long long rows, int s) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(s)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(k) * rows};
  const cuuint32_t box[3] = {KC, BM, 1}, elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device; opts the kernel in to its dynamic shared
// memory there on first use.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(slice_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    if (dev >= 0 && dev < 64) sms[dev] = n;
  }
  return n;
}

// One launch; a_rows (b_rows): rows of the A (B) map.
int launch(const void* a, const void* b, long long a_rows, long long b_rows, Params p,
           void* stream) {
  if (p.s < 1 || p.s > MAX_SLICES || p.K <= 0 || p.K % 32 != 0 || p.K > K_MAX ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.M <= 0 || p.N <= 0 || p.R <= 0 || p.C <= 0) return 0;
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles_n = (p.N + BN - 1) / BN;
  long long items = static_cast<long long>(p.tiles_m) * p.tiles_n * p.R * p.C;
  if (p.kind == SYRK) {
    const long long nb = (p.tiles_m + p.block_tiles - 1) / p.block_tiles;
    items = nb * nb * p.block_tiles * p.block_tiles;
  }
  CUtensorMap ma, mb;
  if (!make_map(&ma, a, p.K, a_rows, p.s) || !make_map(&mb, b, p.K, b_rows, p.s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  const int grid = static_cast<int>(items < sms ? items : sms);
  slice_fold_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

Params params(int kind, int s, int m, int n, int k, void* hi, void* lo) {
  Params p{};
  p.kind = kind;
  p.s = s;
  p.M = m;
  p.N = n;
  p.K = k;
  p.ldo = n;
  p.R = p.C = 1;
  p.hi = static_cast<float*>(hi);
  p.lo = static_cast<float*>(lo);
  return p;
}

}  // namespace

extern "C" {

// ia: (s, m, k) int8; ibt: (s, n, k) int8 (B transposed: K-contiguous rows);
// k a multiple of 32. hi, lo: (m, n) float32.
int dlaf_oz_product(int s, const void* ia, const void* ibt, int m, int n, int k, void* hi,
                    void* lo, void* stream) {
  return launch(ia, ibt, m, n, params(PRODUCT, s, m, n, k, hi, lo), stream);
}

// ia: (s, m, k) int8; hi, lo: (m, m) float32, valid on the block-row
// blocks on and below the block diagonal, zero above; block a multiple of
// 128.
int dlaf_oz_syrk(int s, const void* ia, int m, int k, int block, void* hi, void* lo,
                 void* stream) {
  if (block <= 0 || block % BM != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = params(SYRK, s, m, m, k, hi, lo);
  p.block_tiles = block / BM;
  return launch(ia, ia, m, m, p, stream);
}

// ia: (s, R, bm, k) int8; ib: (s, C, bn, k) int8 (both K-contiguous rows);
// k a multiple of 32; mode: (R, C) int32, 0 = pair skipped (zeros). hi, lo:
// (R, C, bm, bn) float32.
int dlaf_oz_masked(int s, const void* ia, const void* ib, const void* mode, int R, int C,
                   int bm, int bn, int k, void* hi, void* lo, void* stream) {
  Params p = params(PAIRS, s, bm, bn, k, hi, lo);
  p.mode = static_cast<const int*>(mode);
  p.R = R;
  p.C = C;
  p.a_pair_rows = bm;
  p.b_pair_rows = bn;
  p.o_pair = static_cast<long long>(bm) * bn;
  return launch(ia, ib, static_cast<long long>(R) * bm, static_cast<long long>(C) * bn, p,
                stream);
}

}  // extern "C"
