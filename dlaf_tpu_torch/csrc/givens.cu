// Hand-written Hopper (sm_90a) kernel of the D&C merge's Givens undo.
//
// It replaces no Pallas kernel: the JAX package applies this sequence with a
// lax.scan on its device (dlaf_tpu/eigensolver/tridiag_solver.py:305-314).
// For each rotation (i, j, c, s) of the list, in order, on the rows of the
// merge's (n, w) coefficient matrix u (row-major, float64):
//     u[i] <- c u[i] - s u[j],   u[j] <- s u[i] + c u[j]
// The deflation scan chains rotations through a running anchor row, so the
// sequence is sequential along it, while every column is independent.
//
// What bounds it: the bytes (each rotation reads and writes two rows, 6
// flops a column), if enough loads are in flight. One thread a column gives
// 16384 threads at the largest merge, about four warps an SM, so the card
// reaches its bandwidth only with some 18 eight-byte loads in flight a
// thread (Little's law at 3.35 TB/s and about 0.7 us of latency). A loop
// that loads a rotation's rows when it applies it has one: every rotation
// is a round trip to memory.
//
// Design: one thread a column (coalesced rows), looping over the whole list
// in one launch, with the rows of the next kDepth rotations in flight. They
// go through a ring of kDepth slots in shared memory, one cp.async group a
// rotation, each thread copying and reading only its own column's slots:
// cp.async.wait_group waits for the oldest group alone, where loads into
// registers share a few scoreboards and a wait for the oldest became a wait
// for the newest (one round trip a rotation again). Rotations on disjoint
// rows commute exactly, so a row may be loaded as soon as no earlier
// rotation still to be applied writes it. The host works out, for each
// rotation and each of its two rows, where the value comes from
// (givens_kernels.schedule):
//   PREFETCH  memory, copied kDepth rotations ahead, right after rotation
//             t - kDepth is stored (no rotation in between writes the row);
//   FROM_I/J  the previous rotation's new row i or j, kept in a register:
//             the anchor chains of the deflation scan, and a row that
//             returns right after it was written;
//   RELOAD    memory, loaded when the rotation is applied (the row's last
//             writer lies fewer than kDepth rotations back).
// and whether each new row is stored (not when the next rotation takes it
// from the register). Products and sums round separately (__dmul_rn,
// __dsub_rn, __dadd_rn: no fused multiply-add), each element sees the same
// rotations in the same order, so the result is bitwise the plain loop's.
// The list (rows, flags, c, s) is staged through shared memory in chunks,
// with the next kDepth rotations' rows for the copies ahead.
//
// The entry point launches on the given stream, allocates nothing, and
// returns the launch's error code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 16;             // givens_kernels.DEPTH
constexpr int kChunk = 16 * kDepth;    // rotations staged at a time
// flags: the sources of rows i (bits 0-1) and j (bits 2-3), and the stores
constexpr int PREFETCH = 0, FROM_I = 1, FROM_J = 2, STORE_I = 16, STORE_J = 32;

__device__ __forceinline__ void cp8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ double source(int f, double ahead, double a, double b,
                                         const double* row) {
  return f == PREFETCH ? ahead : f == FROM_I ? a : f == FROM_J ? b : *row;
}

// One rotation as the host's schedule lays it out: rows, flags; c, s.
struct Rot {
  int4 r;  // (i, j, flags, 0)
  double2 cs;
};

__global__ void __launch_bounds__(kThreads)
givens_undo_kernel(double* __restrict__ u, long long ld, long long w,
                   const Rot* __restrict__ rot, int g) {
  __shared__ int4 s_rot[kChunk + kDepth];
  __shared__ double2 s_cs[kChunk];
  __shared__ double ring[kDepth][2][kThreads];   // [slot][row i, j][thread]
  const int tid = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool active = col < w;
  double* uc = u + (active ? col : 0);
  double a = 0.0, b = 0.0;  // the previous rotation's new rows i and j
  // rotation n's rows from memory into slot q, one group
  auto ahead = [&](int4 n, int q) {
    if ((n.z & 3) == PREFETCH) cp8(&ring[q][0][tid], uc + n.x * ld);
    if ((n.z >> 2 & 3) == PREFETCH) cp8(&ring[q][1][tid], uc + n.y * ld);
  };
  for (int base = 0; base < g; base += kChunk) {
    const int cnt = min(kChunk + kDepth, g - base);
    __syncthreads();
    for (int t = tid; t < cnt; t += kThreads) {
      s_rot[t] = rot[base + t].r;
      if (t < kChunk) s_cs[t] = rot[base + t].cs;
    }
    __syncthreads();
    if (!active) continue;
    if (base == 0) {
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        if (q < g) ahead(s_rot[q], q);
        cp_commit();
      }
    }
    for (int t0 = 0; t0 < kChunk && base + t0 < g; t0 += kDepth) {
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        const int t = base + t0 + q;
        if (t >= g) break;
        const int4 r = s_rot[t0 + q];
        const double2 c = s_cs[t0 + q];
        double* pi = uc + r.x * ld;
        double* pj = uc + r.y * ld;
        cp_wait<kDepth - 1>();   // rotation t's group
        const double ri = source(r.z & 3, ring[q][0][tid], a, b, pi);
        const double rj = source(r.z >> 2 & 3, ring[q][1][tid], a, b, pj);
        a = __dsub_rn(__dmul_rn(c.x, ri), __dmul_rn(c.y, rj));
        b = __dadd_rn(__dmul_rn(c.y, ri), __dmul_rn(c.x, rj));
        if (r.z & STORE_I) *pi = a;
        if (r.z & STORE_J) *pj = b;
        // rotation t + kDepth's rows, now that rotation t is stored
        if (t + kDepth < g) ahead(s_rot[t0 + q + kDepth], q);
        cp_commit();
      }
    }
  }
  cp_wait<0>();
}

}  // namespace

// depth must be kDepth (the host's schedule is made for it).
extern "C" int dlaf_givens_undo(void* u, long long ld, long long w, const void* rot, int g,
                                int depth, void* stream) {
  if (depth != kDepth) return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 0 || w <= 0) return 0;
  const long long blocks = (w + kThreads - 1) / kThreads;
  givens_undo_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(u), ld, w, static_cast<const Rot*>(rot), g);
  return static_cast<int>(cudaGetLastError());
}
