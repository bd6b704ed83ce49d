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
// What bounds it: the bytes. Each rotation reads and writes two rows, 32 w
// bytes; the work is 6 flops a column a rotation.
//
// Design: one thread per column, looping over the whole list in order, so
// the sequence is one launch however long it is (a loop of tensor
// operations costs several launches a rotation). Neighbouring threads read
// neighbouring columns, so each row access is coalesced. The running anchor
// row stays in a register while consecutive rotations share it (the
// deflation scan's chains), and is written back when the anchor changes.
// The rotations are staged through shared memory in chunks, read once by
// the block. Products and sums round separately (__dmul_rn, __dsub_rn,
// __dadd_rn: no fused multiply-add), which makes the result bitwise the
// plain version's: c*ri - s*rj rounded at each of the three steps.
//
// The entry point launches on the given stream, allocates nothing, and
// returns the launch's error code.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;

__global__ void givens_undo_kernel(double* __restrict__ u, long long ld, long long w,
                                   const long long* __restrict__ ij,
                                   const double* __restrict__ cs, long long g) {
  __shared__ long long s_ij[2 * kChunk];
  __shared__ double s_cs[2 * kChunk];
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = col < w;
  long long cur = -1;  // row held in `vi`
  double vi = 0.0;
  for (long long base = 0; base < g; base += kChunk) {
    const int cnt = static_cast<int>(g - base < kChunk ? g - base : kChunk);
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * cnt; t += kThreads) {
      s_ij[t] = ij[2 * base + t];
      s_cs[t] = cs[2 * base + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const long long i = s_ij[2 * t], j = s_ij[2 * t + 1];
      const double c = s_cs[2 * t], s = s_cs[2 * t + 1];
      // after this, only row i is held in a register and j != i reads
      // memory that is current
      if (i != cur) {
        if (cur >= 0) u[cur * ld + col] = vi;
        cur = i;
        vi = u[i * ld + col];
      }
      double* pj = u + j * ld + col;
      const double rj = *pj;
      const double ri = vi;
      vi = __dsub_rn(__dmul_rn(c, ri), __dmul_rn(s, rj));
      *pj = __dadd_rn(__dmul_rn(s, ri), __dmul_rn(c, rj));
    }
  }
  if (active && cur >= 0) u[cur * ld + col] = vi;
}

}  // namespace

extern "C" int dlaf_givens_undo(void* u, long long ld, long long w, const void* ij,
                                const void* cs, long long g, void* stream) {
  if (g <= 0 || w <= 0) return 0;
  const long long blocks = (w + kThreads - 1) / kThreads;
  givens_undo_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(u), ld, w, static_cast<const long long*>(ij),
      static_cast<const double*>(cs), g);
  return static_cast<int>(cudaGetLastError());
}
