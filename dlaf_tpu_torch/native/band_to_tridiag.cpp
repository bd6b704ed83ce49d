// Native bulge-chasing kernel: Hermitian band -> tridiagonal.
//
// A copy of dlaf_tpu/native/band_to_tridiag.cpp, the C++ twin of the numpy
// chase in dlaf_tpu_torch/eigensolver/band_to_tridiag.py; see that module
// for the algorithm notes and the uniform reflector layout contract. It is
// the host stage the reference also keeps CPU-only (its pika SweepWorker
// pipeline, eigensolver/band_to_tridiag/mc.h), its sweeps pipelined over
// worker threads.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 band_to_tridiag.cpp
//        -o libdlaf_b2t.so -lpthread
// Interface: C ABI consumed via ctypes (dlaf_tpu_torch/native/bindings.py).

#include <atomic>
#include <cmath>
#include <complex>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
struct Traits;

template <>
struct Traits<double> {
  static double conj(double x) { return x; }
  static double abs(double x) { return std::fabs(x); }
  static double real(double x) { return x; }
};

template <>
struct Traits<std::complex<double>> {
  static std::complex<double> conj(std::complex<double> x) { return std::conj(x); }
  static double abs(std::complex<double> x) { return std::abs(x); }
  static double real(std::complex<double> x) { return x.real(); }
};

// Householder generator: (I - tau v v^H) x = beta e1, v[0]=1, beta real.
template <typename T>
void larfg(long m, T* x, T* v, T* tau, double* beta_out) {
  T alpha = x[0];
  double xnorm = 0.0;
  for (long i = 1; i < m; ++i) {
    double a = Traits<T>::abs(x[i]);
    xnorm = std::hypot(xnorm, a);
  }
  double alpha_im = Traits<T>::abs(alpha - T(Traits<T>::real(alpha)));
  if (xnorm == 0.0 && alpha_im == 0.0) {
    for (long i = 0; i < m; ++i) v[i] = T(0);
    *tau = T(0);
    *beta_out = Traits<T>::real(alpha);
    return;
  }
  double r = std::hypot(Traits<T>::abs(alpha), xnorm);
  double ar = Traits<T>::real(alpha);
  double beta = (ar != 0.0) ? -std::copysign(r, ar) : -r;
  // our convention: tau = conj((beta - alpha)/beta)
  T t = Traits<T>::conj((T(beta) - alpha) / T(beta));
  T scale = T(1.0) / (alpha - T(beta));
  v[0] = T(1);
  for (long i = 1; i < m; ++i) v[i] = x[i] * scale;
  *tau = t;
  *beta_out = beta;
}

// Per-worker scratch: every buffer a sweep touches, so concurrent sweeps
// never share temporaries.
template <typename T>
struct Scratch {
  std::vector<T> u, w, x, v, v2, xcol, y, acc;
  explicit Scratch(long b)
      : u(b), w(b), x(b), v(b), v2(b), xcol(b), y(b), acc(b) {}
};

template <typename T>
struct BandChase {
  long n, b, ld;  // ld = 2b+1 rows of working band
  std::vector<T> wb;          // wb[r*n + j] = A[j+r, j]

  BandChase(const T* band, long n_, long b_) : n(n_), b(b_), ld(2 * b_ + 1) {
    wb.assign(static_cast<size_t>(ld) * n, T(0));
    for (long r = 0; r <= b; ++r)
      std::memcpy(&wb[r * n], &band[r * n], sizeof(T) * n);
  }

  T& at(long i, long j) { return wb[(i - j) * n + j]; }  // i >= j, i-j <= 2b

  // S <- H S H^H on the Hermitian window A[j0:j0+m, j0:j0+m].
  //
  // All loops run DIAGONAL-major: for a fixed sub/super-diagonal d the
  // window elements S[c+d, c] are the contiguous run wb[d*n + j0 .. j0+m-d)
  // of the band storage, so both the band-matrix-vector product u = S v and
  // the rank-2 update S -= w v^H + v w^H stream the band rows linearly
  // (the previous dense-window copy strided by n on every element, which
  // was the kernel's bottleneck, not the flops).
  void two_sided(long j0, long m, const T* v, T tau, Scratch<T>& sc) {
    T* u = sc.u.data();
    T* w = sc.w.data();
    // u = S v by diagonals: d = 0 uses the real diagonal; d > 0 adds the
    // lower element to u[c+d] and its conjugate (upper) to u[c]
    for (long r = 0; r < m; ++r) u[r] = T(0);
    {
      const T* row0 = &wb[0 * n + j0];
      for (long c = 0; c < m; ++c) u[c] += T(Traits<T>::real(row0[c])) * v[c];
    }
    for (long d = 1; d < m; ++d) {
      const T* row = &wb[d * n + j0];
      const long len = m - d;
      for (long c = 0; c < len; ++c) {
        u[c + d] += row[c] * v[c];
        u[c] += Traits<T>::conj(row[c]) * v[c + d];
      }
    }
    T vhu = T(0);
    for (long r = 0; r < m; ++r) vhu += Traits<T>::conj(v[r]) * u[r];
    double a2 = Traits<T>::abs(tau);
    T half = T(a2 * a2 / 2.0) * vhu;
    for (long r = 0; r < m; ++r) w[r] = Traits<T>::conj(tau) * u[r] - half * v[r];
    // S -= w v^H + v w^H by diagonals (lower triangle in band storage)
    {
      T* row0 = &wb[0 * n + j0];
      for (long c = 0; c < m; ++c)
        row0[c] = T(Traits<T>::real(row0[c]) -
                    2.0 * Traits<T>::real(w[c] * Traits<T>::conj(v[c])));
    }
    for (long d = 1; d < m; ++d) {
      T* row = &wb[d * n + j0];
      const long len = m - d;
      for (long c = 0; c < len; ++c)
        row[c] -= w[c + d] * Traits<T>::conj(v[c]) +
                  v[c + d] * Traits<T>::conj(w[c]);
    }
  }

  // One full sweep s. ``wait(t)`` blocks until executing chase step t is
  // safe; ``done(t)`` publishes that step t's window writes are complete.
  // Step t of sweep s touches band columns [s+1+t*b, s+1+(t+1)*b) only
  // (plus column s at t=0), so with the pipeline rule "sweep s step t
  // after sweep s-1 completed step t+1" all concurrent windows are
  // disjoint and the result is bitwise identical at any thread count.
  template <typename Wait, typename Done>
  void do_sweep(long s, long n_steps, T* v_out, T* tau_out, Scratch<T>& sc,
                Wait&& wait, Done&& done) {
    long l = std::min(b, n - 1 - s);
    if (l < 1) return;
    wait(0);
    // column s below diag
    T* x = sc.x.data();
    for (long i = 0; i < l; ++i) x[i] = wb[(1 + i) * n + s];
    std::vector<T>& v = sc.v;
    T tau;
    double beta;
    larfg<T>(l, x, v.data(), &tau, &beta);
    wb[1 * n + s] = T(beta);
    for (long i = 1; i < l; ++i) wb[(1 + i) * n + s] = T(0);
    T* vrow = &v_out[(s * n_steps + 0) * b];
    for (long i = 0; i < l; ++i) vrow[i] = v[i];
    tau_out[s * n_steps + 0] = tau;

    long j0 = s + 1, t = 0;
    std::vector<T>& v2 = sc.v2;
    T* xcol = sc.xcol.data();
    T* y = sc.y.data();
    T* acc = sc.acc.data();
    while (true) {
        if (Traits<T>::abs(tau) != 0.0) two_sided(j0, l, v.data(), tau, sc);
        long l2 = std::min(b, n - (j0 + l));
        if (l2 == 0) break;
        // B = A[j0+l : j0+l+l2, j0 : j0+l), worked on IN band storage:
        // B[r, c] lives on band diagonal k2 = l + r - c, whose elements for
        // fixed k2 are the contiguous run wb[k2*n + j0 + c] (c ascending) —
        // all sweeps below stream those rows (no dense block copy)
        const long k2lo = 1, k2hi = l + l2 - 1;
        if (Traits<T>::abs(tau) != 0.0) {
          // B <- B H^H = B - conj(tau) (B v) v^H
          for (long r = 0; r < l2; ++r) y[r] = T(0);
          for (long k2 = k2lo; k2 <= k2hi; ++k2) {
            const T* row = &wb[k2 * n + j0];
            const long clo = std::max<long>(0, l - k2);
            const long chi = std::min<long>(l, l2 + l - k2);
            for (long c = clo; c < chi; ++c) y[k2 - l + c] += row[c] * v[c];
          }
          const T ct = Traits<T>::conj(tau);
          for (long k2 = k2lo; k2 <= k2hi; ++k2) {
            T* row = &wb[k2 * n + j0];
            const long clo = std::max<long>(0, l - k2);
            const long chi = std::min<long>(l, l2 + l - k2);
            for (long c = clo; c < chi; ++c)
              row[c] -= ct * y[k2 - l + c] * Traits<T>::conj(v[c]);
          }
        }
        // eliminate first column of B (strided but only l2 elements)
        for (long r = 0; r < l2; ++r) xcol[r] = wb[(l + r) * n + j0];
        T tau2;
        double beta2;
        larfg<T>(l2, xcol, v2.data(), &tau2, &beta2);
        wb[l * n + j0] = T(beta2);
        for (long r = 1; r < l2; ++r) wb[(l + r) * n + j0] = T(0);
        // left-apply H2 to remaining columns: B -= tau2 v2 (v2^H B)
        if (Traits<T>::abs(tau2) != 0.0 && l > 1) {
          for (long c = 0; c < l; ++c) acc[c] = T(0);
          for (long k2 = k2lo; k2 <= k2hi; ++k2) {
            const T* row = &wb[k2 * n + j0];
            const long clo = std::max<long>(1, l - k2);
            const long chi = std::min<long>(l, l2 + l - k2);
            for (long c = clo; c < chi; ++c)
              acc[c] += Traits<T>::conj(v2[k2 - l + c]) * row[c];
          }
          for (long k2 = k2lo; k2 <= k2hi; ++k2) {
            T* row = &wb[k2 * n + j0];
            const long clo = std::max<long>(1, l - k2);
            const long chi = std::min<long>(l, l2 + l - k2);
            for (long c = clo; c < chi; ++c)
              row[c] -= tau2 * v2[k2 - l + c] * acc[c];
          }
        }
        done(t);
        ++t;
        wait(t);
        T* vr2 = &v_out[(s * n_steps + t) * b];
        for (long r = 0; r < l2; ++r) vr2[r] = v2[r];
        tau_out[s * n_steps + t] = tau2;
        j0 += l;
        l = l2;
        std::memcpy(v.data(), v2.data(), sizeof(T) * l2);
        tau = tau2;
    }
    done(t);
  }

  void extract(double* d_out, T* e_out) {
    for (long j = 0; j < n; ++j) d_out[j] = Traits<T>::real(wb[0 * n + j]);
    for (long j = 0; j + 1 < n; ++j) e_out[j] = wb[1 * n + j];
  }

  void run(T* v_out, T* tau_out, long n_steps, double* d_out, T* e_out,
           long nthreads) {
    // n-2 sweeps like the numpy reference; complex off-diagonal phases are
    // normalized by the caller (python side), not by an extra sweep.
    const long n_sweeps = n - 2;
    const long max_par = std::max<long>(1, (n / std::max<long>(1, b)) / 2);
    long T_ = std::max<long>(1, std::min(nthreads, max_par));
    // pipelined sweeps (the reference's SweepWorker pipeline,
    // band_to_tridiag/mc.h:362-380, as a wavefront over worker threads):
    // progress[s] = completed chase steps of sweep s; sweep s may run step
    // t once sweep s-1 has completed step t+1. Spin-waits are coarse
    // (each step is O(b^2) flops). T_ == 1 runs the SAME worker body
    // inline: a single do_sweep instantiation for every thread count keeps
    // results bitwise identical (separate template instantiations may get
    // different FMA contraction).
    std::vector<std::atomic<long>> progress(std::max<long>(n_sweeps, 1));
    for (auto& p : progress) p.store(0, std::memory_order_relaxed);
    const long FIN = 1L << 60;
    auto worker = [&](long w) {
      Scratch<T> sc(b);
      for (long s = w; s < n_sweeps; s += T_) {
        auto wait = [&](long t) {
          if (s == 0) return;
          while (progress[s - 1].load(std::memory_order_acquire) < t + 2)
            std::this_thread::yield();
        };
        auto done = [&](long t) {
          progress[s].store(t + 1, std::memory_order_release);
        };
        do_sweep(s, n_steps, v_out, tau_out, sc, wait, done);
        progress[s].store(FIN, std::memory_order_release);
      }
    };
    if (T_ <= 1 || n_sweeps <= 1) {
      worker(0);
    } else {
      std::vector<std::thread> pool;
      pool.reserve(T_);
      for (long w = 0; w < T_; ++w) pool.emplace_back(worker, w);
      for (auto& th : pool) th.join();
    }
    extract(d_out, e_out);
  }
};

}  // namespace

extern "C" {

// band: (b+1) x n row-major; v_out: n_sweeps*n_steps*b; tau_out:
// n_sweeps*n_steps; d_out: n; e_out: n-1 (raw, complex for _z).
// nthreads: sweep-pipeline worker count; <= 1 runs the sequential path.
int dlaf_band_to_tridiag_d(const double* band, long n, long b, long n_steps,
                           double* v_out, double* tau_out, double* d_out,
                           double* e_out, long nthreads) {
  if (n <= 0 || b <= 0) return 1;
  BandChase<double> chase(band, n, b);
  chase.run(v_out, tau_out, n_steps, d_out, e_out, nthreads);
  return 0;
}

int dlaf_band_to_tridiag_z(const void* band, long n, long b, long n_steps,
                           void* v_out, void* tau_out, double* d_out,
                           void* e_out, long nthreads) {
  if (n <= 0 || b <= 0) return 1;
  using C = std::complex<double>;
  BandChase<C> chase(reinterpret_cast<const C*>(band), n, b);
  chase.run(reinterpret_cast<C*>(v_out), reinterpret_cast<C*>(tau_out),
            n_steps, d_out, reinterpret_cast<C*>(e_out), nthreads);
  return 0;
}

}  // extern "C"
