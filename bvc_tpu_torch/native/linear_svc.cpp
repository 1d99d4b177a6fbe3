// The linear probe's 'svm' fit: scikit-learn's LinearSVC(random_state=0,
// tol=1e-4) and the defaults it keeps (penalty l2, loss squared_hinge, C 1,
// max_iter 1000, one-vs-rest, an intercept as an extra feature of value
// intercept_scaling that is regularised with the rest), so that the
// evaluation scores where scikit-learn is not installed.
//
// scikit-learn fits it with its copy of liblinear (sklearn/svm/src/liblinear,
// linear.cpp and tron.cpp); this file carries the parts of that code that the
// settings above run, and the random generator of sklearn/svm/src/newrand:
//
// - train() and group_classes(): the classes sorted, the rows grouped by
//   class in their order, one binary problem per class beyond two (the class
//   +1, the rest -1) and one for two classes (the second class +1);
// - solve_l2r_l1l2_svc() for L2R_L2LOSS_SVC_DUAL: dual coordinate descent
//   with shrinking, the active rows permuted each pass by bounded_rand_int on
//   one mt19937 seeded once a fit, so the classes draw from one stream;
// - L2R_L2LOSS_SVC: the primal problem (l2r_l2_svc_fun) by the trust-region
//   Newton method (TRON::tron, TRON::trcg), stopping at a gradient norm of
//   tol * max(min(pos, neg), 1) / rows of the first.
//
// The dual path runs every operation in liblinear's order and, built without
// floating-point contraction (-ffp-contract=off), gives the same weights to
// the bit.  liblinear's TRON takes ddot, dnrm2, daxpy and dscal from the BLAS
// that scikit-learn hands it (scipy's); the caller passes the same functions
// (their addresses, from scipy.linalg.cython_blas), and the primal weights
// are then the same to the bit as well.  A dense
// row is liblinear's sparse row with its zeros added in, which changes no
// sum.  The primal binary problems share no state and run on n_threads
// threads.
//
// The code carried over keeps liblinear's copyright notice:
//
// Copyright (c) 2007-2014 The LIBLINEAR Project.
// All rights reserved.
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions
// are met:
//
// 1. Redistributions of source code must retain the above copyright
// notice, this list of conditions and the following disclaimer.
//
// 2. Redistributions in binary form must reproduce the above copyright
// notice, this list of conditions and the following disclaimer in the
// documentation and/or other materials provided with the distribution.
//
// 3. Neither name of copyright holders nor the names of its contributors
// may be used to endorse or promote products derived from this software
// without specific prior written permission.
//
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
// ``AS IS'' AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
// LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
// A PARTICULAR PURPOSE ARE DISCLAIMED.  IN NO EVENT SHALL THE REGENTS OR
// CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
// EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
// PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
// PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
// LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
// NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
// SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

// One binary problem: l rows of n features (the intercept's included) in the
// grouped order, labels +1 / -1, and the C of each label.
struct Problem {
  const double* x;  // [l, n]
  int64_t l, n;
  const double* y;
  double cp, cn;
};

// newrand.h's tweaked Lemire reduction of one mt19937 draw to [0, range)
uint32_t bounded_rand_int(std::mt19937& rng, uint32_t range) {
  uint32_t x = rng();
  uint64_t m = uint64_t(x) * uint64_t(range);
  uint32_t l = uint32_t(m);
  if (l < range) {
    uint32_t t = -range;
    if (t >= range) {
      t -= range;
      if (t >= range) t %= range;
    }
    while (l < t) {
      x = rng();
      m = uint64_t(x) * uint64_t(range);
      l = uint32_t(m);
    }
  }
  return m >> 32;
}

// solve_l2r_l1l2_svc for L2R_L2LOSS_SVC_DUAL (Hsieh et al., ICML 2008,
// algorithm 3): returns the passes run.
int solve_dual(const Problem& p, double* w, double eps, int max_iter, std::mt19937& rng) {
  const int64_t l = p.l, n = p.n;
  std::vector<double> qd(l), alpha(l, 0.0), diag(l);
  std::vector<int> index(l);
  std::vector<signed char> y(l);
  int64_t active_size = l;
  int iter = 0;
  // liblinear's PGmin_old shrinks rows at the upper bound C, which is
  // infinite for the squared hinge: no row reaches it, so only PGmax_old
  // is kept
  double pg_max_old = INFINITY;
  for (int64_t i = 0; i < l; ++i) diag[i] = 0.5 / (p.y[i] > 0 ? p.cp : p.cn);
  for (int64_t i = 0; i < l; ++i) y[i] = p.y[i] > 0 ? +1 : -1;
  std::fill(w, w + n, 0.0);  // w = sum_i y_i alpha_i x_i, alpha = 0
  for (int64_t i = 0; i < l; ++i) {
    qd[i] = diag[i];
    const double* xi = p.x + i * n;
    for (int64_t j = 0; j < n; ++j)
      if (xi[j] != 0) qd[i] += xi[j] * xi[j];
    index[i] = int(i);
  }
  while (iter < max_iter) {
    double pg_max_new = -INFINITY, pg_min_new = INFINITY;
    for (int64_t i = 0; i < active_size; ++i) {
      const int64_t j = i + bounded_rand_int(rng, uint32_t(active_size - i));
      std::swap(index[i], index[j]);
    }
    for (int64_t s = 0; s < active_size; ++s) {
      const int64_t i = index[s];
      const signed char yi = y[i];
      const double* xi = p.x + i * n;
      double g = 0;
      for (int64_t j = 0; j < n; ++j)
        if (xi[j] != 0) g += w[j] * xi[j];
      g = g * yi - 1;
      g += alpha[i] * diag[i];
      double pg = 0;
      if (alpha[i] == 0) {
        if (g > pg_max_old) {
          --active_size;
          std::swap(index[s], index[active_size]);
          --s;
          continue;
        } else if (g < 0) {
          pg = g;
        }
      } else {
        pg = g;
      }
      pg_max_new = std::max(pg_max_new, pg);
      pg_min_new = std::min(pg_min_new, pg);
      if (std::fabs(pg) > 1.0e-12) {
        const double alpha_old = alpha[i];
        alpha[i] = std::max(alpha[i] - g / qd[i], 0.0);  // no upper bound
        const double d = (alpha[i] - alpha_old) * yi;
        for (int64_t j = 0; j < n; ++j)
          if (xi[j] != 0) w[j] += d * xi[j];
      }
    }
    ++iter;
    if (pg_max_new - pg_min_new <= eps) {
      if (active_size == l) break;
      active_size = l;
      pg_max_old = INFINITY;
      continue;
    }
    pg_max_old = pg_max_new;
    if (pg_max_old <= 0) pg_max_old = INFINITY;
  }
  return iter;
}

// The level-1 BLAS of TRON, in Fortran's calling convention (scipy's
// cython_blas).
struct Blas {
  double (*ddot)(int*, double*, int*, double*, int*);
  double (*dnrm2)(int*, double*, int*);
  void (*daxpy)(int*, double*, double*, int*, double*, int*);
  void (*dscal)(int*, double*, double*, int*);

  double dot(int64_t n, const double* a, const double* b) const {
    int n_ = int(n), inc = 1;
    return ddot(&n_, const_cast<double*>(a), &inc, const_cast<double*>(b), &inc);
  }

  double nrm2(int64_t n, const double* a) const {
    int n_ = int(n), inc = 1;
    return dnrm2(&n_, const_cast<double*>(a), &inc);
  }

  void axpy(int64_t n, double alpha, const double* x, double* y) const {
    int n_ = int(n), inc = 1;
    daxpy(&n_, &alpha, const_cast<double*>(x), &inc, y, &inc);
  }

  void scal(int64_t n, double alpha, double* x) const {
    int n_ = int(n), inc = 1;
    dscal(&n_, &alpha, x, &inc);
  }
};

// l2r_l2_svc_fun: f(w) = w'w / 2 + sum_i C_i max(0, 1 - y_i w'x_i)^2, its
// gradient and its generalised Hessian on the rows with a positive loss.
class SvcFun {
 public:
  explicit SvcFun(const Problem& p) : p_(p), c_(p.l), z_(p.l), active_(p.l), sub_(p.l) {
    for (int64_t i = 0; i < p.l; ++i) c_[i] = p.y[i] > 0 ? p.cp : p.cn;
  }

  double fun(const double* w) {
    double f = 0;
    rows_dot(w, p_.l, [&](int64_t i) { return p_.x + i * p_.n; }, z_.data());
    for (int64_t j = 0; j < p_.n; ++j) f += w[j] * w[j];
    f /= 2.0;
    for (int64_t i = 0; i < p_.l; ++i) {
      z_[i] = p_.y[i] * z_[i];
      const double d = 1 - z_[i];
      if (d > 0) f += c_[i] * d * d;
    }
    return f;
  }

  void grad(const double* w, double* g) {
    n_active_ = 0;
    for (int64_t i = 0; i < p_.l; ++i)
      if (z_[i] < 1) {
        z_[n_active_] = c_[i] * p_.y[i] * (z_[i] - 1);
        active_[n_active_] = i;
        ++n_active_;
      }
    sub_xtv(z_.data(), g);
    for (int64_t j = 0; j < p_.n; ++j) g[j] = w[j] + 2 * g[j];
  }

  void hv(const double* s, double* hs) {
    rows_dot(s, n_active_, [&](int64_t k) { return p_.x + active_[k] * p_.n; }, sub_.data());
    for (int64_t k = 0; k < n_active_; ++k) sub_[k] = c_[active_[k]] * sub_[k];
    sub_xtv(sub_.data(), hs);
    for (int64_t j = 0; j < p_.n; ++j) hs[j] = s[j] + 2 * hs[j];
  }

  int64_t n() const { return p_.n; }

 private:
  // liblinear's Xv and subXv: out[k] = v . row(k), each row summed in its
  // order (no BLAS), eight rows at a time so that eight independent sums
  // keep the adders busy
  template <class RowOf>
  void rows_dot(const double* v, int64_t count, RowOf row, double* out) const {
    constexpr int kRows = 8;
    const int64_t n = p_.n;
    int64_t k = 0;
    for (; k + kRows <= count; k += kRows) {
      const double* r[kRows];
      double acc[kRows] = {};
      for (int q = 0; q < kRows; ++q) r[q] = row(k + q);
      for (int64_t j = 0; j < n; ++j)
        for (int q = 0; q < kRows; ++q) acc[q] += v[j] * r[q][j];
      for (int q = 0; q < kRows; ++q) out[k + q] = acc[q];
    }
    for (; k < count; ++k) {
      const double* r = row(k);
      double acc = 0;
      for (int64_t j = 0; j < n; ++j) acc += v[j] * r[j];
      out[k] = acc;
    }
  }

  void sub_xtv(const double* v, double* out) {
    std::fill(out, out + p_.n, 0.0);
    for (int64_t k = 0; k < n_active_; ++k) {
      const double* xi = p_.x + active_[k] * p_.n;
      for (int64_t j = 0; j < p_.n; ++j) out[j] += v[k] * xi[j];
    }
  }

  const Problem& p_;
  std::vector<double> c_, z_;
  std::vector<int64_t> active_;
  std::vector<double> sub_;
  int64_t n_active_ = 0;
};

// TRON::trcg: conjugate gradient on the Newton system inside the trust
// region of radius delta.
void trcg(const Blas& b, SvcFun& fun, double delta, const double* g, double* s, double* r) {
  const int64_t n = fun.n();
  std::vector<double> d(n), hd(n);
  for (int64_t i = 0; i < n; ++i) {
    s[i] = 0;
    r[i] = -g[i];
    d[i] = r[i];
  }
  const double cgtol = 0.1 * b.nrm2(n, g);
  double rtr = b.dot(n, r, r);
  while (true) {
    if (b.nrm2(n, r) <= cgtol) break;
    fun.hv(d.data(), hd.data());
    double alpha = rtr / b.dot(n, d.data(), hd.data());
    b.axpy(n, alpha, d.data(), s);
    if (b.nrm2(n, s) > delta) {
      alpha = -alpha;
      b.axpy(n, alpha, d.data(), s);
      const double std_ = b.dot(n, s, d.data());
      const double sts = b.dot(n, s, s);
      const double dtd = b.dot(n, d.data(), d.data());
      const double dsq = delta * delta;
      const double rad = std::sqrt(std_ * std_ + dtd * (dsq - sts));
      alpha = std_ >= 0 ? (dsq - sts) / (std_ + rad) : (rad - std_) / dtd;
      b.axpy(n, alpha, d.data(), s);
      alpha = -alpha;
      b.axpy(n, alpha, hd.data(), r);
      break;
    }
    alpha = -alpha;
    b.axpy(n, alpha, hd.data(), r);
    const double rnew = b.dot(n, r, r);
    const double beta = rnew / rtr;
    b.scal(n, beta, d.data());
    b.axpy(n, 1.0, r, d.data());
    rtr = rnew;
  }
}

// TRON::tron: returns the accepted steps.
int solve_primal(const Blas& b, const Problem& p, double* w, double eps, int max_iter) {
  const double eta0 = 1e-4, eta1 = 0.25, eta2 = 0.75;
  const double sigma1 = 0.25, sigma2 = 0.5, sigma3 = 4;
  SvcFun fun(p);
  const int64_t n = p.n;
  std::vector<double> s(n), r(n), w_new(n), g(n);
  std::fill(w, w + n, 0.0);
  double f = fun.fun(w);
  fun.grad(w, g.data());
  double delta = b.nrm2(n, g.data());
  const double gnorm1 = delta;
  double gnorm = gnorm1;
  bool search = !(gnorm <= eps * gnorm1);
  int iter = 1;
  while (iter <= max_iter && search) {
    trcg(b, fun, delta, g.data(), s.data(), r.data());
    std::memcpy(w_new.data(), w, sizeof(double) * n);
    b.axpy(n, 1.0, s.data(), w_new.data());
    const double gs = b.dot(n, g.data(), s.data());
    const double prered = -0.5 * (gs - b.dot(n, s.data(), r.data()));
    const double fnew = fun.fun(w_new.data());
    const double actred = f - fnew;
    const double snorm = b.nrm2(n, s.data());
    if (iter == 1) delta = std::min(delta, snorm);
    const double alpha = fnew - f - gs <= 0 ? sigma3
                                            : std::max(sigma1, -0.5 * (gs / (fnew - f - gs)));
    if (actred < eta0 * prered)
      delta = std::min(std::max(alpha, sigma1) * snorm, sigma2 * delta);
    else if (actred < eta1 * prered)
      delta = std::max(sigma1 * delta, std::min(alpha * snorm, sigma2 * delta));
    else if (actred < eta2 * prered)
      delta = std::max(sigma1 * delta, std::min(alpha * snorm, sigma3 * delta));
    else
      delta = std::max(delta, std::min(alpha * snorm, sigma3 * delta));
    if (actred > eta0 * prered) {
      ++iter;
      std::memcpy(w, w_new.data(), sizeof(double) * n);
      f = fnew;
      fun.grad(w, g.data());
      gnorm = b.nrm2(n, g.data());
      if (gnorm <= eps * gnorm1) break;
    }
    if (f < -1.0e+32) break;
    if (std::fabs(actred) <= 0 && prered <= 0) break;
    if (std::fabs(actred) <= 1.0e-12 * std::fabs(f) && std::fabs(prered) <= 1.0e-12 * std::fabs(f))
      break;
  }
  return iter - 1;
}

}  // namespace

// x: [l, d] row-major; labels: class codes 0 .. k-1 (the sorted classes);
// bias: intercept_scaling (the extra feature); dual: solver choice;
// blas_fns: ddot, dnrm2, daxpy, dscal (the primal solver's).  w: [k == 2 ? 1 :
// k, d + 1] row-major, the last column the intercept's weight; n_iter: one
// count a binary problem.  Returns 0.
extern "C" int bvc_linear_svc(const double* x, int64_t l, int64_t d, const int32_t* labels,
                              int32_t k, double c, double tol, int max_iter, uint32_t seed,
                              int dual, double bias, int n_threads, void* const* blas_fns,
                              double* w, int* n_iter) {
  const int64_t n = d + 1;
  const Blas blas{reinterpret_cast<decltype(Blas::ddot)>(blas_fns[0]),
                  reinterpret_cast<decltype(Blas::dnrm2)>(blas_fns[1]),
                  reinterpret_cast<decltype(Blas::daxpy)>(blas_fns[2]),
                  reinterpret_cast<decltype(Blas::dscal)>(blas_fns[3])};
  // group_classes: the rows of class 0 first, each class in row order
  std::vector<int64_t> perm;
  perm.reserve(l);
  std::vector<int64_t> start(k + 1, 0), count(k, 0);
  for (int64_t i = 0; i < l; ++i) ++count[labels[i]];
  for (int32_t j = 0; j < k; ++j) start[j + 1] = start[j] + count[j];
  for (int32_t j = 0; j < k; ++j)
    for (int64_t i = 0; i < l; ++i)
      if (labels[i] == j) perm.push_back(i);
  std::vector<double> xp(l * n);
  for (int64_t r = 0; r < l; ++r) {
    std::memcpy(&xp[r * n], x + perm[r] * d, sizeof(double) * d);
    xp[r * n + d] = bias;
  }
  const int32_t problems = k == 2 ? 1 : k;
  std::vector<std::vector<double>> ys(problems, std::vector<double>(l));
  for (int32_t q = 0; q < problems; ++q) {
    const int32_t positive = k == 2 ? 1 : q;
    for (int64_t r = 0; r < l; ++r)
      ys[q][r] = (r >= start[positive] && r < start[positive + 1]) ? +1 : -1;
  }
  auto problem = [&](int32_t q) { return Problem{xp.data(), l, n, ys[q].data(), c, c}; };
  if (dual) {
    std::mt19937 rng(seed);  // one stream for the classes, in order
    for (int32_t q = 0; q < problems; ++q)
      n_iter[q] = solve_dual(problem(q), w + q * n, tol, max_iter, rng);
    return 0;
  }
  std::atomic<int32_t> next{0};
  auto work = [&] {
    for (int32_t q; (q = next.fetch_add(1)) < problems;) {
      const Problem p = problem(q);
      int64_t pos = 0;
      for (int64_t r = 0; r < l; ++r) pos += p.y[r] > 0;
      const double primal_tol = tol * std::max<int64_t>(std::min(pos, l - pos), 1) / double(l);
      n_iter[q] = solve_primal(blas, p, w + q * n, primal_tol, max_iter);
    }
  };
  const int threads = std::max(1, std::min<int>(n_threads, problems));
  std::vector<std::thread> pool;
  for (int i = 1; i < threads; ++i) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return 0;
}
