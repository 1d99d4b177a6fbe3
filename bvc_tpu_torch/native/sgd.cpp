// The linear probe's fit: a hinge-loss linear SVM by plain SGD, one binary
// problem per class, at the evaluation's settings (L2 penalty, the 'optimal'
// learning rate, a shuffle each epoch, an intercept, stopping after
// n_iter_no_change epochs without an objective gain of tol).
//
// This is scikit-learn's SGDClassifier.fit (`_plain_sgd` over a dense
// `ArrayData`, with its `WeightVector`) written out for that one case, so
// that the evaluation scores where scikit-learn is not installed.  Every
// operation runs in scikit-learn's order: the weights are a scale times a
// vector, dot products and norms are summed one term after another, and the
// epoch's Fisher-Yates shuffle reapplies the same xorshift seed to the last
// epoch's order.  Built without floating-point contraction
// (-ffp-contract=off), the result is the same to the bit.
//
// The binary problems are independent and each has its own seed, so they
// run on n_threads threads (scikit-learn's n_jobs) with the same result.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr double kWscaleMin = 1e-9;  // the vector folds its scale in below this

struct Settings {
  double alpha, tol;
  int max_iter, n_iter_no_change;
};

// scikit-learn's our_rand_r: a 32-bit xorshift step, kept below 2^31
uint32_t rand_r(uint32_t* seed) {
  if (*seed == 0) *seed = 1;
  *seed ^= *seed << 13;
  *seed ^= *seed >> 17;
  *seed ^= *seed << 5;
  return *seed % (uint32_t(2147483647) + 1u);
}

// One binary problem, y in {-1, +1}.  Returns the epochs run, or -epoch
// when the weights stopped being finite in that epoch.
int fit_binary(const double* x, int64_t n, int64_t d, const double* y, uint32_t seed,
               const Settings& s, double* w, double* intercept_out) {
  std::vector<int> index(n);
  std::iota(index.begin(), index.end(), 0);
  std::fill(w, w + d, 0.0);
  const double typw = std::sqrt(1.0 / std::sqrt(s.alpha));
  const double optimal_init = 1.0 / (typw * s.alpha);  // eta0 = typw
  double wscale = 1.0, sq_norm = 0.0, intercept = 0.0, t = 1.0;
  double best = INFINITY;
  int no_improvement = 0, epoch = 0;
  for (; epoch < s.max_iter; ++epoch) {
    uint32_t r = seed;
    for (unsigned i = 0; i + 1 < unsigned(n); ++i) {
      const unsigned j = i + rand_r(&r) % (unsigned(n) - i);
      std::swap(index[i], index[j]);
    }
    double objective = 0.0;
    for (int64_t k = 0; k < n; ++k) {
      const double* xk = x + int64_t(index[k]) * d;
      const double yk = y[index[k]];
      double dot = 0.0;
      for (int64_t j = 0; j < d; ++j) dot += w[j] * xk[j];
      const double p = dot * wscale + intercept;
      const double eta = 1.0 / (s.alpha * (optimal_init + t - 1));
      const double z = p * yk;
      objective += z <= 1.0 ? 1.0 - z : 0.0;
      const double norm = std::sqrt(sq_norm);
      objective += s.alpha * (0.5 * (norm * norm) + 0.0);
      const double update = -eta * (z <= 1.0 ? -yk : 0.0);
      const double c = std::max(0.0, 1.0 - eta * s.alpha);
      wscale *= c;
      sq_norm *= c * c;
      if (wscale < kWscaleMin) {
        for (int64_t j = 0; j < d; ++j) w[j] *= wscale;
        wscale = 1.0;
      }
      if (update != 0.0) {
        double acc = 0.0;
        for (int64_t j = 0; j < d; ++j) {
          w[j] += xk[j] * (update / wscale);
          acc += w[j] * w[j];
        }
        sq_norm = acc * (wscale * wscale);
        intercept += update;
      }
      t += 1;
    }
    bool finite = std::isfinite(intercept);
    for (int64_t j = 0; finite && j < d; ++j) finite = std::isfinite(w[j]);
    if (!finite) return -(epoch + 1);
    objective /= double(n);
    no_improvement = objective > best - s.tol ? no_improvement + 1 : 0;
    best = std::min(best, objective);
    if (no_improvement >= s.n_iter_no_change) {
      ++epoch;
      break;
    }
  }
  for (int64_t j = 0; j < d; ++j) w[j] *= wscale;
  *intercept_out = intercept;
  return epoch;
}

}  // namespace

// x: [n, d] row-major; y: [k, n] labels in {-1, +1}, one row a problem;
// seeds: [k].  Writes coef [k, d], intercept [k] and epochs [k] (negative:
// the fit overflowed in that epoch).  Returns 0.
extern "C" int bvc_sgd_hinge(const double* x, int64_t n, int64_t d, const double* y,
                             const uint32_t* seeds, int64_t k, double alpha, double tol,
                             int max_iter, int n_iter_no_change, int n_threads,
                             double* coef, double* intercept, int* epochs) {
  const Settings s{alpha, tol, max_iter, n_iter_no_change};
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (int64_t c; (c = next.fetch_add(1)) < k;)
      epochs[c] = fit_binary(x, n, d, y + c * n, seeds[c], s, coef + c * d, intercept + c);
  };
  const int64_t threads = std::max<int64_t>(1, std::min<int64_t>(n_threads, k));
  std::vector<std::thread> pool;
  for (int64_t i = 1; i < threads; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return 0;
}
