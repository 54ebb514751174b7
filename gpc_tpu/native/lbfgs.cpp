// Limited-memory BFGS with the Moré-Thuente line search, reverse communication.
//
// C++ counterpart of the reference's Fortran LBFGS + MCSRCH/MCSTEP
// (reference ndlfortran.f:8-1153, driven via reverse communication from
// COptimisable::lbfgsOptimise, COptimisable.cpp:185-245).  Same architecture:
// the optimizer is native code holding the curvature history; the caller owns
// the objective (here a jitted JAX computation) and feeds (f, g) back per
// request, so device evaluations and native bookkeeping interleave without
// callbacks across the FFI boundary.
//
// Line search: the Moré-Thuente algorithm (ACM TOMS 20(3), 1994 — the
// MINPACK cvsrch/cstep scheme the reference's MCSRCH/MCSTEP implements),
// written from the published algorithm: a guaranteed-sufficient-decrease
// search with the four-case cubic/quadratic trial-step update and the
// stage-1 modified-function trick.  Driver conventions follow Nocedal's
// lbfgs.f: FTOL=1e-4, GTOL=0.9, XTRAPF=4, MAXFEV per search, first-iteration
// trial step 1/‖g‖₂, convergence ‖g‖₂ ≤ eps·max(1, ‖x‖₂), H₀ = (sᵀy/yᵀy)·I.
// (The reference's own f2c bundle ndlfortran.c omits LBFGS entirely, so its
// MSVC builds never had `-O quasinew`; trajectory parity versus the Fortran
// is unverifiable in this environment — tools/build_oracle.sh stubs lbfgs_ —
// and is asserted instead by algorithm identity plus the trajectory-quality
// tests in tests/test_optim.py.)
//
// API (ctypes-friendly):
//   handle = lbfgs_create(n, m)          — n params, m history pairs (ref: m=10)
//   task = lbfgs_step(handle, x, f, g)   — caller supplies f,g at current x;
//                                          x is updated in place to the next
//                                          evaluation point.
//       task = 0: evaluate f,g at new x and call again
//       task = 1: converged (gradient tolerance met)
//       task = 2: line-search failure / numerical breakdown (x = best seen)
//   lbfgs_destroy(handle)
//
// Build: g++ -O3 -shared -fPIC lbfgs.cpp -o liblbfgs_native.so

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double FTOL = 1e-4;    // sufficient decrease (lbfgs.f:284)
constexpr double GTOL = 0.9;     // curvature (lbfgs.f default, :245-247)
constexpr double XTRAPF = 4.0;   // extrapolation factor (MCSRCH)
constexpr double STPMIN = 1e-20;
constexpr double STPMAX = 1e20;

enum Phase { NEW_DIRECTION, LINE_SEARCH };

struct State {
  int n;
  int m;
  long iter = 0;
  double grad_tol = 1e-6;   // eps: ‖g‖₂ ≤ eps·max(1, ‖x‖₂)
  double xtol = 1e-6;       // MCSRCH interval tolerance (ref passes paramTol)
  int max_ls = 20;          // MAXFEV (lbfgs.f uses 20)

  std::vector<std::vector<double>> s_hist, y_hist;
  std::vector<double> rho;

  std::vector<double> x0, g0, d;  // line-search origin, gradient, direction
  double f0 = 0.0, dg0 = 0.0;

  Phase phase = NEW_DIRECTION;
  double stp = 1.0;
  int ls_iter = 0;

  // Moré-Thuente search state
  bool brackt = false, stage1 = true;
  double stx = 0.0, fx = 0.0, dx = 0.0;   // best step so far
  double sty = 0.0, fy = 0.0, dy = 0.0;   // other endpoint
  double stmin = 0.0, stmax = 0.0;
  double width = 0.0, width1 = 0.0;

  std::vector<double> x_best;
  double f_best = HUGE_VAL;
};

double dot(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

double nrm2(const double* a, int n) { return std::sqrt(dot(a, a, n)); }

// Two-loop recursion: d = -H·g using the stored (s, y) pairs; H₀ scaled by
// γ = sᵀy/yᵀy (lbfgs.f's diagonal update).
void two_loop(State* st, const double* g, double* d) {
  const int n = st->n;
  const int k = static_cast<int>(st->s_hist.size());
  std::vector<double> q(g, g + n), alpha(k);
  for (int i = k - 1; i >= 0; --i) {
    alpha[i] = st->rho[i] * dot(st->s_hist[i].data(), q.data(), n);
    for (int j = 0; j < n; ++j) q[j] -= alpha[i] * st->y_hist[i][j];
  }
  double gamma = 1.0;
  if (k > 0) {
    const double yy = dot(st->y_hist[k - 1].data(), st->y_hist[k - 1].data(), n);
    if (yy > 0) gamma = 1.0 / (st->rho[k - 1] * yy);
  }
  for (int j = 0; j < n; ++j) q[j] *= gamma;
  for (int i = 0; i < k; ++i) {
    const double beta = st->rho[i] * dot(st->y_hist[i].data(), q.data(), n);
    for (int j = 0; j < n; ++j) q[j] += (alpha[i] - beta) * st->s_hist[i][j];
  }
  for (int j = 0; j < n; ++j) d[j] = -q[j];
}

void set_trial(State* st, double* x, double stp) {
  st->stp = stp;
  for (int j = 0; j < st->n; ++j) x[j] = st->x0[j] + stp * st->d[j];
}

// ---------------------------------------------------------------------------
// cstep — the Moré-Thuente four-case trial-step computation.  Updates the
// interval of uncertainty (stx..sty) and produces the next trial stp from
// cubic/quadratic models of the data (stx, fx, dx), (sty, fy, dy),
// (stp, fp, dp).  Returns false on inconsistent input.
// ---------------------------------------------------------------------------
bool cstep(double& stx, double& fx, double& dx, double& sty, double& fy,
           double& dy, double& stp, double fp, double dp, bool& brackt,
           double stpmin, double stpmax) {
  if ((brackt && (stp <= std::min(stx, sty) || stp >= std::max(stx, sty))) ||
      dx * (stp - stx) >= 0.0 || stpmax < stpmin)
    return false;

  const double sgnd = dp * (dx >= 0.0 ? 1.0 : -1.0);
  double stpf;
  bool bound;

  if (fp > fx) {
    // Case 1: higher function value — the minimum is bracketed.  Cubic step,
    // or the average of cubic and quadratic if the cubic is further from stx.
    bound = true;
    const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
    const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
    double gamma = s * std::sqrt(std::max(
        0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
    if (stp < stx) gamma = -gamma;
    const double p = (gamma - dx) + theta;
    const double q = ((gamma - dx) + gamma) + dp;
    const double r = p / q;
    const double stpc = stx + r * (stp - stx);
    const double stpq =
        stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / 2.0) * (stp - stx);
    stpf = (std::fabs(stpc - stx) < std::fabs(stpq - stx))
               ? stpc
               : stpc + (stpq - stpc) / 2.0;
    brackt = true;
  } else if (sgnd < 0.0) {
    // Case 2: lower value, derivatives of opposite sign — bracketed.
    bound = false;
    const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
    const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
    double gamma = s * std::sqrt(std::max(
        0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
    if (stp > stx) gamma = -gamma;
    const double p = (gamma - dp) + theta;
    const double q = ((gamma - dp) + gamma) + dx;
    const double r = p / q;
    const double stpc = stp + r * (stx - stp);
    const double stpq = stp + (dp / (dp - dx)) * (stx - stp);
    stpf = (std::fabs(stpc - stp) > std::fabs(stpq - stp)) ? stpc : stpq;
    brackt = true;
  } else if (std::fabs(dp) < std::fabs(dx)) {
    // Case 3: lower value, same sign, decreasing derivative magnitude.  The
    // cubic may not have a minimizer in the step direction; safeguarded.
    bound = true;
    const double theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp;
    const double s = std::max({std::fabs(theta), std::fabs(dx), std::fabs(dp)});
    double gamma = s * std::sqrt(std::max(
        0.0, (theta / s) * (theta / s) - (dx / s) * (dp / s)));
    if (stp > stx) gamma = -gamma;
    const double p = (gamma - dp) + theta;
    const double q = (gamma + (dx - dp)) + gamma;
    const double r = p / q;
    double stpc;
    if (r < 0.0 && gamma != 0.0)
      stpc = stp + r * (stx - stp);
    else if (stp > stx)
      stpc = stpmax;
    else
      stpc = stpmin;
    const double stpq = stp + (dp / (dp - dx)) * (stx - stp);
    if (brackt)
      stpf = (std::fabs(stp - stpc) < std::fabs(stp - stpq)) ? stpc : stpq;
    else
      stpf = (std::fabs(stp - stpc) > std::fabs(stp - stpq)) ? stpc : stpq;
  } else {
    // Case 4: lower value, same sign, non-decreasing magnitude.
    bound = false;
    if (brackt) {
      const double theta = 3.0 * (fp - fy) / (sty - stp) + dy + dp;
      const double s =
          std::max({std::fabs(theta), std::fabs(dy), std::fabs(dp)});
      double gamma = s * std::sqrt(std::max(
          0.0, (theta / s) * (theta / s) - (dy / s) * (dp / s)));
      if (stp > sty) gamma = -gamma;
      const double p = (gamma - dp) + theta;
      const double q = ((gamma - dp) + gamma) + dy;
      const double r = p / q;
      stpf = stp + r * (sty - stp);
    } else if (stp > stx) {
      stpf = stpmax;
    } else {
      stpf = stpmin;
    }
  }

  // Update the interval of uncertainty.
  if (fp > fx) {
    sty = stp;
    fy = fp;
    dy = dp;
  } else {
    if (sgnd < 0.0) {
      sty = stx;
      fy = fx;
      dy = dx;
    }
    stx = stp;
    fx = fp;
    dx = dp;
  }

  // Compute the new (safeguarded) step.
  stpf = std::min(std::max(stpf, stpmin), stpmax);
  stp = stpf;
  if (brackt && bound) {
    if (sty > stx)
      stp = std::min(stx + 0.66 * (sty - stx), stp);
    else
      stp = std::max(stx + 0.66 * (sty - stx), stp);
  }
  return true;
}

// Initialize the Moré-Thuente state for a fresh search from x0 along d.
void ls_init(State* st) {
  st->brackt = false;
  st->stage1 = true;
  st->stx = 0.0;
  st->fx = st->f0;
  st->dx = st->dg0;
  st->sty = 0.0;
  st->fy = st->f0;
  st->dy = st->dg0;
  st->stmin = 0.0;
  st->stmax = st->stp + XTRAPF * st->stp;
  st->width = STPMAX - STPMIN;
  st->width1 = 2.0 * (STPMAX - STPMIN);
  st->ls_iter = 0;
}

// Prepare a new search direction from (x, f, g); returns next task.
int begin_direction(State* st, double* x, double f, const double* g) {
  const int n = st->n;
  // lbfgs.f convergence: ‖g‖₂ ≤ eps·max(1, ‖x‖₂)
  if (nrm2(g, n) <= st->grad_tol * std::max(1.0, nrm2(x, n))) return 1;
  std::memcpy(st->x0.data(), x, n * sizeof(double));
  std::memcpy(st->g0.data(), g, n * sizeof(double));
  st->f0 = f;
  two_loop(st, g, st->d.data());
  st->dg0 = dot(st->d.data(), g, n);
  if (st->dg0 >= 0.0) {  // not a descent direction: reset history
    st->s_hist.clear();
    st->y_hist.clear();
    st->rho.clear();
    for (int j = 0; j < n; ++j) st->d[j] = -g[j];
    st->dg0 = -dot(g, g, n);
    if (st->dg0 == 0.0) return 1;
  }
  st->phase = LINE_SEARCH;
  const double init = st->iter == 0 ? 1.0 / nrm2(st->g0.data(), n) : 1.0;
  st->stp = std::min(std::max(init, STPMIN), STPMAX);
  ls_init(st);
  set_trial(st, x, st->stp);
  return 0;
}

// Accept the point at x (with f, g): update history and start next direction.
int accept(State* st, double* x, double f, const double* g) {
  const int n = st->n;
  std::vector<double> s(n), yv(n);
  for (int j = 0; j < n; ++j) {
    s[j] = x[j] - st->x0[j];
    yv[j] = g[j] - st->g0[j];
  }
  const double sy = dot(s.data(), yv.data(), n);
  if (sy > 1e-10 * dot(yv.data(), yv.data(), n)) {
    st->s_hist.push_back(std::move(s));
    st->y_hist.push_back(std::move(yv));
    st->rho.push_back(1.0 / sy);
    if (static_cast<int>(st->s_hist.size()) > st->m) {
      st->s_hist.erase(st->s_hist.begin());
      st->y_hist.erase(st->y_hist.begin());
      st->rho.erase(st->rho.begin());
    }
  }
  st->iter++;
  st->phase = NEW_DIRECTION;
  return begin_direction(st, x, f, g);
}

}  // namespace

extern "C" {

void* lbfgs_create(int n, int m) {
  State* st = new State();
  st->n = n;
  st->m = m > 0 ? m : 10;
  st->x0.resize(n);
  st->g0.resize(n);
  st->d.resize(n);
  st->x_best.resize(n);
  return st;
}

void lbfgs_destroy(void* h) { delete static_cast<State*>(h); }

void lbfgs_set_tols(void* h, double grad_tol, double xtol, int max_ls) {
  State* st = static_cast<State*>(h);
  st->grad_tol = grad_tol;
  st->xtol = xtol;
  st->max_ls = max_ls;
}

long lbfgs_iterations(void* h) { return static_cast<State*>(h)->iter; }

int lbfgs_step(void* h, double* x, double f, const double* g) {
  State* st = static_cast<State*>(h);
  const int n = st->n;

  if (std::isfinite(f) && f < st->f_best) {
    st->f_best = f;
    std::memcpy(st->x_best.data(), x, n * sizeof(double));
  }

  if (st->phase == NEW_DIRECTION) return begin_direction(st, x, f, g);

  // ---- MCSRCH: a trial at x = x0 + stp·d just got evaluated ---------------
  st->ls_iter++;
  if (!std::isfinite(f)) {
    // outside MT's assumptions (the reference Fortran would propagate the
    // NaN); retreat toward the best endpoint and retry
    if (st->ls_iter >= st->max_ls) {
      std::memcpy(x, st->x_best.data(), n * sizeof(double));
      return 2;
    }
    set_trial(st, x, st->stx + 0.1 * (st->stp - st->stx));
    return 0;
  }
  const double dg = dot(st->d.data(), g, n);
  const double dgtest = FTOL * st->dg0;
  const double ftest1 = st->f0 + st->stp * dgtest;

  // termination tests (MCSRCH INFO codes)
  int info = 0;
  if ((st->brackt && (st->stp <= st->stmin || st->stp >= st->stmax)))
    info = 6;  // rounding errors prevent progress
  if (st->stp == STPMAX && f <= ftest1 && dg <= dgtest) info = 5;
  if (st->stp == STPMIN && (f > ftest1 || dg >= dgtest)) info = 4;
  if (st->ls_iter >= st->max_ls) info = 3;
  if (st->brackt && st->stmax - st->stmin <= st->xtol * st->stmax) info = 2;
  if (f <= ftest1 && std::fabs(dg) <= GTOL * (-st->dg0)) info = 1;

  if (info == 1) return accept(st, x, f, g);
  if (info != 0) {
    // lbfgs.f maps INFO≠1 to IFLAG=-1 "line search failed"; keep the best
    // point seen (richer than the Fortran, which just stops)
    if (f < st->f0) return accept(st, x, f, g);
    std::memcpy(x, st->x_best.data(), n * sizeof(double));
    return 2;
  }

  // stage 1 → stage 2 transition
  if (st->stage1 && f <= ftest1 && dg >= std::min(FTOL, GTOL) * st->dg0)
    st->stage1 = false;

  // trial-step update — modified function in stage 1 when f is still above
  // the sufficient-decrease line but below fx
  bool ok;
  if (st->stage1 && f <= st->fx && f > ftest1) {
    double fm = f - st->stp * dgtest;
    double fxm = st->fx - st->stx * dgtest;
    double fym = st->fy - st->sty * dgtest;
    const double dgm = dg - dgtest;
    double dxm = st->dx - dgtest;
    double dym = st->dy - dgtest;
    ok = cstep(st->stx, fxm, dxm, st->sty, fym, dym, st->stp, fm, dgm,
               st->brackt, st->stmin, st->stmax);
    st->fx = fxm + st->stx * dgtest;
    st->fy = fym + st->sty * dgtest;
    st->dx = dxm + dgtest;
    st->dy = dym + dgtest;
  } else {
    ok = cstep(st->stx, st->fx, st->dx, st->sty, st->fy, st->dy, st->stp, f,
               dg, st->brackt, st->stmin, st->stmax);
  }
  if (!ok) {
    if (f < st->f0) return accept(st, x, f, g);
    std::memcpy(x, st->x_best.data(), n * sizeof(double));
    return 2;
  }

  // force sufficient decrease of the interval width
  if (st->brackt) {
    if (std::fabs(st->sty - st->stx) >= 0.66 * st->width1)
      st->stp = st->stx + 0.5 * (st->sty - st->stx);
    st->width1 = st->width;
    st->width = std::fabs(st->sty - st->stx);
  }

  // bounds for the next trial
  if (st->brackt) {
    st->stmin = std::min(st->stx, st->sty);
    st->stmax = std::max(st->stx, st->sty);
  } else {
    st->stmin = st->stx;
    st->stmax = st->stp + XTRAPF * (st->stp - st->stx);
  }
  st->stp = std::min(std::max(st->stp, STPMIN), STPMAX);
  if (st->brackt && (st->stp <= st->stmin || st->stp >= st->stmax))
    st->stp = st->stx;  // next evaluation at the best point (MCSRCH guard)

  set_trial(st, x, st->stp);
  return 0;
}

}  // extern "C"
