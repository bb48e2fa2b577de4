// symreg.cpp — compact genetic-programming symbolic regression engine.
//
// Native counterpart of the reference's SymbolicRegression.jl post-pass
// (Lotka-Volterra/Symbolic_reg.jl:138-156 and the SRRegressor calls in
// "PDE examples/Fisher-KPP_Source.jl:216-234"): fits closed-form
// expressions to trained KAN activation curves. The search itself is
// host-side combinatorics — exactly the part that belongs in C++ —
// while all tensor math stays in JAX.
//
// Design: postfix expression genomes over {+,-,*,/,sin,cos,exp,square},
// tournament-selection GP with subtree crossover/mutation, protected
// division, constant jitter + a light local constant-refinement pass,
// and a parsimony-pressure fitness (MSE * (1 + alpha * size)).
//
// C API (ctypes-friendly):
//   int symreg_fit(const double* X, const double* y, int n, int nvars,
//                  unsigned ops_mask, int pop, int gens, unsigned seed,
//                  double parsimony, char* out_expr, int out_cap,
//                  double* out_mse, int* out_size);
// Returns 0 on success. out_expr receives a numpy-evaluable infix
// string using variables x0..x{nvars-1}.

#include <atomic>
#include <cmath>
#include <map>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

enum Op : int {
  CONST = 0, VAR = 1,
  ADD = 2, SUB = 3, MUL = 4, DIV = 5,
  SIN = 6, COS = 7, EXP = 8, SQ = 9,
  N_OPS = 10
};

// bit positions in ops_mask for optional ops
constexpr unsigned MASK_ADD = 1u << 0, MASK_SUB = 1u << 1,
    MASK_MUL = 1u << 2, MASK_DIV = 1u << 3, MASK_SIN = 1u << 4,
    MASK_COS = 1u << 5, MASK_EXP = 1u << 6, MASK_SQ = 1u << 7;

struct Node {
  int op;
  double value;   // CONST payload
  int var;        // VAR payload
};

using Genome = std::vector<Node>;  // postfix order

int arity(int op) {
  switch (op) {
    case CONST: case VAR: return 0;
    case SIN: case COS: case EXP: case SQ: return 1;
    default: return 2;
  }
}

struct Rng {
  std::mt19937 g;
  explicit Rng(unsigned seed) : g(seed) {}
  double uniform() { return std::uniform_real_distribution<>(0, 1)(g); }
  double normal() { return std::normal_distribution<>(0, 1)(g); }
  int randint(int lo, int hi) {  // [lo, hi)
    return std::uniform_int_distribution<>(lo, hi - 1)(g);
  }
};

struct Problem {
  const double* X;  // [n, nvars] row-major
  const double* y;  // [n]
  int n, nvars;
  std::vector<int> ops;       // enabled operator list (non-terminal)
  double parsimony;
  int max_size = 31;
};

// evaluate genome over all samples; returns false on numeric blowup
bool evaluate(const Genome& g, const Problem& p, std::vector<double>& out) {
  static thread_local std::vector<std::vector<double>> stack;
  size_t sp = 0;
  for (const Node& nd : g) {
    if (arity(nd.op) > (int)sp) return false;  // malformed genome
    switch (nd.op) {
      case CONST: {
        if (stack.size() < sp + 1) stack.resize(sp + 1);
        stack[sp].assign(p.n, nd.value);
        ++sp;
        break;
      }
      case VAR: {
        if (stack.size() < sp + 1) stack.resize(sp + 1);
        stack[sp].resize(p.n);
        for (int i = 0; i < p.n; ++i)
          stack[sp][i] = p.X[i * p.nvars + nd.var];
        ++sp;
        break;
      }
      case ADD: case SUB: case MUL: case DIV: {
        std::vector<double>& b = stack[sp - 1];
        std::vector<double>& a2 = stack[sp - 2];
        for (int i = 0; i < p.n; ++i) {
          double l = a2[i], r = b[i];
          double v;
          if (nd.op == ADD) v = l + r;
          else if (nd.op == SUB) v = l - r;
          else if (nd.op == MUL) v = l * r;
          else v = std::fabs(r) < 1e-9 ? l / (r >= 0 ? 1e-9 : -1e-9) : l / r;
          a2[i] = v;
        }
        --sp;
        break;
      }
      default: {  // unary
        std::vector<double>& a1 = stack[sp - 1];
        for (int i = 0; i < p.n; ++i) {
          double v = a1[i];
          switch (nd.op) {
            case SIN: v = std::sin(v); break;
            case COS: v = std::cos(v); break;
            case EXP: v = std::exp(std::min(v, 40.0)); break;
            case SQ: v = v * v; break;
          }
          a1[i] = v;
        }
        break;
      }
    }
  }
  if (sp != 1) return false;
  out = stack[0];
  for (int i = 0; i < p.n; ++i)
    if (!std::isfinite(out[i])) return false;
  return true;
}

double mse_of(const Genome& g, const Problem& p) {
  std::vector<double> out;
  if (!evaluate(g, p, out)) return 1e30;
  double s = 0;
  for (int i = 0; i < p.n; ++i) {
    double d = out[i] - p.y[i];
    s += d * d;
  }
  return s / p.n;
}

double fitness(const Genome& g, const Problem& p) {
  return mse_of(g, p) * (1.0 + p.parsimony * g.size());
}

Genome random_terminal(const Problem& p, Rng& rng) {
  Genome g;
  if (rng.uniform() < 0.5) {
    g.push_back({VAR, 0.0, rng.randint(0, p.nvars)});
  } else {
    g.push_back({CONST, rng.normal() * 2.0, 0});
  }
  return g;
}

Genome random_tree(const Problem& p, Rng& rng, int depth) {
  if (depth <= 0 || rng.uniform() < 0.3) return random_terminal(p, rng);
  int op = p.ops[rng.randint(0, (int)p.ops.size())];
  Genome g;
  for (int c = 0; c < arity(op); ++c) {
    Genome sub = random_tree(p, rng, depth - 1);
    g.insert(g.end(), sub.begin(), sub.end());
  }
  g.push_back({op, 0.0, 0});
  return g;
}

// subtree extent: [lo, i] covering the subtree rooted at postfix index i
int subtree_lo(const Genome& g, int i) {
  int need = 1;
  int j = i;
  while (true) {
    need += arity(g[j].op) - 1;
    if (need == 0) return j;
    --j;
  }
}

Genome crossover(const Genome& a, const Genome& b, Rng& rng, int max_size) {
  int ia = rng.randint(0, (int)a.size());
  int ib = rng.randint(0, (int)b.size());
  int la = subtree_lo(a, ia), lb = subtree_lo(b, ib);
  Genome child;
  child.insert(child.end(), a.begin(), a.begin() + la);
  child.insert(child.end(), b.begin() + lb, b.begin() + ib + 1);
  child.insert(child.end(), a.begin() + ia + 1, a.end());
  if ((int)child.size() > max_size) return a;
  return child;
}

void mutate(Genome& g, const Problem& p, Rng& rng) {
  double r = rng.uniform();
  if (r < 0.35) {  // constant jitter
    std::vector<int> consts;
    for (int i = 0; i < (int)g.size(); ++i)
      if (g[i].op == CONST) consts.push_back(i);
    if (!consts.empty()) {
      Node& nd = g[consts[rng.randint(0, (int)consts.size())]];
      if (rng.uniform() < 0.5) nd.value += rng.normal() * 0.1;
      else nd.value *= (1.0 + rng.normal() * 0.2);
      return;
    }
    r = 0.9;  // fall through to subtree replace
  }
  if (r < 0.6) {  // point mutation: swap operator of same arity
    int i = rng.randint(0, (int)g.size());
    int ar = arity(g[i].op);
    if (ar == 0) {
      Genome t = random_terminal(p, rng);
      g[i] = t[0];
    } else {
      std::vector<int> cands;
      for (int op : p.ops)
        if (arity(op) == ar) cands.push_back(op);
      if (!cands.empty())
        g[i].op = cands[rng.randint(0, (int)cands.size())];
    }
    return;
  }
  // subtree replacement
  int i = rng.randint(0, (int)g.size());
  int lo = subtree_lo(g, i);
  Genome sub = random_tree(p, rng, 2);
  Genome out;
  out.insert(out.end(), g.begin(), g.begin() + lo);
  out.insert(out.end(), sub.begin(), sub.end());
  out.insert(out.end(), g.begin() + i + 1, g.end());
  if ((int)out.size() <= p.max_size) g = out;
}

// local constant refinement: coordinate random search on the best genome
void refine_constants(Genome& g, const Problem& p, Rng& rng, int iters) {
  double best = mse_of(g, p);
  for (int it = 0; it < iters; ++it) {
    std::vector<int> consts;
    for (int i = 0; i < (int)g.size(); ++i)
      if (g[i].op == CONST) consts.push_back(i);
    if (consts.empty()) return;
    int ci = consts[rng.randint(0, (int)consts.size())];
    double old = g[ci].value;
    double scale = std::pow(10.0, -1 - rng.randint(0, 3));
    g[ci].value += rng.normal() * scale * (std::fabs(old) + 0.1);
    double m = mse_of(g, p);
    if (m < best) best = m;
    else g[ci].value = old;
  }
}

// dense k x k linear solve (Gaussian elimination, partial pivoting);
// returns false if singular
bool solve_lin(std::vector<double> A, std::vector<double> b, int k,
               std::vector<double>& x) {
  for (int col = 0; col < k; ++col) {
    int piv = col;
    for (int r = col + 1; r < k; ++r)
      if (std::fabs(A[r * k + col]) > std::fabs(A[piv * k + col])) piv = r;
    if (std::fabs(A[piv * k + col]) < 1e-300) return false;
    if (piv != col) {
      for (int c = col; c < k; ++c) std::swap(A[piv * k + c], A[col * k + c]);
      std::swap(b[piv], b[col]);
    }
    for (int r = col + 1; r < k; ++r) {
      double f = A[r * k + col] / A[col * k + col];
      for (int c = col; c < k; ++c) A[r * k + c] -= f * A[col * k + c];
      b[r] -= f * b[col];
    }
  }
  x.assign(k, 0.0);
  for (int r = k - 1; r >= 0; --r) {
    double s = b[r];
    for (int c = r + 1; c < k; ++c) s -= A[r * k + c] * x[c];
    x[r] = s / A[r * k + r];
  }
  for (int r = 0; r < k; ++r)
    if (!std::isfinite(x[r])) return false;
  return true;
}

// Levenberg-Marquardt refinement of the genome's constants: finite-
// difference Jacobian + damped normal equations. Converges quadratically
// near the optimum where the coordinate random search stalls — this is
// what tightens "1.5017 x" toward "1.5 x" at equal cost.
void refine_constants_lm(Genome& g, const Problem& p, int max_iters) {
  std::vector<int> consts;
  for (int i = 0; i < (int)g.size(); ++i)
    if (g[i].op == CONST) consts.push_back(i);
  if (consts.empty()) return;
  const int k = (int)consts.size();

  std::vector<double> out, outp, J((size_t)p.n * k);
  if (!evaluate(g, p, out)) return;
  auto mse_from = [&](const std::vector<double>& o) {
    double s = 0;
    for (int i = 0; i < p.n; ++i) {
      double d = o[i] - p.y[i];
      s += d * d;
    }
    return s / p.n;
  };
  double mse = mse_from(out);
  double lambda = 1e-3;

  for (int it = 0; it < max_iters && mse > 1e-28; ++it) {
    bool ok = true;
    for (int j = 0; j < k; ++j) {             // FD Jacobian column j
      double old = g[consts[j]].value;
      double h = 1e-6 * (std::fabs(old) + 1e-3);
      g[consts[j]].value = old + h;
      bool e = evaluate(g, p, outp);
      g[consts[j]].value = old;
      if (!e) { ok = false; break; }
      for (int i = 0; i < p.n; ++i)
        J[(size_t)i * k + j] = (outp[i] - out[i]) / h;
    }
    if (!ok) return;

    std::vector<double> A((size_t)k * k, 0.0), bvec(k, 0.0);
    for (int i = 0; i < p.n; ++i) {
      double r = out[i] - p.y[i];
      for (int a = 0; a < k; ++a) {
        double Ja = J[(size_t)i * k + a];
        bvec[a] -= Ja * r;
        for (int b2 = a; b2 < k; ++b2)
          A[a * k + b2] += Ja * J[(size_t)i * k + b2];
      }
    }
    for (int a = 0; a < k; ++a)
      for (int b2 = 0; b2 < a; ++b2) A[a * k + b2] = A[b2 * k + a];

    bool improved = false;
    for (int t = 0; t < 6 && !improved; ++t) {
      std::vector<double> Ad = A, delta;
      for (int a = 0; a < k; ++a)
        Ad[a * k + a] += lambda * std::max(A[a * k + a], 1e-12);
      if (!solve_lin(Ad, bvec, k, delta)) { lambda *= 10; continue; }
      for (int j = 0; j < k; ++j) g[consts[j]].value += delta[j];
      double m2 = evaluate(g, p, outp) ? mse_from(outp) : 1e300;
      if (m2 < mse) {
        mse = m2;
        out = outp;
        lambda = std::max(lambda / 3.0, 1e-12);
        improved = true;
      } else {
        for (int j = 0; j < k; ++j) g[consts[j]].value -= delta[j];
        lambda *= 4;
      }
    }
    if (!improved) return;
  }
}

std::string to_infix(const Genome& g) {
  std::vector<std::string> stack;
  char buf[64];
  for (const Node& nd : g) {
    switch (nd.op) {
      case CONST:
        snprintf(buf, sizeof buf, "%.10g", nd.value);
        stack.push_back(buf);
        break;
      case VAR:
        snprintf(buf, sizeof buf, "x%d", nd.var);
        stack.push_back(buf);
        break;
      case ADD: case SUB: case MUL: case DIV: {
        std::string b = stack.back(); stack.pop_back();
        std::string a = stack.back(); stack.pop_back();
        const char* sym = nd.op == ADD ? "+" : nd.op == SUB ? "-"
            : nd.op == MUL ? "*" : "/";
        stack.push_back("(" + a + " " + sym + " " + b + ")");
        break;
      }
      default: {
        std::string a = stack.back(); stack.pop_back();
        const char* fn = nd.op == SIN ? "sin" : nd.op == COS ? "cos"
            : nd.op == EXP ? "exp" : "square";
        if (nd.op == SQ) stack.push_back("((" + a + ")**2)");
        else stack.push_back(std::string(fn) + "(" + a + ")");
        break;
      }
    }
  }
  return stack.empty() ? "0" : stack.back();
}

// Pareto archive: best (lowest-MSE) genome seen at each size. Filled
// for free from the fitness evaluations of a single GP run — the
// SRRegressor-style hall of fame the reference's model selection reads.
using Front = std::map<int, std::pair<Genome, double>>;  // size -> (g, mse)

void front_update(Front* f, const Genome& g, double mse) {
  if (!f || mse >= 1e29) return;
  int sz = (int)g.size();
  auto it = f->find(sz);
  if (it == f->end() || mse < it->second.second) (*f)[sz] = {g, mse};
}

// one full GP run; `cancel` (optional) aborts remaining generations
// when another restart has already met the target; `front` (optional)
// accumulates the per-size hall of fame
Genome run_gp(const Problem& p, int pop, int gens, unsigned seed,
              const std::atomic<bool>* cancel, Front* front = nullptr) {
  Rng rng(seed ? seed : 12345u);
  std::vector<Genome> popv(pop);
  std::vector<double> fit(pop);
  for (int i = 0; i < pop; ++i) {
    popv[i] = random_tree(p, rng, 3);
    fit[i] = fitness(popv[i], p);
  }

  Genome best = popv[0];
  double best_fit = fit[0];
  auto track = [&](const Genome& g, double f) {
    if (f < best_fit) { best = g; best_fit = f; }
    // fitness = mse * (1 + parsimony * size): recover the raw mse
    front_update(front, g, f / (1.0 + p.parsimony * g.size()));
  };
  for (int i = 1; i < pop; ++i) track(popv[i], fit[i]);

  const int TOUR = 5;
  for (int gen = 0; gen < gens; ++gen) {
    if (cancel && cancel->load(std::memory_order_relaxed)) break;
    std::vector<Genome> next(pop);
    std::vector<double> nfit(pop);
    next[0] = best;                 // elitism
    nfit[0] = best_fit;
    for (int i = 1; i < pop; ++i) {
      auto pick = [&]() -> const Genome& {
        int bi = rng.randint(0, pop);
        for (int t = 1; t < TOUR; ++t) {
          int c = rng.randint(0, pop);
          if (fit[c] < fit[bi]) bi = c;
        }
        return popv[bi];
      };
      Genome child = rng.uniform() < 0.7
          ? crossover(pick(), pick(), rng, p.max_size)
          : pick();
      mutate(child, p, rng);
      next[i] = std::move(child);
      nfit[i] = fitness(next[i], p);
      track(next[i], nfit[i]);
    }
    popv.swap(next);
    fit.swap(nfit);
    if (gen % 10 == 9) {
      Genome refined = best;
      refine_constants(refined, p, rng, 30);   // rough: escape plateaus
      refine_constants_lm(refined, p, 6);      // tight: quadratic local
      track(refined, fitness(refined, p));
    }
  }
  refine_constants(best, p, rng, 200);
  refine_constants_lm(best, p, 30);
  return best;
}

int build_problem(Problem& p, unsigned ops_mask) {
  if (ops_mask & MASK_ADD) p.ops.push_back(ADD);
  if (ops_mask & MASK_SUB) p.ops.push_back(SUB);
  if (ops_mask & MASK_MUL) p.ops.push_back(MUL);
  if (ops_mask & MASK_DIV) p.ops.push_back(DIV);
  if (ops_mask & MASK_SIN) p.ops.push_back(SIN);
  if (ops_mask & MASK_COS) p.ops.push_back(COS);
  if (ops_mask & MASK_EXP) p.ops.push_back(EXP);
  if (ops_mask & MASK_SQ) p.ops.push_back(SQ);
  return p.ops.empty() ? 2 : 0;
}

int write_result(const Genome& best, const Problem& p, char* out_expr,
                 int out_cap, double* out_mse, int* out_size) {
  std::string expr = to_infix(best);
  if ((int)expr.size() + 1 > out_cap) return 3;
  std::memcpy(out_expr, expr.c_str(), expr.size() + 1);
  if (out_mse) *out_mse = mse_of(best, p);
  if (out_size) *out_size = (int)best.size();
  return 0;
}

}  // namespace

extern "C" int symreg_fit(const double* X, const double* y, int n,
                          int nvars, unsigned ops_mask, int pop, int gens,
                          unsigned seed, double parsimony, char* out_expr,
                          int out_cap, double* out_mse, int* out_size) {
  if (n <= 0 || nvars <= 0 || pop < 8 || !X || !y || !out_expr)
    return 1;
  Problem p{X, y, n, nvars, {}, parsimony};
  if (int rc = build_problem(p, ops_mask)) return rc;
  Genome best = run_gp(p, pop, gens, seed, nullptr);
  return write_result(best, p, out_expr, out_cap, out_mse, out_size);
}

// Parallel multi-restart search (the reference runs 20 populations,
// Symbolic_reg.jl:150): OpenMP over independent restarts, with early
// cancellation once any restart's best MSE drops below `stop_mse`
// (pass <= 0 to always run every restart to completion).
extern "C" int symreg_fit_multi(const double* X, const double* y, int n,
                                int nvars, unsigned ops_mask, int pop,
                                int gens, unsigned seed, double parsimony,
                                int restarts, double stop_mse,
                                char* out_expr, int out_cap,
                                double* out_mse, int* out_size) {
  if (n <= 0 || nvars <= 0 || pop < 8 || restarts < 1 || !X || !y ||
      !out_expr)
    return 1;
  Problem p{X, y, n, nvars, {}, parsimony};
  if (int rc = build_problem(p, ops_mask)) return rc;

  std::vector<Genome> bests(restarts);
  std::vector<double> mses(restarts, 1e300);
  std::atomic<bool> cancel(false);

#pragma omp parallel for schedule(dynamic, 1)
  for (int r = 0; r < restarts; ++r) {
    if (cancel.load(std::memory_order_relaxed)) continue;
    bests[r] = run_gp(p, pop, gens, seed + 7919u * (unsigned)r + 1,
                      &cancel);
    mses[r] = mse_of(bests[r], p);
    if (stop_mse > 0 && mses[r] <= stop_mse)
      cancel.store(true, std::memory_order_relaxed);
  }

  int bi = -1;
  for (int r = 0; r < restarts; ++r) {
    if (bests[r].empty()) continue;
    if (bi < 0 || mses[r] < mses[bi] ||
        (mses[r] == mses[bi] && bests[r].size() < bests[bi].size()))
      bi = r;
  }
  if (bi < 0) return 4;
  return write_result(bests[bi], p, out_expr, out_cap, out_mse, out_size);
}

// Pareto-front fit: ONE multi-restart GP search returning the whole
// per-size hall of fame (dominated entries pruned, every survivor
// LM-refined) instead of a single scalarized winner — the engine-side
// counterpart of PySR/SRRegressor model selection. out_exprs receives
// the '\n'-joined infix strings of the front, sizes ascending.
extern "C" int symreg_fit_pareto(const double* X, const double* y, int n,
                                 int nvars, unsigned ops_mask, int pop,
                                 int gens, unsigned seed, double parsimony,
                                 int restarts, int max_front,
                                 char* out_exprs, int out_cap,
                                 double* out_mses, int* out_sizes,
                                 int* out_count) {
  if (n <= 0 || nvars <= 0 || pop < 8 || restarts < 1 || max_front < 1 ||
      !X || !y || !out_exprs || !out_mses || !out_sizes || !out_count)
    return 1;
  Problem p{X, y, n, nvars, {}, parsimony};
  if (int rc = build_problem(p, ops_mask)) return rc;

  std::vector<Front> fronts(restarts);
#pragma omp parallel for schedule(dynamic, 1)
  for (int r = 0; r < restarts; ++r)
    run_gp(p, pop, gens, seed + 7919u * (unsigned)r + 1, nullptr,
           &fronts[r]);

  Front merged;
  for (const Front& f : fronts)
    for (const auto& kv : f)
      front_update(&merged, kv.second.first, kv.second.second);

  // LM-refine every candidate, then prune to the Pareto-dominant set
  // (strictly decreasing mse with increasing size)
  std::vector<std::pair<Genome, double>> refined;
  for (auto& kv : merged) {
    Genome g = kv.second.first;
    refine_constants_lm(g, p, 20);
    refined.push_back({g, mse_of(g, p)});
  }
  std::sort(refined.begin(), refined.end(),
            [](const auto& a, const auto& b) {
              return a.first.size() != b.first.size()
                  ? a.first.size() < b.first.size()
                  : a.second < b.second;
            });
  std::vector<std::pair<Genome, double>> front;
  double best = 1e300;
  for (auto& e : refined) {
    if (e.second < best * (1.0 - 1e-12)) {
      front.push_back(e);
      best = e.second;
    }
  }
  // Truncate from the LARGE-size end: keep the (max_front-1) simplest
  // members plus the final lowest-MSE one. compact_fit's
  // shortest-within-tolerance selection needs the short-expression knee
  // (dropping the smallest sizes could delete it); the best-MSE member
  // anchors the tolerance band, so it is always retained.
  if ((int)front.size() > max_front) {
    auto best_entry = front.back();
    front.resize(max_front - 1);
    front.push_back(best_entry);
  }

  std::string joined;
  int cnt = 0;
  for (auto& e : front) {
    std::string expr = to_infix(e.first);
    if ((int)(joined.size() + expr.size() + 2) > out_cap) break;
    if (cnt) joined += '\n';
    joined += expr;
    out_mses[cnt] = e.second;
    out_sizes[cnt] = (int)e.first.size();
    ++cnt;
  }
  if (cnt == 0) return 4;
  std::memcpy(out_exprs, joined.c_str(), joined.size() + 1);
  *out_count = cnt;
  return 0;
}
