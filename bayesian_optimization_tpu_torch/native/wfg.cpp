// Exact hypervolume by the WFG algorithm (While, Bradstreet & Barone 2012),
// written from the algorithm description for this framework. The reference
// library's vendored Python dimension-sweep carries the comment
// "TODO: write this in C++" (ref: bayes_optim/utils/multi_objective/
// hypervolume.py:29) — this is that native kernel, exposed through ctypes.
//
// Convention: MAXIMIZATION. hv = volume of the union of boxes [ref, p].
// Points not strictly above ref in some coordinate contribute their clipped
// box; callers should pre-filter empty contributors.
//
// Built at first use by native/__init__.py (g++ -O3 -shared -fPIC) into
// bayesian_optimization_tpu_torch/_build/.

#include <algorithm>
#include <cstddef>
#include <vector>

namespace {

using Point = std::vector<double>;

double inclhv(const Point& p, const Point& ref) {
    double v = 1.0;
    for (std::size_t j = 0; j < ref.size(); ++j) {
        double e = p[j] - ref[j];
        if (e <= 0.0) return 0.0;
        v *= e;
    }
    return v;
}

// strictly-dominates-or-equals for maximization: a >= b componentwise
bool weakly_dominates(const Point& a, const Point& b) {
    for (std::size_t j = 0; j < a.size(); ++j)
        if (a[j] < b[j]) return false;
    return true;
}

// keep only non-dominated points of `ps` (in place)
void nds_filter(std::vector<Point>& ps) {
    std::vector<Point> kept;
    kept.reserve(ps.size());
    for (std::size_t i = 0; i < ps.size(); ++i) {
        bool dominated = false;
        for (std::size_t k = 0; k < kept.size() && !dominated; ++k)
            if (weakly_dominates(kept[k], ps[i])) dominated = true;
        if (dominated) continue;
        // drop kept points dominated by ps[i]
        std::vector<Point> next;
        next.reserve(kept.size() + 1);
        for (auto& q : kept)
            if (!weakly_dominates(ps[i], q)) next.push_back(std::move(q));
        next.push_back(ps[i]);
        kept = std::move(next);
    }
    ps = std::move(kept);
}

double wfg_hv(std::vector<Point> ps, const Point& ref);

// exclusive hypervolume of ps[i] against ps[i+1..]
double exclhv(const std::vector<Point>& ps, std::size_t i, const Point& ref) {
    double inc = inclhv(ps[i], ref);
    if (i + 1 >= ps.size() || inc == 0.0) return inc;
    // limit set: componentwise min of ps[i] with each later point
    std::vector<Point> limit;
    limit.reserve(ps.size() - i - 1);
    for (std::size_t k = i + 1; k < ps.size(); ++k) {
        Point q(ref.size());
        for (std::size_t j = 0; j < ref.size(); ++j)
            q[j] = std::min(ps[i][j], ps[k][j]);
        limit.push_back(std::move(q));
    }
    nds_filter(limit);
    return inc - wfg_hv(std::move(limit), ref);
}

double wfg_hv(std::vector<Point> ps, const Point& ref) {
    if (ps.empty()) return 0.0;
    // sort by first objective descending: better locality and smaller
    // limit sets on average
    std::sort(ps.begin(), ps.end(),
              [](const Point& a, const Point& b) { return a[0] > b[0]; });
    double total = 0.0;
    for (std::size_t i = 0; i < ps.size(); ++i) total += exclhv(ps, i, ref);
    return total;
}

}  // namespace

extern "C" {

// Y: n*m row-major front, ref: m reference point -> hypervolume
double wfg_hypervolume(const double* Y, int n, int m, const double* ref) {
    std::vector<Point> ps(n, Point(m));
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < m; ++j) ps[i][j] = Y[i * m + j];
    Point r(ref, ref + m);
    nds_filter(ps);
    return wfg_hv(std::move(ps), r);
}

}  // extern "C"
