// emsar_tpu native solver polish: float64 SQUAREM EM cycles on the host.
//
// Mirrors emsar_tpu/model/solver.py::polish_host_f64 (same update rule,
// same stabilized SQUAREM acceptance, same termwise likelihood-gain
// convergence test) over the flat edge-list problem.  Used to close the
// float32 convergence floor after the device solve; a C++ loop makes the
// polish ~10x cheaper than the NumPy bincount formulation.
//
// Reference objective being maximized: per-module Poisson likelihood
// F = sum_c R_c log(E_c s_c) - E_c s_c with s_c = sum_t m_ct theta_t
// (reference MLE, src/emsar_functions.c:3033-3126; Fp :2946).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// s[c] = sum over edges of mult * theta[tid]
void intensities(const int32_t* e_cid, const int32_t* e_tid,
                 const double* mult, int64_t n_edges, int64_t n_seg,
                 const double* theta, double* s) {
    std::fill(s, s + n_seg, 0.0);
    for (int64_t i = 0; i < n_edges; i++)
        s[e_cid[i]] += mult[i] * theta[e_tid[i]];
}

struct Problem {
    const int32_t* e_cid;
    const int32_t* e_tid;
    const double* mult;
    int64_t n_edges;
    const double* eumaps;  // [n_seg]
    const double* reads;   // [n_seg]
    int64_t n_seg;
    const double* inv_denom;  // [ntid]
    int64_t ntid;
};

// One multiplicative EM step; also emits s(theta_in) (intensities of the
// INPUT theta), letting callers reuse it.
void em_step(const Problem& p, const double* theta, double* s,
             double* ratio, double* num, double* theta_out) {
    intensities(p.e_cid, p.e_tid, p.mult, p.n_edges, p.n_seg, theta, s);
    for (int64_t c = 0; c < p.n_seg; c++)
        ratio[c] = s[c] > 0 ? p.reads[c] / s[c] : 0.0;
    std::fill(num, num + p.ntid, 0.0);
    for (int64_t i = 0; i < p.n_edges; i++)
        num[p.e_tid[i]] += p.mult[i] * ratio[p.e_cid[i]];
    for (int64_t t = 0; t < p.ntid; t++)
        theta_out[t] = theta[t] * num[t] * p.inv_denom[t];
}

// logL(s_new) - logL(s_old) from intensity deltas (termwise; resolves
// tiny gains that differencing two O(1e6) log-likelihoods cannot).  With
// skip_unread the read term of a segment without reads is left out (it is
// 0): the JAX package's library computes it, and a read-less segment whose
// ratio rounds to -1 then adds 0 * log1p(-1) = NaN.
double gain(const Problem& p, const double* s_old, const double* s_new,
            bool skip_unread) {
    double acc = 0.0;
    for (int64_t c = 0; c < p.n_seg; c++) {
        double so = s_old[c], sn = s_new[c];
        double term;
        if (skip_unread && !(p.reads[c] > 0)) {
            term = 0.0;
        } else if (so > 0 && sn > 0) {
            term = p.reads[c] * std::log1p((sn - so) / so);
        } else if (so > 0 && sn <= 0 && p.reads[c] > 0) {
            term = -1e30;  // read-bearing intensity collapse: -inf
        } else if (so <= 0 && sn > 0 && p.reads[c] > 0) {
            term = 1e30;
        } else {
            term = 0.0;
        }
        acc += term - p.eumaps[c] * (sn - so);
    }
    return acc;
}

}  // namespace

extern "C" int64_t emsar_polish_squarem(
    const int32_t* e_cid, const int32_t* e_tid, const double* mult,
    int64_t n_edges, const double* eumaps, const double* reads,
    int64_t n_seg, const double* inv_denom, int64_t ntid, double* theta,
    double epsilon, int64_t max_cycles, int skip_unread) {
    Problem p{e_cid, e_tid, mult, n_edges, eumaps, reads, n_seg,
              inv_denom, ntid};
    std::vector<double> s_prev(n_seg), s_a(n_seg), s_b(n_seg);
    std::vector<double> ratio(n_seg), num(ntid);
    std::vector<double> t1(ntid), t2(ntid), proj(ntid), cand(ntid);

    intensities(e_cid, e_tid, mult, n_edges, n_seg, theta, s_prev.data());
    int64_t cycle = 0;
    for (; cycle < max_cycles; cycle++) {
        em_step(p, theta, s_a.data(), ratio.data(), num.data(), t1.data());
        em_step(p, t1.data(), s_a.data(), ratio.data(), num.data(),
                t2.data());
        double rn2 = 0.0, vn2 = 0.0;
        for (int64_t t = 0; t < ntid; t++) {
            double r = t1[t] - theta[t];
            double v = t2[t] - t1[t] - r;
            rn2 += r * r;
            vn2 += v * v;
        }
        double vn = std::sqrt(vn2);
        double alpha = vn > 0 ? -std::sqrt(rn2) / vn : -1.0;
        alpha = std::min(alpha, -1.0);  // never shorter than a plain step
        for (int64_t t = 0; t < ntid; t++) {
            double r = t1[t] - theta[t];
            double v = t2[t] - t1[t] - r;
            // zero-crossing coordinates fall back to the plain double-EM
            // value (exact 0 is absorbing for multiplicative EM)
            double extrap = theta[t] - 2.0 * alpha * r + alpha * alpha * v;
            proj[t] = extrap > 0 ? extrap : t2[t];
        }
        // stabilization step; s_a := s(proj) (unused), then compare the
        // candidate against the plain double step by likelihood gain
        em_step(p, proj.data(), s_a.data(), ratio.data(), num.data(),
                cand.data());
        intensities(e_cid, e_tid, mult, n_edges, n_seg, t2.data(),
                    s_a.data());
        intensities(e_cid, e_tid, mult, n_edges, n_seg, cand.data(),
                    s_b.data());
        const double* s_new;
        if (gain(p, s_a.data(), s_b.data(), skip_unread != 0) >= 0) {
            std::copy(cand.begin(), cand.end(), theta);
            s_new = s_b.data();
        } else {
            std::copy(t2.begin(), t2.end(), theta);
            s_new = s_a.data();
        }
        if (gain(p, s_prev.data(), s_new, skip_unread != 0) < epsilon) {
            cycle++;
            break;
        }
        std::copy(s_new, s_new + n_seg, s_prev.begin());
    }
    return cycle;
}
