/*
 * Generalized Poisson-gamma mixture probabilities
 * (arXiv:1902.08831, eqs. 91/97) — native host implementation.
 *
 * The TPU framework's primary implementation is the vectorized,
 * differentiable JAX version in poisson.py; this C library is the
 * host-side native equivalent of the reference framework's compiled
 * extension (cf. pisa/utils/llh_defs/poisson_gamma.c — same mathematics,
 * independent implementation), selectable via use_c=True for parity with
 * the reference's stats.generalized_poisson_llh(use_c=True) path and used
 * as an independent cross-check of the JAX recursion.
 *
 * Math: with q_s = 1/(1+beta_s), the mixture's probability generating
 * function is  Delta(x) = prod_s (1 - q_s x)^{-alpha_s}.  Expanding in
 * powers of x gives the recursion
 *
 *   delta_0 = 1,
 *   delta_i = (1/i) * sum_{j=1..i} S_j * delta_{i-j},
 *   S_j     = sum_s alpha_s * q_s^j,
 *
 * and  P(k) = prod_s (beta_s/(1+beta_s))^{alpha_s} * delta_k.
 *
 * Sources with beta <= 0 or non-finite parameters are skipped (mirroring
 * the JAX implementation's mask).
 */

#include <math.h>
#include <stddef.h>

#define PG_MIN_PROB 1e-300

/* log P(k) for one bin.  Scratch layout (caller-allocated):
 *   deltas : k+1 doubles
 *   qpow   : n_sources doubles (running q_s^j)
 *   st     : k doubles (S_1 .. S_k)
 */
static double pg_log_prob_single(
    long k,
    const double *alphas,
    const double *betas,
    long n_sources,
    double *deltas,
    double *qpow,
    double *st
) {
    double log_prefac = 0.0;
    long i, j, s;

    for (s = 0; s < n_sources; ++s) {
        double a = alphas[s];
        double b = betas[s];
        if (b > 0.0 && isfinite(a) && isfinite(b)) {
            qpow[s] = 1.0;
            /* alpha * log(beta/(1+beta)) = -alpha * log1p(1/beta) */
            log_prefac -= a * log1p(1.0 / b);
        } else {
            qpow[s] = 0.0; /* masked: q^j stays 0, contributes nothing */
        }
    }

    for (j = 1; j <= k; ++j) {
        double sj = 0.0;
        for (s = 0; s < n_sources; ++s) {
            double b = betas[s];
            if (b > 0.0 && isfinite(b) && isfinite(alphas[s])) {
                qpow[s] /= (1.0 + b); /* now q_s^j */
                sj += alphas[s] * qpow[s];
            }
        }
        st[j - 1] = sj;
    }

    deltas[0] = 1.0;
    for (i = 1; i <= k; ++i) {
        double conv = 0.0;
        for (j = 1; j <= i; ++j) {
            conv += st[j - 1] * deltas[i - j];
        }
        deltas[i] = conv / (double)i;
    }

    {
        double p = deltas[k];
        if (!(p > PG_MIN_PROB)) {
            p = PG_MIN_PROB;
        }
        return log_prefac + log(p);
    }
}

/* Vectorized over bins.
 *  k      : (n_bins,) data counts (clipped to >= 0)
 *  alphas : (n_bins, n_sources) row-major
 *  betas  : (n_bins, n_sources) row-major
 *  out    : (n_bins,) log probabilities
 *  scratch: at least (max_k + 1) + n_sources + max_k doubles, where max_k
 *           is the largest count in k
 */
void pg_log_mixture(
    const long *k,
    const double *alphas,
    const double *betas,
    long n_bins,
    long n_sources,
    double *out,
    double *scratch
) {
    long b;
    for (b = 0; b < n_bins; ++b) {
        long kb = k[b] > 0 ? k[b] : 0;
        double *deltas = scratch;
        double *qpow = deltas + (kb + 1);
        double *st = qpow + n_sources;
        out[b] = pg_log_prob_single(
            kb, alphas + b * n_sources, betas + b * n_sources, n_sources,
            deltas, qpow, st
        );
    }
}
