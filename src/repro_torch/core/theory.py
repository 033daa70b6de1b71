"""Theory helpers: the paper's prescribed step sizes, thresholds and rates
(port of ``repro.core.theory``; pure float math, the same formulas).
"""
from __future__ import annotations

import math


def gamma_full(E: int, q: float, q0: float) -> float:
    """Theorem 1 / 6 (full participation, bidirectional EF compression).

    Gamma = 2 E^2 + 2E sqrt(1-q)/q + 4E sqrt(10 (1-q0)) / (q0 q).
    Gamma -> 2E^2 with no compression; the brief's Gamma(q,q0)=1 normalization
    corresponds to dividing by the uncompressed value.
    """
    base = 2.0 * E * E
    comp = 2.0 * E * math.sqrt(max(1.0 - q, 0.0)) / q \
        + 4.0 * E * math.sqrt(10.0 * max(1.0 - q0, 0.0)) / (q0 * q)
    return base + comp


def _gamma_partial_r(E: int, q: float, q0: float, r: float) -> float:
    """Theorem 7's Gamma as a function of the participation ratio ``r``
    (uniform sampling: r = n/m; non-uniform: the effective ratio from
    :func:`effective_ratio`)."""
    return (2.0 * E * E
            + 16.0 * E * r * math.sqrt(10.0 * (1.0 - q) * (1.0 - q0)) / (q0 * q * q)
            + 8.0 * E * math.sqrt(10.0 * (1.0 - q0)) / (q0 * q)
            + 20.0 * E / (q * q)
            + r * 4.0 * E * math.sqrt(10.0 * (1.0 - q)) / (q * q))


def gamma_partial(E: int, q: float, q0: float, n: int, m: int) -> float:
    """Theorem 7 (partial participation, deterministic compressors)."""
    return _gamma_partial_r(E, q, q0, n / m)


def ht_variance(pi, q) -> float:
    """Per-round variance factor of the Horvitz-Thompson participation
    estimator under sampler inclusion probabilities ``pi`` ([n], with
    sum(pi) = m) and population weights ``q`` ([n], sum 1):

        V = sum_j q_j^2 (1 - pi_j) / pi_j,

    so Var[g_hat] = V * B^2 for per-client values bounded by B under
    independent (Poisson) inclusion.  For without-replacement designs with
    negatively associated inclusions (uniform, Madow systematic over the
    capped probabilities -- repro_torch.fleet.samplers) the joint-inclusion
    covariance terms are non-positive, so V upper-bounds the true
    variance.  Uniform sampling (pi_j = m/n, q_j = 1/n) gives the closed
    form V = (1 - m/n) / m."""
    V = 0.0
    for pj, qj in zip(pi, q):
        if pj <= 0.0:
            if qj > 0.0:
                raise ValueError(
                    "ht_variance: client with positive population weight "
                    "has zero inclusion probability (estimator is biased)")
            continue
        V += qj * qj * (1.0 - pj) / pj
    return V


def effective_ratio(pi, q, m: int) -> float:
    """The participation ratio ``r`` Theorem 7's Gamma sees under a
    non-uniform sampler: r_eff = 1 / max(1 - m V, 1/n-scale floor) with
    V = :func:`ht_variance`.  Uniform sampling recovers r = n/m exactly
    (m V = 1 - m/n there); heavier-tailed inclusion laws inflate it."""
    V = ht_variance(pi, q)
    return 1.0 / max(1.0 - m * V, 1e-12)


def gamma_partial_sampled(E: int, q_c: float, q0: float, pi, qw,
                          m: int) -> float:
    """Theorem 7's Gamma under a non-uniform client sampler: the uniform
    ratio n/m is replaced by the importance-sampling effective ratio from
    the sampler's exact inclusion probabilities (``pi`` =
    ``ClientSampler.inclusion_probs``, ``qw`` the population weights the
    HT aggregation is unbiased for).  ``q_c``/``q0`` are the uplink /
    downlink compressor contraction parameters as in
    :func:`gamma_partial`."""
    return _gamma_partial_r(E, q_c, q0, effective_ratio(pi, qw, m))


def eta_star(D: float, G: float, E: int, T: int, gamma: float) -> float:
    """eta = sqrt(D^2 / (2 G^2 E T Gamma))."""
    return math.sqrt(D * D / (2.0 * G * G * E * T * gamma))


def eps_star_full(D: float, G: float, E: int, T: int, gamma: float) -> float:
    """eps = sqrt(2 D^2 G^2 Gamma / (E T))."""
    return math.sqrt(2.0 * D * D * G * G * gamma / (E * T))


def eps_star_partial(D: float, G: float, E: int, T: int, gamma: float,
                     n: int, m: int, q: float, sigma: float, delta: float) -> float:
    """Theorem 7 threshold (adds sampling-concentration terms)."""
    base = eps_star_full(D, G, E, T, gamma)
    t1 = (n / m) * 2.0 * D * G * math.sqrt(max(1.0 - q, 0.0)) / (q * T)
    t2 = 4.0 * G * D / math.sqrt(m * T) * math.sqrt(2.0 * math.log(3.0 / delta))
    t3 = 2.0 * sigma * math.sqrt(2.0 / m * math.log(6.0 * T / delta))
    return base + t1 + t2 + t3


def rate_bound(D: float, G: float, E: int, T: int, gamma: float) -> float:
    """Predicted bound on max{f(w_bar)-f*, g(w_bar)}: O(DG sqrt(Gamma / (E T)))."""
    return eps_star_full(D, G, E, T, gamma)


def beta_min(eps: float) -> float:
    """Soft switching sharpness lower bound (Theorem 2): beta >= 2/eps."""
    return 2.0 / eps
