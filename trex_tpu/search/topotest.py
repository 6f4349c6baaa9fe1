"""Tree topology tests: KH, SH, RELL bootstrap proportions, ELW.

Given one alignment and a set of candidate topologies, decide which trees
the data can reject — the CONSEL / IQ-TREE "topology test" workflow. All
tests ride the same two primitives as the branch supports: per-tree
per-site log-likelihood vectors (branch lengths Newton-optimized per tree)
and RELL resampling, one (replicates x patterns) @ (patterns x trees)
matmul.

Implemented tests (per non-best tree, against the ML tree):
- ``p_kh``   Kishino-Hasegawa via RELL: each tree's replicate totals are
  centered at its observed total (the null says both trees explain the
  data equally well); p = fraction of replicates where the centered score
  difference reaches the observed difference.
- ``p_sh``   Shimodaira-Hasegawa: like KH but corrected for selection of
  the best tree by comparing against the max over ALL candidates per
  replicate (valid when the true tree is in the set).
- ``bp``     RELL bootstrap proportion: fraction of replicates the tree wins.
- ``elw``    Expected likelihood weight (Strimmer & Rambaut 2002): mean over
  replicates of the tree's likelihood weight softmax(L*_r).
- ``p_au``   Approximately unbiased test (Shimodaira 2002): multiscale
  bootstrap — win proportions at several resampling scales r, weighted
  least-squares fit of ``z(r) = d*sqrt(r) + c/sqrt(r)`` to the normal
  quantiles of the win proportions, ``p_au = 1 - Phi(d - c)``. The least
  biased of the tests; degenerate cases (a tree winning everywhere or
  nowhere at every scale) collapse to 1/0.

The reference has no model-based machinery at all (SURVEY.md §2); this is
new capability alongside `search.alrt` / `search.ufboot`.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.ops.likelihood import per_site_log_likelihood
from trex_tpu.ops.likelihood_asr import optimize_branch_lengths_newton
from trex_tpu.search.bootstrap import _replicate_weights
from trex_tpu.topology import Topology


@dataclass
class TopologyTestResult:
    """Per-tree test results, aligned with the input tree order."""

    log_likelihoods: np.ndarray  # (T,) observed lnL at Newton lengths
    delta: np.ndarray            # (T,) lnL_best - lnL_tree (0 for the best)
    p_kh: np.ndarray             # (T,) KH p-value vs the best tree
    p_sh: np.ndarray             # (T,) SH p-value (max-corrected)
    bp: np.ndarray               # (T,) RELL bootstrap proportion
    elw: np.ndarray              # (T,) expected likelihood weight
    best_index: int
    per_site: np.ndarray         # (T, P) per-pattern lnL vectors
    p_au: np.ndarray | None = None  # (T,) AU p-values (when au_scales set)


def topology_tests(
    key: jax.Array,
    trees: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    n_replicates: int = 10000,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    au_scales: tuple[float, ...] | None = (
        0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4,
    ),
    mesh=None,
) -> TopologyTestResult:
    """Run KH / SH / BP / ELW over a batched Topology of candidate trees.

    ``site_weights`` makes compressed site patterns exact (the resampler
    draws sites by their multiplicities, as everywhere else).

    ``mesh``: optional ('tree', 'site') ``jax.sharding.Mesh`` — the
    per-tree Newton + per-site-lnL pass (the dominant cost) shards its
    candidate axis over the mesh's ``tree`` axis, bit-identical to the
    single-device map (``parallel.sharded.sharded_per_site_matrix``).
    """
    n_trees = int(trees.children.shape[0])
    if n_trees < 2:
        raise ValueError("topology tests need at least two candidate trees")
    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    leaf = jnp.asarray(leaf_sequences)

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_per_site_matrix

        per_site = sharded_per_site_matrix(
            mesh, trees, leaf, n_states, rates=rates, freqs=freqs,
            weights=weights, n_sweeps=n_sweeps,
            sequences_are_masks=sequences_are_masks,
        )  # (T, P)
    else:
        def newton_and_persite(topo):
            lengths, _ = optimize_branch_lengths_newton(
                topo, leaf, n_states, rates, freqs, weights,
                sequences_are_masks=sequences_are_masks, n_sweeps=n_sweeps,
            )
            return per_site_log_likelihood(
                topo, lengths, leaf, n_states, rates, freqs,
                sequences_are_masks=sequences_are_masks,
            )

        per_site = jax.lax.map(
            newton_and_persite, trees, batch_size=64
        )  # (T,P)
    obs = np.asarray(per_site @ weights, np.float64)  # (T,)
    best = int(obs.argmax())
    delta = obs[best] - obs

    rep_w = _replicate_weights(
        key, int(weights.shape[0]), n_replicates, weights
    ).astype(jnp.float32)  # (R, P)
    rell = np.asarray(rep_w @ jnp.transpose(per_site), np.float64)  # (R, T)

    # Center each tree's replicate totals at its observed total: the shared
    # null hypothesis "all candidate trees explain the data equally well".
    centered = rell - obs[None, :] + 0.0
    centered = centered - centered.mean(axis=0, keepdims=True)

    p_kh = np.ones((n_trees,))
    p_sh = np.ones((n_trees,))
    for t in range(n_trees):
        if t == best:
            continue
        # KH: two-tree comparison against the observed difference.
        null_delta = centered[:, best] - centered[:, t]
        p_kh[t] = float(np.mean(null_delta >= delta[t]))
        # SH: the observed difference is measured against the best OF ALL
        # candidates per replicate (corrects for having selected `best`).
        null_max = centered.max(axis=1) - centered[:, t]
        p_sh[t] = float(np.mean(null_max >= delta[t]))

    winners = rell.argmax(axis=1)
    bp = np.bincount(winners, minlength=n_trees) / float(rell.shape[0])

    p_au = None
    if au_scales is not None and len(au_scales) >= 2:
        p_au = _au_test(
            jax.random.fold_in(key, 7), per_site, weights,
            n_replicates, au_scales,
        )
    # ELW in log space: softmax of replicate totals across trees.
    shifted = rell - rell.max(axis=1, keepdims=True)
    w = np.exp(shifted)
    w = w / w.sum(axis=1, keepdims=True)
    elw = w.mean(axis=0)
    return TopologyTestResult(
        log_likelihoods=obs,
        delta=delta,
        p_kh=p_kh,
        p_sh=p_sh,
        bp=bp,
        elw=elw,
        best_index=best,
        per_site=np.asarray(per_site, np.float64),
        p_au=p_au,
    )


def _au_test(
    key: jax.Array,
    per_site: jax.Array,
    weights: jax.Array,
    n_replicates: int,
    scales: tuple[float, ...],
) -> np.ndarray:
    """AU p-values from multiscale RELL bootstraps.

    For each scale r, resample ``round(n * r)`` sites and record each
    tree's win proportion bp_r. A weighted least-squares fit of
    ``Phi^{-1}(1 - bp_r) = d sqrt(r) + c / sqrt(r)`` (weights = the
    binomial delta-method precision of each quantile) gives the signed
    distance d and curvature c of the hypothesis boundary;
    ``p_au = 1 - Phi(d - c)``.
    """
    from scipy.stats import norm

    n_trees = per_site.shape[0]
    length = per_site.shape[1]
    base = jnp.asarray(weights, jnp.float32)
    total = float(jnp.sum(base))
    probs = base / jnp.sum(base)
    per_site_t = jnp.transpose(jnp.asarray(per_site, jnp.float32))

    bps = np.zeros((len(scales), n_trees))
    for s_idx, r in enumerate(scales):
        n_r = max(1, int(round(total * r)))
        k = jax.random.fold_in(key, s_idx)

        def one(kk, n_r=n_r):
            picks = jax.random.choice(kk, length, (n_r,), p=probs)
            return jnp.zeros((length,), jnp.float32).at[picks].add(1.0)

        rep_w = jax.vmap(one)(jax.random.split(k, n_replicates))  # (R, P)
        rell_r = np.asarray(rep_w @ per_site_t)  # (R, T)
        wins = rell_r.argmax(axis=1)
        bps[s_idx] = np.bincount(wins, minlength=n_trees) / float(
            n_replicates
        )

    rs = np.asarray(scales, np.float64)
    p_au = np.zeros((n_trees,))
    for t in range(n_trees):
        bp_t = bps[:, t]
        usable = (bp_t > 0) & (bp_t < 1)
        if usable.sum() < 2:
            p_au[t] = 1.0 if bp_t.mean() > 0.5 else 0.0
            continue
        z = norm.ppf(1.0 - bp_t[usable])
        x1 = np.sqrt(rs[usable])
        x2 = 1.0 / np.sqrt(rs[usable])
        # Delta-method precision of each z estimate.
        var = bp_t[usable] * (1.0 - bp_t[usable]) / n_replicates
        w = norm.pdf(z) ** 2 / np.maximum(var, 1e-12)
        X = np.stack([x1, x2], axis=1)
        sw = np.sqrt(w)
        beta, *_ = np.linalg.lstsq(sw[:, None] * X, sw * z, rcond=None)
        d, c = beta
        p_au[t] = float(1.0 - norm.cdf(d - c))
    return p_au
