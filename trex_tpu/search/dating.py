"""Bayesian node-age dating on a fixed topology (strict clock).

Complements ``search.mcmc`` (which samples topologies): here the tree is
fixed and the state is the vector of node AGES (ultrametric tree, leaves
at age 0), the usual "date the inferred tree" workflow. Because no
host-side move generation is needed, the ENTIRE sampler — all runs and
chains, all generations — compiles to one jitted ``lax.scan`` over a
vmapped chain batch: zero host/device round trips until the trace comes
back. This is the ideal accelerator MCMC shape (contrast the topology
sampler's 2-3 syncs per generation).

Model: strict clock with rate 1 — ages are in expected-substitutions
units; rescale externally with a calibration. Priors: root age
Exponential(1/root_age_prior_mean); interior ages uniform on the valid
region given the root (joint density ∝ exp(-r/m) · 1{valid ordering}).
For the 3-taxon case this implies root age ~ Gamma(2, m) exactly — used
as a validation oracle, alongside 2-taxon quadrature and simulated-age
recovery (tests/test_dating.py).

Moves per generation (each a full vmapped pruning eval):
- interior age slide: uniform between the node's children max and its
  parent age (symmetric given the rest of the state);
- root age multiplier (Hastings t'/t, exponential prior term).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.topology import Topology


@dataclasses.dataclass
class DatingResult:
    sample_ages: np.ndarray
    """(n_samples, n_all) posterior age samples (pooled cold chains)."""
    sample_lnl: np.ndarray
    """(n_samples,) data log-likelihoods."""
    mean_ages: np.ndarray
    """(n_all,) posterior mean age per node."""
    age_hpd: np.ndarray
    """(n_all, 2) central 95% posterior interval per node."""
    ess_root_age: float
    acceptance: dict[str, float]
    newick: str
    """Ultrametric tree with branch lengths from the posterior mean ages."""
    generations: int
    sample_rates: np.ndarray | None = None
    """(n_samples, n_all) per-branch rate multipliers (relaxed clock only;
    root entry is a placeholder 1)."""
    sample_clock_rate: np.ndarray | None = None
    """(n_samples,) global substitution rate (substitutions/site/time
    unit; calibrated analyses only)."""
    sample_ne: np.ndarray | None = None
    """(n_samples,) coalescent effective population size (Gibbs-sampled;
    tree_prior='coalescent' with ne=None only)."""


def coalescent_area(ages: jax.Array, n_leaves: int) -> jax.Array:
    """Kingman "area" A = sum over inter-event intervals of k(k-1)/2 dt.

    ``ages`` (n_all,) node ages (tips may be nonzero — serial coalescent);
    k = active lineages in the interval, +1 at each tip going back in
    time, -1 at each coalescence. log p(ages | Ne) = -(n-1) log Ne - A/Ne.
    """
    n_all = ages.shape[-1]
    deltas = jnp.where(jnp.arange(n_all) < n_leaves, 1.0, -1.0)
    order = jnp.argsort(ages)
    sorted_ages = ages[order]
    k = jnp.cumsum(deltas[order])  # lineages AFTER each event (back in time)
    dt = jnp.diff(sorted_ages)
    k_mid = k[:-1]  # lineage count within each interval
    return jnp.sum(k_mid * (k_mid - 1.0) / 2.0 * dt)


def mcmc_date(
    key: jax.Array,
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    n_generations: int = 4000,
    n_chains: int = 2,
    sample_every: int = 4,
    burnin_frac: float = 0.25,
    root_age_prior_mean: float = 0.3,
    root_tuning: float = 0.6,
    clock: str = "strict",
    relaxed_sd: float = 0.3,
    rate_tuning: float = 1.0,
    calibrations: dict | None = None,
    tip_ages: np.ndarray | None = None,
    clock_rate_prior_sd: float = 1.5,
    tree_prior: str = "uniform",
    ne: float | None = None,
    ne_prior: tuple[float, float] = (0.001, 0.001),
    start_ages: np.ndarray | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    leaf_names: list[str] | None = None,
    prior_only: bool = False,
    mesh=None,
) -> DatingResult:
    """Sample node ages of ``topology`` under a strict or relaxed clock.

    ``n_chains`` independent chains run vmapped; all are sampled (they are
    not heated — age posteriors on a fixed topology rarely need coupling).
    ``start_ages`` defaults to the ML clock fit (``ops.clock.optimize_clock``)
    jittered per chain, which skips most burn-in.

    ``clock="relaxed"`` is the uncorrelated-lognormal relaxed clock
    (Drummond et al. 2006): each branch carries a rate multiplier with iid
    LogNormal(-sd^2/2, sd^2) prior (mean 1, sd ``relaxed_sd`` on the log
    scale), sampled by per-branch Gaussian random walks on log-rate. The
    effective branch length is (parent age - node age) * rate; sampled
    ages stay in TIME units (the newick is the posterior-mean time tree).

    ``calibrations`` switches the analysis to ABSOLUTE time: a dict
    mapping clades (frozensets of leaf indices, or the string "root") to
    (min_age, max_age) uniform calibration bounds on the clade's MRCA
    age. Every calibrated clade must be monophyletic in ``topology``. A
    global substitution rate (substitutions/site/time-unit) is then
    sampled too (broad lognormal prior, sd ``clock_rate_prior_sd`` around
    an ML-derived initial value) and reported via ``sample_clock_rate``;
    the root-age prior mean should be given in time units.

    ``tip_ages`` ((n_leaves,) sampling times as ages, 0 = most recent)
    enables TIP DATING of heterochronous data (serially sampled viruses):
    leaves sit at their fixed ages, and the clock rate is sampled as in
    the calibrated case — the tip-age spread identifies it without any
    node calibration.

    ``mesh`` (a ``jax.sharding.Mesh`` with a 'tree' axis) shards the chain
    batch across devices — chains are independent, so this is pure data
    parallelism with bit-identical results (tested on the virtual mesh);
    ``n_chains`` must be divisible by the axis size.

    ``tree_prior="coalescent"`` replaces the uniform-interior prior with
    the (serial) Kingman coalescent: log p(ages | Ne) = -(n-1) log Ne -
    A/Ne with A = sum over inter-event intervals of k(k-1)/2 * dt (the
    coalescent "area"; tips enter at their ages). ``ne`` fixes the
    effective population size; ``ne=None`` SAMPLES it by conjugate Gibbs
    (InvGamma(a0 + n - 1, b0 + A), ``ne_prior=(a0, b0)``) — phylodynamic
    Ne estimation; posterior samples in ``sample_ne``.
    """
    from trex_tpu.ops.clock import ages_to_lengths, optimize_clock
    from trex_tpu.ops.likelihood import (
        _per_site_log_likelihood,
        discrete_gamma_rates,
        gtr_eigensystem,
        gtr_transition,
    )

    n_leaves = topology.n_leaves
    n_all = topology.n_all
    n_anc = topology.n_ancestors
    parents = jnp.asarray(np.asarray(topology.parents))
    children = jnp.asarray(np.asarray(topology.children))
    prior_rate = 1.0 / root_age_prior_mean

    if prior_only:
        leaf_sequences = jnp.zeros((n_leaves, 1), dtype=jnp.int32)
        site_weights = jnp.zeros((1,), dtype=jnp.float32)
        sequences_are_masks = False
    leaf_sequences = jnp.asarray(leaf_sequences)
    weights = None if site_weights is None else jnp.asarray(site_weights)

    q = n_states
    if rates is not None or freqs is not None:
        eig_freqs = jnp.full((q,), 1.0 / q) if freqs is None else jnp.asarray(freqs)
        eig_rates = jnp.ones((q, q)) if rates is None else jnp.asarray(rates)
        eigvals, left, right = gtr_eigensystem(eig_rates, eig_freqs)
        root_prior = eig_freqs
    else:
        eigvals = None
        root_prior = None

    relaxed = clock == "relaxed"
    if clock not in ("strict", "relaxed"):
        raise ValueError(f"unknown clock {clock!r}")

    # --- calibrations: per-node uniform age bounds + a sampled global rate
    heterochronous = tip_ages is not None and np.ptp(
        np.asarray(tip_ages)
    ) > 0
    calibrated = bool(calibrations) or tip_ages is not None
    cal_lo = np.zeros(n_all, np.float32)
    cal_hi = np.full(n_all, np.inf, np.float32)
    if calibrations:
        from trex_tpu.search.bootstrap import subtree_leaf_sets

        clade_to_node = {
            s: n_leaves + i
            for i, s in enumerate(subtree_leaf_sets(topology))
        }
        for clade, (lo_b, hi_b) in calibrations.items():
            if clade == "root":
                node = n_all - 1
            else:
                node = clade_to_node.get(frozenset(clade))
                if node is None:
                    raise ValueError(
                        f"calibrated clade {sorted(clade)} is not "
                        "monophyletic in the topology"
                    )
            cal_lo[node] = lo_b
            cal_hi[node] = hi_b
    cal_lo_dev = jnp.asarray(cal_lo)
    cal_hi_dev = jnp.asarray(cal_hi)

    def effective_lengths(ages, log_rates, log_clock_rate):
        lengths = ages_to_lengths(
            Topology(children=children, parents=parents), ages
        )
        if calibrated:
            lengths = lengths * jnp.exp(log_clock_rate)
        if relaxed:
            lengths = lengths * jnp.exp(log_rates)
        return lengths

    def lnl_of_ages(ages, log_rates, log_clock_rate):
        lengths = effective_lengths(ages, log_rates, log_clock_rate)

        def per_site_at(scale):
            if eigvals is not None:
                pmats = jax.vmap(
                    lambda t: gtr_transition(t, eigvals, left, right)
                )(lengths * scale)
                return _per_site_log_likelihood(
                    Topology(children=children, parents=parents),
                    lengths, leaf_sequences, n_states,
                    sequences_are_masks=sequences_are_masks,
                    transition_matrices=pmats, root_prior=root_prior,
                )
            return _per_site_log_likelihood(
                Topology(children=children, parents=parents),
                lengths * scale, leaf_sequences, n_states,
                sequences_are_masks=sequences_are_masks,
            )

        if gamma_shape is None:
            per_site = per_site_at(1.0)
        else:
            cat = discrete_gamma_rates(gamma_shape, n_categories)
            per_site = jax.nn.logsumexp(
                jax.vmap(per_site_at)(cat), axis=0
            ) - jnp.log(n_categories)
        if weights is not None:
            per_site = per_site * weights
        return jnp.sum(per_site)

    # The generation scan is latency-bound on sequential per-generation
    # dependencies, not on the pruning compute, so the lax pruning serves.
    batched_lnl = jax.vmap(lnl_of_ages)
    sd2 = relaxed_sd * relaxed_sd
    # A calibrated root gets a UNIFORM prior from its bounds; the
    # exponential root prior would double-penalize it.
    if calibrated and np.isfinite(cal_hi[-1]):
        prior_rate = 0.0

    coalescent = tree_prior == "coalescent"
    if tree_prior not in ("uniform", "coalescent"):
        raise ValueError(f"unknown tree_prior {tree_prior!r}")
    sample_ne = coalescent and ne is None
    ne0 = float(ne) if ne is not None else 1.0
    ne_a0, ne_b0 = ne_prior
    if coalescent:
        # The coalescent density replaces both the uniform-interior prior
        # and the exponential root prior.
        prior_rate = 0.0
    batched_area = jax.vmap(lambda a: coalescent_area(a, n_leaves))

    def dtree_logprior(prop_ages, ages, ne_batch):
        """Per-chain Delta log tree prior for an age move (Ne fixed)."""
        if not coalescent:
            return 0.0
        return -(batched_area(prop_ages) - batched_area(ages)) / ne_batch

    # --- initial ages --------------------------------------------------------
    seeds = np.asarray(jax.random.key_data(key)).ravel()
    rng = np.random.default_rng(int(seeds[-1]))
    log_clock_rate0 = 0.0
    if start_ages is None and not prior_only:
        ml_ages, _ = optimize_clock(
            topology, leaf_sequences, n_states,
            sequences_are_masks=sequences_are_masks, site_weights=weights,
            rates=rates, freqs=freqs,
        )
        start_ages = np.asarray(ml_ages)
        if heterochronous:
            # Tip dating: put leaves at their sampling ages, stack the ML
            # age increments (rescaled so the tree spans ~2x the tip
            # spread) above them bottom-up; the implied rate seeds the
            # sampled clock rate.
            ml_root = max(float(start_ages[-1]), 1e-6)
            tips = np.asarray(tip_ages, np.float64)
            span = max(float(np.ptp(tips)), 1e-6)
            scale = 2.0 * span / ml_root
            start2 = np.zeros(n_all)
            start2[:n_leaves] = tips
            children_np = np.asarray(topology.children)
            ml_np = np.asarray(start_ages, np.float64)
            for a in range(n_anc):
                v = n_leaves + a
                c0, c1 = int(children_np[a, 0]), int(children_np[a, 1])
                inc_ml = ml_np[v] - max(ml_np[c0], ml_np[c1])
                start2[v] = (
                    max(start2[c0], start2[c1]) + max(inc_ml, 1e-4) * scale
                )
            start_ages = start2
            log_clock_rate0 = float(np.log(max(ml_root / (2.0 * span), 1e-8)))
        elif calibrated:
            # Rescale ML substitution-unit ages into calibrated time via
            # the first calibrated node's bound midpoint; the implied
            # substitution rate seeds (and centers the prior of) the
            # sampled clock rate.
            cal_nodes = [
                v for v in range(n_all)
                if cal_lo[v] > 0 or np.isfinite(cal_hi[v])
            ]
            anchor = cal_nodes[0]
            hi_eff = (
                cal_hi[anchor]
                if np.isfinite(cal_hi[anchor])
                else cal_lo[anchor] * 3.0 + 1.0
            )
            target = (cal_lo[anchor] + hi_eff) / 2.0
            ml_anchor = max(float(start_ages[anchor]), 1e-6)
            start_ages = start_ages * (target / ml_anchor)
            log_clock_rate0 = float(np.log(max(ml_anchor / target, 1e-8)))
    elif start_ages is None:
        from trex_tpu.ops.clock import increments_to_ages

        start_ages = np.asarray(
            increments_to_ages(
                topology,
                jnp.asarray(
                    rng.uniform(0.02, 0.1, size=n_anc).astype(np.float32)
                ),
            )
        )
    ages0 = np.broadcast_to(
        np.asarray(start_ages, np.float32)[None], (n_chains, n_all)
    ).copy()
    if tip_ages is not None:
        ages0[:, :n_leaves] = np.asarray(tip_ages, np.float32)[None]
    # Jitter interior proportionally (keeps ordering with high probability;
    # invalid jitters are snapped back by the move bounds immediately).
    ages0[:, n_leaves:] *= rng.uniform(
        0.95, 1.05, size=(n_chains, n_anc)
    ).astype(np.float32)
    # Re-enforce validity: parent age strictly above children, inside any
    # calibration window.
    for c in range(n_chains):
        for a in range(n_anc):
            v = n_leaves + a
            lo = max(
                float(ages0[c, int(topology.children[a][0])]),
                float(ages0[c, int(topology.children[a][1])]),
                float(cal_lo[v]),
            )
            if ages0[c, v] <= lo:
                ages0[c, v] = lo + 1e-4
            if ages0[c, v] > cal_hi[v]:
                ages0[c, v] = max(cal_hi[v] - 1e-4, lo + 1e-4)
    if calibrated:
        bad = [
            (c, v)
            for c in range(n_chains)
            for v in range(n_leaves, n_all)
            if not (cal_lo[v] <= ages0[c, v] <= cal_hi[v])
        ]
        if bad:
            raise ValueError(
                "could not satisfy all calibration windows jointly from "
                f"the starting ages (violations: {bad[:4]}...)"
            )

    # --- the whole sampler: one jitted scan ---------------------------------
    anc_ids = jnp.arange(n_leaves, n_all - 1, dtype=jnp.int32)

    n_burnin = int(burnin_frac * n_generations)

    @jax.jit
    def run(key, ages, log_rates, log_cr, ne_vec):
        lnl = batched_lnl(ages, log_rates, log_cr)

        def gen(carry, inputs):
            (ages, log_rates, log_cr, ne_vec, lnl, acc_slide, acc_root,
             acc_rate, acc_cr, log_tune) = carry
            step_idx, k = inputs
            (k_node, k_u, k_acc1, k_mult, k_acc2,
             k_rnode, k_rstep, k_acc3, k_cr, k_acc4,
             k_ne) = jax.random.split(k, 11)

            # Interior slide (skipped entirely when there is no interior).
            if n_anc > 1:
                node = jax.random.choice(k_node, anc_ids, shape=(n_chains,))
                rows = jnp.arange(n_chains)
                kid_pair = children[node - n_leaves]
                low = jnp.maximum(
                    jnp.maximum(
                        ages[rows, kid_pair[:, 0]], ages[rows, kid_pair[:, 1]]
                    ),
                    cal_lo_dev[node],
                )
                high = jnp.minimum(
                    ages[rows, parents[node]], cal_hi_dev[node]
                )
                prop_age = low + (high - low) * jax.random.uniform(
                    k_u, (n_chains,)
                )
                prop = ages.at[rows, node].set(prop_age)
                prop_lnl = batched_lnl(prop, log_rates, log_cr)
                take = (
                    jnp.log(jax.random.uniform(k_acc1, (n_chains,)))
                    < prop_lnl - lnl + dtree_logprior(prop, ages, ne_vec)
                )
                ages = jnp.where(take[:, None], prop, ages)
                lnl = jnp.where(take, prop_lnl, lnl)
                acc_slide = acc_slide + take.sum()

            # Per-branch rate random walk (relaxed clock only).
            if relaxed:
                rows = jnp.arange(n_chains)
                rnode = jax.random.randint(
                    k_rnode, (n_chains,), 0, n_all - 1
                )
                step = rate_tuning * relaxed_sd * jax.random.normal(
                    k_rstep, (n_chains,)
                )
                old_lr = log_rates[rows, rnode]
                new_lr = old_lr + step
                prop_lr = log_rates.at[rows, rnode].set(new_lr)
                prop_lnl = batched_lnl(ages, prop_lr, log_cr)
                mu = -0.5 * sd2
                dprior = (
                    (old_lr - mu) ** 2 - (new_lr - mu) ** 2
                ) / (2.0 * sd2)
                take = (
                    jnp.log(jax.random.uniform(k_acc3, (n_chains,)))
                    < prop_lnl - lnl + dprior
                )
                log_rates = jnp.where(take[:, None], prop_lr, log_rates)
                lnl = jnp.where(take, prop_lnl, lnl)
                acc_rate = acc_rate + take.sum()

            # Root multiplier (per-chain step size, Robbins-Monro-adapted
            # toward ~40% acceptance DURING BURN-IN ONLY — the kernel is
            # frozen afterwards, so the retained samples target the exact
            # posterior).
            rows = jnp.arange(n_chains)
            tune = jnp.exp(log_tune)
            factor = jnp.exp(
                tune * (jax.random.uniform(k_mult, (n_chains,)) - 0.5)
            )
            old_root = ages[:, -1]
            new_root = old_root * factor
            kid_pair = children[-1]
            low = jnp.maximum(
                jnp.maximum(
                    ages[rows, kid_pair[0]], ages[rows, kid_pair[1]]
                ),
                cal_lo_dev[-1],
            )
            prop = ages.at[:, -1].set(new_root)
            prop_lnl = batched_lnl(prop, log_rates, log_cr)
            log_alpha = (
                prop_lnl - lnl
                - prior_rate * (new_root - old_root)
                + dtree_logprior(prop, ages, ne_vec)
                + jnp.log(factor)
            )
            take = (
                (new_root > low)
                & (new_root <= cal_hi_dev[-1])
                & (jnp.log(jax.random.uniform(k_acc2, (n_chains,)))
                   < log_alpha)
            )
            ages = jnp.where(take[:, None], prop, ages)
            lnl = jnp.where(take, prop_lnl, lnl)
            acc_root = acc_root + (step_idx >= n_burnin) * take.sum()
            adapting = (step_idx < n_burnin).astype(jnp.float32)
            log_tune = jnp.clip(
                log_tune + adapting * 0.08 * (take.astype(jnp.float32) - 0.4),
                jnp.log(1e-3), jnp.log(4.0),
            )

            # Global clock-rate random walk (calibrated analyses only;
            # lognormal prior centered on the ML-derived seed).
            if calibrated:
                step = 0.3 * jax.random.normal(k_cr, (n_chains,))
                new_cr = log_cr + step
                prop_lnl = batched_lnl(ages, log_rates, new_cr)
                dprior = (
                    (log_cr - log_clock_rate0) ** 2
                    - (new_cr - log_clock_rate0) ** 2
                ) / (2.0 * clock_rate_prior_sd**2)
                take = (
                    jnp.log(jax.random.uniform(k_acc4, (n_chains,)))
                    < prop_lnl - lnl + dprior
                )
                log_cr = jnp.where(take, new_cr, log_cr)
                lnl = jnp.where(take, prop_lnl, lnl)
                acc_cr = acc_cr + take.sum()

                # Joint (time x f, rate / f) scale move: the likelihood is
                # EXACTLY invariant (lengths = rate * dt), so this slides
                # along the rate/time ridge at zero evaluation cost; only
                # the priors and the f^n_anc Jacobian enter. Calibration
                # windows gate acceptance.
                k_s, k_acc5 = jax.random.split(k_cr)
                f = jnp.exp(
                    0.5 * (jax.random.uniform(k_s, (n_chains,)) - 0.5)
                )
                prop_ages = ages.at[:, n_leaves:].multiply(f[:, None])
                new_cr2 = log_cr - jnp.log(f)
                old_root = ages[:, -1]
                new_root = prop_ages[:, -1]
                inside = jnp.all(
                    (prop_ages[:, n_leaves:] >= cal_lo_dev[None, n_leaves:])
                    & (prop_ages[:, n_leaves:]
                       <= cal_hi_dev[None, n_leaves:]),
                    axis=1,
                )
                if heterochronous:
                    # Fixed nonzero tips: interior-only scaling can push a
                    # parent below a leaf child; gate on full ordering.
                    kid_max = jnp.maximum(
                        prop_ages[:, children[:, 0]],
                        prop_ages[:, children[:, 1]],
                    )
                    inside = inside & jnp.all(
                        prop_ages[:, n_leaves:] > kid_max, axis=1
                    )
                dprior = (
                    -prior_rate * (new_root - old_root)
                    + (
                        (log_cr - log_clock_rate0) ** 2
                        - (new_cr2 - log_clock_rate0) ** 2
                    ) / (2.0 * clock_rate_prior_sd**2)
                    + dtree_logprior(prop_ages, ages, ne_vec)
                )
                if heterochronous:
                    # Fixed nonzero tips break the exact invariance
                    # (leaf-edge lengths change): evaluate.
                    prop_lnl = batched_lnl(prop_ages, log_rates, new_cr2)
                    dlik = prop_lnl - lnl
                else:
                    prop_lnl = lnl
                    dlik = 0.0
                take = inside & (
                    jnp.log(jax.random.uniform(k_acc5, (n_chains,)))
                    < dlik + dprior + n_anc * jnp.log(f)
                )
                ages = jnp.where(take[:, None], prop_ages, ages)
                log_cr = jnp.where(take, new_cr2, log_cr)
                lnl = jnp.where(take, prop_lnl, lnl)

            # Conjugate Gibbs update of Ne: Ne | ages ~ InvGamma(a0 + n - 1,
            # b0 + A).
            if sample_ne:
                area = batched_area(ages)
                shape_post = ne_a0 + (n_leaves - 1)
                gamma_draw = jax.random.gamma(
                    k_ne, shape_post, shape=(n_chains,)
                )
                ne_vec = (ne_b0 + area) / gamma_draw

            return (
                (ages, log_rates, log_cr, ne_vec, lnl, acc_slide, acc_root,
                 acc_rate, acc_cr, log_tune),
                (ages, log_rates, log_cr, ne_vec, lnl),
            )

        keys = jax.random.split(key, n_generations)
        log_tune0 = jnp.full((n_chains,), jnp.log(root_tuning))
        zero = jnp.zeros((), jnp.int32)
        (
            (_, _, _, _, _, acc_slide, acc_root, acc_rate, acc_cr, _),
            traces,
        ) = jax.lax.scan(
            gen,
            (ages, log_rates, log_cr, ne_vec, lnl, zero, zero, zero, zero,
             log_tune0),
            (jnp.arange(n_generations), keys),
        )
        trace_ages, trace_rates, trace_cr, trace_ne, trace_lnl = traces
        return (trace_ages, trace_rates, trace_cr, trace_ne, trace_lnl,
                acc_slide, acc_root, acc_rate, acc_cr)

    log_rates0 = np.zeros((n_chains, n_all), np.float32)
    if relaxed:
        log_rates0[:, :-1] = (
            rng.normal(-0.5 * sd2, relaxed_sd, size=(n_chains, n_all - 1))
        ).astype(np.float32)
    log_cr0 = np.full((n_chains,), log_clock_rate0, np.float32)
    ne_init = np.full((n_chains,), ne0, np.float32)
    if sample_ne:
        # Seed Ne at the conjugate posterior mean of the starting trees.
        a_start = np.asarray(
            jax.vmap(lambda a: coalescent_area(a, n_leaves))(
                jnp.asarray(ages0)
            )
        )
        ne_init = (
            (ne_b0 + a_start) / max(ne_a0 + (n_leaves - 1) - 1.0, 1.0)
        ).astype(np.float32)
    ages_dev = jnp.asarray(ages0)
    rates_dev = jnp.asarray(log_rates0)
    cr_dev = jnp.asarray(log_cr0)
    ne_dev = jnp.asarray(ne_init)
    if mesh is not None:
        # Chains are independent: shard the chain axis over the mesh's
        # 'tree' axis (pure data parallelism, results bit-identical).
        from jax.sharding import NamedSharding, PartitionSpec

        from trex_tpu.parallel.mesh import TREE_AXIS

        chain_sharding = NamedSharding(mesh, PartitionSpec(TREE_AXIS))
        ages_dev = jax.device_put(
            ages_dev, NamedSharding(mesh, PartitionSpec(TREE_AXIS, None))
        )
        rates_dev = jax.device_put(
            rates_dev, NamedSharding(mesh, PartitionSpec(TREE_AXIS, None))
        )
        cr_dev = jax.device_put(cr_dev, chain_sharding)
        ne_dev = jax.device_put(ne_dev, chain_sharding)
    (
        trace_ages, trace_rates, trace_cr, trace_ne, trace_lnl,
        acc_slide, acc_root, acc_rate, acc_cr,
    ) = jax.device_get(run(key, ages_dev, rates_dev, cr_dev, ne_dev))

    # --- summaries -----------------------------------------------------------
    keep = np.arange(n_burnin, n_generations, sample_every)
    sample_ages = np.asarray(trace_ages)[keep].reshape(-1, n_all)
    sample_lnl = np.asarray(trace_lnl)[keep].reshape(-1)
    mean_ages = sample_ages.mean(axis=0)
    lo = np.percentile(sample_ages, 2.5, axis=0)
    hi = np.percentile(sample_ages, 97.5, axis=0)

    from trex_tpu.io import save_newick
    from trex_tpu.ops.clock import ages_to_lengths as a2l
    from trex_tpu.search.mcmc import effective_sample_size

    mean_lengths = np.asarray(
        a2l(topology, jnp.asarray(mean_ages.astype(np.float32)))
    )
    newick = save_newick(
        topology, leaf_names, branch_lengths=np.clip(mean_lengths, 0, None)
    )
    root_trace = np.asarray(trace_ages)[n_burnin:, 0, -1]
    sample_rates = (
        np.exp(np.asarray(trace_rates)[keep].reshape(-1, n_all))
        if relaxed
        else None
    )
    sample_clock_rate = (
        np.exp(np.asarray(trace_cr)[keep].reshape(-1)) if calibrated else None
    )
    sample_ne_arr = (
        np.asarray(trace_ne)[keep].reshape(-1) if sample_ne else None
    )
    return DatingResult(
        sample_ages=sample_ages,
        sample_lnl=sample_lnl,
        mean_ages=mean_ages,
        age_hpd=np.stack([lo, hi], axis=1),
        ess_root_age=effective_sample_size(root_trace),
        acceptance={
            "slide": float(acc_slide)
            / max((n_generations * n_chains), 1),
            # Root moves are counted post burn-in only (the step size
            # adapts during burn-in).
            "root": float(acc_root)
            / max((n_generations - n_burnin) * n_chains, 1),
            **(
                {"rate": float(acc_rate) / max(n_generations * n_chains, 1)}
                if relaxed
                else {}
            ),
            **(
                {
                    "clock_rate": float(acc_cr)
                    / max(n_generations * n_chains, 1)
                }
                if calibrated
                else {}
            ),
        },
        newick=newick,
        generations=n_generations,
        sample_rates=sample_rates,
        sample_clock_rate=sample_clock_rate,
        sample_ne=sample_ne_arr,
    )
