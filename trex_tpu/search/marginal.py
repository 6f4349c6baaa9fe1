"""Stepping-stone marginal likelihood (Bayes-factor model comparison).

Xie et al. 2011 (Syst. Biol. 60:150): run power posteriors
``prior x likelihood^beta_k`` along a ladder ``beta_k = (k/K)^(1/alpha)``
(alpha = 0.3 concentrates rungs near the prior, where the integrand
varies fastest) and estimate each ratio

    r_k = Z(beta_{k+1}) / Z(beta_k) = E_{beta_k}[ L^(beta_{k+1} - beta_k) ]

by importance sampling from the rung's own samples; the log marginal
likelihood is the sum of log r_k. Fixed topology, branch-length
multiplier moves only.

Device shape: ALL rungs are rows of one vmapped chain batch, and the whole
ladder — every rung, every generation — runs as ONE jitted ``lax.scan``
(zero host round trips). This is the same trick as ``search.dating``:
what MrBayes runs as K sequential chains is here a single device batch.

Validation (tests/test_marginal.py): the 2-taxon JC marginal likelihood
has a 1D quadrature form (the likelihood depends only on the root-path
sum s, whose prior is Gamma(2, m)); the stepping-stone estimate matches
it to MC error. Bayes factors then prefer the true model on simulated
data.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.topology import Topology


def stepping_stone(
    key: jax.Array,
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    n_rungs: int = 32,
    n_generations: int = 3000,
    burnin_frac: float = 0.3,
    alpha: float = 0.3,
    brlen_prior_mean: float = 0.1,
    tuning: float = 1.4,
    moves_per_generation: int = 2,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    sample_model: bool = False,
    model_tuning: float = 200.0,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    mesh=None,
) -> dict:
    """Log marginal likelihood of (model, fixed ``topology``).

    ``mesh``: optional ``jax.sharding.Mesh`` with a 'tree' axis — the rung
    batch (the power-posterior ladder, pure data parallelism: every rung's
    chain is independent) shards over it via input shardings that jit/GSPMD
    propagates through the whole single-scan sampler, the
    ``search.dating`` pattern. ``n_rungs`` must divide by the tree axis
    size. Traces are bit-identical to the unsharded run
    (tests/test_sharding.py).

    With ``sample_model`` the GTR exchangeability/frequency simplices are
    INTEGRATED over their flat Dirichlet(1) priors alongside the branch
    lengths (per-rung Dirichlet-centered moves, prior unheated) — required
    for honest Bayes factors between substitution models; with fixed
    ``rates``/``freqs`` the result is the marginal conditional on those
    parameters (fine for comparing topologies or clocks under one model,
    but it awards complex models no Occam penalty).

    Returns dict with ``log_marginal``, per-rung ``log_ratios``, ``betas``,
    ``acceptance``, and ``ess_min`` (worst per-rung ESS of the power term).
    """
    from trex_tpu.ops.likelihood import (
        _per_site_log_likelihood,
        discrete_gamma_rates,
        gtr_eigensystem,
        gtr_transition,
        per_site_log_likelihood,
    )
    from trex_tpu.search.mcmc import (
        _dirichlet_logpdf,
        _pairs_to_matrix,
        effective_sample_size,
    )

    n_all = topology.n_all
    q = n_states
    prior_rate = 1.0 / brlen_prior_mean
    children = jnp.asarray(np.asarray(topology.children))
    leaf_sequences = jnp.asarray(leaf_sequences)
    weights = None if site_weights is None else jnp.asarray(site_weights)

    if sample_model:
        def lnl_one(lengths, rates_vec, freqs_row):
            eigvals, left, right = gtr_eigensystem(
                _pairs_to_matrix(rates_vec, q), freqs_row
            )

            def per_site_at(scale):
                pmats = jax.vmap(
                    lambda t: gtr_transition(t, eigvals, left, right)
                )(lengths * scale)
                return _per_site_log_likelihood(
                    Topology(
                        children=children,
                        parents=jnp.zeros((n_all,), jnp.int32),
                    ),
                    lengths, leaf_sequences, n_states,
                    sequences_are_masks=sequences_are_masks,
                    transition_matrices=pmats, root_prior=freqs_row,
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
    else:
        def lnl_one(lengths, rates_vec=None, freqs_row=None):
            per_site = per_site_log_likelihood(
                Topology(
                    children=children, parents=jnp.zeros((n_all,), jnp.int32)
                ),
                lengths, leaf_sequences, n_states,
                rates=rates, freqs=freqs,
                gamma_shape=gamma_shape, n_categories=n_categories,
                sequences_are_masks=sequences_are_masks,
            )
            if weights is not None:
                per_site = per_site * weights
            return jnp.sum(per_site)

    batched_lnl = jax.vmap(lnl_one)

    # Ladder: beta_0 = 0 (pure prior) .. beta_{K-1} just below 1; the
    # K ratios step to beta_K = 1.
    k = np.arange(n_rungs)
    betas = (k / n_rungs) ** (1.0 / alpha)
    betas_up = ((k + 1) / n_rungs) ** (1.0 / alpha)
    beta = jnp.asarray(betas.astype(np.float32))

    seeds = np.asarray(jax.random.key_data(key)).ravel()
    rng = np.random.default_rng(int(seeds[-1]))
    lengths0 = rng.exponential(
        brlen_prior_mean, size=(n_rungs, n_all)
    ).astype(np.float32)
    lengths0[:, -1] = 0.0
    n_pairs = q * (q - 1) // 2
    rates0 = rng.dirichlet(
        np.ones(n_pairs), size=n_rungs
    ).astype(np.float32)
    freqs0 = rng.dirichlet(np.ones(q), size=n_rungs).astype(np.float32)

    total_steps = n_generations * moves_per_generation

    @jax.jit
    def run(key, lengths, rates_v, freqs_v):
        lnl = batched_lnl(lengths, rates_v, freqs_v)
        rows = jnp.arange(n_rungs)

        def simplex_move(x, lnl, eval_prop, k):
            """Power-posterior Dirichlet-centered move on a simplex batch."""
            k_prop, k_acc = jax.random.split(k)
            prop = jax.random.dirichlet(k_prop, model_tuning * x)
            lq_fwd = jax.vmap(_dirichlet_logpdf)(prop, model_tuning * x)
            lq_rev = jax.vmap(_dirichlet_logpdf)(x, model_tuning * prop)
            prop_lnl = eval_prop(prop)
            inside = jnp.min(prop, axis=-1) >= 1e-5
            log_alpha = beta * (prop_lnl - lnl) + lq_rev - lq_fwd
            take = inside & (
                jnp.log(jax.random.uniform(k_acc, (n_rungs,))) < log_alpha
            )
            return (
                jnp.where(take[:, None], prop, x),
                jnp.where(take, prop_lnl, lnl),
            )

        def step(carry, k):
            lengths, rates_v, freqs_v, lnl, accepted = carry
            k_node, k_mult, k_acc, k_r, k_f = jax.random.split(k, 5)
            node = jax.random.randint(k_node, (n_rungs,), 0, n_all - 1)
            factor = jnp.exp(
                tuning * (jax.random.uniform(k_mult, (n_rungs,)) - 0.5)
            )
            old = lengths[rows, node]
            new = old * factor
            prop = lengths.at[rows, node].set(new)
            prop_lnl = batched_lnl(prop, rates_v, freqs_v)
            # Power posterior: prior UNHEATED, likelihood^beta.
            log_alpha = (
                beta * (prop_lnl - lnl)
                - prior_rate * (new - old)
                + jnp.log(factor)
            )
            take = jnp.log(jax.random.uniform(k_acc, (n_rungs,))) < log_alpha
            lengths = jnp.where(take[:, None], prop, lengths)
            lnl = jnp.where(take, prop_lnl, lnl)
            accepted = accepted + take.sum()
            if sample_model:
                rates_v, lnl = simplex_move(
                    rates_v, lnl,
                    lambda rv: batched_lnl(lengths, rv, freqs_v), k_r,
                )
                freqs_v, lnl = simplex_move(
                    freqs_v, lnl,
                    lambda fv: batched_lnl(lengths, rates_v, fv), k_f,
                )
            return (lengths, rates_v, freqs_v, lnl, accepted), lnl

        keys = jax.random.split(key, total_steps)
        (lengths, rates_v, freqs_v, lnl, accepted), trace = jax.lax.scan(
            step, (lengths, rates_v, freqs_v, lnl, jnp.zeros((), jnp.int32)),
            keys,
        )
        return trace, accepted

    lengths_dev = jnp.asarray(lengths0)
    rates_dev = jnp.asarray(rates0)
    freqs_dev = jnp.asarray(freqs0)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from trex_tpu.parallel.mesh import TREE_AXIS

        n_tree = mesh.shape[TREE_AXIS]
        if n_rungs % n_tree != 0:
            raise ValueError(
                f"n_rungs = {n_rungs} must be divisible by the mesh tree "
                f"axis size ({n_tree})"
            )
        rung_s = NamedSharding(mesh, PartitionSpec(TREE_AXIS))
        lengths_dev = jax.device_put(lengths_dev, rung_s)
        rates_dev = jax.device_put(rates_dev, rung_s)
        freqs_dev = jax.device_put(freqs_dev, rung_s)
    trace, accepted = jax.device_get(
        run(key, lengths_dev, rates_dev, freqs_dev)
    )
    trace = np.asarray(trace)  # (total_steps, n_rungs)
    n_burn = int(burnin_frac * total_steps)
    samples = trace[n_burn:]  # (S, K)

    # log r_k = logmeanexp( (beta_{k+1} - beta_k) * lnl_k ).
    deltas = (betas_up - betas)[None, :]
    terms = deltas * samples
    m = terms.max(axis=0)
    log_ratios = m + np.log(np.exp(terms - m).mean(axis=0))
    ess = [
        effective_sample_size(terms[:, j])
        for j in range(n_rungs)
    ]
    return {
        "log_marginal": float(log_ratios.sum()),
        "log_ratios": log_ratios,
        "betas": betas,
        "acceptance": float(accepted) / (total_steps * n_rungs),
        "ess_min": float(min(ess)),
    }
