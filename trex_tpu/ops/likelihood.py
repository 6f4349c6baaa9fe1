"""Felsenstein pruning: phylogenetic likelihood, differentiable in branch lengths.

A second scoring model beyond parsimony (the reference has none; cf.
TreeFlow-style differentiable phylogenetics): per-site likelihood of the
alignment under a continuous-time substitution model, computed by the pruning
recursion over the same (nodes, states, sites) layout and ancestor-scan
schedule as the Sankoff DP — so it jits, vmaps over candidate batches, and
shards over ('tree', 'site') identically.

Provided models: Jukes-Cantor (JC69) generalized to Q states and reversible
GTR (arbitrary symmetric exchangeabilities + stationary frequencies, via the
eigendecomposition of the pi-symmetrized generator). JC69's transition
matrix has the closed form

    P(t)[i,j] = 1/Q + (1 - 1/Q) exp(-Q/(Q-1) t)     if i == j
                1/Q - (1/Q)     exp(-Q/(Q-1) t)     otherwise,

smooth in t, so ``jax.grad`` w.r.t. branch lengths drives ML branch-length
optimization. Underflow is handled with per-node max-scaling accumulated in
log space (standard pruning practice).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from trex_tpu.topology import Topology


def jc69_transition(branch_length: jax.Array, n_states: int) -> jax.Array:
    """(Q, Q) JC69 transition matrix for one branch length (scalar)."""
    q = n_states
    decay = jnp.exp(-q / (q - 1.0) * branch_length)
    same = 1.0 / q + (1.0 - 1.0 / q) * decay
    diff = 1.0 / q - (1.0 / q) * decay
    return jnp.full((q, q), diff) + (same - diff) * jnp.eye(q)


def gtr_generator(rates: jax.Array, freqs: jax.Array) -> jax.Array:
    """Normalized reversible (GTR) rate matrix Q.

    Off-diagonals ``Q_ij = s_ij * pi_j`` from symmetric exchangeabilities,
    diagonal set so rows sum to 0, scaled to one expected substitution per
    unit branch length. ``P(t) = expm(Q t)`` — the AD-robust transition path
    (``jnp.linalg.eigh``'s gradient blows up when eigenvalues collide, which
    free rate/frequency optimization routinely drives them to; ``expm``'s
    does not).
    """
    sym = (rates + rates.T) / 2.0
    gen = sym * freqs[None, :]
    gen = gen - jnp.diag(jnp.diag(gen))
    gen = gen - jnp.diag(jnp.sum(gen, axis=1))
    scale = -jnp.sum(freqs * jnp.diag(gen))
    return gen / scale


def gtr_eigensystem(
    rates: jax.Array, freqs: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Eigensystem of a normalized reversible (GTR) rate matrix.

    Args:
        rates: (Q, Q) symmetric exchangeabilities (diagonal ignored).
        freqs: (Q,) stationary distribution.

    Returns:
        (eigenvalues (Q,), left (Q,Q), right (Q,Q)) such that
        ``P(t) = right @ diag(exp(eigenvalues * t)) @ left``. The rate matrix
        is normalized to one expected substitution per unit branch length.
        Differentiable (eigh of the symmetrized generator).
    """
    sym = (rates + rates.T) / 2.0
    gen = sym * freqs[None, :]
    gen = gen - jnp.diag(jnp.diag(gen))
    gen = gen - jnp.diag(jnp.sum(gen, axis=1))
    # Normalize expected rate: -sum_i pi_i * Q_ii == 1.
    scale = -jnp.sum(freqs * jnp.diag(gen))
    gen = gen / scale
    sqrt_pi = jnp.sqrt(freqs)
    balanced = sqrt_pi[:, None] * gen / sqrt_pi[None, :]  # symmetric
    eigvals, eigvecs = jnp.linalg.eigh((balanced + balanced.T) / 2.0)
    right = eigvecs / sqrt_pi[:, None]
    left = eigvecs.T * sqrt_pi[None, :]
    return eigvals, left, right


def gtr_transition(
    branch_length: jax.Array,
    eigvals: jax.Array,
    left: jax.Array,
    right: jax.Array,
) -> jax.Array:
    """(Q, Q) transition matrix from a precomputed GTR eigensystem.

    The reconstruction matmul runs at HIGHEST precision: a reduced-precision
    default (TF32 on a GPU) perturbs small transition probabilities by
    several percent, which is likelihood-visible (~1% of the total lnL).
    """
    p = jnp.matmul(
        right * jnp.exp(eigvals * branch_length)[None, :],
        left,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.clip(p, 0.0, 1.0)


def tree_log_likelihood(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    site_mask: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Log-likelihood of the alignment given topology + branch lengths.

    Args:
        branch_lengths: (n_all,) per-node branch length ABOVE each node (the
            root entry is ignored). Must be positive.
        leaf_sequences: (n_leaves, L) int states, or int32 state-set
            bitmasks with ``sequences_are_masks=True`` (IUPAC ambiguity /
            gaps): the tip partial is 1 at every allowed state, the standard
            missing-data treatment — the likelihood sums over all
            resolutions of the ambiguity.
        rates / freqs: optional GTR exchangeabilities (Q, Q) and stationary
            frequencies (Q,); both None -> JC69 with a uniform prior.

    Returns:
        Scalar log-likelihood (f32), differentiable w.r.t. branch_lengths
        (and rates/freqs when given).
    """
    per_site = _per_site_log_likelihood(
        topology, branch_lengths, leaf_sequences, n_states,
        rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
    )
    if site_mask is not None:
        per_site = per_site * site_mask.astype(per_site.dtype)
    return jnp.sum(per_site)


batched_tree_log_likelihood = jax.vmap(
    tree_log_likelihood, in_axes=(0, 0, None, None)
)


def batched_log_likelihood(
    topologies: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    shared_transition: jax.Array | None = None,
    root_prior: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """(B,) log-likelihoods of a candidate batch (the batched ML scorer).

    The scorer of the enumerating ML climbs, the ML bootstrap and the
    mesh-sharded ranking. ``shared_transition`` (Q, Q) serves every branch
    of every tree (ranking branches share one fixed length, so one matrix
    covers the batch without materializing (B, n_all, Q, Q)), with
    ``root_prior`` (default uniform); without it each branch gets JC69 at
    its own length. ``site_weights`` (L,) multiply the per-site terms
    (compressed patterns, bootstrap).
    """
    q = n_states
    pmats = prior = None
    if shared_transition is not None:
        n_all = topologies.children.shape[-2] * 2 + 1
        pmats = jnp.broadcast_to(shared_transition, (n_all, q, q))
        prior = jnp.full((q,), 1.0 / q) if root_prior is None else root_prior

    def one(topo, lengths):
        per_site = _per_site_log_likelihood(
            topo, lengths, leaf_sequences, q,
            sequences_are_masks=sequences_are_masks,
            transition_matrices=pmats, root_prior=prior,
        )
        if site_weights is not None:
            per_site = per_site * site_weights.astype(per_site.dtype)
        return jnp.sum(per_site)

    return jax.vmap(one)(topologies, branch_lengths)


def discrete_gamma_rates(shape: float | jax.Array, n_categories: int) -> jax.Array:
    """Mean rates of ``n_categories`` equal-probability Gamma(shape, 1/shape)
    categories (Yang 1994 quantile method), normalized to mean 1.

    Quantile boundaries come from the Wilson-Hilferty chi-square approximation
    (smooth in ``shape``, so the whole +Gamma likelihood stays differentiable
    w.r.t. the shape parameter); category means use the midpoint rate of each
    probability slice.
    """
    k = n_categories
    probs = (jnp.arange(k, dtype=jnp.float32) + 0.5) / k  # slice midpoints
    # Wilson-Hilferty: chi2_q(p, df) ~ df * (1 - 2/(9df) + z_p sqrt(2/(9df)))^3
    # with Gamma(shape, scale=1/shape) == chi2(2*shape) / (2*shape).
    df = 2.0 * shape
    z = jnp.sqrt(2.0) * jax.scipy.special.erfinv(2.0 * probs - 1.0)
    chi2 = df * (1.0 - 2.0 / (9.0 * df) + z * jnp.sqrt(2.0 / (9.0 * df))) ** 3
    rates = jnp.maximum(chi2 / df, 1e-6)
    return rates / jnp.mean(rates)


def tree_log_likelihood_gamma(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    gamma_shape: float | jax.Array = 1.0,
    n_categories: int = 4,
    site_mask: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Log-likelihood under discrete-Gamma rate heterogeneity (+G).

    Each site's likelihood is the equal-weight mixture over ``n_categories``
    Gamma rate categories; category r scales every branch length by its mean
    rate. Differentiable in branch lengths AND ``gamma_shape``.
    """
    cat_rates = discrete_gamma_rates(gamma_shape, n_categories)

    def per_site_ll(rate):
        # Recover per-site log-liks by running the pruning with scaled
        # branches; tree_log_likelihood sums over sites, so compute the
        # per-site vector via the same recursion core.
        return _per_site_log_likelihood(
            topology, branch_lengths * rate, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )

    all_cat = jax.vmap(per_site_ll)(cat_rates)  # (K, L)
    mixed = jax.nn.logsumexp(all_cat, axis=0) - jnp.log(n_categories)  # (L,)
    if site_mask is not None:
        mixed = mixed * site_mask.astype(mixed.dtype)
    return jnp.sum(mixed)


def tree_log_likelihood_freerate(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    category_rates: jax.Array,
    category_weights: jax.Array,
    site_mask: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """FreeRate (+R) heterogeneity: a K-category rate mixture where both the
    rates and the mixture weights are free parameters (no Gamma shape
    constraint — strictly more expressive than +G at the same K).

    For identifiability the caller should normalize ``sum_k w_k r_k == 1``
    (mean rate 1; the overall scale lives in the branch lengths) —
    ``optimize_model`` does. Differentiable in everything.
    """

    def per_site_ll(rate):
        return _per_site_log_likelihood(
            topology, branch_lengths * rate, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )

    all_cat = jax.vmap(per_site_ll)(category_rates)  # (K, L)
    log_w = jnp.log(jnp.maximum(category_weights, 1e-30))[:, None]
    mixed = jax.nn.logsumexp(all_cat + log_w, axis=0)  # (L,)
    if site_mask is not None:
        mixed = mixed * site_mask.astype(mixed.dtype)
    return jnp.sum(mixed)


def tree_log_likelihood_gamma_invariant(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    gamma_shape: float | jax.Array = 1.0,
    p_invariant: float | jax.Array = 0.0,
    n_categories: int = 4,
    site_mask: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """+G+I model: Gamma rate mixture plus an invariant-sites category.

    The rate-0 category's per-site likelihood has the closed form
    ``sum_s prior[s] * [every leaf allows state s]`` — the prior mass of the
    shared state for constant sites, (floored) 0 otherwise. It is computed
    directly rather than by running the pruning with zero branch lengths:
    zero lengths make entire partial columns exactly 0, and the per-node
    rescaling's ``log(scale)`` backward then multiplies a unit cotangent by
    1/floor = 1e30, overflowing f32 gradients to NaN. Differentiable in
    branch lengths, ``gamma_shape``, ``p_invariant``, and the model.
    """
    cat_rates = discrete_gamma_rates(gamma_shape, n_categories)

    def per_site_ll(rate):
        return _per_site_log_likelihood(
            topology, branch_lengths * rate, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )

    all_cat = jax.vmap(per_site_ll)(cat_rates)  # (K, L)
    q = n_states
    prior = freqs if freqs is not None else jnp.full((q,), 1.0 / q)
    states = jnp.arange(q, dtype=jnp.int32)
    leaves = leaf_sequences.astype(jnp.int32)
    if sequences_are_masks:
        allows = ((leaves[:, None, :] >> states[None, :, None]) & 1) == 1
    else:
        allows = (leaves[:, None, :] == states[None, :, None]) | (
            leaves[:, None, :] < 0
        )
    shared = jnp.all(allows, axis=0)  # (Q, L): state s possible at EVERY leaf
    inv_lik = jnp.sum(prior[:, None] * shared.astype(prior.dtype), axis=0)
    inv_ll = jnp.log(jnp.maximum(inv_lik, 1e-30))  # (L,)
    gamma_mixed = jax.nn.logsumexp(all_cat, axis=0) - jnp.log(n_categories)
    p_inv = jnp.clip(p_invariant, 1e-9, 1.0 - 1e-9)
    mixed = jnp.logaddexp(
        jnp.log(p_inv) + inv_ll, jnp.log1p(-p_inv) + gamma_mixed
    )
    if site_mask is not None:
        mixed = mixed * site_mask.astype(mixed.dtype)
    return jnp.sum(mixed)


def per_site_log_likelihood(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    gamma_shape: float | jax.Array | None = None,
    n_categories: int = 4,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """(L,) per-site log-likelihoods (public surface for RELL resampling,
    SH-aLRT supports, and site-wise model comparison). With ``gamma_shape``,
    each site's value is the +G category mixture."""
    if gamma_shape is None:
        return _per_site_log_likelihood(
            topology, branch_lengths, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )
    cat_rates = discrete_gamma_rates(gamma_shape, n_categories)
    all_cat = jax.vmap(
        lambda r: _per_site_log_likelihood(
            topology, branch_lengths * r, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )
    )(cat_rates)
    return jax.nn.logsumexp(all_cat, axis=0) - jnp.log(n_categories)


def highest_matmul_precision(fn):
    """Trace ``fn`` under f32 matmul precision.

    On a GPU the default float32 matmul precision may run in TF32, which
    keeps about three decimal digits; the likelihood stack's small Q x Q
    transition/message contractions lose several percent on individual
    probabilities that way (~1% of total lnL — model-selection visible).
    "highest" keeps full float32. Scoped here rather than set globally so
    the soft-cost gram matmuls keep the fast default.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@highest_matmul_precision
def _per_site_log_likelihood(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    sequences_are_masks: bool = False,
    transition_matrices: jax.Array | None = None,
    root_prior: jax.Array | None = None,
) -> jax.Array:
    """(L,) per-site log-likelihoods (same recursion as tree_log_likelihood).

    ``transition_matrices`` ((n_all, Q, Q), one P per branch) overrides the
    model arguments entirely (then ``root_prior`` must be given) — the path
    for callers that precompute transitions, e.g. per-chain sampled-model
    MCMC where the eigensystem is built once per proposal.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]
    q = n_states

    pmats_all = None
    if transition_matrices is not None:
        if root_prior is None:
            raise ValueError("transition_matrices requires root_prior")
        pmats_all = transition_matrices
        transition = None
    elif rates is not None or freqs is not None:
        if freqs is None:
            freqs = jnp.full((q,), 1.0 / q)
        if rates is None:
            rates = jnp.ones((q, q))
        gen = gtr_generator(rates, freqs)
        # expm, not the eigensystem: eigh's gradient is undefined at
        # degenerate spectra, which rate/frequency optimization hits.
        transition = lambda t: jax.scipy.linalg.expm(gen * t)
        root_prior = freqs
    else:
        transition = lambda t: jc69_transition(t, q)
        root_prior = jnp.full((q,), 1.0 / q)

    partials0 = jnp.zeros((n_all, q, length))
    states = jnp.arange(q, dtype=jnp.int32)
    if sequences_are_masks:
        # Tip partial = 1 at every allowed state (ambiguity/gap support).
        leaf_onehot = (
            (leaf_sequences.astype(jnp.int32)[:, None, :] >> states[None, :, None]) & 1
        ).astype(jnp.float32)
    else:
        # Negative states mean "missing" (e.g. an ambiguous codon): the tip
        # partial is 1 everywhere, marginalizing the leaf out.
        leaves = leaf_sequences.astype(jnp.int32)[:, None, :]
        leaf_onehot = (
            (leaves == states[None, :, None]) | (leaves < 0)
        ).astype(jnp.float32)
    partials0 = partials0.at[:n_leaves].set(leaf_onehot)
    partials0 = partials0.at[n_leaves:].set(1.0)
    logscale0 = jnp.zeros((length,))

    def up(carry, inputs):
        partials, logscale = carry
        anc_offset, child_pair = inputs
        child_partials = partials[child_pair]
        if pmats_all is not None:
            child_mats = pmats_all[child_pair]
        else:
            child_mats = jax.vmap(transition)(branch_lengths[child_pair])
        messages = jnp.einsum(
            "cij,cjl->cil", child_mats, child_partials,
            preferred_element_type=jnp.float32,
        )
        combined = messages[0] * messages[1]
        scale = jnp.maximum(jnp.max(combined, axis=0), 1e-30)
        combined = combined / scale
        partials = jax.lax.dynamic_update_slice(
            partials, combined[None], (n_leaves + anc_offset, 0, 0)
        )
        return (partials, logscale + jnp.log(scale)), None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    (partials, logscale), _ = jax.lax.scan(
        up, (partials0, logscale0), (offsets, topology.children)
    )
    site_lik = jnp.sum(root_prior[:, None] * partials[-1], axis=0)
    # Floor before the log (same 1e-30 as the fused kernel): a zero-probability
    # site (e.g. a variable site in the +I model's rate-0 category) must yield
    # a very negative but FINITE log-lik, and a zero gradient rather than the
    # 0/0 = NaN that d(log 0)/d(freqs) produces.
    return jnp.log(jnp.maximum(site_lik, 1e-30)) + logscale


def optimize_branch_lengths(
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 500,
    sequences_are_masks: bool = False,
    site_weights: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """ML branch lengths on a fixed topology by gradient ascent.

    Parameterizes lengths as softplus(theta) for positivity; the whole loop
    is one jitted scan. Returns (branch_lengths (n_all,), loss curve).
    """
    n_all = topology.n_all

    def lengths(theta):
        return jax.nn.softplus(theta)

    def loss_fn(theta):
        return -tree_log_likelihood(
            topology, lengths(theta), leaf_sequences, n_states,
            site_mask=site_weights, rates=rates, freqs=freqs,
            sequences_are_masks=sequences_are_masks,
        )

    theta0 = jnp.full(
        (n_all,), jnp.log(jnp.expm1(jnp.asarray(init_length)))
    )
    optimizer = optax.adam(learning_rate)

    @jax.jit
    def run(theta):
        opt_state = optimizer.init(theta)

        def step(carry, _):
            th, st = carry
            loss, grads = jax.value_and_grad(loss_fn)(th)
            updates, st = optimizer.update(grads, st, th)
            th = optax.apply_updates(th, updates)
            return (th, st), loss

        (theta_f, _), losses = jax.lax.scan(
            step, (theta, opt_state), None, length=n_iterations
        )
        return theta_f, losses

    theta_f, losses = run(theta0)
    return lengths(theta_f), losses


def _parse_model_string(model: str) -> dict:
    """Parse "<base>[+g][+i] | <base>+rK" into a spec.

    Bases: jc | k80 | hky | f81 | tn93 | gtr | empirical. The named
    nucleotide models are the classic constrained GTR submodels (DNA order
    ACGT; transitions A<->G and C<->T): K80 = one kappa, equal frequencies;
    HKY85 = kappa + free frequencies; F81 = equal exchangeabilities + free
    frequencies; TN93 = separate purine/pyrimidine transition rates + free
    frequencies. They require n_states == 4.
    """
    import re as _re

    m = _re.fullmatch(
        r"(jc|k80|hky|f81|tn93|gtr|empirical)(?:(\+g)?(\+i)?|(\+r([2-8])))?",
        model.lower(),
    )
    if not m:
        raise ValueError(f"unknown model {model!r}")
    base = m.group(1)
    return {
        "model": model.lower(),
        "base": base,
        "use_gtr": base == "gtr",
        "use_fixed": base == "empirical",
        "use_kappa": base in ("k80", "hky"),
        "use_tn": base == "tn93",
        "free_freqs": base in ("hky", "f81", "tn93"),
        "use_gamma": bool(m.group(2)),
        "use_inv": bool(m.group(3)),
        "n_free": int(m.group(5)) if m.group(5) else 0,
    }


def _init_model_params(spec: dict, q: int, fixed_freqs=None) -> dict:
    """Initial unconstrained substitution-model parameters (no lengths)."""
    params: dict = {}
    if spec["use_gtr"]:
        n_pairs = q * (q - 1) // 2
        # Slightly off-uniform so the eigh gradient is defined at step 0.
        params["theta_rates"] = 0.01 * jnp.arange(1, n_pairs, dtype=jnp.float32)
        params["logit_freqs"] = jnp.zeros((q,))
    if spec["use_fixed"] and fixed_freqs is None:
        params["logit_freqs"] = jnp.zeros((q,))
    if spec["use_kappa"] or spec["use_tn"] or spec["base"] == "f81":
        if q != 4:
            raise ValueError(
                f"model {spec['model']!r} is a nucleotide model (needs "
                f"n_states == 4, got {q})"
            )
    if spec["use_kappa"]:
        params["theta_kappa"] = jnp.asarray(jnp.log(jnp.expm1(2.0)))
    if spec["use_tn"]:
        params["theta_kappa_r"] = jnp.asarray(jnp.log(jnp.expm1(2.0)))
        params["theta_kappa_y"] = jnp.asarray(jnp.log(jnp.expm1(2.0)))
    if spec["free_freqs"]:
        params["logit_freqs"] = jnp.zeros((q,))
    if spec["use_gamma"]:
        params["theta_shape"] = jnp.asarray(jnp.log(jnp.expm1(1.0)))
    if spec["use_inv"]:
        params["logit_inv"] = jnp.asarray(-2.0)
    if spec["n_free"]:
        # Spread initial rates across a decade so categories differentiate.
        init_rates = jnp.geomspace(0.2, 3.0, spec["n_free"])
        params["theta_cat_rates"] = jnp.log(jnp.expm1(init_rates))
        params["logit_cat_weights"] = jnp.zeros((spec["n_free"],))
    return params


def _build_model_params(
    spec: dict, params: dict, q: int, fixed_rates=None, fixed_freqs=None
) -> tuple[dict, jax.Array | None, jax.Array | None]:
    """Constrained substitution-model parameters from unconstrained ones."""
    out: dict = {}
    rates = freqs = None
    if spec["use_fixed"]:
        rates = fixed_rates
        freqs = (
            fixed_freqs
            if fixed_freqs is not None
            else jax.nn.softmax(params["logit_freqs"])
        )
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_gtr"]:
        pair_i, pair_j = jnp.triu_indices(q, k=1)
        pair_rates = jax.nn.softplus(params["theta_rates"])
        # Pin the last exchangeability to 1 (identifiability).
        pair_rates = jnp.concatenate(
            [pair_rates, jnp.ones((1,), pair_rates.dtype)]
        )
        rates = jnp.zeros((q, q))
        rates = rates.at[pair_i, pair_j].set(pair_rates)
        rates = rates + rates.T
        freqs = jax.nn.softmax(params["logit_freqs"])
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_kappa"] or spec["use_tn"] or spec["base"] == "f81":
        # Constrained GTR submodels, DNA order ACGT: transitions are
        # A<->G (0,2) and C<->T (1,3); transversions pinned at 1.
        if spec["use_tn"]:
            k_r = jax.nn.softplus(params["theta_kappa_r"])
            k_y = jax.nn.softplus(params["theta_kappa_y"])
            out["kappa_purine"] = k_r
            out["kappa_pyrimidine"] = k_y
        elif spec["use_kappa"]:
            k_r = k_y = jax.nn.softplus(params["theta_kappa"])
            out["kappa"] = k_r
        else:  # f81
            k_r = k_y = jnp.asarray(1.0)
        rates = jnp.ones((q, q)) - jnp.eye(q)
        rates = rates.at[0, 2].set(k_r).at[2, 0].set(k_r)
        rates = rates.at[1, 3].set(k_y).at[3, 1].set(k_y)
        freqs = (
            jax.nn.softmax(params["logit_freqs"])
            if spec["free_freqs"]
            else jnp.full((q,), 1.0 / q)
        )
        out["rates"] = rates
        out["freqs"] = freqs
    if spec["use_gamma"]:
        out["gamma_shape"] = jax.nn.softplus(params["theta_shape"])
    if spec["use_inv"]:
        out["p_invariant"] = jax.nn.sigmoid(params["logit_inv"])
    if spec["n_free"]:
        w = jax.nn.softmax(params["logit_cat_weights"])
        r = jax.nn.softplus(params["theta_cat_rates"])
        r = r / jnp.sum(w * r)  # mean rate 1 (scale lives in lengths)
        out["category_rates"] = r
        out["category_weights"] = w
    return out, rates, freqs


def _model_log_likelihood(
    spec: dict,
    built: dict,
    rates,
    freqs,
    topology: Topology,
    lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    site_mask,
    n_categories: int,
    sequences_are_masks: bool,
) -> jax.Array:
    """Dispatch the right likelihood variant for a parsed model spec."""
    common = dict(
        site_mask=site_mask,
        rates=rates,
        freqs=freqs,
        sequences_are_masks=sequences_are_masks,
    )
    if spec["n_free"]:
        return tree_log_likelihood_freerate(
            topology, lengths, leaf_sequences, n_states,
            built["category_rates"], built["category_weights"], **common,
        )
    if spec["use_inv"]:
        # "+i" without "+g": one rate-1 category plus the invariant class.
        return tree_log_likelihood_gamma_invariant(
            topology, lengths, leaf_sequences, n_states,
            gamma_shape=built.get("gamma_shape", 1.0),
            p_invariant=built["p_invariant"],
            n_categories=n_categories if spec["use_gamma"] else 1,
            **common,
        )
    if spec["use_gamma"]:
        return tree_log_likelihood_gamma(
            topology, lengths, leaf_sequences, n_states,
            gamma_shape=built["gamma_shape"],
            n_categories=n_categories, **common,
        )
    return tree_log_likelihood(
        topology, lengths, leaf_sequences, n_states, **common
    )


def optimize_model(
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    model: str = "gtr+g",
    n_categories: int = 4,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 800,
    sequences_are_masks: bool = False,
    site_weights: jax.Array | None = None,
    fixed_rates: jax.Array | None = None,
    fixed_freqs: jax.Array | None = None,
) -> tuple[dict[str, jax.Array], jax.Array]:
    """Joint ML estimation of branch lengths + substitution-model parameters.

    Everything is fit by gradient ascent on the log-likelihood in one jitted
    ``lax.scan`` — the same recipe as ``optimize_branch_lengths`` but over the
    full parameter pytree:

    - branch lengths: softplus-positive, one per node;
    - GTR exchangeabilities: softplus-positive distinct pairs, the last pair
      pinned to 1 for identifiability (rate-matrix scale lives in the branch
      lengths);
    - stationary frequencies: softmax over Q logits;
    - Gamma shape (``+g`` models): softplus-positive;
    - invariant fraction (``+i`` models): sigmoid in (0, 1).

    Args:
        model: "<base>[+g[+i] | +rK]" with base "jc", "gtr", or "empirical";
            "+g" discrete Gamma, "+g+i" adds invariant sites, "+rK" FreeRate
            with K in 2..8 categories (free rates AND weights, normalized to
            mean rate 1). Base "empirical" holds exchangeabilities fixed at
            ``fixed_rates`` (e.g. a PAML-format amino-acid matrix via
            ``io.parse_paml_rates``); frequencies come from ``fixed_freqs``
            when given, else are fit by ML (+F-style).

    Returns:
        (params, losses): ``params`` maps "branch_lengths" (n_all,), and for
        GTR models "rates" (Q, Q, symmetric, last pair 1.0) and "freqs"
        (Q,); plus "gamma_shape" / "p_invariant" / "category_rates" +
        "category_weights" when fit. ``losses`` is the negative-log-
        likelihood curve (``n_iterations + 1`` entries; the last is at
        the returned parameters).

    Note: GTR transition matrices go through ``jnp.linalg.eigh`` of the
    symmetrized generator; its gradient is undefined at exactly degenerate
    spectra (e.g. perfectly uniform JC-like rates), so GTR initialization
    perturbs the rates slightly off uniform.
    """
    spec = _parse_model_string(model)
    if spec["use_fixed"]:
        if fixed_rates is None:
            raise ValueError(
                "model 'empirical' needs fixed_rates (e.g. io.parse_paml_rates)"
            )
        fixed_rates = jnp.asarray(fixed_rates, jnp.float32)
        if fixed_freqs is not None:
            fixed_freqs = jnp.asarray(fixed_freqs, jnp.float32)
    q = n_states
    n_all = topology.n_all

    def build(params):
        out, rates, freqs = _build_model_params(
            spec, params, q, fixed_rates, fixed_freqs
        )
        out["branch_lengths"] = jax.nn.softplus(params["theta_len"])
        return out, rates, freqs

    def loss_fn(params):
        built, rates, freqs = build(params)
        return -_model_log_likelihood(
            spec, built, rates, freqs, topology, built["branch_lengths"],
            leaf_sequences, n_states, site_weights, n_categories,
            sequences_are_masks,
        )

    params0 = _init_model_params(spec, q, fixed_freqs)
    params0["theta_len"] = jnp.full(
        (n_all,), jnp.log(jnp.expm1(jnp.asarray(init_length)))
    )

    optimizer = optax.adam(learning_rate)

    @jax.jit
    def run(params):
        opt_state = optimizer.init(params)

        def step(carry, _):
            p, st = carry
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, st = optimizer.update(grads, st, p)
            p = optax.apply_updates(p, updates)
            return (p, st), loss

        (params_f, _), losses = jax.lax.scan(
            step, (params, opt_state), None, length=n_iterations
        )
        # Each scanned loss is taken before its update; close the curve
        # with the loss of the parameters actually returned.
        return params_f, jnp.append(losses, loss_fn(params_f))

    params_f, losses = run(params0)
    built, _, _ = build(params_f)
    return built, losses


def optimize_model_partitioned(
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    partition_ids: jax.Array,
    *,
    models: list[str] | tuple[str, ...],
    linked: str = "proportional",
    n_categories: int = 4,
    init_length: float = 0.1,
    learning_rate: float = 0.05,
    n_iterations: int = 800,
    sequences_are_masks: bool = False,
    site_weights: jax.Array | None = None,
    fixed_rates: jax.Array | None = None,
    fixed_freqs: jax.Array | None = None,
) -> tuple[dict, jax.Array]:
    """Partitioned ML: per-partition substitution models over one shared
    topology and one shared set of branch lengths.

    The standard multi-gene analysis (e.g. one GTR+G per gene): the total
    log-likelihood is the sum of per-partition log-likelihoods, each computed
    with its own model parameters. Branch lengths are shared; with
    ``linked="proportional"`` every partition p > 0 additionally gets a free
    positive rate multiplier m_p (partition 0 is pinned to 1 for
    identifiability), so faster-evolving genes stretch the same tree;
    ``linked="equal"`` pins all multipliers to 1. Everything is fit jointly
    by Adam in one jitted ``lax.scan``.

    Args:
        partition_ids: (L,) int array mapping each site (or compressed
            pattern) to its partition 0..P-1.
        models: one model string per partition (the ``optimize_model``
            grammar). 'empirical' partitions share ``fixed_rates``/``freqs``.

    Returns:
        (result, nll_curve): ``result`` maps "branch_lengths" (n_all,),
        "rate_multipliers" (P,), and "partitions" — a list of per-partition
        param dicts (same keys as ``optimize_model``, plus "log_likelihood").
    """
    if linked not in ("proportional", "equal"):
        raise ValueError(f"linked must be 'proportional' or 'equal', got {linked!r}")
    pids = np.asarray(partition_ids)
    n_parts = int(pids.max()) + 1
    if len(models) != n_parts:
        raise ValueError(
            f"{n_parts} partitions but {len(models)} model strings"
        )
    specs = [_parse_model_string(m) for m in models]
    for spec in specs:
        if spec["use_fixed"] and fixed_rates is None:
            raise ValueError("'empirical' partitions need fixed_rates")
    if fixed_rates is not None:
        fixed_rates = jnp.asarray(fixed_rates, jnp.float32)
    if fixed_freqs is not None:
        fixed_freqs = jnp.asarray(fixed_freqs, jnp.float32)
    q = n_states
    n_all = topology.n_all
    base_weights = (
        jnp.ones((pids.shape[0],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    # Per-partition site masks fold the base pattern weights in.
    part_masks = [
        base_weights * jnp.asarray(pids == p, jnp.float32)
        for p in range(n_parts)
    ]
    proportional = linked == "proportional"

    def build(params):
        lengths = jax.nn.softplus(params["theta_len"])
        if proportional and n_parts > 1:
            mult = jnp.concatenate(
                [jnp.ones((1,)), jax.nn.softplus(params["theta_mult"])]
            )
        else:
            mult = jnp.ones((n_parts,))
        parts = [
            _build_model_params(
                specs[p], params[f"part{p}"], q, fixed_rates, fixed_freqs
            )
            for p in range(n_parts)
        ]
        return lengths, mult, parts

    def part_lls(params):
        lengths, mult, parts = build(params)
        return lengths, mult, parts, [
            _model_log_likelihood(
                specs[p], parts[p][0], parts[p][1], parts[p][2],
                topology, lengths * mult[p], leaf_sequences, n_states,
                part_masks[p], n_categories, sequences_are_masks,
            )
            for p in range(n_parts)
        ]

    def loss_fn(params):
        _, _, _, lls = part_lls(params)
        return -sum(lls)

    params0: dict = {
        "theta_len": jnp.full(
            (n_all,), jnp.log(jnp.expm1(jnp.asarray(init_length)))
        )
    }
    if proportional and n_parts > 1:
        params0["theta_mult"] = jnp.full(
            (n_parts - 1,), jnp.log(jnp.expm1(1.0))
        )
    for p, spec in enumerate(specs):
        params0[f"part{p}"] = _init_model_params(spec, q, fixed_freqs)

    optimizer = optax.adam(learning_rate)

    @jax.jit
    def run(params):
        opt_state = optimizer.init(params)

        def step(carry, _):
            prm, st = carry
            loss, grads = jax.value_and_grad(loss_fn)(prm)
            updates, st = optimizer.update(grads, st, prm)
            prm = optax.apply_updates(prm, updates)
            return (prm, st), loss

        (params_f, _), losses = jax.lax.scan(
            step, (params, opt_state), None, length=n_iterations
        )
        # As in ``optimize_model``: the curve ends at the returned params.
        return params_f, jnp.append(losses, loss_fn(params_f))

    params_f, losses = run(params0)
    lengths, mult, parts, lls = part_lls(params_f)
    result = {
        "branch_lengths": lengths,
        "rate_multipliers": mult,
        "partitions": [
            {**parts[p][0], "log_likelihood": lls[p]} for p in range(n_parts)
        ],
    }
    return result, losses


@highest_matmul_precision
def posterior_site_rates(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    gamma_shape: float | jax.Array,
    n_categories: int = 4,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    *,
    category_rates: jax.Array | None = None,
    category_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Posterior mean substitution rate per site under a rate mixture.

    The empirical-Bayes site-rate estimate (IQ-TREE's ``--rate``): with
    discrete-Gamma categories r_k (or an explicit FreeRate mixture via
    ``category_rates``/``category_weights``), the per-site posterior over
    categories is ``w_k(s) ∝ prior_k · L_k(s)`` and the returned rate is
    ``Σ_k w_k(s) r_k``. Slowly-evolving (conserved) sites score < 1, fast
    sites > 1.

    Returns:
        (mean_rates (L,), posteriors (K, L)).
    """
    if category_rates is not None:
        cat = jnp.asarray(category_rates, jnp.float32)
        prior_w = (
            jnp.asarray(category_weights, jnp.float32)
            if category_weights is not None
            else jnp.full((cat.shape[0],), 1.0 / cat.shape[0])
        )
    else:
        cat = discrete_gamma_rates(gamma_shape, n_categories)
        prior_w = jnp.full((n_categories,), 1.0 / n_categories)
    prior_w = prior_w / jnp.sum(prior_w)

    def per_site_ll(rate):
        return _per_site_log_likelihood(
            topology, branch_lengths * rate, leaf_sequences, n_states,
            rates=rates, freqs=freqs, sequences_are_masks=sequences_are_masks,
        )

    ll_k = jax.vmap(per_site_ll)(cat)  # (K, L)
    log_post = ll_k + jnp.log(prior_w)[:, None]
    log_post = log_post - jax.scipy.special.logsumexp(
        log_post, axis=0, keepdims=True
    )
    post = jnp.exp(log_post)
    return jnp.sum(post * cat[:, None], axis=0), post
