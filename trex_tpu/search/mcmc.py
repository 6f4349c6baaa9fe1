"""Bayesian phylogenetic MCMC: Metropolis-coupled, device-batched chains.

The reference has no Bayesian machinery at all (its only posterior-ish
object is the Gumbel-softmax topology relaxation, ``/root/reference/src/
trex/tree.py:50-107``); this is the MrBayes-class capability re-designed for
a batched accelerator execution model:

- **All chains ride one device batch.** Every run x chain is a row of a
  batched state (topologies as ``children`` tensors, branch lengths, log
  posteriors); the per-generation likelihood evaluations — the only O(data)
  work — are ONE vmapped pruning pass over the whole chain batch, exactly
  the layout the batched scorers already use.
- **Entire generations live on device.** Branch-length sweeps, model moves,
  NNI topology proposals (constructed by ``ops.tree_moves`` pointer-swap +
  renumber — no host move library in the loop), Metropolis accepts, and the
  MC^3 swaps are all tensor ops on the chain batch; ``sample_every``
  generations run as one jitted dispatch, and the host loop never blocks on
  the device between checkpoints (async dispatch). A host-looped design
  pays 2-3 blocking round trips per generation; this design removes every
  per-generation sync.
- **Branch lengths carry across rearrangements by clade identity** — free
  under the pointer-swap representation: only the rearranged edge's clade
  changes and it keeps its slot, so the carry is the identity map up to the
  renumber permutation (exactly the hash-table carry the host utilities
  below implement; parity-tested in ``tests/test_tree_moves.py``).
- **Metropolis coupling (MC^3)**: within each independent run, chain k
  targets ``posterior^beta_k`` with ``beta_k = 1/(1 + heat*k)``; adjacent
  chains propose state swaps between blocks; only the cold chain (k=0) is
  sampled. Sampled states are re-canonicalized on host (the device
  numbering is topologically valid but not structure-determined).

Priors: iid Exponential(rate = 1/brlen_prior_mean) on the 2n-2 branch
lengths; uniform over topologies. Model: JC69 or fixed GTR(+Gamma is left
to ``optimize_model`` empirical-Bayes fits — pass fitted ``rates/freqs``).

Convergence diagnostics follow standard practice: ASDSF between the
independent runs' split frequencies, ESS of the cold-chain log-likelihood,
and per-move acceptance rates.

Statistical validation (tests/test_mcmc.py): prior-only sampling recovers
the exponential prior; the 2-taxon branch-length posterior matches 1D
quadrature; the 5-taxon topology posterior matches exhaustive enumeration
over all 105 rooted topologies (with and without heated chains).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.topology import Topology


@dataclasses.dataclass
class McmcResult:
    """Posterior sample + summaries from ``mcmc_sample``."""

    sample_children: np.ndarray
    """(n_samples, n_anc, 2) cold-chain topology samples (all runs pooled,
    post burn-in)."""
    sample_lengths: np.ndarray
    """(n_samples, n_all) matching branch-length samples."""
    sample_lnl: np.ndarray
    """(n_samples,) matching data log-likelihoods."""
    sample_run: np.ndarray
    """(n_samples,) which independent run each sample came from."""
    split_posterior: dict[frozenset[int], float]
    """Posterior probability of every sampled split (clade leaf set)."""
    consensus_newick: str
    """Majority-rule consensus of the posterior sample, clade posterior
    probabilities as internal labels."""
    acceptance: dict[str, float]
    """Acceptance rates per move class ('branch', 'topology', 'swap')."""
    asdsf: float | None
    """Average standard deviation of split frequencies across runs (None
    for a single run). < 0.01-0.05 is the usual converged range."""
    ess_lnl: float
    """Effective sample size of the pooled cold-chain lnL trace."""
    generations: int
    mean_lengths: np.ndarray
    """(n_all,) pooled mean branch length per canonical node index. Node
    identity mixes across topologies; for per-clade summaries aggregate
    ``sample_lengths`` over ``sample_children`` clades instead."""
    sample_rates: np.ndarray | None = None
    """(n_samples, Q(Q-1)/2) sampled exchangeability simplices (upper
    triangle, row-major) in sampled-model mode; None otherwise."""
    sample_freqs: np.ndarray | None = None
    """(n_samples, Q) sampled stationary-frequency simplices, or None."""


def _logsumexp_rows(logw: np.ndarray) -> np.ndarray:
    m = logw.max(axis=1)
    return m + np.log(np.exp(logw - m[:, None]).sum(axis=1))


def _exp_logprior(lengths: jax.Array, rate: float) -> jax.Array:
    """log p(branch lengths) under iid Exponential(rate); root entry excluded."""
    return jnp.log(rate) * (lengths.shape[-1] - 1) - rate * jnp.sum(
        lengths[..., :-1], axis=-1
    )


def _pairs_to_matrix(vec: jax.Array, q: int) -> jax.Array:
    """(Q(Q-1)/2,) upper-triangle exchangeabilities -> (Q, Q) symmetric."""
    iu = jnp.triu_indices(q, 1)
    m = jnp.zeros((q, q), vec.dtype).at[iu].set(vec)
    return m + m.T


def _matrix_to_pairs(m: np.ndarray, q: int) -> np.ndarray:
    iu = np.triu_indices(q, 1)
    vec = np.asarray(m, dtype=np.float64)[iu]
    return (vec / vec.sum()).astype(np.float32)


def _dirichlet_logpdf(x: jax.Array, alpha: jax.Array) -> jax.Array:
    from jax.scipy.special import gammaln

    return (
        gammaln(jnp.sum(alpha))
        - jnp.sum(gammaln(alpha))
        + jnp.sum((alpha - 1.0) * jnp.log(x))
    )


def _build_eval(
    leaf_sequences: jax.Array,
    n_states: int,
    n_all: int,
    site_weights: jax.Array | None,
    sequences_are_masks: bool,
    rates: jax.Array | None,
    freqs: jax.Array | None,
    gamma_shape: float | None,
    n_categories: int,
    sample_model: bool = False,
    eval_chunk: int | None = None,
):
    """TRACEABLE batched data-lnL evaluator for the on-device sampler.

    Returns ``batched_eval(children (B, n_anc, 2), lengths (B, n_all)
    [, rates_v (B, P), freqs_v (B, Q)]) -> (B,)``, usable inside the
    generation scan (every call site of the sampler is traced, so this must
    not jit internally).

    Scoring is the lax pruning recursion. With ``sample_model``, GTR
    transitions come from the eigensystem (one diag-exp matmul per
    branch), not per-branch ``expm`` — model parameters are constants
    within any one evaluation here, so the AD-robustness reason for
    ``expm`` (``ops.likelihood`` docstring) does not apply.

    With ``sample_model`` the signature gains per-row
    ``(rates_vec (B, Q(Q-1)/2 simplex), freqs (B, Q) simplex)``.

    The lax path auto-chunks via ``lax.map(batch_size=...)`` when the full
    partials buffer (B * n_all * Q * L f32) would exceed ~2 GB, or at
    ``eval_chunk`` rows when that is given.

    Also returns ``nbr_lnl(children (C, n_anc, 2), lengths (C, n_all)
    [, rates_v, freqs_v]) -> (C, K)``: EXACT log-likelihoods of every NNI
    neighbor of every chain via the analytic rescoring scan
    (``ops.nni_scan`` — one up/down pass instead of 2(n-2) prunings, the
    informed proposal's hot path), or None under +Gamma (mixture rescoring
    not implemented; the caller falls back to direct neighbor evaluation).
    """
    from trex_tpu.ops.likelihood import (
        _per_site_log_likelihood,
        discrete_gamma_rates,
        gtr_eigensystem,
        gtr_transition,
        per_site_log_likelihood,
    )
    from trex_tpu.ops.nni_scan import nni_neighborhood_lnl

    q = n_states
    length = int(leaf_sequences.shape[-1])
    def chunked(one_row, args):
        """vmap, or lax.map(batch_size=...) when the buffer would blow HBM."""
        b = int(args[0].shape[0])
        if eval_chunk is not None:
            chunk = eval_chunk
        else:
            bytes_full = 4 * b * n_all * q * length
            budget = 2 << 30  # carried over; not yet derived for the H100
            chunk = b if bytes_full <= budget else max(1, b * budget // bytes_full)
        if chunk >= b:
            return jax.vmap(one_row)(*args)
        return jax.lax.map(lambda xs: one_row(*xs), args, batch_size=chunk)

    if sample_model:
        def pmats_of(lengths_row, rates_vec, freqs_row):
            eigvals, left, right = gtr_eigensystem(
                _pairs_to_matrix(rates_vec, q), freqs_row
            )
            return jax.vmap(
                lambda t: gtr_transition(t, eigvals, left, right)
            )(lengths_row)

        def lnl_one(children, lengths, rates_vec, freqs_row):
            topo = Topology(
                children=children,
                parents=jnp.zeros((n_all,), dtype=jnp.int32),
            )

            def per_site_at(scale):
                return _per_site_log_likelihood(
                    topo, lengths, leaf_sequences, n_states,
                    sequences_are_masks=sequences_are_masks,
                    transition_matrices=pmats_of(
                        lengths * scale, rates_vec, freqs_row
                    ),
                    root_prior=freqs_row,
                )

            if gamma_shape is None:
                per_site = per_site_at(1.0)
            else:
                cat = discrete_gamma_rates(gamma_shape, n_categories)
                per_site = jax.nn.logsumexp(
                    jax.vmap(per_site_at)(cat), axis=0
                ) - jnp.log(n_categories)
            if site_weights is not None:
                per_site = per_site * site_weights
            return jnp.sum(per_site)

        def batched_eval(children, lengths, rates_v, freqs_v):
            return chunked(lnl_one, (children, lengths, rates_v, freqs_v))

        nbr_lnl = None
        if gamma_shape is None:
            def nbr_one(children_row, lengths_row, rv, fr):
                return nni_neighborhood_lnl(
                    children_row, lengths_row, leaf_sequences, q,
                    transition_matrices=pmats_of(lengths_row, rv, fr),
                    root_prior=fr, site_weights=site_weights,
                    sequences_are_masks=sequences_are_masks,
                )

            nbr_vm = jax.vmap(nbr_one)

            def nbr_lnl(children, lengths, rates_v, freqs_v):
                return nbr_vm(children, lengths, rates_v, freqs_v)

        return batched_eval, nbr_lnl

    if rates is not None or freqs is not None:
        eig_freqs = jnp.full((q,), 1.0 / q) if freqs is None else freqs
        eig_rates = jnp.ones((q, q)) if rates is None else rates
        eigvals, left, right = gtr_eigensystem(eig_rates, eig_freqs)
    else:
        eigvals = None

    def lnl_one_fixed(children, lengths):
        topo = Topology(
            children=children,
            parents=jnp.zeros((n_all,), dtype=jnp.int32),
        )
        per_site = per_site_log_likelihood(
            topo, lengths, leaf_sequences, n_states,
            rates=rates, freqs=freqs,
            gamma_shape=gamma_shape, n_categories=n_categories,
            sequences_are_masks=sequences_are_masks,
        )
        if site_weights is not None:
            per_site = per_site * site_weights
        return jnp.sum(per_site)

    def batched_eval_fixed(children, lengths):
        return chunked(lnl_one_fixed, (children, lengths))

    def batched_eval(children, lengths, rates_v=None, freqs_v=None):
        return batched_eval_fixed(children, lengths)

    nbr_lnl = None
    if gamma_shape is None:
        if eigvals is not None:
            def nbr_one(children_row, lengths_row):
                pm = jax.vmap(
                    lambda t: gtr_transition(t, eigvals, left, right)
                )(lengths_row)
                return nni_neighborhood_lnl(
                    children_row, lengths_row, leaf_sequences, q,
                    transition_matrices=pm, root_prior=eig_freqs,
                    site_weights=site_weights,
                    sequences_are_masks=sequences_are_masks,
                )
        else:
            def nbr_one(children_row, lengths_row):
                return nni_neighborhood_lnl(
                    children_row, lengths_row, leaf_sequences, q,
                    site_weights=site_weights,
                    sequences_are_masks=sequences_are_masks,
                )

        nbr_vm = jax.vmap(nbr_one)

        def nbr_lnl(children, lengths, rates_v=None, freqs_v=None):
            return nbr_vm(children, lengths)

    return batched_eval, nbr_lnl


def carry_lengths_nni(
    old_topology: Topology,
    old_lengths: np.ndarray,
    new_topology: Topology,
) -> np.ndarray:
    """Branch lengths carried across a rearrangement by clade identity.

    Every edge is identified by the leaf set below it; edges whose clade
    persists keep their length (leaf edges carry by index). Changed clades
    inherit the leftover lengths by sorted clade rank, which makes the carry
    an INVOLUTION: applying it from the new topology back to the old one
    restores the original assignment exactly — required for the reverse
    proposal density of the topology Metropolis move to be well defined.
    (For NNI exactly one clade changes, so the rank mapping is trivial.)

    The device sampler gets this carry for free (``ops.tree_moves``:
    pointer-swap keeps every persisting clade in its slot); this host
    version remains the oracle it is parity-tested against, and the utility
    for host-side workflows.
    """
    from trex_tpu.search.bootstrap import subtree_leaf_sets

    n_leaves = old_topology.n_leaves
    old_sets = subtree_leaf_sets(old_topology)
    new_sets = subtree_leaf_sets(new_topology)
    old_map = {s: float(old_lengths[n_leaves + i]) for i, s in enumerate(old_sets)}
    new_set_set = set(new_sets)
    clade_rank = lambda s: tuple(sorted(s))
    leftover = sorted(
        (s for s in old_map if s not in new_set_set), key=clade_rank
    )
    changed = sorted(
        (s for s in new_sets if s not in old_map), key=clade_rank
    )
    assert len(leftover) == len(changed)
    inherit = {c: old_map[o] for c, o in zip(changed, leftover)}
    out = np.array(old_lengths, dtype=np.float32, copy=True)
    for i, s in enumerate(new_sets):
        out[n_leaves + i] = old_map.get(s, inherit.get(s, 0.0))
    return out


def _clade_hash_batch(
    children_batch: np.ndarray, n_leaves: int, salt: np.ndarray
) -> np.ndarray:
    """(B, n_all) additive clade hashes: hash(node) = sum of its leaves'
    salts (uint64 wraparound). Disjoint leaf sets -> distinct sums w.h.p."""
    b, n_anc, _ = children_batch.shape
    n_all = n_leaves + n_anc
    h = np.zeros((b, n_all), np.uint64)
    h[:, :n_leaves] = salt[None, :]
    rows = np.arange(b)
    for a in range(n_anc):
        h[:, n_leaves + a] = (
            h[rows, children_batch[:, a, 0]] + h[rows, children_batch[:, a, 1]]
        )
    return h


def _carry_lengths_nni_batch(
    old_children: np.ndarray,
    old_lengths: np.ndarray,
    nbr_children: np.ndarray,
    n_leaves: int,
    salt: np.ndarray,
) -> np.ndarray:
    """Vectorized ``carry_lengths_nni`` over a whole NNI neighborhood.

    Same semantics (clade-identity carry, single changed clade inherits the
    single leftover length) but via additive clade hashes + searchsorted —
    O(B * n) numpy instead of O(B * n^2) Python frozenset work. Host-side
    utility (the sampler itself now carries lengths on device).
    """
    n_anc = n_leaves - 1
    n_all = 2 * n_leaves - 1
    b = nbr_children.shape[0]
    old_h = _clade_hash_batch(old_children[None], n_leaves, salt)[0]
    new_h = _clade_hash_batch(nbr_children, n_leaves, salt)
    anc_old_h = old_h[n_leaves:]
    order = np.argsort(anc_old_h, kind="stable")
    sorted_h = anc_old_h[order]
    anc_len_sorted = old_lengths[n_leaves:][order]
    idx = np.minimum(
        np.searchsorted(sorted_h, new_h[:, n_leaves:]), n_anc - 1
    )
    match = sorted_h[idx] == new_h[:, n_leaves:]
    out = np.broadcast_to(
        old_lengths.astype(np.float32), (b, n_all)
    ).copy()
    out[:, n_leaves:] = np.where(match, anc_len_sorted[idx], 0.0)
    miss_rows, miss_cols = np.where(~match)
    if miss_rows.size:
        # NNI changes exactly one clade; the leftover old hash is the total
        # minus the matched row sum (exact under uint64 wraparound).
        assert miss_rows.size == b and np.array_equal(
            miss_rows, np.arange(b)
        ), "NNI neighbors must each change exactly one clade"
        total = anc_old_h.sum(dtype=np.uint64)
        matched = np.where(match, sorted_h[idx], np.uint64(0)).sum(
            axis=1, dtype=np.uint64
        )
        pos = np.minimum(
            np.searchsorted(sorted_h, total - matched), n_anc - 1
        )
        out[miss_rows, n_leaves + miss_cols] = anc_len_sorted[pos]
    return out


def effective_sample_size(trace: np.ndarray) -> float:
    """ESS via the initial positive sequence estimator (Geyer 1992)."""
    x = np.asarray(trace, dtype=np.float64)
    n = x.size
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = float(np.dot(x, x) / n)
    if var <= 0:
        return float(n)
    # Autocovariances via FFT.
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conjugate(f), m)[:n].real / n
    rho = acov / var
    # Sum consecutive pairs while positive.
    s = 0.0
    for k in range(1, n // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair <= 0:
            break
        s += pair
    ess = n / (1.0 + 2.0 * s)
    return float(min(max(ess, 1.0), n))


def average_stddev_split_freqs(
    per_run_samples: list[list[Topology]], min_freq: float = 0.1
) -> float | None:
    """ASDSF between independent runs (splits above ``min_freq`` anywhere)."""
    from trex_tpu.search.consensus import split_frequencies

    if len(per_run_samples) < 2:
        return None
    freqs = [split_frequencies(s) for s in per_run_samples if s]
    if len(freqs) < 2:
        return None
    splits = {s for f in freqs for s, v in f.items() if v >= min_freq}
    if not splits:
        return 0.0
    sds = [
        float(np.std([f.get(s, 0.0) for f in freqs])) for s in splits
    ]
    return float(np.mean(sds))


def mcmc_sample(
    key: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    n_generations: int = 10_000,
    n_runs: int = 2,
    n_chains: int = 4,
    heat: float = 0.1,
    sample_every: int = 20,
    burnin_frac: float = 0.25,
    branch_moves_per_gen: int = 1,
    topo_moves: bool = True,
    topo_proposal: str = "informed",
    topo_informed_power: float = 0.1,
    brlen_prior_mean: float = 0.1,
    tuning: float = 1.4,
    start: Topology | None = None,
    start_lengths: np.ndarray | None = None,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    sample_model: bool = False,
    model_tuning: float = 500.0,
    leaf_names: list[str] | None = None,
    prior_only: bool = False,
    progress_every: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    stop_after_generations: int | None = None,
    eval_chunk: int | None = None,
    mesh=None,
) -> McmcResult:
    """Sample the Bayesian tree posterior with coupled MCMC chains.

    One *generation* = ``branch_moves_per_gen`` single-branch multiplier
    moves, one model-simplex round (sampled-model mode), one NNI topology
    Metropolis round, and one MC^3 swap proposal per run — ALL constructed
    and accepted on device. ``sample_every`` generations form one sample
    block, and up to 64 blocks between host boundaries
    (checkpoint/progress/stop) run as ONE dispatch (``superblock_fn``:
    a device-side scan stacking the cold-chain snapshots), so the fixed
    per-dispatch cost is paid per superblock, not per sample block.

    Args:
        leaf_sequences: (n_leaves, L) int states (or bitmasks with
            ``sequences_are_masks=True``). Compress to site patterns first
            and pass ``site_weights`` for long alignments.
        n_runs / n_chains: independent runs (for ASDSF) x coupled chains
            per run (chain 0 cold, k heated by ``1/(1 + heat*k)``).
        topo_proposal: "informed" (default) draws the NNI neighbor
            proportionally to ``posterior^(beta/2)`` over the WHOLE
            neighborhood — a locally-balanced proposal (Zanella 2020,
            J. Am. Stat. Assoc.) whose Hastings factor is the ratio of
            neighborhood normalizers; both the proposal weights and the
            reverse normalizer are one batched likelihood call over all
            chains x neighbors, which is exactly the shape the batched
            scorers are fastest at. "nni" draws a neighbor uniformly
            (symmetric, 1 eval/chain/generation) — cheaper per generation
            but mixes far slower on peaked posteriors.
        topo_informed_power: weight exponent p of the informed proposal
            (neighbor weights ``posterior^(p * beta)``). The default 0.1
            mixed best per sampling step at 64 taxa x 2048 sites x 8
            chains: the literature-default p=0.5 made the proposal
            near-deterministic on peaked phylogenetic posteriors and
            stalled the chain; a small p keeps the informed ranking
            while restoring acceptance.
        rates / freqs / gamma_shape: optional fixed substitution model
            (empirical-Bayes: fit once with ``optimize_model``); default JC69.
        sample_model: FULL Bayes over the GTR model — per-chain
            exchangeability and stationary-frequency simplices with flat
            Dirichlet(1) priors, one Dirichlet-centered Metropolis move on
            each per generation (on device). ``rates``/``freqs`` then only
            seed the chains (uniform when absent); ``gamma_shape`` stays
            fixed if given.
        prior_only: target the prior alone (validation: the sampler must
            recover Exponential branch lengths / uniform topologies).
        start: optional starting topology (defaults to random per chain).
        checkpoint_dir: write the FULL sampler state (chain states, the RNG
            key, accumulated samples and counters) to
            ``<dir>/mcmc_checkpoint.npz`` on (block-rounded)
            ``checkpoint_every``-generation boundaries; if the file already
            exists, RESUME from it — bit-identical to an uninterrupted run
            (tested). Keep ``n_generations`` (the FINAL target, which fixes
            the burn-in boundary) the same across legs; use
            ``stop_after_generations`` to bound how many generations one
            call executes (a checkpoint is written at the stop). Both
            intervals round up to whole ``sample_every`` blocks — the
            device executes whole blocks per dispatch.
        eval_chunk: cap on simultaneously evaluated trees in the lax
            likelihood path (None = auto from a ~2 GB partials budget).
        mesh: optional ``jax.sharding.Mesh`` with a 'tree' axis
            (``parallel.mesh.make_mesh``): the runs x chains batch axis of
            the sampler state is sharded over it (chains are data-parallel;
            the only cross-chain traffic is the MC^3 swap permutation and
            the integer acceptance-counter psums, which XLA partitions
            automatically). ``n_runs * n_chains`` must divide by the tree
            axis size. Trajectories are bit-identical to single-device
            (every float op is per-chain; the partitioned sums are
            integer-valued) — pinned in tests/test_sharding.py.

    Returns:
        ``McmcResult`` — pooled post-burn-in cold-chain samples, split
        posterior probabilities, consensus tree, diagnostics.
    """
    from trex_tpu.io import (
        canonicalize_topology,
        reroot_on_outgroup,
        sample_topologies,
    )
    from trex_tpu.ops.tree_moves import (
        nni_neighbor_device,
        nni_neighborhood_device,
    )
    from trex_tpu.search.consensus import (
        majority_rule_consensus,
        split_frequencies,
    )

    n_leaves = int(leaf_sequences.shape[0])
    n_anc = n_leaves - 1
    n_all = 2 * n_leaves - 1
    n_total = n_runs * n_chains
    prior_rate = 1.0 / brlen_prior_mean
    do_topo = topo_moves and n_leaves >= 4
    n_nbr = 2 * (n_leaves - 2)
    n_pairs = n_states * (n_states - 1) // 2

    seeds = np.asarray(jax.random.key_data(key)).ravel()
    rng = np.random.default_rng(int(seeds[-1]))

    # --- initial state -----------------------------------------------------
    if start is not None:
        children_host = np.broadcast_to(
            np.asarray(start.children)[None], (n_total, n_anc, 2)
        ).copy()
    else:
        starts = sample_topologies(int(rng.integers(2**31)), n_leaves, n_total)
        children_host = np.asarray(starts.children).copy()
    if start_lengths is not None:
        lengths_host = np.broadcast_to(
            np.asarray(start_lengths, dtype=np.float32)[None], (n_total, n_all)
        ).copy()
    else:
        lengths_host = rng.exponential(
            brlen_prior_mean, size=(n_total, n_all)
        ).astype(np.float32)
    lengths_host[:, -1] = 0.0  # root entry is unused by the likelihood

    if prior_only:
        leaf_sequences = jnp.zeros((n_leaves, 1), dtype=jnp.int32)
        site_weights = jnp.zeros((1,), dtype=jnp.float32)

    batched_eval, nbr_lnl = _build_eval(
        jnp.asarray(leaf_sequences), n_states, n_all,
        None if site_weights is None else jnp.asarray(site_weights),
        sequences_are_masks, rates, freqs,
        gamma_shape, n_categories,
        sample_model=sample_model, eval_chunk=eval_chunk,
    )

    # Per-chain model state (sampled-model mode): exchangeability and
    # frequency simplices, seeded from the given model or uniform. When the
    # model is fixed these stay as (n_total, 1) dummies so the state pytree
    # has one structure either way.
    if sample_model:
        if rates is not None:
            rates0 = _matrix_to_pairs(np.asarray(rates), n_states)
        else:
            rates0 = np.full((n_pairs,), 1.0 / n_pairs, np.float32)
        if freqs is not None:
            f0 = np.asarray(freqs, np.float64)
            freqs0 = (f0 / f0.sum()).astype(np.float32)
        else:
            freqs0 = np.full((n_states,), 1.0 / n_states, np.float32)
        rates_host = np.broadcast_to(rates0, (n_total, n_pairs)).copy()
        freqs_host = np.broadcast_to(freqs0, (n_total, n_states)).copy()
    else:
        rates_host = np.zeros((n_total, 1), np.float32)
        freqs_host = np.zeros((n_total, 1), np.float32)

    beta_host = np.array(
        [1.0 / (1.0 + heat * k) for _ in range(n_runs) for k in range(n_chains)],
        dtype=np.float32,
    )
    beta = jnp.asarray(beta_host)
    rows = jnp.arange(n_total)
    cold_rows = np.arange(n_runs) * n_chains
    cold = jnp.asarray(cold_rows)

    def ev(ch, ln, rv, fv):
        if sample_model:
            return batched_eval(ch, ln, rv, fv)
        return batched_eval(ch, ln)

    # --- one generation, fully traced ---------------------------------------
    # Acceptance counters: [branch, topology, swap, model] accepted counts;
    # denominators are deterministic (gens * moves * chains), computed host-
    # side at the end.
    def gen_step(state):
        children, lengths, lnl, rates_v, freqs_v, k, acc = state

        if branch_moves_per_gen > 0:
            k, sub = jax.random.split(k)
            logprior = _exp_logprior(lengths, prior_rate)

            def bstep(carry, kk):
                lengths, lnl, logprior, n_acc = carry
                k_node, k_mult, k_acc = jax.random.split(kk, 3)
                node = jax.random.randint(k_node, (n_total,), 0, n_all - 1)
                factor = jnp.exp(
                    tuning * (jax.random.uniform(k_mult, (n_total,)) - 0.5)
                )
                old = lengths[rows, node]
                new = old * factor
                prop = lengths.at[rows, node].set(new)
                prop_lnl = ev(children, prop, rates_v, freqs_v)
                prop_logprior = logprior - prior_rate * (new - old)
                log_alpha = (
                    beta * (prop_lnl - lnl + prop_logprior - logprior)
                    + jnp.log(factor)
                )
                take = (
                    jnp.log(jax.random.uniform(k_acc, (n_total,))) < log_alpha
                )
                lengths = jnp.where(take[:, None], prop, lengths)
                lnl = jnp.where(take, prop_lnl, lnl)
                logprior = jnp.where(take, prop_logprior, logprior)
                return (lengths, lnl, logprior, n_acc + take.sum()), None

            keys = jax.random.split(sub, branch_moves_per_gen)
            (lengths, lnl, _, n_acc), _ = jax.lax.scan(
                bstep,
                (lengths, lnl, logprior, jnp.zeros((), jnp.int32)),
                keys,
            )
            acc = acc.at[0].add(n_acc)

        if sample_model:
            # One Dirichlet-centered Metropolis move per simplex per chain.
            # Flat Dirichlet(1) priors, so only the proposal densities enter
            # the ratio; components below 1e-5 are auto-rejected (truncated
            # prior: keeps the eigensystem away from degenerate corners
            # while preserving detailed balance).
            k, k_r, k_f = jax.random.split(k, 3)

            def simplex_move(x, other_eval, kk):
                k_prop, k_acc = jax.random.split(kk)
                prop = jax.random.dirichlet(k_prop, model_tuning * x)
                lq_fwd = jax.vmap(_dirichlet_logpdf)(prop, model_tuning * x)
                lq_rev = jax.vmap(_dirichlet_logpdf)(x, model_tuning * prop)
                prop_lnl = other_eval(prop)
                inside = jnp.min(prop, axis=-1) >= 1e-5
                log_alpha = beta * (prop_lnl - lnl) + lq_rev - lq_fwd
                take = inside & (
                    jnp.log(jax.random.uniform(k_acc, (n_total,))) < log_alpha
                )
                return take, prop, prop_lnl

            take, prop, prop_lnl = simplex_move(
                rates_v,
                lambda rv: batched_eval(children, lengths, rv, freqs_v),
                k_r,
            )
            rates_v = jnp.where(take[:, None], prop, rates_v)
            lnl = jnp.where(take, prop_lnl, lnl)
            acc = acc.at[3].add(take.sum())

            take, prop, prop_lnl = simplex_move(
                freqs_v,
                lambda fv: batched_eval(children, lengths, rates_v, fv),
                k_f,
            )
            freqs_v = jnp.where(take[:, None], prop, freqs_v)
            lnl = jnp.where(take, prop_lnl, lnl)
            acc = acc.at[3].add(take.sum())

        if do_topo:
            if topo_proposal == "informed":
                # Forward: draw y ~ exp(p * beta * lnl) over N(x), p =
                # topo_informed_power (the branch prior is invariant under
                # the carry, so it cancels). With weight exponent g = p*b:
                # alpha = pi(y) q(x|y) / (pi(x) q(y|x))
                #       = exp((1-p) b (lnl_y - lnl_x)) * Z_x / Z_y.
                # p = 1/2 is the locally-balanced sqrt weight; smaller p
                # softens the pick on peaked posteriors (at 64 taxa x 2048
                # sites the sqrt weight is near-deterministic and the
                # normalizer correction rejects ~97% of proposals).
                # Neighbor lnLs come from the analytic rescoring scan when
                # available (one up/down pass per chain instead of 2(n-2)
                # prunings), and only the PICKED neighbor is constructed.
                if nbr_lnl is not None:
                    lnl_x_nbr = nbr_lnl(children, lengths, rates_v, freqs_v)
                else:
                    nbr_fn = jax.vmap(
                        lambda c, l: nni_neighborhood_device(c, l, n_leaves)
                    )
                    rep_r = jnp.repeat(rates_v, n_nbr, axis=0)
                    rep_f = jnp.repeat(freqs_v, n_nbr, axis=0)
                    nbr_c, nbr_l = nbr_fn(children, lengths)
                    lnl_x_nbr = ev(
                        nbr_c.reshape(-1, n_anc, 2),
                        nbr_l.reshape(-1, n_all),
                        rep_r, rep_f,
                    ).reshape(n_total, n_nbr)
                logw_x = topo_informed_power * beta[:, None] * lnl_x_nbr
                z_x = jax.nn.logsumexp(logw_x, axis=1)
                k, k_pick, k_acc = jax.random.split(k, 3)
                pick = jax.random.categorical(k_pick, logw_x, axis=1)
                prop_lnl = lnl_x_nbr[rows, pick]
                prop_c, prop_l = jax.vmap(
                    lambda c, l, e, v: nni_neighbor_device(
                        c, l, e, v, n_leaves
                    )
                )(children, lengths, pick // 2, pick % 2)
                # Reverse normalizer over N(y): x is in it by NNI symmetry
                # with exactly the current lengths (pointer-swap carry is
                # involutive), and lnL is renumbering-invariant.
                if nbr_lnl is not None:
                    lnl_y_nbr = nbr_lnl(prop_c, prop_l, rates_v, freqs_v)
                else:
                    nbr_c2, nbr_l2 = nbr_fn(prop_c, prop_l)
                    lnl_y_nbr = ev(
                        nbr_c2.reshape(-1, n_anc, 2),
                        nbr_l2.reshape(-1, n_all),
                        rep_r, rep_f,
                    ).reshape(n_total, n_nbr)
                z_y = jax.nn.logsumexp(
                    topo_informed_power * beta[:, None] * lnl_y_nbr, axis=1
                )
                log_alpha = (
                    (1.0 - topo_informed_power) * beta * (prop_lnl - lnl)
                    + z_x
                    - z_y
                )
            else:  # plain uniform NNI (symmetric; 1 eval of C trees)
                k, k_edge, k_var, k_acc = jax.random.split(k, 4)
                edge = jax.random.randint(k_edge, (n_total,), 0, n_anc - 1)
                var = jax.random.randint(k_var, (n_total,), 0, 2)
                prop_c, prop_l = jax.vmap(
                    lambda c, l, e, v: nni_neighbor_device(
                        c, l, e, v, n_leaves
                    )
                )(children, lengths, edge, var)
                prop_lnl = ev(prop_c, prop_l, rates_v, freqs_v)
                # Same length multiset -> prior unchanged; symmetric move.
                log_alpha = beta * (prop_lnl - lnl)
            take = jnp.log(jax.random.uniform(k_acc, (n_total,))) < log_alpha
            children = jnp.where(take[:, None, None], prop_c, children)
            lengths = jnp.where(take[:, None], prop_l, lengths)
            lnl = jnp.where(take, prop_lnl, lnl)
            acc = acc.at[1].add(take.sum())

        if n_chains > 1:
            k, k_pick, k_acc = jax.random.split(k, 3)
            ks = jax.random.randint(k_pick, (n_runs,), 0, n_chains - 1)
            i = jnp.arange(n_runs) * n_chains + ks
            j = i + 1
            post = lnl + _exp_logprior(lengths, prior_rate)
            log_alpha = (beta[i] - beta[j]) * (post[j] - post[i])
            take = jnp.log(jax.random.uniform(k_acc, (n_runs,))) < log_alpha
            # Scatter-free permutation: j = i + 1, so an accepted swap is
            # +1 at position i and -1 at position j (runs touch disjoint
            # positions). The double `.at[].set` formulation this replaces
            # is miscompiled by GSPMD when the chain axis is sharded over a
            # mesh (the second scatter is dropped on some shards, turning
            # the swap into a copy — caught by the round-4 bit-identity
            # test; one-hot arithmetic partitions exactly).
            oh_i = (rows[None, :] == i[:, None]).astype(jnp.int32)
            oh_j = (rows[None, :] == j[:, None]).astype(jnp.int32)
            shift = ((oh_i - oh_j) * take[:, None].astype(jnp.int32)).sum(0)
            perm = rows + shift
            children = children[perm]
            lengths = lengths[perm]
            lnl = lnl[perm]
            rates_v = rates_v[perm]
            freqs_v = freqs_v[perm]
            acc = acc.at[2].add(take.sum())

        return (children, lengths, lnl, rates_v, freqs_v, k, acc)

    @partial(jax.jit, donate_argnums=(0,), static_argnums=(1,))
    def superblock_fn(state, n_blocks):
        """``n_blocks`` sample blocks in ONE dispatch, samples stacked.

        Every dispatch carries a fixed host-side cost regardless of
        content. Scanning blocks on device and stacking the cold-chain
        snapshots amortizes that fixed cost across every block between
        host boundaries (checkpoint/progress/stop), which is what makes
        the topology sampler dispatch-light like ``mcmc_date``. The
        per-generation graph is unchanged, so trajectories are
        bit-identical to the one-block-per-dispatch layout (the resume
        test pins this).
        """

        def one_block(s, _):
            s = jax.lax.fori_loop(
                0, sample_every, lambda _, t: gen_step(t), s
            )
            children, lengths, lnl, rates_v, freqs_v, _, _ = s
            return s, (
                children[cold], lengths[cold], lnl[cold],
                rates_v[cold], freqs_v[cold],
            )

        return jax.lax.scan(one_block, state, None, length=n_blocks)

    total_blocks = n_generations // sample_every
    trailing = n_generations - total_blocks * sample_every
    n_burnin = int(burnin_frac * n_generations)

    # --- checkpoint / resume -------------------------------------------------
    samples_children: list[np.ndarray] = []
    samples_lengths: list[np.ndarray] = []
    samples_lnl: list[float] = []
    samples_run: list[int] = []
    samples_rates: list[np.ndarray] = []
    samples_freqs: list[np.ndarray] = []

    gens_done = 0
    acc_host = np.zeros((4,), np.int32)
    key_dev = key
    lnl_host = None
    ckpt_path = None
    if checkpoint_dir is not None:
        import os as _os

        _os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = _os.path.join(checkpoint_dir, "mcmc_checkpoint.npz")
        if _os.path.exists(ckpt_path):
            ck = np.load(ckpt_path, allow_pickle=False)
            gens_done = int(ck["gens_done"])
            children_host = ck["children"].copy()
            lengths_host = ck["lengths"].copy()
            # The chain's lnL is part of the state: recomputing it could
            # differ from the in-jit value in low-order bits and flip later
            # accept decisions (resume must be bit-identical).
            lnl_host = ck["lnl"].copy()
            rates_host = ck["rates"].copy()
            freqs_host = ck["freqs"].copy()
            acc_host = ck["acc"].copy()
            key_dev = jax.random.wrap_key_data(jnp.asarray(ck["jax_key"]))
            samples_children = list(ck["s_children"])
            samples_lengths = list(ck["s_lengths"])
            samples_lnl = list(ck["s_lnl"])
            samples_run = list(ck["s_run"])
            if sample_model and "s_rates" in ck:
                samples_rates = list(ck["s_rates"])
                samples_freqs = list(ck["s_freqs"])

    if lnl_host is None:
        lnl0 = ev(
            jnp.asarray(children_host), jnp.asarray(lengths_host),
            jnp.asarray(rates_host), jnp.asarray(freqs_host),
        )
    else:
        lnl0 = jnp.asarray(lnl_host)
    state = (
        jnp.asarray(children_host), jnp.asarray(lengths_host), lnl0,
        jnp.asarray(rates_host), jnp.asarray(freqs_host), key_dev,
        jnp.asarray(acc_host),
    )
    if mesh is not None:
        # Shard the chain axis over the mesh's 'tree' axis; jit propagates
        # the shardings through the superblock (GSPMD inserts the swap
        # permute / counter psums). Everything per-chain stays local.
        from jax.sharding import NamedSharding, PartitionSpec

        from trex_tpu.parallel.mesh import TREE_AXIS

        n_tree = mesh.shape[TREE_AXIS]
        if n_total % n_tree != 0:
            raise ValueError(
                f"n_runs * n_chains = {n_total} must be divisible by the "
                f"mesh tree axis size ({n_tree})"
            )
        chain_s = NamedSharding(mesh, PartitionSpec(TREE_AXIS))
        repl = NamedSharding(mesh, PartitionSpec())
        state = tuple(
            jax.device_put(x, chain_s if i < 5 else repl)
            for i, x in enumerate(state)
        )

    pending: list[tuple[int, tuple]] = []

    def flush_pending():
        for first_blk, samples in pending:
            s_children, s_lengths, s_lnl, s_rates, s_freqs = (
                np.asarray(x) for x in jax.device_get(samples)
            )
            for i in range(s_children.shape[0]):
                gen = (first_blk + i) * sample_every
                if gen <= n_burnin:
                    continue
                for r in range(n_runs):
                    samples_children.append(s_children[i, r])
                    samples_lengths.append(s_lengths[i, r])
                    samples_lnl.append(float(s_lnl[i, r]))
                    samples_run.append(r)
                    if sample_model:
                        samples_rates.append(s_rates[i, r])
                        samples_freqs.append(s_freqs[i, r])
        pending.clear()

    def write_checkpoint(state, gens_now):
        import os as _os

        flush_pending()
        children_d, lengths_d, lnl_d, rates_d, freqs_d, key_d, acc_d = state
        payload = {
            "gens_done": gens_now,
            "children": np.asarray(jax.device_get(children_d)),
            "lengths": np.asarray(jax.device_get(lengths_d)),
            "lnl": np.asarray(jax.device_get(lnl_d)),
            "rates": np.asarray(jax.device_get(rates_d)),
            "freqs": np.asarray(jax.device_get(freqs_d)),
            "acc": np.asarray(jax.device_get(acc_d)),
            "jax_key": np.asarray(jax.device_get(jax.random.key_data(key_d))),
            "s_children": np.stack(samples_children)
            if samples_children
            else np.zeros((0, n_anc, 2), np.int32),
            "s_lengths": np.stack(samples_lengths)
            if samples_lengths
            else np.zeros((0, n_all), np.float32),
            "s_lnl": np.asarray(samples_lnl, np.float64),
            "s_run": np.asarray(samples_run, np.int32),
        }
        if sample_model:
            payload["s_rates"] = (
                np.stack(samples_rates)
                if samples_rates
                else np.zeros((0, n_pairs), np.float32)
            )
            payload["s_freqs"] = (
                np.stack(samples_freqs)
                if samples_freqs
                else np.zeros((0, n_states), np.float32)
            )
        tmp = ckpt_path + ".tmp.npz"
        np.savez(tmp, **payload)
        _os.replace(tmp, ckpt_path)

    # --- main loop: async block dispatch -------------------------------------
    blocks_done = gens_done // sample_every
    ck_blocks = max(1, -(-checkpoint_every // sample_every))
    prog_blocks = (
        max(1, round(progress_every / sample_every)) if progress_every else 0
    )
    stop_blocks = (
        None
        if stop_after_generations is None
        else -(-stop_after_generations // sample_every)
    )
    executed = 0
    stopped_early = False
    blk = blocks_done
    last_progress = blk // prog_blocks if prog_blocks else 0
    max_dispatch = 64  # blocks per dispatch between host boundaries
    while blk < total_blocks:
        g = min(max_dispatch, total_blocks - blk)
        if ckpt_path is not None:
            g = min(g, ck_blocks - (blk % ck_blocks))
        if prog_blocks:
            g = min(g, prog_blocks - (blk % prog_blocks))
        if stop_blocks is not None:
            g = max(1, min(g, stop_blocks - executed))
        state, samples = superblock_fn(state, g)
        pending.append((blk + 1, samples))
        executed += g
        blk += g
        gens_done = blk * sample_every
        # Print whenever a progress boundary was CROSSED, not only when blk
        # lands exactly on the grid (the stop_after clamp can knock blk off
        # the prog_blocks multiples and silently skip lines otherwise).
        if prog_blocks and blk // prog_blocks > last_progress:
            last_progress = blk // prog_blocks
            lnl_cold = np.asarray(jax.device_get(pending[-1][1][2]))[-1]
            cold_str = " ".join(f"{v:.2f}" for v in lnl_cold)
            print(f"[mcmc] gen {gens_done}/{n_generations} cold lnL: {cold_str}")
        at_stop = (
            stop_blocks is not None
            and executed >= stop_blocks
            and blk < total_blocks
        )
        if ckpt_path is not None and (blk % ck_blocks == 0 or at_stop):
            write_checkpoint(state, gens_done)
        if at_stop:
            stopped_early = True
            break

    if not stopped_early:
        if trailing and gens_done == total_blocks * sample_every:
            advance = jax.jit(
                lambda s: jax.lax.fori_loop(
                    0, trailing, lambda _, st: gen_step(st), s
                ),
                donate_argnums=(0,),
            )
            state = advance(state)
            gens_done = n_generations
        if ckpt_path is not None:
            write_checkpoint(state, gens_done)
    flush_pending()
    acc_host = np.asarray(jax.device_get(state[6]))

    # --- summaries ----------------------------------------------------------
    # The device sampler's numbering is topologically valid but arbitrary;
    # canonicalize every sample (structure-determined numbering + matching
    # length permutation) so byte identities and node-indexed summaries mean
    # the same thing they do for host-enumerated trees.
    canon_children: list[np.ndarray] = []
    canon_lengths: list[np.ndarray] = []
    for c, l in zip(samples_children, samples_lengths):
        cc, ll = canonicalize_topology(c, l)
        canon_children.append(cc)
        canon_lengths.append(ll)

    # Summarize on a CANONICAL ROOTING (re-root every sample on leaf 0):
    # under a reversible model the data cannot identify the root, so chains
    # wander over rootings and raw rooted-clade frequencies fluctuate even
    # at a fixed unrooted topology. Rooting on leaf 0 makes clades correspond
    # 1:1 to unrooted splits — the quantity MrBayes-style summaries (split
    # posteriors, consensus, ASDSF) are defined on.
    zero_parents = np.zeros((n_all,), dtype=np.int32)
    sample_topos = [
        reroot_on_outgroup(
            Topology(children=c, parents=zero_parents), [0]
        )[0]
        for c in canon_children
    ]
    per_run = [
        [t for t, r in zip(sample_topos, samples_run) if r == rr]
        for rr in range(n_runs)
    ]
    split_post = split_frequencies(sample_topos) if sample_topos else {}
    consensus = (
        majority_rule_consensus(sample_topos, leaf_names)[0]
        if sample_topos
        else ""
    )
    per_run_lnl = [
        np.array([v for v, r in zip(samples_lnl, samples_run) if r == rr])
        for rr in range(n_runs)
    ]
    ess = float(
        sum(effective_sample_size(t) for t in per_run_lnl if t.size > 0)
    )
    mean_lengths = (
        np.mean(np.stack(canon_lengths), axis=0)
        if canon_lengths
        else np.zeros(n_all, np.float32)
    )
    branch_n = gens_done * branch_moves_per_gen * n_total
    topo_n = gens_done * n_total if do_topo else 0
    swap_n = gens_done * n_runs if n_chains > 1 else 0
    model_n = 2 * gens_done * n_total if sample_model else 0
    return McmcResult(
        sample_children=(
            np.stack(canon_children)
            if canon_children
            else np.zeros((0, n_anc, 2), np.int32)
        ),
        sample_lengths=(
            np.stack(canon_lengths)
            if canon_lengths
            else np.zeros((0, n_all), np.float32)
        ),
        sample_lnl=np.asarray(samples_lnl, dtype=np.float64),
        sample_run=np.asarray(samples_run, dtype=np.int32),
        split_posterior=split_post,
        consensus_newick=consensus,
        acceptance={
            "branch": int(acc_host[0]) / max(branch_n, 1),
            "topology": int(acc_host[1]) / max(topo_n, 1),
            "swap": int(acc_host[2]) / max(swap_n, 1),
            **(
                {"model": int(acc_host[3]) / max(model_n, 1)}
                if sample_model
                else {}
            ),
        },
        asdsf=average_stddev_split_freqs(per_run),
        ess_lnl=ess,
        generations=n_generations,
        mean_lengths=mean_lengths.astype(np.float32),
        sample_rates=np.stack(samples_rates) if samples_rates else None,
        sample_freqs=np.stack(samples_freqs) if samples_freqs else None,
    )
