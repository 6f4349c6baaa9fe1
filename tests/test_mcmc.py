"""Statistical validation of the Bayesian MCMC sampler.

Three ground-truth oracles, strongest available at each scale:

1. prior recovery — with the likelihood disabled, sampled branch lengths
   must match the Exponential prior (validates proposal + acceptance
   mechanics end to end);
2. 2-taxon quadrature — the posterior of the root-path length under JC has
   a 1D integral representation; MCMC moments must match it;
3. 5-taxon exhaustive enumeration — with fixed equal branch lengths the
   exact topology posterior is a softmax over all 105 rooted topologies;
   the sampled frequencies must match in total variation, with and without
   Metropolis coupling.

The reference has no Bayesian machinery to port
(/root/reference/src/trex — grepped: no MCMC/posterior code), so these
oracles take the place of reference parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.io import sample_topologies, spr_move
from trex_tpu.ops.likelihood import tree_log_likelihood
from trex_tpu.search.mcmc import (
    carry_lengths_nni,
    effective_sample_size,
    mcmc_sample,
)
from trex_tpu.topology import Topology


def _single(seed, n_leaves):
    return jax.tree_util.tree_map(
        lambda x: x[0], sample_topologies(seed, n_leaves, 1)
    )


def test_prior_only_recovers_exponential_prior():
    res = mcmc_sample(
        jax.random.PRNGKey(0),
        jnp.zeros((6, 4), dtype=jnp.int32), 4,
        n_generations=4000, n_runs=1, n_chains=1, sample_every=5,
        burnin_frac=0.2, prior_only=True, brlen_prior_mean=0.1,
    )
    lens = res.sample_lengths[:, :-1].ravel()
    assert abs(lens.mean() - 0.1) < 0.015
    # Exponential: sd == mean.
    assert abs(lens.std() - 0.1) < 0.02
    # Uniform topology posterior: no (unrooted-nontrivial) split should
    # dominate. Samples are canonically rooted on leaf 0, so |s| == 5 is
    # the always-present complement of the root leaf — trivial.
    nontrivial = [p for s, p in res.split_posterior.items() if 1 < len(s) < 5]
    assert max(nontrivial) < 0.6


def test_two_taxon_branch_posterior_matches_quadrature():
    rng = np.random.default_rng(0)
    length = 300
    a = rng.integers(0, 4, length)
    b = np.where(
        rng.uniform(size=length) < 0.15, (a + rng.integers(1, 4, length)) % 4, a
    )
    leaves = jnp.asarray(np.stack([a, b]).astype(np.int32))
    topo = Topology(
        children=jnp.asarray([[0, 1]], dtype=jnp.int32),
        parents=jnp.asarray([2, 2, 2], dtype=jnp.int32),
    )

    # Exact: s = t0 + t1 is the only likelihood-visible quantity (JC is
    # reversible); prior of s is Gamma(2, rate); 1D quadrature.
    grid = jnp.linspace(1e-4, 1.5, 2000)
    lnl = np.asarray(
        jax.jit(
            jax.vmap(
                lambda s: tree_log_likelihood(
                    topo, jnp.stack([s, 0.0 * s, 0.0 * s]), leaves, 4
                )
            )
        )(grid)
    )
    g = np.asarray(grid)
    rate = 10.0
    logpost = lnl + np.log(g) - rate * g
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean_exact = float((w * g).sum())
    sd_exact = float(np.sqrt((w * (g - mean_exact) ** 2).sum()))

    res = mcmc_sample(
        jax.random.PRNGKey(1), leaves, 4,
        n_generations=4000, n_runs=1, n_chains=1, sample_every=4,
        burnin_frac=0.25, brlen_prior_mean=0.1, topo_moves=False,
        branch_moves_per_gen=2,
    )
    s = res.sample_lengths[:, 0] + res.sample_lengths[:, 1]
    # ~700 correlated samples: 4 standard errors of tolerance.
    assert abs(s.mean() - mean_exact) < 4 * sd_exact / np.sqrt(
        max(res.ess_lnl, 50.0)
    ) + 0.005
    assert abs(s.std() - sd_exact) < 0.012
    assert res.acceptance["branch"] > 0.2


def _all_rooted_5leaf(start: Topology) -> dict[bytes, Topology]:
    seen = {np.asarray(start.children).tobytes(): start}
    frontier = [start]
    while frontier:
        nxt = []
        for topo in frontier:
            for p in range(topo.n_all - 1):
                for v in range(topo.n_all - 1):
                    moved = spr_move(topo, p, v)
                    if moved is None:
                        continue
                    k = np.asarray(moved.children).tobytes()
                    if k not in seen:
                        seen[k] = moved
                        nxt.append(moved)
        frontier = nxt
    return seen


@pytest.mark.parametrize(
    "n_chains,informed_power", [(1, 0.5), (3, 0.5), (1, 0.2), (1, 0.1)]
)
def test_topology_posterior_matches_enumeration(n_chains, informed_power):
    """Sampled topology frequencies vs the exact 105-tree posterior.

    Branch lengths fixed (all equal) so the exact posterior is a softmax
    of per-tree log-likelihoods; n_chains=3 additionally exercises the
    MC^3 swap machinery (the cold posterior must be unchanged), and
    informed_power=0.2 / 0.1 (the production default, the measured ESS/s
    winner) pin that a softened proposal weight still targets the SAME
    posterior (only the Hastings factor changes)."""
    truth = _single(5, 5)
    bl = 0.2
    from trex_tpu.models.simulate import simulate_alignment

    aln = simulate_alignment(
        jax.random.PRNGKey(2), truth, np.full(9, bl, np.float32), n_sites=60
    )
    leaves = jnp.asarray(aln.astype(np.int32))

    seen = _all_rooted_5leaf(truth)
    assert len(seen) == 105
    keys = list(seen)
    children = jnp.asarray(np.stack([np.asarray(seen[k].children) for k in keys]))
    lens = jnp.full((9,), bl)
    lnls = np.asarray(
        jax.jit(
            jax.vmap(
                lambda ch: tree_log_likelihood(
                    Topology(children=ch, parents=jnp.zeros((9,), jnp.int32)),
                    lens, leaves, 4,
                )
            )
        )(children)
    )
    post = np.exp(lnls - lnls.max())
    post /= post.sum()
    exact = dict(zip(keys, post))

    res = mcmc_sample(
        jax.random.PRNGKey(3), leaves, 4,
        n_generations=12000, n_runs=1, n_chains=n_chains, sample_every=2,
        burnin_frac=0.15, branch_moves_per_gen=0, topo_moves=True,
        topo_informed_power=informed_power,
        start=truth, start_lengths=np.full(9, bl, np.float32),
    )
    counts: dict[bytes, int] = {}
    for c in res.sample_children:
        counts[c.tobytes()] = counts.get(c.tobytes(), 0) + 1
    n = sum(counts.values())
    assert set(counts) <= set(keys)  # chain stays on canonical topologies
    tvd = 0.5 * sum(abs(counts.get(k, 0) / n - exact[k]) for k in keys)
    assert tvd < 0.08
    if n_chains > 1:
        assert res.acceptance["swap"] > 0.2  # coupling actually mixes


def test_joint_sampling_converges_and_summarizes():
    """Joint topology + branch sampling: runs agree (ASDSF), consensus
    recovers the strongly supported simulated splits.

    Split summaries are canonically rooted (leaf 0), i.e. unrooted splits —
    the root itself is unidentifiable under a reversible model."""
    from trex_tpu.io import reroot_on_outgroup
    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.search.bootstrap import subtree_leaf_sets

    truth = _single(9, 8)
    aln = simulate_alignment(
        jax.random.PRNGKey(4), truth, np.full(15, 0.15, np.float32),
        n_sites=400,
    )
    leaves = jnp.asarray(aln.astype(np.int32))
    res = mcmc_sample(
        jax.random.PRNGKey(5), leaves, 4,
        n_generations=2000, n_runs=2, n_chains=1, sample_every=5,
        burnin_frac=0.3, branch_moves_per_gen=4,
    )
    assert res.asdsf is not None and res.asdsf < 0.05
    assert res.ess_lnl > 20
    # Strong data at 400 sites: the true splits carry high posterior mass.
    truth0 = reroot_on_outgroup(truth, [0])[0]
    true_splits = set(subtree_leaf_sets(truth0))
    high = {s for s, p in res.split_posterior.items() if p > 0.8}
    assert len(high & true_splits) >= 4
    assert high <= true_splits  # nothing wrong is strongly supported
    assert res.consensus_newick.count("(") >= 3
    # Posterior-mean branch lengths in a sane range around the truth.
    inner = res.mean_lengths[:-1]
    assert 0.03 < inner.mean() < 0.4


def test_carry_lengths_preserves_multiset_and_clades():
    from trex_tpu.io import nni_neighbors_host
    from trex_tpu.search.bootstrap import subtree_leaf_sets

    rng = np.random.default_rng(0)
    topo = _single(13, 10)
    lengths = rng.exponential(0.1, size=topo.n_all).astype(np.float32)
    lengths[-1] = 0.0
    nbr_c, _ = nni_neighbors_host(topo)
    old_sets = subtree_leaf_sets(topo)
    old_map = {
        s: lengths[topo.n_leaves + i] for i, s in enumerate(old_sets)
    }
    for j in range(nbr_c.shape[0]):
        new = Topology(
            children=nbr_c[j], parents=np.zeros(topo.n_all, np.int32)
        )
        out = carry_lengths_nni(topo, lengths, new)
        # Same multiset of lengths (prior invariance of the topology move).
        np.testing.assert_allclose(np.sort(out), np.sort(lengths), rtol=1e-6)
        # Every persisting clade keeps its length.
        for i, s in enumerate(subtree_leaf_sets(new)):
            if s in old_map:
                assert out[new.n_leaves + i] == pytest.approx(old_map[s])


def test_batch_carry_matches_reference_carry():
    """Hash-based vectorized carry == per-neighbor frozenset carry."""
    from trex_tpu.io import nni_neighbors_host
    from trex_tpu.search.mcmc import _carry_lengths_nni_batch

    rng = np.random.default_rng(1)
    for seed, n_leaves in ((0, 6), (1, 11), (2, 17)):
        topo = _single(seed, n_leaves)
        lengths = rng.exponential(0.1, size=topo.n_all).astype(np.float32)
        lengths[-1] = 0.0
        nbr_c, _ = nni_neighbors_host(topo)
        salt = rng.integers(1, 2**62, size=n_leaves, dtype=np.uint64) * 2 + 1
        got = _carry_lengths_nni_batch(
            np.asarray(topo.children), lengths, nbr_c, n_leaves, salt
        )
        for j in range(nbr_c.shape[0]):
            want = carry_lengths_nni(
                topo, lengths,
                Topology(
                    children=nbr_c[j],
                    parents=np.zeros(topo.n_all, np.int32),
                ),
            )
            np.testing.assert_allclose(got[j], want, rtol=1e-6)


def test_effective_sample_size_behaviour():
    rng = np.random.default_rng(0)
    iid = rng.normal(size=2000)
    ess_iid = effective_sample_size(iid)
    assert ess_iid > 1000
    # Strongly autocorrelated AR(1): ESS must collapse.
    x = np.zeros(2000)
    for i in range(1, 2000):
        x[i] = 0.98 * x[i - 1] + rng.normal() * 0.02
    assert effective_sample_size(x) < ess_iid / 5


def test_sampled_model_prior_recovers_dirichlet():
    """Full-Bayes mode, prior only: simplices must match Dirichlet(1).

    Dirichlet(1) marginals: freqs mean 1/4, sd sqrt(3/16/5) ~ 0.194;
    rates (k=6) mean 1/6, sd ~ 0.141. Tolerances account for the random
    walk's autocorrelation at proposal concentration 20."""
    res = mcmc_sample(
        jax.random.PRNGKey(0), jnp.zeros((5, 4), jnp.int32), 4,
        n_generations=5000, n_runs=1, n_chains=1, sample_every=4,
        burnin_frac=0.2, prior_only=True, sample_model=True,
        model_tuning=20.0, branch_moves_per_gen=1,
    )
    f, r = res.sample_freqs, res.sample_rates
    assert np.all(np.abs(f.mean(0) - 0.25) < 0.12)
    assert np.all(np.abs(r.mean(0) - 1 / 6) < 0.09)
    assert 0.10 < f.std(0).mean() < 0.28
    assert 0.08 < r.std(0).mean() < 0.22
    assert res.acceptance["model"] > 0.15


def test_sampled_model_recovers_gtr():
    """Full Bayes recovers HKY-like exchangeabilities + skewed freqs."""
    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.search.mcmc import _matrix_to_pairs

    truth = _single(7, 10)
    rates = np.ones((4, 4), np.float32)
    rates[0, 2] = rates[2, 0] = 4.0  # A<->G transitions
    rates[1, 3] = rates[3, 1] = 4.0  # C<->T transitions
    freqs = np.array([0.35, 0.15, 0.20, 0.30], np.float32)
    aln = simulate_alignment(
        jax.random.PRNGKey(1), truth, np.full(19, 0.15, np.float32),
        n_sites=1500, rates=rates, freqs=freqs,
    )
    res = mcmc_sample(
        jax.random.PRNGKey(2), jnp.asarray(aln.astype(np.int32)), 4,
        n_generations=2500, n_runs=1, n_chains=1, sample_every=5,
        burnin_frac=0.4, branch_moves_per_gen=4,
        sample_model=True, model_tuning=300.0,
        start=truth, topo_moves=False,
    )
    f = res.sample_freqs.mean(0)
    r = res.sample_rates.mean(0)
    np.testing.assert_allclose(f, freqs, atol=0.035)
    true_pairs = _matrix_to_pairs(rates, 4)
    np.testing.assert_allclose(r, true_pairs, atol=0.05)
    # Transitions (pairs AG=idx1, CT=idx4) clearly above transversions.
    transitions = r[[1, 4]].mean()
    transversions = r[[0, 2, 3, 5]].mean()
    assert transitions > 2.5 * transversions


def test_pallas_prior_folding_matches_lax():
    """Per-tree root priors folded into the root-child P == explicit prior.

    A scorer with one shared prior takes per-tree root priors by scaling
    the root's first child transition rows by diag(freqs) and summing with
    a ones prior (sum_s pi_s A_s B_s == sum_s (diag(pi) A)_s B_s). Checked
    against the pruning with explicit transition matrices + true prior."""
    from trex_tpu.ops.likelihood import (
        _per_site_log_likelihood,
        gtr_eigensystem,
        gtr_transition,
    )
    from trex_tpu.search.mcmc import _pairs_to_matrix

    rng = np.random.default_rng(0)
    n_leaves, q, length, batch = 7, 4, 96, 3
    topos = sample_topologies(5, n_leaves, batch)
    children = jnp.asarray(np.asarray(topos.children))
    n_all = 2 * n_leaves - 1
    lengths = jnp.asarray(
        rng.exponential(0.1, size=(batch, n_all)).astype(np.float32)
    )
    leaves = jnp.asarray(rng.integers(0, q, size=(n_leaves, length)))
    rates_v = jnp.asarray(
        rng.dirichlet(np.ones(q * (q - 1) // 2), size=batch).astype(np.float32)
    )
    freqs_v = jnp.asarray(rng.dirichlet(np.ones(q), size=batch).astype(np.float32))

    def pmats_of(lens_row, rv, fr):
        eigvals, left, right = gtr_eigensystem(_pairs_to_matrix(rv, q), fr)
        return jax.vmap(lambda t: gtr_transition(t, eigvals, left, right))(
            lens_row
        )

    pmats = jax.vmap(pmats_of)(lengths, rates_v, freqs_v)
    want = np.array([
        float(
            jnp.sum(
                _per_site_log_likelihood(
                    Topology(
                        children=children[b],
                        parents=jnp.zeros((n_all,), jnp.int32),
                    ),
                    lengths[b], leaves, q,
                    transition_matrices=pmats[b], root_prior=freqs_v[b],
                )
            )
        )
        for b in range(batch)
    ])
    c1 = children[:, -1, 0]
    folded = pmats.at[jnp.arange(batch), c1].multiply(freqs_v[:, :, None])
    got = np.array([
        float(
            jnp.sum(
                _per_site_log_likelihood(
                    Topology(
                        children=children[b],
                        parents=jnp.zeros((n_all,), jnp.int32),
                    ),
                    lengths[b], leaves, q,
                    transition_matrices=folded[b],
                    root_prior=jnp.ones((q,), jnp.float32),
                )
            )
        )
        for b in range(batch)
    ])
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5)


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """Interrupt + resume == uninterrupted run, sample for sample."""
    from trex_tpu.models.simulate import simulate_alignment

    truth = _single(9, 6)
    aln = simulate_alignment(
        jax.random.PRNGKey(4), truth, np.full(11, 0.15, np.float32),
        n_sites=120,
    )
    leaves = jnp.asarray(aln.astype(np.int32))
    common = dict(
        n_runs=1, n_chains=2, sample_every=5, burnin_frac=0.2,
        branch_moves_per_gen=2, sample_model=True, model_tuning=100.0,
    )
    full = mcmc_sample(
        jax.random.PRNGKey(5), leaves, 4, n_generations=600, **common
    )
    ckdir = str(tmp_path / "ck")
    # First leg: same FINAL target, interrupted after 300 generations.
    mcmc_sample(
        jax.random.PRNGKey(5), leaves, 4, n_generations=600,
        stop_after_generations=300,
        checkpoint_dir=ckdir, checkpoint_every=150, **common,
    )
    # Second leg: resumes from generation 300 and finishes.
    resumed = mcmc_sample(
        jax.random.PRNGKey(5), leaves, 4, n_generations=600,
        checkpoint_dir=ckdir, checkpoint_every=150, **common,
    )
    np.testing.assert_array_equal(resumed.sample_children, full.sample_children)
    np.testing.assert_array_equal(resumed.sample_lengths, full.sample_lengths)
    np.testing.assert_array_equal(resumed.sample_lnl, full.sample_lnl)
    np.testing.assert_array_equal(resumed.sample_rates, full.sample_rates)
    np.testing.assert_array_equal(resumed.sample_freqs, full.sample_freqs)
    assert resumed.acceptance == full.acceptance
