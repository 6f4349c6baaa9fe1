"""Ambiguity (state-set bitmask) support in the likelihood paths.

Correctness contract: a tip partial with 1 at every allowed state makes the
site likelihood the SUM over all resolutions of the ambiguity (linearity of
the pruning recursion in each tip partial) — the standard missing-data
treatment in ML phylogenetics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops.likelihood import (
    batched_log_likelihood,
    optimize_branch_lengths,
    tree_log_likelihood,
    tree_log_likelihood_gamma,
)
from trex_tpu.topology import random_topologies

Q = 4


def _case(seed: int, n_leaves: int = 6, length: int = 10):
    rng = np.random.default_rng(seed)
    topo = jax.tree.map(
        lambda a: a[0], random_topologies(jax.random.key(seed), n_leaves, 1)
    )
    seqs = rng.integers(0, Q, size=(n_leaves, length)).astype(np.int32)
    blens = jnp.asarray(rng.uniform(0.05, 0.4, size=topo.n_all))
    return topo, seqs, blens


@pytest.mark.parametrize("seed", [0, 1])
def test_singleton_masks_match_integer_states(seed):
    topo, seqs, blens = _case(seed)
    masks = jnp.asarray((1 << seqs).astype(np.int32))
    expected = tree_log_likelihood(topo, blens, jnp.asarray(seqs), Q)
    got = tree_log_likelihood(topo, blens, masks, Q, sequences_are_masks=True)
    np.testing.assert_allclose(float(got), float(expected), rtol=1e-6)
    g_expected = tree_log_likelihood_gamma(
        topo, blens, jnp.asarray(seqs), Q, gamma_shape=0.7
    )
    g_got = tree_log_likelihood_gamma(
        topo, blens, masks, Q, gamma_shape=0.7, sequences_are_masks=True
    )
    np.testing.assert_allclose(float(g_got), float(g_expected), rtol=1e-6)


def test_ambiguous_site_is_sum_over_resolutions():
    topo, seqs, blens = _case(7, length=1)
    allowed = [0, 2, 3]
    masks = (1 << seqs).astype(np.int32)
    masks[1, 0] = sum(1 << s for s in allowed)
    got = float(
        tree_log_likelihood(
            topo, blens, jnp.asarray(masks), Q, sequences_are_masks=True
        )
    )
    parts = []
    for s in allowed:
        variant = seqs.copy()
        variant[1, 0] = s
        parts.append(
            float(tree_log_likelihood(topo, blens, jnp.asarray(variant), Q))
        )
    expected = np.log(np.sum(np.exp(parts)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_fully_missing_leaf_marginalizes_out():
    # A leaf that is all-ambiguous with a ZERO branch contributes exactly 1:
    # summing uniform tip partials over P(0)=I leaves the sibling unchanged.
    # With a positive branch, rows of P sum to 1, same result (JC69 is
    # doubly stochastic) — the leaf drops out of the likelihood entirely.
    topo, seqs, blens = _case(9)
    masks = (1 << seqs).astype(np.int32)
    masks[3, :] = (1 << Q) - 1
    got = float(
        tree_log_likelihood(
            topo, blens, jnp.asarray(masks), Q, sequences_are_masks=True
        )
    )
    # Oracle: sum over the missing leaf's resolutions per site.
    per_site = []
    for col in range(seqs.shape[1]):
        vals = []
        for s in range(Q):
            variant = seqs[:, col : col + 1].copy()
            variant[3, 0] = s
            vals.append(
                float(
                    tree_log_likelihood(topo, blens, jnp.asarray(variant), Q)
                )
            )
        per_site.append(np.log(np.sum(np.exp(vals))))
    np.testing.assert_allclose(got, np.sum(per_site), rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
def test_pallas_interpret_matches_lax_with_masks(batch):
    """The batched ML scorer == per-tree log-likelihood, ambiguity present."""
    rng = np.random.default_rng(11)
    n_leaves, length = 8, 24
    topos = random_topologies(jax.random.key(11), n_leaves, batch)
    seqs = rng.integers(0, Q, size=(n_leaves, length)).astype(np.int32)
    masks = (1 << seqs).astype(np.int32)
    masks[0, :4] = 0b1111
    masks[2, 5] = 0b0101
    blens = jnp.full((batch, 2 * n_leaves - 1), 0.15)
    expected = jnp.stack(
        [
            tree_log_likelihood(
                jax.tree.map(lambda a, i=i: a[i], topos),
                blens[i],
                jnp.asarray(masks),
                Q,
                sequences_are_masks=True,
            )
            for i in range(batch)
        ]
    )
    got = batched_log_likelihood(
        topos, blens, jnp.asarray(masks), Q, sequences_are_masks=True,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), rtol=2e-5)


def test_compressed_patterns_exact_for_likelihood():
    # Weighted unique-pattern log-lik == full-alignment log-lik, per tree
    # and through the batched scorer, with ambiguity present.
    from trex_tpu.alignment import compress_alignment

    rng = np.random.default_rng(21)
    n_leaves, length = 7, 60
    topos = random_topologies(jax.random.key(21), n_leaves, 2)
    # Few distinct columns -> real compression.
    base = rng.integers(0, Q, size=(n_leaves, 6)).astype(np.int32)
    seqs = base[:, rng.integers(0, 6, size=length)]
    masks = (1 << seqs).astype(np.int32)
    masks[0, :3] = 0b1111
    patterns, weights = compress_alignment(masks)
    assert patterns.shape[1] < length
    blens = jnp.full((2, 2 * n_leaves - 1), 0.2)

    topo0 = jax.tree.map(lambda a: a[0], topos)
    full = tree_log_likelihood(
        topo0, blens[0], jnp.asarray(masks), Q, sequences_are_masks=True
    )
    compressed = tree_log_likelihood(
        topo0, blens[0], jnp.asarray(patterns), Q,
        site_mask=jnp.asarray(weights, jnp.float32), sequences_are_masks=True,
    )
    np.testing.assert_allclose(float(compressed), float(full), rtol=1e-6)

    kernel_full = batched_log_likelihood(
        topos, blens, jnp.asarray(masks), Q, sequences_are_masks=True,
    )
    kernel_compressed = batched_log_likelihood(
        topos, blens, jnp.asarray(patterns), Q,
        site_weights=jnp.asarray(weights, jnp.float32),
        sequences_are_masks=True,
    )
    np.testing.assert_allclose(
        np.asarray(kernel_compressed), np.asarray(kernel_full), rtol=2e-5
    )


def test_kernel_site_block_shrink_stays_lane_aligned():
    # 64 leaves x 1331 sites (an odd length) through the batched scorer
    # equals the per-tree likelihood.
    rng = np.random.default_rng(31)
    n_leaves, length = 64, 1331
    topos = random_topologies(jax.random.key(31), n_leaves, 2)
    seqs = jnp.asarray(rng.integers(0, Q, size=(n_leaves, length)).astype(np.int32))
    blens = jnp.full((2, 2 * n_leaves - 1), 0.1)
    got = batched_log_likelihood(topos, blens, seqs, Q)
    expected = jnp.stack(
        [
            tree_log_likelihood(
                jax.tree.map(lambda a, i=i: a[i], topos), blens[i], seqs, Q
            )
            for i in range(2)
        ]
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), rtol=2e-5)


def test_branch_length_optimization_with_masks():
    topo, seqs, _ = _case(13, n_leaves=5, length=40)
    masks = (1 << seqs).astype(np.int32)
    masks[1, :8] = 0b1111
    lengths, losses = optimize_branch_lengths(
        topo, jnp.asarray(masks), Q, n_iterations=60,
        sequences_are_masks=True,
    )
    assert np.all(np.asarray(lengths) > 0)
    assert float(losses[-1]) < float(losses[0])  # gradient flows through masks


def test_ml_hill_climb_with_masks_smoke():
    from trex_tpu.search.ml import ml_hill_climb

    topo, seqs, _ = _case(17, n_leaves=6, length=30)
    masks = (1 << seqs).astype(np.int32)
    masks[4, :5] = 0b1111
    result, lengths, losses = ml_hill_climb(
        topo, jnp.asarray(masks), Q, max_rounds=3, neighborhood="nni",
        n_length_iterations=40, sequences_are_masks=True,
    )
    assert np.isfinite(result.score)
    assert np.all(np.asarray(lengths) > 0)
