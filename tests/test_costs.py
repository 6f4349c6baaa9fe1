"""Soft/surrogate/exact costs: naive-oracle parity and invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops.costs import exact_cost, soft_parsimony_cost, surrogate_cost
from trex_tpu.ops.sankoff import sankoff_score
from trex_tpu.topology import balanced_adjacency, balanced_topology
from trex_tpu.types import CostModel


def naive_surrogate(seqs, adj):
    """O(N^2 L Q) direct evaluation of 1/2 sum_ij A_ij ||S_i - S_j||^2."""
    n = seqs.shape[0]
    total = 0.0
    for i in range(n):
        for j in range(n):
            d = seqs[i] - seqs[j]
            total += adj[i, j] * np.sum(d * d)
    return total / 2.0


def naive_soft(seqs, adj, cost):
    n = seqs.shape[0]
    total = 0.0
    for i in range(n):
        for j in range(n):
            d = seqs[i] - seqs[j]  # (L, Q)
            total += adj[i, j] * np.einsum("lq,qr,lr->", d, cost, d)
    return total / 2.0


@pytest.fixture
def soft_inputs():
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    n, length, q = 7, 6, 4
    seqs = jax.nn.softmax(jax.random.normal(k1, (n, length, q)), axis=-1)
    adj = jax.nn.softmax(jax.random.normal(k2, (n, n)), axis=-1)
    return seqs, adj


def test_surrogate_matches_naive(soft_inputs):
    seqs, adj = soft_inputs
    got = surrogate_cost(seqs, adj)
    want = naive_surrogate(np.asarray(seqs), np.asarray(adj))
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_soft_cost_matches_naive(soft_inputs):
    seqs, adj = soft_inputs
    cost = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
    got = soft_parsimony_cost(seqs, adj, jnp.asarray(cost))
    want = naive_soft(np.asarray(seqs), np.asarray(adj), cost)
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_soft_cost_diagonal_and_none(soft_inputs):
    seqs, adj = soft_inputs
    diag = jnp.ones(4)
    full = jnp.eye(4)
    a = soft_parsimony_cost(seqs, adj, diag)
    b = soft_parsimony_cost(seqs, adj, full)
    c = soft_parsimony_cost(seqs, adj, None)
    assert float(a) == pytest.approx(float(b), rel=1e-5)
    assert float(a) == pytest.approx(float(c), rel=1e-5)


def test_costs_nonnegative_and_zero_on_identical(soft_inputs):
    seqs, adj = soft_inputs
    assert float(surrogate_cost(seqs, adj)) >= 0
    same = jnp.broadcast_to(seqs[0], seqs.shape)
    assert float(surrogate_cost(same, adj)) == pytest.approx(0.0, abs=1e-5)


def test_exact_cost_agrees_with_sankoff_on_full_labeling():
    """With ALL node states given, exact_cost == per-edge Hamming sum, and the
    Sankoff score of the leaves alone lower-bounds it."""
    n_leaves, q, length = 8, 4, 16
    key = jax.random.PRNGKey(7)
    states = jax.random.randint(key, (2 * n_leaves - 1, length), 0, q)
    adj = balanced_adjacency(n_leaves)
    cm = CostModel.hamming(q).matrix
    one_hot = jax.nn.one_hot(states, q)
    got = exact_cost(one_hot, adj, cm)

    parents = np.asarray(jnp.argmax(adj, axis=1))
    s = np.asarray(states)
    want = sum(
        (s[i] != s[parents[i]]).sum() for i in range(2 * n_leaves - 2)
    )
    assert float(got) == want

    opt = sankoff_score(balanced_topology(n_leaves), cm, states[:n_leaves])
    assert float(opt) <= float(got)


def test_surrogate_gradients_flow(soft_inputs):
    seqs, adj = soft_inputs
    g = jax.grad(lambda s: surrogate_cost(s, adj))(seqs)
    assert g.shape == seqs.shape
    assert jnp.all(jnp.isfinite(g))
    assert float(jnp.abs(g).sum()) > 0


def test_transition_transversion_cost_model():
    cm = CostModel.transition_transversion(1.0, 2.5)
    m = np.asarray(cm.matrix)
    assert m.shape == (4, 4)
    np.testing.assert_array_equal(np.diag(m), np.zeros(4))
    # A<->G and C<->T are transitions (ACGT order).
    assert m[0, 2] == m[2, 0] == 1.0
    assert m[1, 3] == m[3, 1] == 1.0
    assert m[0, 1] == m[0, 3] == 2.5
    # Weighted parsimony via the general-cost dispatch agrees with lax.
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.ops.sankoff import batched_sankoff_score
    from trex_tpu.topology import random_topologies

    topos = random_topologies(jax.random.PRNGKey(0), 8, 3)
    leaf = jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, 4)
    want = batched_sankoff_score(topos, cm.matrix, leaf)
    got = batched_scores_fastest(topos, cm.matrix, leaf)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _brute_force_parsimony(children, n_leaves, cost, leaf, weights):
    """Min over every ancestral labeling, site by site (tiny trees only)."""
    import itertools

    n_anc = n_leaves - 1
    cost = np.asarray(cost)
    total = 0.0
    for site in range(leaf.shape[1]):
        best = np.inf
        for labels in itertools.product(range(cost.shape[0]), repeat=n_anc):
            state = list(leaf[:, site]) + list(labels)
            c = sum(
                cost[state[n_leaves + a], state[child]]
                for a in range(n_anc)
                for child in children[a]
            )
            best = min(best, c)
        total += weights[site] * best
    return total


@pytest.mark.parametrize("n_leaves", [3, 4, 5])
def test_general_cost_dispatch_matches_brute_force(n_leaves):
    """Non-Hamming costs take the lax min-plus path: exact minimum."""
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.topology import random_topologies

    rng = np.random.default_rng(n_leaves)
    cost = rng.integers(1, 5, (4, 4)).astype(np.float32)
    cost = (cost + cost.T) / 2
    np.fill_diagonal(cost, 0.0)
    topos = random_topologies(jax.random.PRNGKey(n_leaves), n_leaves, 3)
    leaf = rng.integers(0, 4, (n_leaves, 6)).astype(np.int32)
    weights = rng.integers(1, 4, 6).astype(np.float32)
    got = np.asarray(
        batched_scores_fastest(
            topos, jnp.asarray(cost), jnp.asarray(leaf),
            site_weights=jnp.asarray(weights),
        )
    )
    children = np.asarray(topos.children)
    want = [
        _brute_force_parsimony(children[b], n_leaves, cost, leaf, weights)
        for b in range(3)
    ]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
