"""The batched ML scorer (``ops.likelihood.batched_log_likelihood``).

It ranks candidates for the enumerating ML climbs, the ML bootstrap and
the mesh-sharded scorer. Oracles: per-tree ``tree_log_likelihood`` over
tree counts, odd lengths, ambiguity masks, site weights and the shared
transition; and brute-force enumeration of every ancestral state assignment
at 5 taxa or fewer.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops.likelihood import (
    _per_site_log_likelihood,
    batched_log_likelihood,
    gtr_eigensystem,
    gtr_transition,
    jc69_transition,
    tree_log_likelihood,
)
from trex_tpu.topology import random_topologies

Q = 4
RATES = np.array(
    [[0, 1, 4, 1], [1, 0, 1, 4], [4, 1, 0, 1], [1, 4, 1, 0]], np.float32
)
FREQS = np.array([0.3, 0.2, 0.3, 0.2], np.float32)


def _case(seed, n_leaves, length, batch):
    rng = np.random.default_rng(seed)
    topos = random_topologies(jax.random.key(seed), n_leaves, batch)
    seqs = rng.integers(0, Q, size=(n_leaves, length)).astype(np.int32)
    blens = rng.uniform(0.02, 0.4, size=(batch, 2 * n_leaves - 1))
    return topos, jnp.asarray(seqs), jnp.asarray(blens, jnp.float32), rng


def _per_tree(topos, blens, leaves, **kw):
    return np.array([
        float(
            tree_log_likelihood(
                jax.tree.map(lambda a, i=i: a[i], topos), blens[i], leaves, Q,
                **kw,
            )
        )
        for i in range(blens.shape[0])
    ])


@pytest.mark.parametrize("batch", [1, 2, 5, 8])
def test_matches_per_tree_over_tree_counts(batch):
    topos, seqs, blens, _ = _case(batch, 7, 40, batch)
    got = np.asarray(batched_log_likelihood(topos, blens, seqs, Q))
    np.testing.assert_allclose(got, _per_tree(topos, blens, seqs), rtol=1e-5)


@pytest.mark.parametrize("length", [1, 37, 129, 300])
def test_matches_per_tree_at_unaligned_lengths(length):
    topos, seqs, blens, _ = _case(10 + length, 6, length, 3)
    got = np.asarray(batched_log_likelihood(topos, blens, seqs, Q))
    np.testing.assert_allclose(got, _per_tree(topos, blens, seqs), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_and_site_weights(seed):
    topos, seqs, blens, rng = _case(20 + seed, 8, 50, 3)
    masks = np.asarray(1 << np.asarray(seqs), np.int32)
    masks[0, :5] = 0b1111
    masks[3, 7] = 0b0110
    masks = jnp.asarray(masks)
    weights = jnp.asarray(rng.integers(0, 4, 50), jnp.float32)
    got = np.asarray(
        batched_log_likelihood(
            topos, blens, masks, Q, site_weights=weights,
            sequences_are_masks=True,
        )
    )
    want = _per_tree(
        topos, blens, masks, site_mask=weights, sequences_are_masks=True
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_zero_weights_give_zero():
    topos, seqs, blens, _ = _case(30, 5, 12, 2)
    got = batched_log_likelihood(
        topos, blens, seqs, Q, site_weights=jnp.zeros((12,), jnp.float32)
    )
    np.testing.assert_array_equal(np.asarray(got), np.zeros(2))


def _shared(model, t):
    if model == "jc":
        return jc69_transition(jnp.asarray(t), Q), None
    eig = gtr_eigensystem(jnp.asarray(RATES), jnp.asarray(FREQS))
    return gtr_transition(jnp.asarray(t), *eig), jnp.asarray(FREQS)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_shared_transition_equals_per_node(model):
    """One shared (Q, Q) matrix == the same matrix on every branch."""
    topos, seqs, _, _ = _case(40, 9, 64, 4)
    blens = jnp.full((4, 17), 0.15)
    shared, prior = _shared(model, 0.15)
    got = batched_log_likelihood(
        topos, blens, seqs, Q, shared_transition=shared, root_prior=prior
    )
    want = [
        float(
            jnp.sum(
                _per_site_log_likelihood(
                    jax.tree.map(lambda a, i=i: a[i], topos), blens[i], seqs,
                    Q, transition_matrices=jnp.broadcast_to(
                        shared, (17, Q, Q)
                    ),
                    root_prior=jnp.full((Q,), 0.25) if prior is None
                    else prior,
                )
            )
        )
        for i in range(4)
    ]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


def test_shared_gtr_matches_model_arguments():
    """Eigensystem shared matrix == per-branch GTR (expm) from rates/freqs."""
    topos, seqs, _, _ = _case(50, 8, 80, 3)
    blens = jnp.full((3, 15), 0.1)
    shared, prior = _shared("gtr", 0.1)
    got = batched_log_likelihood(
        topos, blens, seqs, Q, shared_transition=shared, root_prior=prior
    )
    want = _per_tree(
        topos, blens, seqs, rates=jnp.asarray(RATES), freqs=jnp.asarray(FREQS)
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4)


def _jc_matrix(t):
    same = 0.25 + 0.75 * np.exp(-4.0 * t / 3.0)
    diff = 0.25 - 0.25 * np.exp(-4.0 * t / 3.0)
    return np.where(np.eye(Q, dtype=bool), same, diff)


def _brute_force(children, n_leaves, pmats, prior, leaves):
    """Sum over every ancestral assignment, site by site."""
    n_anc = n_leaves - 1
    total = 0.0
    for site in range(leaves.shape[1]):
        lik = 0.0
        for labels in itertools.product(range(Q), repeat=n_anc):
            state = list(leaves[:, site]) + list(labels)
            p = prior[state[-1]]
            for a in range(n_anc):
                for c in children[a]:
                    p *= pmats[c][state[n_leaves + a], state[c]]
            lik += p
        total += np.log(lik)
    return total


@pytest.mark.parametrize("model", ["jc-per-branch", "shared-gtr"])
@pytest.mark.parametrize("n_leaves", [2, 3, 4, 5])
def test_brute_force_enumeration(n_leaves, model):
    rng = np.random.default_rng(n_leaves)
    topos = random_topologies(jax.random.key(70 + n_leaves), n_leaves, 2)
    seqs = rng.integers(0, Q, size=(n_leaves, 4)).astype(np.int32)
    n_all = 2 * n_leaves - 1
    blens = rng.uniform(0.05, 0.5, size=(2, n_all)).astype(np.float32)
    children = np.asarray(topos.children)
    if model == "jc-per-branch":
        got = batched_log_likelihood(
            topos, jnp.asarray(blens), jnp.asarray(seqs), Q
        )
        pmats = [[_jc_matrix(t) for t in row] for row in blens]
        prior = np.full(Q, 0.25)
    else:
        shared, prior = _shared("gtr", 0.2)
        got = batched_log_likelihood(
            topos, jnp.asarray(blens), jnp.asarray(seqs), Q,
            shared_transition=shared, root_prior=prior,
        )
        pmats = [[np.asarray(shared, np.float64)] * n_all] * 2
        prior = np.asarray(prior, np.float64)
    want = [
        _brute_force(children[b], n_leaves, pmats[b], prior, seqs)
        for b in range(2)
    ]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)
