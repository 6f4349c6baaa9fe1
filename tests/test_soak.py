"""Randomized soak: every path agrees on a spread of random instances.

A compressed version of the standalone soak harness (/tmp-level runs use 40+
trials); guards the cross-path invariants against future regressions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.alignment import compress_alignment
from trex_tpu.ops.costs import exact_cost
from trex_tpu.ops.fitch import batched_fitch_score, fitch_reconstruct
from trex_tpu.ops.sankoff import batched_sankoff_score, sankoff_reconstruct
from trex_tpu.ops.dispatch import batched_scores_fastest
from trex_tpu.ops import fitch_pallas
from trex_tpu.ops.fitch_pallas import batched_fitch_score_pallas
from trex_tpu.io import align_leaf_order, load_newick, save_newick
from trex_tpu.search.bootstrap import subtree_leaf_sets
from trex_tpu.topology import random_topologies, topology_to_adjacency
from trex_tpu.types import CostModel


@pytest.mark.parametrize("trial", range(12))
def test_randomized_soak(trial):
    # Per-trial rng so trials are independent tests (smoke tier picks one).
    rng = np.random.default_rng(999 + trial)
    n_leaves = int(rng.choice([4, 8, 12, 24]))
    q = int(rng.choice([2, 4, 20]))
    length = int(rng.integers(3, 150))
    batch = int(rng.choice([1, 3, 6]))
    topos = random_topologies(jax.random.PRNGKey(trial), n_leaves, batch)
    leaf = jax.random.randint(
        jax.random.PRNGKey(5000 + trial), (n_leaves, length), 0, q
    )
    cost = CostModel.hamming(q).matrix
    ref = np.asarray(batched_sankoff_score(topos, cost, leaf))

    assert np.array_equal(np.asarray(batched_fitch_score(topos, leaf)), ref)
    assert np.array_equal(
        np.asarray(batched_scores_fastest(topos, cost, leaf)), ref
    )
    block = int(rng.choice([32, 128]))
    assert np.array_equal(
        np.asarray(
            fitch_pallas._fitch_scores(
                topos, leaf, None, sequences_are_masks=False,
                site_block=block,
                table_budget=fitch_pallas.TABLE_BUDGET_BYTES,
                interpret=True,
            )
        ),
        ref,
    )
    patterns, weights = compress_alignment(np.asarray(leaf))
    comp = batched_fitch_score_pallas(
        topos,
        jnp.asarray(patterns),
        site_weights=jnp.asarray(weights, jnp.float32),
        interpret=True,
    )
    assert np.array_equal(np.asarray(comp), ref)

    t0 = jax.tree_util.tree_map(lambda x: x[0], topos)
    recon, _, score = sankoff_reconstruct(t0, cost, leaf)
    realized = exact_cost(
        jax.nn.one_hot(recon, q), topology_to_adjacency(t0), cost
    )
    assert abs(float(realized) - float(score)) < 1e-3
    _, fitch_s = fitch_reconstruct(t0, leaf, q)
    assert float(fitch_s) == ref[0]

    names = [f"t{i}" for i in range(n_leaves)]
    back, _, names2 = load_newick(save_newick(t0, names))
    aligned = align_leaf_order(back, names2, names)
    assert set(subtree_leaf_sets(aligned)) == set(subtree_leaf_sets(t0))
