"""Grand consistency sweep: every scoring path agrees on random instances.

One randomized test ties the whole engine together: for random shapes,
alphabets, and topologies, the lax Sankoff DP, the Hamming closed form, the
Fitch bitsets, the GPU Fitch kernel (interpret mode), the dispatcher, the
weighted/compressed variants, and the sharded path must all return the
same scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.alignment import compress_alignment
from trex_tpu.ops.fitch import batched_fitch_score
from trex_tpu.ops.sankoff import (
    batched_sankoff_score,
    batched_sankoff_score_hamming,
)
from trex_tpu.ops.dispatch import batched_scores_fastest
from trex_tpu.ops.fitch_pallas import batched_fitch_score_pallas
from trex_tpu.parallel.mesh import make_mesh
from trex_tpu.parallel.sharded import sharded_batch_scores
from trex_tpu.topology import random_topologies
from trex_tpu.types import CostModel


@pytest.mark.parametrize("trial", range(4))
def test_all_paths_agree(trial):
    # Per-trial rng so trials are independent tests (smoke tier picks one).
    rng = np.random.default_rng(trial)
    mesh = make_mesh(jax.devices(), tree_parallelism=2)
    n_leaves = int(rng.choice([8, 16]))
    q = int(rng.choice([2, 4, 8]))
    length = int(rng.choice([64, 96, 128]))
    batch = 8
    topos = random_topologies(jax.random.PRNGKey(trial), n_leaves, batch)
    leaf = jax.random.randint(
        jax.random.PRNGKey(100 + trial), (n_leaves, length), 0, q
    )
    cost = CostModel.hamming(q).matrix

    ref = np.asarray(batched_sankoff_score(topos, cost, leaf))
    paths = {
        "lax-hamming": batched_sankoff_score_hamming(topos, cost, leaf),
        "fitch-lax": batched_fitch_score(topos, leaf),
        "dispatch": batched_scores_fastest(topos, cost, leaf),
        "fitch-kernel": batched_fitch_score_pallas(
            topos, leaf, interpret=True
        ),
        "sharded": sharded_batch_scores(mesh, topos, cost, leaf),
    }
    patterns, weights = compress_alignment(np.asarray(leaf))
    paths["fitch-kernel-compressed"] = batched_fitch_score_pallas(
        topos,
        jnp.asarray(patterns),
        site_weights=jnp.asarray(weights, jnp.float32),
        interpret=True,
    )
    for name, scores in paths.items():
        np.testing.assert_allclose(
            np.asarray(scores), ref, atol=1e-4,
            err_msg=f"trial {trial} path {name}",
        )
