"""The GPU kernels, compiled for the card, against lax at real widths.

Marked ``gpu``: they skip without a card (the ``gpu`` fixture decides at
run time). On a card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
``chip_smoke.py`` runs the same comparisons in its phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops.fitch import fitch_score
from trex_tpu.ops.fitch_pallas import (
    batched_fitch_score_pallas,
    insertion_delta_pallas,
)
from trex_tpu.search.stepwise import insertion_delta_lax
from trex_tpu.topology import random_topologies

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize(
    "n_leaves,length,batch",
    # 1024 trees of 1024 taxa: 4.3 GB of node tables, so two chunks.
    [(64, 1024, 2048), (1024, 1024, 256), (1024, 1024, 1024)],
)
def test_fitch_kernel_matches_lax_at_width(gpu, n_leaves, length, batch):
    topos = random_topologies(jax.random.PRNGKey(0), n_leaves, batch)
    leaf = jax.random.randint(jax.random.PRNGKey(1), (n_leaves, length), 0, 4)
    want = jax.jit(jax.vmap(fitch_score, in_axes=(0, None)))(topos, leaf)
    got = batched_fitch_score_pallas(topos, leaf)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n_leaves,length", [(1024, 1024), (2048, 4096)])
def test_insertion_kernel_matches_lax_at_width(gpu, n_leaves, length):
    rng = np.random.default_rng(0)
    topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(7), n_leaves, 1)
    )
    children = np.asarray(topo.children)
    parents = np.asarray(topo.parents)
    t = 5
    row = parents[t] - n_leaves
    sib = int(children[row].sum() - t)
    var = children.copy()
    var[row] = (sib, sib)
    up = np.zeros((2 * n_leaves - 1, length), np.int32)
    up[:n_leaves] = 1 << rng.integers(0, 4, (n_leaves, length))
    for a, (c0, c1) in enumerate(var):
        inter = up[c0] & up[c1]
        up[n_leaves + a] = np.where(inter == 0, up[c0] | up[c1], inter)
    weights = jnp.asarray(rng.integers(1, 4, length), jnp.float32)
    var_d, up_d = jnp.asarray(var), jnp.asarray(up)
    want = jax.jit(insertion_delta_lax)(var_d, up_d, up_d[t], weights)
    got = insertion_delta_pallas(
        var_d, up_d, jnp.int32(t), weights, n_leaves=n_leaves
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
