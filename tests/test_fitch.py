"""Fitch bitset parsimony: equivalence with Sankoff, kernel parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops.costs import exact_cost
from trex_tpu.ops.fitch import batched_fitch_score, fitch_reconstruct, fitch_score
from trex_tpu.ops.sankoff import batched_sankoff_score, sankoff_score
from trex_tpu.ops import fitch_pallas as fp
from trex_tpu.ops.fitch_pallas import batched_fitch_score_pallas
from trex_tpu.topology import (
    Topology,
    balanced_topology,
    random_topologies,
    topology_to_adjacency,
)
from trex_tpu.types import CostModel


def kernel_at_block(topos, leaf, site_block, *, site_weights=None,
                    sequences_are_masks=False,
                    table_budget=fp.TABLE_BUDGET_BYTES):
    """The scoring kernel (interpret mode) at a chosen site block."""
    return fp._fitch_scores(
        topos, leaf, site_weights, sequences_are_masks=sequences_are_masks,
        site_block=site_block, table_budget=table_budget, interpret=True,
    )


@pytest.mark.parametrize("n_leaves,q,length", [(4, 4, 20), (8, 2, 33), (16, 20, 40)])
def test_fitch_equals_sankoff_hamming(n_leaves, q, length):
    """Fitch == unit-cost Sankoff on every topology/alphabet tried."""
    topos = random_topologies(jax.random.PRNGKey(0), n_leaves, 8)
    leaf = jax.random.randint(jax.random.PRNGKey(1), (n_leaves, length), 0, q)
    cost = CostModel.hamming(q).matrix
    sankoff = batched_sankoff_score(topos, cost, leaf)
    fitch = batched_fitch_score(topos, leaf)
    np.testing.assert_array_equal(np.asarray(fitch), np.asarray(sankoff))


def test_fitch_pallas_matches_lax_interpret():
    n_leaves, q, length = 8, 4, 2048  # spans two site blocks
    topos = random_topologies(jax.random.PRNGKey(2), n_leaves, 4)
    leaf = jax.random.randint(jax.random.PRNGKey(3), (n_leaves, length), 0, q)
    want = batched_fitch_score(topos, leaf)
    got = batched_fitch_score_pallas(topos, leaf, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fitch_pallas_handles_unaligned_lengths():
    """Non-tile-multiple L is zero-padded; padded sites add no events."""
    n_leaves, q, length = 8, 4, 777
    topos = random_topologies(jax.random.PRNGKey(4), n_leaves, 2)
    leaf = jax.random.randint(jax.random.PRNGKey(5), (n_leaves, length), 0, q)
    want = batched_fitch_score(topos, leaf)
    got = batched_fitch_score_pallas(topos, leaf, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fitch_reconstruct_achieves_score():
    n_leaves, q, length = 8, 4, 50
    topo = balanced_topology(n_leaves)
    leaf = jax.random.randint(jax.random.PRNGKey(6), (n_leaves, length), 0, q)
    chosen, score = fitch_reconstruct(topo, leaf, q)
    assert float(score) == float(
        sankoff_score(topo, CostModel.hamming(q).matrix, leaf)
    )
    np.testing.assert_array_equal(np.asarray(chosen[:n_leaves]), np.asarray(leaf))
    realized = exact_cost(
        jax.nn.one_hot(chosen, q),
        topology_to_adjacency(topo),
        CostModel.hamming(q).matrix,
    )
    assert float(realized) == float(score)


def test_fitch_site_mask():
    topo = balanced_topology(4)
    leaf = jax.random.randint(jax.random.PRNGKey(7), (4, 10), 0, 4)
    padded = jnp.pad(leaf, ((0, 0), (0, 6)), constant_values=3)
    mask = jnp.arange(16) < 10
    assert float(fitch_score(topo, leaf)) == float(
        fitch_score(topo, padded, site_mask=mask)
    )


@pytest.mark.parametrize("site_block", [32, 64, 256])
def test_fitch_pallas_multi_tree_parity(site_block):
    """Every power-of-two site block gives the same scores."""
    n_leaves, q, length = 8, 4, 1024
    topos = random_topologies(jax.random.PRNGKey(8), n_leaves, 6)
    leaf = jax.random.randint(jax.random.PRNGKey(9), (n_leaves, length), 0, q)
    want = batched_fitch_score_pallas(topos, leaf, interpret=True)
    got = kernel_at_block(topos, leaf, site_block)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fitch_pallas_large_tree_pack_shrink():
    """512-leaf trees: 511 ancestor rows pad to a 512-row program table."""
    n_leaves, q, length = 512, 4, 256
    topos = random_topologies(jax.random.PRNGKey(12), n_leaves, 2)
    leaf = jax.random.randint(jax.random.PRNGKey(13), (n_leaves, length), 0, q)
    want = batched_fitch_score(topos, leaf)
    got = batched_fitch_score_pallas(topos, leaf, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fitch_sankoff_equivalence_fuzz():
    """Heavier randomized equivalence sweep across shapes and alphabets."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        n_leaves = int(rng.choice([4, 8, 16, 32]))
        q = int(rng.choice([2, 4, 20, 31]))
        length = int(rng.integers(5, 90))
        topos = random_topologies(jax.random.PRNGKey(trial), n_leaves, 3)
        leaf = jax.random.randint(
            jax.random.PRNGKey(100 + trial), (n_leaves, length), 0, q
        )
        cost = CostModel.hamming(q).matrix
        sankoff = batched_sankoff_score(topos, cost, leaf)
        fitch = batched_fitch_score(topos, leaf)
        np.testing.assert_array_equal(np.asarray(fitch), np.asarray(sankoff))


def test_fitch_state_sets_and_ambiguity():
    from trex_tpu.ops.fitch import fitch_state_sets

    topo = balanced_topology(4)
    # Site 0: all leaves agree -> every node set = {0}, ambiguity 1.
    # Site 1: leaves 0,1 = state 0; leaves 2,3 = state 1 -> root ambiguous.
    leaf = jnp.array([[0, 0], [0, 0], [0, 1], [0, 1]], dtype=jnp.int32)
    sets, amb = fitch_state_sets(topo, leaf)
    assert sets.shape == (7, 2) and amb.shape == (7, 2)
    np.testing.assert_array_equal(np.asarray(amb[:, 0]), np.ones(7))
    assert int(amb[-1, 1]) == 2  # root set {0,1}
    assert int(sets[-1, 1]) == 0b11
    np.testing.assert_array_equal(np.asarray(amb[:4]), np.ones((4, 2)))


def test_fitch_pallas_weighted_compressed_patterns():
    """Kernel weighted scoring == plain scoring on compressed patterns."""
    from trex_tpu.alignment import compress_alignment

    n_leaves, q, length = 8, 2, 300
    topos = random_topologies(jax.random.PRNGKey(14), n_leaves, 4)
    leaf = jax.random.randint(jax.random.PRNGKey(15), (n_leaves, length), 0, q)
    patterns, weights = compress_alignment(np.asarray(leaf))
    full = batched_fitch_score_pallas(topos, leaf, interpret=True)
    compressed = kernel_at_block(
        topos,
        jnp.asarray(patterns),
        64,
        site_weights=jnp.asarray(weights, jnp.float32),
    )
    np.testing.assert_array_equal(np.asarray(compressed), np.asarray(full))


@pytest.mark.parametrize("site_block", [32, 128])
def test_fitch_swar_packing_parity(site_block):
    # Weighted scores == lax Fitch exactly at a length that leaves a
    # partial last site block (weight-0, state-0 padding).
    rng = np.random.default_rng(17)
    n_leaves, length, batch = 10, 300, 5
    topos = random_topologies(jax.random.PRNGKey(17), n_leaves, batch)
    seqs = rng.integers(0, 4, size=(n_leaves, length)).astype(np.int32)
    weights = jnp.asarray(rng.integers(1, 4, size=length), jnp.float32)
    expected = jnp.stack(
        [
            fitch_score(
                jax.tree_util.tree_map(lambda a, i=i: a[i], topos),
                jnp.asarray(seqs), site_mask=weights,
            )
            for i in range(batch)
        ]
    )
    got = kernel_at_block(
        topos, jnp.asarray(seqs), site_block, site_weights=weights
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def test_fitch_swar_packing_masks_and_validation():
    rng = np.random.default_rng(19)
    topos = random_topologies(jax.random.PRNGKey(19), 8, 3)
    seqs = rng.integers(0, 4, size=(8, 70)).astype(np.int32)
    masks = (1 << seqs).astype(np.int32)
    masks[1, :6] = 0b1111
    expected = jnp.stack(
        [
            fitch_score(
                jax.tree_util.tree_map(lambda a, i=i: a[i], topos),
                jnp.asarray(masks), sequences_are_masks=True,
            )
            for i in range(3)
        ]
    )
    got = batched_fitch_score_pallas(
        topos, jnp.asarray(masks), interpret=True, sequences_are_masks=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))
    with pytest.raises(ValueError, match="power of two"):
        kernel_at_block(topos, jnp.asarray(seqs), 48)


@pytest.mark.parametrize(
    "length,requested,expected",
    [(1024, 128, 128), (70, 128, 128), (40, 128, 64), (5, 32, 8), (1, 32, 1)],
)
def test_site_block_shrinks_to_alignment(length, requested, expected):
    from trex_tpu.ops.fitch_pallas import site_block_for

    assert site_block_for(length, requested) == expected


@pytest.mark.parametrize("x,expected", [(1, 1), (2, 2), (3, 4), (63, 64), (64, 64), (65, 128)])
def test_next_pow2(x, expected):
    from trex_tpu.ops.fitch_pallas import next_pow2

    assert next_pow2(x) == expected


def test_fitch_kernel_partial_counts_reduce_to_scores():
    """Per-site partial counts, summed by XLA, give the weighted score; a
    batch of one tree and fractional weights take the same path."""
    rng = np.random.default_rng(23)
    topos = random_topologies(jax.random.PRNGKey(23), 6, 1)
    seqs = rng.integers(0, 4, size=(6, 45)).astype(np.int32)
    weights = rng.random(45).astype(np.float32)
    got = kernel_at_block(
        topos, jnp.asarray(seqs), 16, site_weights=jnp.asarray(weights)
    )
    t0 = jax.tree_util.tree_map(lambda a: a[0], topos)
    _, per_site = _per_site_events(t0, seqs)
    np.testing.assert_allclose(
        np.asarray(got), [np.sum(per_site * weights)], rtol=1e-6
    )


def _per_site_events(topo, seqs):
    """Host Fitch: (root set, per-site union events) of one tree."""
    children = np.asarray(topo.children)
    n = seqs.shape[0]
    sets = list(1 << seqs.astype(np.int64))
    events = np.zeros(seqs.shape[1])
    for c0, c1 in children:
        inter = sets[c0] & sets[c1]
        empty = inter == 0
        events += empty
        sets.append(np.where(empty, sets[c0] | sets[c1], inter))
    assert len(sets) == 2 * n - 1
    return sets[-1], events


@pytest.mark.parametrize("trees_per_chunk", [1, 2, 3, 5])
def test_fitch_kernel_table_budget_chunks_batch(trees_per_chunk):
    """A batch whose node tables exceed the budget runs in chunks of trees
    (the last chunk padded with all-zero trees); the scores equal lax."""
    n_leaves, length, batch, block = 10, 70, 5, 32
    topos = random_topologies(jax.random.PRNGKey(31), n_leaves, batch)
    leaf = jax.random.randint(jax.random.PRNGKey(32), (n_leaves, length), 0, 4)
    per_tree = fp.next_pow2(n_leaves - 1) * 96 * 4  # 70 sites pad to 96
    got = kernel_at_block(
        topos, leaf, block, table_budget=trees_per_chunk * per_tree
    )
    want = batched_fitch_score(topos, leaf)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "n_leaves,length,batch,grid,table_gb",
    [
        (64, 1024, 2048, (2048, 8), 0.54),
        (1024, 1024, 256, (256, 8), 1.07),
        (1024, 1024, 1024, (512, 8), 4.29),  # over budget: two chunks
        (12, 40, 3, (3, 1), 0.0),  # block shrinks to 64 sites
    ],
)
def test_fitch_kernel_grid_and_table_footprint(
    n_leaves, length, batch, grid, table_gb, monkeypatch
):
    """The public kernel uses the module's site block and table budget:
    one program per (tree, site block), and a node table of
    trees x n_anc_pad x padded_L int32 per call, at most 2 GiB."""
    seen = {}

    def fake_call(kernel, *, grid, out_shape, **kw):
        seen.update(grid=grid, table=out_shape[1].shape, backend=kw["backend"])
        return lambda *args: [jnp.zeros(out_shape[0].shape, jnp.int32), None]

    monkeypatch.setattr(fp.pl, "pallas_call", fake_call)
    monkeypatch.setattr(fp, "_fitch_scores", fp._fitch_scores.__wrapped__)
    n_anc = n_leaves - 1
    topos = Topology(
        children=jnp.zeros((batch, n_anc, 2), jnp.int32),
        parents=jnp.zeros((batch, 2 * n_leaves - 1), jnp.int32),
    )
    out = batched_fitch_score_pallas(
        topos, jnp.zeros((n_leaves, length), jnp.int32)
    )
    assert out.shape == (batch,)
    assert seen["backend"] == "triton"
    assert seen["grid"] == grid
    block = min(fp.FITCH_SITE_BLOCK, fp.next_pow2(length))
    assert seen["table"] == (grid[0], grid[1], fp.next_pow2(n_anc), block)
    table_bytes = 4 * int(np.prod(seen["table"]))
    assert table_bytes <= fp.TABLE_BUDGET_BYTES
    assert abs(batch / grid[0] * table_bytes / 1e9 - table_gb) < 0.01
