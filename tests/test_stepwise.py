"""Stepwise-addition starting trees (device-batched greedy construction)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.models.mutation_tree import generate_groundtruth
from trex_tpu.ops.fitch import fitch_score
from trex_tpu.search.ratchet import rf_distance_unrooted
from trex_tpu.search.stepwise import stepwise_addition, stepwise_addition_multi
from trex_tpu.topology import topology_from_adjacency


def _groundtruth(n_leaves=16, seed=3):
    data = generate_groundtruth(
        n_leaves=n_leaves, n_states=4, n_mutations=3, seq_length=400, seed=seed
    )
    true = topology_from_adjacency(data.adjacency, n_leaves)
    return true, data.masked_sequences[:n_leaves]


def _assert_valid_topology(topo):
    children = np.asarray(topo.children)
    parents = np.asarray(topo.parents)
    n_leaves = topo.n_leaves
    for a in range(topo.n_ancestors):
        node = n_leaves + a
        assert children[a, 0] < children[a, 1] < node
        assert parents[children[a, 0]] == node
        assert parents[children[a, 1]] == node
    assert parents[-1] == topo.n_all - 1
    # Every non-root node appears exactly once as a child.
    flat = children.ravel()
    assert sorted(flat) == list(range(topo.n_all - 1))


def test_reported_score_matches_exact_rescore():
    _, seqs = _groundtruth()
    topo, score = stepwise_addition(seqs, 4, seed=1)
    _assert_valid_topology(topo)
    assert float(fitch_score(topo, jnp.asarray(seqs))) == score


def test_recovers_generating_topology():
    true, seqs = _groundtruth()
    topo, score = stepwise_addition(seqs, 4, seed=0)
    true_score = float(fitch_score(true, jnp.asarray(seqs)))
    # Greedy construction on low-homoplasy data: parsimony-optimal, and the
    # tree itself matches the generator.
    assert score <= true_score
    assert rf_distance_unrooted(topo, true) == 0


def test_explicit_order_and_validation():
    _, seqs = _groundtruth(n_leaves=8, seed=5)
    order = np.arange(8)
    topo, score = stepwise_addition(seqs, 4, order=order)
    _assert_valid_topology(topo)
    with pytest.raises(ValueError, match="permutation"):
        stepwise_addition(seqs, 4, order=np.zeros(8, dtype=int))
    with pytest.raises(ValueError, match="at least 3"):
        stepwise_addition(seqs[:2], 4)


def test_multi_order_takes_best():
    _, seqs = _groundtruth(n_leaves=8, seed=9)
    single_scores = [
        stepwise_addition(seqs, 4, seed=s)[1] for s in range(4)
    ]
    _, best = stepwise_addition_multi(seqs, 4, n_orders=4, seed=0)
    assert best <= max(single_scores)


def test_scan_and_batched_paths_agree():
    from trex_tpu.io import native

    if not native.available():
        pytest.skip("native library unavailable")
    _, seqs = _groundtruth(n_leaves=16, seed=21)
    for seed in (0, 1):
        t_scan, s_scan = stepwise_addition(seqs, 4, seed=seed, use_scan=True)
        t_batch, s_batch = stepwise_addition(seqs, 4, seed=seed, use_scan=False)
        # Same greedy rule, same exact per-edge scores: equal tree quality
        # (tie-breaking order may differ between the two evaluators).
        assert s_scan == s_batch
        _assert_valid_topology(t_scan)
        assert float(fitch_score(t_scan, jnp.asarray(np.asarray(seqs)))) == s_scan


def test_masks_input_and_site_weights():
    _, seqs = _groundtruth(n_leaves=8, seed=11)
    seqs = np.asarray(seqs)
    masks = (1 << seqs.astype(np.int32)).astype(np.int32)
    masks[0, :5] = 0b1111  # some missing data in taxon 0
    weights = np.ones(seqs.shape[1], dtype=np.float32)
    weights[:10] = 2.0
    topo, score = stepwise_addition(
        masks, 4, sequences_are_masks=True, site_weights=jnp.asarray(weights),
        seed=2,
    )
    _assert_valid_topology(topo)
    expected = float(
        fitch_score(
            topo, jnp.asarray(masks), site_mask=jnp.asarray(weights),
            sequences_are_masks=True,
        )
    )
    assert score == expected


def test_device_loop_block_invariance():
    """The superblocked device loop is bit-identical per block size: one
    insertion per dispatch == all insertions in one dispatch."""
    from trex_tpu.search.stepwise import _stepwise_scan

    _, seqs = _groundtruth(n_leaves=16, seed=31)
    seqs = np.asarray(seqs)[:12]  # non-power-of-two taxon count on purpose
    masks = (1 << seqs.astype(np.int32)).astype(np.int32)
    ham = jnp.ones((4, 4)) - jnp.eye(4)
    fm = np.int32(0b1111)
    order = list(np.random.default_rng(5).permutation(12))
    t1, s1 = _stepwise_scan(masks, 4, order, fm, None, ham, block=1)
    t2, s2 = _stepwise_scan(masks, 4, order, fm, None, ham, block=64)
    assert s1 == s2
    np.testing.assert_array_equal(
        np.asarray(t1.children), np.asarray(t2.children)
    )


def test_device_insertion_steps_are_optimal():
    """Brute-force oracle for the on-device insertion scan + slot-shift
    apply: after every step, the realized (padded) tree score equals the
    MINIMUM over all induced-edge insertions, each evaluated from scratch
    with the exact Fitch scorer. Validates the restricted-SPR identity
    scores AND the shift renumbering in one property."""
    from trex_tpu.search.stepwise import (
        _children_to_parents,
        _initial_up,
        _stepwise_block,
    )
    from trex_tpu.topology import Topology

    rng = np.random.default_rng(17)
    # length must be a _SITE_CHUNKS multiple when driving _stepwise_block
    # directly (the production wrapper pads).
    n, length, q = 10, 48, 4
    seqs = rng.integers(0, q, (n, length))
    masks = (1 << seqs.astype(np.int32)).astype(np.int32)
    order = list(rng.permutation(n))
    full_mask = np.int32((1 << q) - 1)

    # Seed state exactly as _stepwise_scan builds it.
    n_anc = n - 1
    t0, t1, t2 = order[:3]
    children = np.empty((n_anc, 2), np.int32)
    children[0] = sorted((t0, t1))
    children[1] = sorted((n, t2))
    prev = n + 1
    for j, t in enumerate(order[3:]):
        children[2 + j] = sorted((prev, t))
        prev = n + 2 + j
    scored = np.full_like(masks, full_mask)
    for t in order[:3]:
        scored[t] = masks[t]
    added = np.zeros((n,), bool)
    added[order[:3]] = True
    children_dev = jnp.asarray(children)
    scored_dev = jnp.asarray(scored.astype(np.int32))
    state = (
        children_dev, scored_dev, jnp.asarray(added),
        _initial_up(children_dev, scored_dev, n_leaves=n),
    )
    order_dev = jnp.asarray(order, jnp.int32)
    masks_dev = jnp.asarray(masks.astype(np.int32))
    weights = jnp.ones((length,), jnp.float32)

    def padded_score(children_np, scored_np):
        topo = Topology(
            children=jnp.asarray(children_np),
            parents=jnp.asarray(_children_to_parents(children_np, n)),
        )
        return float(
            fitch_score(
                topo, jnp.asarray(scored_np), sequences_are_masks=True
            )
        )

    def host_insert(children_np, k, v):
        """Apply the slot-shift insertion of taxon order[k] at edge v."""
        t = order[k]
        c_node, r = n + k - 1, n + k - 2
        parents = _children_to_parents(children_np, n)
        u = int(parents[v])
        ch = children_np.copy()
        ch = ch + ((ch >= u) & (ch <= r)).astype(np.int32)
        out = ch.copy()
        for row_node in range(u + 1, c_node + 1):
            out[row_node - n] = ch[row_node - 1 - n]
        if u <= 2 * n - 2:
            out[u - n] = sorted((v, t))
        if u <= r:
            fix = out[u + 1 - n]
            fix[fix == v] = u
            out[u + 1 - n] = sorted(fix)
        return out

    for k in range(3, n):
        ch_np = np.asarray(state[0])
        sc_np = np.asarray(state[1]).copy()
        t = order[k]
        sc_np[t] = masks[t]
        r = n + k - 2
        candidates = [
            v for v in range(2 * n - 1)
            if (v < n and added[v]) or (n <= v <= r)
        ]
        cand_scores = [
            padded_score(host_insert(ch_np, k, v), sc_np) for v in candidates
        ]
        state = _stepwise_block(
            *state, order_dev, masks_dev, weights, jnp.int32(k),
            n_steps=1, n_leaves=n,
        )
        realized = padded_score(np.asarray(state[0]), sc_np)
        assert realized == min(cand_scores), (k, realized, min(cand_scores))
        added[t] = True


def test_insertion_delta_kernel_parity():
    """GPU insertion kernel (interpret mode) == spr_scan's own delta."""
    from trex_tpu.ops.fitch_pallas import insertion_delta_pallas
    from trex_tpu.ops.spr_scan import spr_scan
    from trex_tpu.topology import random_topologies

    rng = np.random.default_rng(23)
    n, length, q = 12, 70, 4
    topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(7), n, 1)
    )
    n_all = 2 * n - 1
    masks = (1 << rng.integers(0, q, (n_all, length)).astype(np.int32))
    # Build up sets for the real tree; prune an arbitrary leaf t.
    t = 5
    children = np.asarray(topo.children)
    parents = np.asarray(topo.parents)
    q_row = parents[t] - n
    sib = int(children[q_row].sum() - t)
    var = children.copy()
    var[q_row] = (sib, sib)
    up = np.zeros((n_all, length), np.int32)
    up[:n] = masks[:n]
    for a in range(n - 1):
        c0, c1 = var[a]
        inter = up[c0] & up[c1]
        up[n + a] = np.where(inter == 0, up[c0] | up[c1], inter)
    weights = rng.random(length).astype(np.float32)
    got = np.asarray(
        insertion_delta_pallas(
            jnp.asarray(var), jnp.asarray(up), jnp.int32(t),
            jnp.asarray(weights), n_leaves=n, interpret=True,
        )
    )
    # Oracle: spr_scan's own delta for this prune node (scores - total).
    scores, _ = spr_scan(
        topo, jnp.asarray(masks[:n]), jnp.asarray(weights),
        sequences_are_masks=True,
        prune_nodes=jnp.asarray([t], jnp.int32),
    )
    row = np.asarray(scores)[0]
    finite = np.isfinite(row)
    # scores = L(T\t)+L(t)+delta; recover the constant from any finite v.
    base = None
    for v in range(n_all):
        if finite[v]:
            if base is None:
                base = row[v] - got[v]
            else:
                np.testing.assert_allclose(row[v] - got[v], base, atol=1e-4)
    assert base is not None


@pytest.mark.parametrize(
    "n_leaves,length,requested,block,n_pad",
    [(12, 70, 32, 32, 32), (12, 20, 32, 32, 32), (12, 5, 32, 8, 32),
     (2048, 4096, 32, 32, 4096), (9, 600, 64, 64, 32)],
)
def test_insertion_kernel_auto_site_block(
    n_leaves, length, requested, block, n_pad, monkeypatch
):
    """Block choice and padding: the site block shrinks to a power of two
    covering the alignment, rows pad to a power of two (at least one
    16-row chunk), and there is no taxon ceiling."""
    from trex_tpu.ops import fitch_pallas as fp

    seen = {}

    def fake_call(kernel, *, grid, in_specs, out_specs, out_shape, **kw):
        seen.update(grid=grid, out_shape=out_shape, backend=kw["backend"])
        return lambda *args: [
            jnp.zeros(s.shape, s.dtype) for s in out_shape
        ]

    monkeypatch.setattr(fp.pl, "pallas_call", fake_call)
    n_all = 2 * n_leaves - 1
    out = fp._insertion_delta.__wrapped__(
        jnp.zeros((n_leaves - 1, 2), jnp.int32),
        jnp.zeros((n_all, length), jnp.int32), jnp.int32(0),
        jnp.ones((length,), jnp.float32), n_leaves=n_leaves,
        site_block=requested, interpret=False,
    )
    assert out.shape == (n_all,)
    assert seen["backend"] == "triton"
    assert seen["grid"] == (-(-length // block),)
    assert seen["out_shape"][1].shape == (n_pad, seen["grid"][0] * block)


def test_insertion_kernel_block_size_parity():
    """Same inputs at site_block 128 vs 32 (interpret mode) give identical
    deltas for integer weights: per-site terms are blocking-invariant and
    integer-weight f32 sums are exact, so the partial-sum regrouping
    cannot change a bit."""
    from trex_tpu.ops.fitch_pallas import _insertion_delta
    from trex_tpu.topology import random_topologies

    rng = np.random.default_rng(31)
    n, length, q = 12, 600, 4
    topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(8), n, 1)
    )
    n_all = 2 * n - 1
    masks = (1 << rng.integers(0, q, (n_all, length)).astype(np.int32))
    t = 4
    children = np.asarray(topo.children)
    parents = np.asarray(topo.parents)
    q_row = parents[t] - n
    sib = int(children[q_row].sum() - t)
    var = children.copy()
    var[q_row] = (sib, sib)
    up = np.zeros((n_all, length), np.int32)
    up[:n] = masks[:n]
    for a in range(n - 1):
        c0, c1 = var[a]
        inter = up[c0] & up[c1]
        up[n + a] = np.where(inter == 0, up[c0] | up[c1], inter)
    weights = rng.integers(1, 5, length).astype(np.float32)
    outs = [
        np.asarray(
            _insertion_delta(
                jnp.asarray(var), jnp.asarray(up), jnp.int32(t),
                jnp.asarray(weights), n_leaves=n, site_block=sb,
                interpret=True,
            )
        )
        for sb in (128, 32)
    ]
    np.testing.assert_array_equal(outs[0], outs[1])
