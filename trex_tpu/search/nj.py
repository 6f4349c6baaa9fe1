"""Distance-based starting trees: neighbor joining and UPGMA.

The reference's searches start from balanced or random topologies
(``evals/benchmark.py:781-791``); production parsimony/ML search converges
far faster from a distance tree. Split of labor: the O(n^2 L) distance
matrix runs on the device as matmuls (``ops/distances.py``); the O(n^3)
agglomeration below is host-side numpy (it runs once, is branchy, and its
n x n argmin scans would waste an accelerator).

Output is a rooted binary ``Topology`` in the engine's canonical numbering
(leaves first, ancestors in join order, root last) — each join creates the
next ancestor index from two strictly smaller active indices, so index
order is topological by construction.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from trex_tpu.topology import Topology


def neighbor_joining(distances) -> tuple[Topology, np.ndarray]:
    """Saitou-Nei neighbor joining, rooted at the final join.

    Args:
        distances: (n, n) symmetric distance matrix (any additive or
            near-additive metric; ``ops.distances.jc_distance_matrix`` is the
            usual source).

    Returns:
        topology: rooted binary ``Topology`` over ``2n - 1`` nodes. On an
            exactly additive matrix the unrooted topology is the true tree
            (NJ's consistency guarantee); the root lands on the last-joined
            edge.
        branch_lengths: (2n - 1,) f64, indexed by child node (same
            convention as ``io.load_newick``); root entry is 0. Negative NJ
            estimates are kept verbatim — clamp at the call site if needed.
    """
    d0 = np.asarray(distances, dtype=np.float64)
    n_leaves = d0.shape[0]
    if d0.shape != (n_leaves, n_leaves):
        raise ValueError(f"distances must be square, got {d0.shape}")
    if n_leaves < 2:
        raise ValueError("need at least 2 taxa")
    n_all = 2 * n_leaves - 1

    children = np.zeros((n_leaves - 1, 2), dtype=np.int32)
    parents = np.zeros((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    blens = np.zeros((n_all,), dtype=np.float64)

    # Active working set: distance rows + the engine node id each row maps to.
    d = d0.copy()
    ids = np.arange(n_leaves, dtype=np.int32)

    for a in range(n_leaves - 1):
        r = d.shape[0]
        if r > 2:
            row_sums = d.sum(axis=1)
            q = (r - 2) * d - row_sums[:, None] - row_sums[None, :]
            np.fill_diagonal(q, np.inf)
            i, j = np.unravel_index(np.argmin(q), q.shape)
            if i > j:
                i, j = j, i
            dij = d[i, j]
            bl_i = 0.5 * dij + (row_sums[i] - row_sums[j]) / (2.0 * (r - 2))
            bl_j = dij - bl_i
            new_row = 0.5 * (d[i] + d[j] - dij)
        else:
            i, j = 0, 1
            dij = d[0, 1]
            bl_i = bl_j = 0.5 * dij
            new_row = np.zeros((2,))

        node = n_leaves + a
        # ids stays sorted (new nodes get the largest index), so i < j
        # implies ids[i] < ids[j] — ascending children for free.
        children[a] = (int(ids[i]), int(ids[j]))
        parents[ids[i]] = node
        parents[ids[j]] = node
        blens[ids[i]] = bl_i
        blens[ids[j]] = bl_j
        # Contract rows i, j into the new node's row.
        keep = np.delete(np.arange(r), [i, j])
        nd = np.empty((r - 1, r - 1))
        nd[:-1, :-1] = d[np.ix_(keep, keep)]
        nd[-1, :-1] = new_row[keep]
        nd[:-1, -1] = new_row[keep]
        nd[-1, -1] = 0.0
        d = nd
        ids = np.append(ids[keep], np.int32(node))

    topo = Topology(children=jnp.asarray(children), parents=jnp.asarray(parents))
    return topo, blens


def upgma(distances) -> tuple[Topology, np.ndarray]:
    """UPGMA average-linkage clustering (ultrametric / molecular clock).

    Same output contract as ``neighbor_joining``. Exact on ultrametric
    matrices; prefer NJ when rates vary across lineages.
    """
    d0 = np.asarray(distances, dtype=np.float64)
    n_leaves = d0.shape[0]
    if n_leaves < 2:
        raise ValueError("need at least 2 taxa")
    n_all = 2 * n_leaves - 1

    children = np.zeros((n_leaves - 1, 2), dtype=np.int32)
    parents = np.zeros((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    blens = np.zeros((n_all,), dtype=np.float64)
    heights = np.zeros((n_all,), dtype=np.float64)

    d = d0.copy()
    np.fill_diagonal(d, np.inf)
    ids = np.arange(n_leaves, dtype=np.int32)
    sizes = np.ones((n_leaves,), dtype=np.float64)

    for a in range(n_leaves - 1):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if i > j:
            i, j = j, i
        node = n_leaves + a
        height = 0.5 * d[i, j]
        children[a] = (int(ids[i]), int(ids[j]))
        parents[ids[i]] = node
        parents[ids[j]] = node
        heights[node] = height
        blens[ids[i]] = height - heights[ids[i]]
        blens[ids[j]] = height - heights[ids[j]]
        # Size-weighted average linkage.
        new_row = (sizes[i] * d[i] + sizes[j] * d[j]) / (sizes[i] + sizes[j])
        keep = np.delete(np.arange(d.shape[0]), [i, j])
        r = keep.size + 1
        nd = np.full((r, r), np.inf)
        nd[:-1, :-1] = d[np.ix_(keep, keep)]
        nd[-1, :-1] = new_row[keep]
        nd[:-1, -1] = new_row[keep]
        d = nd
        sizes = np.append(sizes[keep], sizes[i] + sizes[j])
        ids = np.append(ids[keep], np.int32(node))

    topo = Topology(children=jnp.asarray(children), parents=jnp.asarray(parents))
    return topo, blens


def nj_start_tree(
    leaf_sequences,
    n_states: int,
    site_weights=None,
    *,
    method: str = "nj",
    correction: str = "jc",
) -> tuple[Topology, np.ndarray]:
    """Distance starting tree straight from an alignment.

    The device computes the distance matrix (matmuls); the host
    agglomerates.

    Args:
        method: "nj" (default) or "upgma".
        correction: "jc" (Jukes-Cantor, default) or "p" (raw proportion).
    """
    from trex_tpu.ops.distances import jc_distance_matrix, p_distance_matrix

    dist_fn = {"jc": jc_distance_matrix, "p": p_distance_matrix}[correction]
    d = np.asarray(dist_fn(jnp.asarray(leaf_sequences), n_states, site_weights))
    build = {"nj": neighbor_joining, "upgma": upgma}[method]
    return build(d)


def nj_bootstrap(
    key,
    leaf_sequences,
    n_states: int,
    *,
    n_replicates: int = 100,
    method: str = "nj",
    correction: str = "jc",
    site_weights=None,
) -> tuple[Topology, np.ndarray, np.ndarray]:
    """Distance-tree bootstrap: per-split support for the NJ/UPGMA tree.

    All replicate distance matrices come from ONE vmapped device call
    (bootstrap site weights feed the weighted distance formulas directly —
    no resampled alignments are materialized); the host agglomerates each
    replicate and counts which reference splits it retains.

    Returns:
        (reference topology, branch_lengths, support (n_ancestors,) in
        [0, 1]; trivial splits get 1.0).
    """
    import jax

    from trex_tpu.ops.distances import jc_distance_matrix, p_distance_matrix
    from trex_tpu.search.bootstrap import _replicate_weights, subtree_leaf_sets

    dist_fn = {"jc": jc_distance_matrix, "p": p_distance_matrix}[correction]
    build = {"nj": neighbor_joining, "upgma": upgma}[method]
    ref_topo, blens = nj_start_tree(
        leaf_sequences, n_states, site_weights,
        method=method, correction=correction,
    )
    n_leaves = ref_topo.n_leaves
    every = frozenset(range(n_leaves))

    def norm_splits(topo):
        out = set()
        for clade in subtree_leaf_sets(topo):
            side = every - clade if 0 in clade else clade
            if 1 < len(side) < n_leaves - 1:
                out.add(side)
        return out

    ref_clades = list(subtree_leaf_sets(ref_topo))
    ref_norm = []
    for clade in ref_clades:
        side = every - clade if 0 in clade else clade
        ref_norm.append(side if 1 < len(side) < n_leaves - 1 else None)

    length = leaf_sequences.shape[-1]
    base_w = (
        jnp.ones((length,), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    rep_w = _replicate_weights(key, length, n_replicates, base_w)
    seqs = jnp.asarray(leaf_sequences)
    dists = jax.lax.map(
        lambda w: dist_fn(seqs, n_states, w.astype(jnp.float32)),
        rep_w,
        batch_size=32,
    )  # (R, n, n)
    dists_np = np.asarray(dists)

    counts = np.zeros((len(ref_norm),))
    for r in range(n_replicates):
        topo_r, _ = build(dists_np[r])
        splits_r = norm_splits(topo_r)
        for i, split in enumerate(ref_norm):
            if split is not None and split in splits_r:
                counts[i] += 1
    support = counts / float(n_replicates)
    for i, split in enumerate(ref_norm):
        if split is None:
            support[i] = 1.0
    return ref_topo, blens, support
