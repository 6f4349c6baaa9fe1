"""Approximate Bremer (decay) support from the analytic SPR scan.

Bremer support of an internal branch = extra parsimony steps needed by the
best tree that LACKS that split. Exact decay needs constrained searches;
the classic fast approximation (PAUP*'s SPR-decay) bounds it within the
SPR neighborhood: an SPR move destroys exactly the splits on the path
between its prune edge and its regraft edge, so

    decay[e]  <=  min over moves destroying e of (move score - best score)

and the whole bound comes from ONE ``ops.spr_scan`` matrix (the same
single batched up/down pass the search uses) plus O(n^2) host path walks.
Equality holds whenever some best split-lacking tree is one SPR away —
verified against exhaustive enumeration on small instances in
``tests/test_bremer.py``.

The reference has no branch-support machinery of any kind (SURVEY.md §5);
this joins `search.bootstrap`/`search.alrt`/`search.ufboot` as new
capability riding the engine's analytic scan.
"""

from __future__ import annotations

import jax
import numpy as np

from trex_tpu.topology import Topology


def spr_decay_support(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    mesh=None,
) -> tuple[np.ndarray, float]:
    """(n_ancestors,) SPR-decay values for each internal branch + base score.

    Entries are upper bounds on the true Bremer support (in parsimony
    steps); the root's entry and branches with no destroying move in the
    neighborhood are NaN. ``mesh``: optional ('tree', 'site') mesh — the
    scan's prune axis shards over it (``parallel.sharded.sharded_spr_scan``,
    bit-identical rows); the decay analysis genuinely needs the full
    table, so this path keeps the table readback (fine at support-tool
    scales; the scalar-readback climbs are for 10k+ taxa).
    """
    from trex_tpu.ops.spr_scan import spr_scan_segmented

    n_leaves = topology.n_leaves
    n_all = topology.n_all
    parents = np.asarray(topology.parents)

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_spr_scan

        scores, base = sharded_spr_scan(
            mesh, topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    else:
        scores, base = spr_scan_segmented(
            topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    scores = np.asarray(scores, np.float64)
    base = float(base)

    # Depth array for path walks (root depth 0).
    depth = np.zeros(n_all, np.int32)
    for node in range(n_all - 2, -1, -1):
        depth[node] = depth[parents[node]] + 1

    def path_edges(a: int, b: int) -> list[int]:
        """Original-tree edges whose splits an SPR from junction ``a`` to
        the edge above ``b`` destroys.

        "Edge of node x" = the branch above x. Crossed edges on the a..b
        path all flip (the moved subtree switches sides), INCLUDING a's own
        edge when the path goes up through it (its split loses the subtree)
        and the first edge below a when the path descends (its split gains
        it); only the regraft edge above ``b`` survives — insertion merely
        subdivides it.
        """
        edges = []
        x, y = a, b
        while x != y:
            if depth[x] >= depth[y]:
                edges.append(x)
                x = parents[x]
            else:
                edges.append(y)
                y = parents[y]
        return [e for e in edges if e != b]

    from trex_tpu.io import spr_move
    from trex_tpu.search.bootstrap import subtree_leaf_sets
    from trex_tpu.search.ratchet import unrooted_splits

    every = frozenset(range(n_leaves))
    ref_sides: list[frozenset | None] = []
    for clade in subtree_leaf_sets(topology):
        side = every - clade if 0 in clade else clade
        ref_sides.append(side if 1 < len(side) < n_leaves - 1 else None)

    # Candidate (delta, p, v, claimed-edges) moves from the path rule. The
    # rule is a SUPERSET filter: it can claim destruction for moves that
    # merely re-root the same unrooted tree, so each edge's minimum is
    # verified exactly (apply the move, diff the split sets) in ascending
    # delta order — typically one spr_move per edge.
    candidates: list[tuple[float, int, int, tuple[int, ...]]] = []
    for p in range(n_all - 1):
        anchor = int(parents[p])
        for v in np.nonzero(np.isfinite(scores[p]))[0]:
            claimed = tuple(
                e for e in path_edges(anchor, int(v)) if e >= n_leaves
            )
            if claimed:
                candidates.append(
                    (float(scores[p, int(v)] - base), p, int(v), claimed)
                )
    candidates.sort(key=lambda c: c[0])

    decay = np.full((topology.n_ancestors,), np.nan)
    unset = {
        i for i in range(topology.n_ancestors) if ref_sides[i] is not None
    }
    for delta, p, v, claimed in candidates:
        pending = [e - n_leaves for e in claimed if (e - n_leaves) in unset]
        if not pending:
            continue
        moved = spr_move(topology, p, v)
        if moved is None:
            continue
        moved_splits = unrooted_splits(moved)
        for i in pending:
            if ref_sides[i] not in moved_splits:
                decay[i] = delta
                unset.discard(i)
        if not unset:
            break
    return decay, base
