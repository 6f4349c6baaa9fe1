"""Greedy stepwise-addition starting trees, device-batched.

Classic parsimony stepwise addition (add taxa one at a time, each at the
edge that minimizes the score) re-shaped for a static-shape batch
scorer: instead of growing the tree (one XLA recompile per size), every
intermediate tree is FULL-size over all n taxa, with not-yet-added taxa
carried as fully ambiguous leaves (state-set mask = all states). A fully
ambiguous leaf provably contributes 0 to any parsimony score and leaves all
other state sets unchanged (``tests/test_ambiguity.py``), so the padded
score equals the induced-subtree score exactly — and every step is ONE
fixed-shape ``batched_scores_fastest`` call over all insertion edges, hitting
the fused Fitch kernel on a GPU with zero recompiles after the first step.

The reference has no discrete tree construction at all (searches start from
balanced or random trees, ``evals/benchmark.py:781-791``); this is new
capability, standard in production parsimony engines.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.ops.dispatch import batched_scores_fastest, use_kernel
from trex_tpu.topology import Topology


@dataclasses.dataclass
class _GrowingTree:
    """Host-side induced tree over the added taxa, arbitrary internal labels.

    Internal nodes are negative labels; leaves are taxon ids. ``parent`` maps
    every node except the root; ``kids`` maps internal labels to their two
    children.
    """

    root: int
    parent: dict[int, int]
    kids: dict[int, list[int]]
    next_label: int = -1

    def edges(self) -> list[int]:
        """Child endpoints of every edge (the edge above each non-root node)."""
        return [n for n in self.parent]

    def attach(self, taxon: int, edge_child: int | None) -> None:
        """Insert ``taxon`` on the edge above ``edge_child`` (None = above root)."""
        w = self.next_label
        self.next_label -= 1
        self.kids[w] = []
        if edge_child is None:
            self.kids[w] = [self.root, taxon]
            self.parent[self.root] = w
            self.parent[taxon] = w
            self.root = w
            return
        up = self.parent[edge_child]
        self.kids[up][self.kids[up].index(edge_child)] = w
        self.parent[w] = up
        self.kids[w] = [edge_child, taxon]
        self.parent[edge_child] = w
        self.parent[taxon] = w

    def copy(self) -> "_GrowingTree":
        return _GrowingTree(
            root=self.root,
            parent=dict(self.parent),
            kids={k: list(v) for k, v in self.kids.items()},
            next_label=self.next_label,
        )


def _materialize(tree: _GrowingTree, parked: list[int], n_leaves: int) -> np.ndarray:
    """Full-size canonical children array: induced tree + parked chain.

    Parked (not-yet-added) taxa are chained above the induced root; they are
    fully ambiguous during scoring, so their placement is score-neutral.
    Ancestors are numbered by post-order completion (children visited by
    minimum leaf descendant, the engine's canonical convention), so children
    always have smaller indices than their parent.
    """
    work = tree.copy()
    for t in parked:
        work.attach(t, None)

    children = np.empty((n_leaves - 1, 2), dtype=np.int32)
    # Iterative post-order; order children by minimum leaf descendant.
    min_leaf: dict[int, int] = {}

    def resolve_min(node: int) -> int:
        if node >= 0:
            return node
        if node not in min_leaf:
            stack = [node]
            post = []
            while stack:
                x = stack.pop()
                post.append(x)
                if x < 0:
                    stack.extend(work.kids[x])
            for x in reversed(post):
                if x < 0:
                    min_leaf[x] = min(
                        (x_ if x_ >= 0 else min_leaf[x_]) for x_ in work.kids[x]
                    )
        return min_leaf[node]

    number: dict[int, int] = {}
    counter = n_leaves
    stack: list[tuple[int, bool]] = [(work.root, False)]
    while stack:
        node, expanded = stack.pop()
        if node >= 0:
            continue
        if expanded:
            a, b = work.kids[node]
            ia = a if a >= 0 else number[a]
            ib = b if b >= 0 else number[b]
            lo, hi = (ia, ib) if ia < ib else (ib, ia)
            children[counter - n_leaves] = (lo, hi)
            number[node] = counter
            counter += 1
        else:
            stack.append((node, True))
            kids = sorted(work.kids[node], key=resolve_min)
            for k in reversed(kids):
                stack.append((k, False))
    return children


def _children_to_parents(children: np.ndarray, n_leaves: int) -> np.ndarray:
    n_all = 2 * n_leaves - 1
    parents = np.empty((n_all,), dtype=np.int32)
    parents[-1] = n_all - 1
    for a in range(n_leaves - 1):
        parents[children[a, 0]] = n_leaves + a
        parents[children[a, 1]] = n_leaves + a
    return parents


def _batch_topology(children_list: list[np.ndarray], n_leaves: int) -> Topology:
    ch = np.stack(children_list)
    par = np.stack([_children_to_parents(c, n_leaves) for c in children_list])
    return Topology(children=jnp.asarray(ch), parents=jnp.asarray(par))


def stepwise_addition(
    leaf_sequences,
    n_states: int,
    *,
    sequences_are_masks: bool = False,
    order: np.ndarray | None = None,
    seed: int | None = None,
    site_weights=None,
    use_scan: bool | None = None,
) -> tuple[Topology, float]:
    """Build a tree by greedy stepwise addition (device-batched scoring).

    Args:
        leaf_sequences: (n_leaves, L) integer states, or state-set bitmasks
            with ``sequences_are_masks=True`` (composes with IUPAC input).
        n_states: alphabet size Q (<= 32; scoring is unit-cost Fitch).
        order: explicit addition order (permutation of taxa); default is a
            random order from ``seed`` (or 0).
        site_weights: optional (L,) weights (compressed patterns/bootstrap).
        use_scan: evaluate insertions with the analytic scan — one O(n)
            Fitch up/down pass per step instead of batch-scoring 2n
            candidate trees, with the WHOLE loop run as blocked on-device
            scans (``_stepwise_block``: ~(n-3)/128 dispatches instead of
            one per insertion). Default True;
            no native-library dependency. Both paths are exact and reach
            trees of equal score (tie-breaks on equal-score insertions can
            differ between paths).

    Returns:
        (topology, score): the grown tree over all taxa and its exact
        unit-cost parsimony score.

    In the batched path every addition step scores all insertion edges in
    one fixed-shape batch (padded to ``2 * n_leaves - 2`` candidates), so
    XLA compiles the scorer once for the whole construction.
    """
    seqs = np.asarray(leaf_sequences)
    n_leaves = seqs.shape[0]
    if n_leaves < 3:
        raise ValueError("stepwise addition needs at least 3 taxa")
    masks = (
        seqs.astype(np.int32)
        if sequences_are_masks
        else (1 << seqs.astype(np.int32))
    )
    full_mask = np.int32((1 << n_states) - 1)
    if order is None:
        rng = np.random.default_rng(0 if seed is None else seed)
        order = rng.permutation(n_leaves)
    order = [int(t) for t in np.asarray(order)]
    if sorted(order) != list(range(n_leaves)):
        raise ValueError("order must be a permutation of all taxa")

    hamming = jnp.ones((n_states, n_states)) - jnp.eye(n_states)
    max_candidates = 2 * n_leaves - 2

    if use_scan is None:
        # Device loop: no native-library dependency. The event flag rides
        # bit _FLAG_SHIFT of the up-set words, so the state mask must fit
        # below it (always true for dna/protein).
        use_scan = n_states <= 30
    if use_scan:
        return _stepwise_scan(
            masks, n_states, order, full_mask, site_weights, hamming
        )

    # Seed tree: the first three taxa (all rooted resolutions of 3 taxa give
    # the same unrooted tree, hence the same parsimony score).
    t0, t1, t2 = order[:3]
    tree = _GrowingTree(
        root=-1, parent={t0: -1, t1: -1}, kids={-1: [t0, t1]}, next_label=-2
    )
    tree.attach(t2, None)

    added = order[:3]
    scored_masks = np.full_like(masks, full_mask)
    for t in added:
        scored_masks[t] = masks[t]

    for step in range(3, n_leaves):
        taxon = order[step]
        parked = order[step + 1 :]
        scored_masks[taxon] = masks[taxon]
        masks_dev = jnp.asarray(scored_masks)

        # Candidates: insert ``taxon`` on every edge of the induced tree,
        # plus above the induced root.
        insertion_points: list[int | None] = list(tree.edges()) + [None]
        cand_children = []
        for edge_child in insertion_points:
            cand = tree.copy()
            cand.attach(taxon, edge_child)
            cand_children.append(_materialize(cand, parked, n_leaves))
        n_real = len(cand_children)
        while len(cand_children) < max_candidates:
            cand_children.append(cand_children[0])
        topos = _batch_topology(cand_children, n_leaves)

        scores = np.asarray(
            batched_scores_fastest(
                topos, hamming, masks_dev,
                site_weights=site_weights, sequences_are_masks=True,
            )
        )[:n_real]
        best = int(np.argmin(scores))
        tree.attach(taxon, insertion_points[best])

    final_children = _materialize(tree, [], n_leaves)
    batched = _batch_topology([final_children] * max_candidates, n_leaves)
    final_score = float(
        np.asarray(
            batched_scores_fastest(
                batched, hamming, jnp.asarray(masks),
                site_weights=site_weights, sequences_are_masks=True,
            )
        )[0]
    )
    topo = jax.tree.map(lambda a: a[0], batched)
    return topo, final_score


_SITE_CHUNKS = 16  # vmapped site-chunks per pass; see _stepwise_block
_FLAG_SHIFT = 30  # event-flag bit in internal up-set rows (needs Q <= 30)


@partial(jax.jit, static_argnames=("n_leaves",))
def _initial_up(children, scored, n_leaves: int):
    """(n_all, L) flagged Fitch up sets of the full padded seed tree.

    Internal rows carry ``merged_set | (event << _FLAG_SHIFT)``; leaf rows
    the raw masks. Run ONCE per construction — every later insertion
    updates this buffer incrementally (see ``_stepwise_block``). The pass
    is vmapped over ``_SITE_CHUNKS`` site chunks (XLA keeps the batched
    scan carry in place; the single-chunk form pays a full-buffer copy
    per sequential step).
    """
    n_all = 2 * n_leaves - 1
    n_anc = n_leaves - 1
    v_chunks = _SITE_CHUNKS
    length = scored.shape[-1]
    l_chunk = length // v_chunks
    smask = jnp.int32((1 << _FLAG_SHIFT) - 1)
    flag = jnp.int32(1) << _FLAG_SHIFT
    offsets = jnp.arange(n_anc, dtype=jnp.int32)

    def one(leaf_sets):  # (n_leaves, Lc)
        sets0 = jnp.zeros((n_all, l_chunk), jnp.int32)
        sets0 = sets0.at[:n_leaves].set(leaf_sets)

        def step(sets, inputs):
            anc_offset, pair = inputs
            c = sets[pair] & smask
            inter = c[0] & c[1]
            empty = inter == 0
            merged = jnp.where(empty, (c[0] | c[1]) | flag, inter)
            sets = jax.lax.dynamic_update_slice(
                sets, merged[None], (n_leaves + anc_offset, 0)
            )
            return sets, None

        sets, _ = jax.lax.scan(step, sets0, (offsets, children))
        return sets

    chunked = jax.vmap(one, in_axes=1)(
        scored.reshape(n_leaves, v_chunks, l_chunk)
    )  # (V, n_all, Lc)
    return jnp.moveaxis(chunked, 0, 1).reshape(n_all, length)


def insertion_delta_lax(var_children, up_states, tmask, weights):
    """(n_all,) join penalties delta(t, v): the lax down pass + reduction.

    Same contract as ``ops.fitch_pallas.insertion_delta_pallas`` (which
    takes t's index; this takes its set ``tmask``). The scan's carry is
    the whole (n_all, L) down table, read and written with dynamic rows
    every step, so XLA adds two full-table copies per step.
    """
    from trex_tpu.ops.spr_scan import _combine0

    n_anc = var_children.shape[0]
    n_leaves = n_anc + 1
    offsets = jnp.arange(n_anc, dtype=jnp.int32)

    def step(down, inputs):
        anc_offset, pair = inputs
        d = down[n_leaves + anc_offset]
        c1, c2 = pair[0], pair[1]
        is_pass = c1 == c2
        ctx1 = jnp.where(is_pass, d, _combine0(d, up_states[c2]))
        ctx2 = _combine0(d, up_states[c1])
        down = down.at[c1].set(ctx1)
        down = down.at[c2].set(jnp.where(is_pass, ctx1, ctx2))
        return down, None

    down, _ = jax.lax.scan(
        step, jnp.zeros_like(up_states), (offsets, var_children), reverse=True
    )
    ctx = _combine0(up_states, down)
    empty_join = (tmask[None, :] & ctx) == 0
    return jnp.sum(empty_join.astype(jnp.float32) * weights[None, :], axis=-1)


@partial(
    jax.jit,
    static_argnames=("n_steps", "n_leaves"),
    donate_argnums=(0, 1, 2, 3),
)
def _stepwise_block(
    children, scored, added, up, order_dev, masks_all, weights, k0,
    n_steps: int, n_leaves: int,
):
    """``n_steps`` insertion steps in ONE dispatch (device-side scan).

    Carries the growing tree entirely on device under a fixed numbering
    scheme that keeps the child<parent index invariant WITHOUT per-step
    canonical renumbering (a host round trip per insertion would cost one
    blocking dispatch per taxon):

      before step k: induced internals occupy n..n+k-2 (root = n+k-2),
      parked-chain internals occupy n+k-1..2n-2 bottom-up, chain bottom
      c = n+k-1 holding (induced_root, order[k]).

    One step = (1) dissolve c (pass-through row, exactly ``ops.spr_scan``'s
    single-prune variant), (2) score every insertion edge via the SPR
    identity using the MAINTAINED flagged up sets (one copy-free down
    pass; per-site event totals are the flag-bit sum), (3) argmin over
    VALID positions (added leaves + induced internals — chain placements
    are always score ties with the induced-root edge, so restricting
    loses nothing), and (4) the slot-shift insert: the new internal w
    takes its parent slot u = parents[v*], internals [u, n+k-2] shift up
    one (node labels +1), the freed slot n+k-1 lands the shifted induced
    root exactly where the next chain node already points, and only w's
    ANCESTOR PATH has its up sets/flags recomputed (bounded by tree
    depth). The shift preserves child<parent everywhere (a shifted
    node's parent is always shifted too); attach-above-root is the same
    formula with u = parents[induced_root] = c (empty shift range).

    Why incremental: a from-scratch up pass per insertion is not just
    O(n L) redundant work — XLA also inserts TWO full-carry copies per
    sequential step into that read+write scan. Keeping up sets as
    insertion-loop state eliminates the up pass; the remaining
    down+delta pass hits the SAME copy pathology in every lax
    formulation (``insertion_delta_lax``: on an H100 at 2048 taxa x 4096
    sites the copies take 188 of 209 ms per insertion), so on a GPU it
    runs as a Triton kernel (``ops.fitch_pallas.insertion_delta_pallas``)
    that walks the table in place; the lax path serves the CPU. Chain rows
    above the frontier hold stale sets with zero flags; they are never
    read for any valid output (their contexts only reach parked-leaf
    positions, which the argmin masks).
    """
    n_all = 2 * n_leaves - 1
    n_anc = n_leaves - 1
    row_node = n_leaves + jnp.arange(n_anc, dtype=jnp.int32)
    node_idx = jnp.arange(n_all, dtype=jnp.int32)
    smask = jnp.int32((1 << _FLAG_SHIFT) - 1)
    flag = jnp.int32(1) << _FLAG_SHIFT
    kernel = use_kernel()

    def body(state, k):
        children, scored, added, up = state
        t = order_dev[k]
        tmask = masks_all[t]
        scored = scored.at[t].set(tmask)
        up = up.at[t].set(tmask)
        c_node = n_leaves + k - 1  # chain bottom (t's parent)
        r = c_node - 1  # induced root
        var = children.at[k - 1].set(jnp.stack([r, r]))
        up_states = up & smask
        if kernel:
            from trex_tpu.ops.fitch_pallas import insertion_delta_pallas

            delta = insertion_delta_pallas(
                var, up_states, t, weights, n_leaves=n_leaves
            )
        else:
            delta = insertion_delta_lax(var, up_states, tmask, weights)
        # L(T minus t) = flag-bit weighted sum (chain + dissolved rows
        # carry flag 0 by construction).
        flags = (up[n_leaves:] >> _FLAG_SHIFT).astype(jnp.float32)
        total = jnp.sum(flags * weights[None, :])
        row = total + delta
        added_full = jnp.concatenate(
            [added, jnp.zeros((n_anc,), bool)]
        )
        valid = jnp.where(
            node_idx < n_leaves, added_full[node_idx], node_idx <= r
        )
        row = jnp.where(valid, row, jnp.inf)
        v = jnp.argmin(row).astype(jnp.int32)
        parents = (
            jnp.zeros((n_all,), jnp.int32)
            .at[children[:, 0]].set(row_node)
            .at[children[:, 1]].set(row_node)
        )
        u_old = parents[v]
        # Relabel shifted nodes, shift their rows up by one, drop w in.
        ch2 = children + ((children >= u_old) & (children <= r)).astype(
            jnp.int32
        )
        rows = jnp.arange(n_anc, dtype=jnp.int32)
        src = jnp.where(
            (row_node > u_old) & (row_node <= c_node), rows - 1, rows
        )
        new_children = ch2[src]
        w_row = jnp.stack([jnp.minimum(v, t), jnp.maximum(v, t)])
        new_children = jnp.where(
            (row_node == u_old)[:, None], w_row[None, :], new_children
        )
        # The (shifted) old parent still lists v as a child; w replaced it.
        fix_row = (row_node == u_old + 1) & (u_old <= r)
        new_children = jnp.where(
            fix_row[:, None] & (new_children == v), u_old, new_children
        )
        new_children = jnp.sort(new_children, axis=1)
        # Shift the internal up rows identically and drop w's set in
        # (v's row is below the shift range, so read it pre-shift).
        vset = up_states[v]
        inter = vset & tmask
        ev = inter == 0
        wset = jnp.where(ev, (vset | tmask) | flag, inter)
        anc_rows = up[n_leaves:][src]
        anc_rows = jax.lax.dynamic_update_slice(
            anc_rows, wset[None], (u_old - n_leaves, 0)
        )
        up = up.at[n_leaves:].set(anc_rows)
        # Recompute w's ancestor path (the only stale sets), bottom-up.
        new_parents = (
            jnp.zeros((n_all,), jnp.int32)
            .at[new_children[:, 0]].set(row_node)
            .at[new_children[:, 1]].set(row_node)
            # Sentinel above every index so the path walk terminates when
            # the LAST insertion's path reaches the absolute root (whose
            # scatter entry would otherwise read 0 and loop forever).
            .at[n_all - 1].set(jnp.int32(n_all))
        )
        new_root = c_node  # n + k - 1

        def pcond(carry):
            x, _ = carry
            return x <= new_root

        def pstep(carry):
            x, up = carry
            pair = new_children[x - n_leaves]
            a = up[pair[0]] & smask
            b = up[pair[1]] & smask
            inter = a & b
            evp = inter == 0
            merged = jnp.where(evp, (a | b) | flag, inter)
            up = jax.lax.dynamic_update_slice(up, merged[None], (x, 0))
            return (new_parents[x], up)

        _, up = jax.lax.while_loop(pcond, pstep, (new_parents[u_old], up))
        added = added.at[t].set(True)
        return (new_children, scored, added, up), None

    ks = k0 + jnp.arange(n_steps, dtype=jnp.int32)
    state, _ = jax.lax.scan(body, (children, scored, added, up), ks)
    return state


def _stepwise_scan(
    masks: np.ndarray,
    n_states: int,
    order: list[int],
    full_mask: np.int32,
    site_weights,
    hamming,
    block: int = 128,
) -> tuple[Topology, float]:
    """Device-superblocked stepwise addition: the whole insertion loop runs
    as blocked on-device scans (``_stepwise_block``), ~``(n-3)/block``
    dispatches total instead of one per insertion. Numbering is the slot-
    shift scheme; the result is canonicalized once at the end. Scores are
    exactly the classic algorithm's (chain-placement ties excepted — see
    ``_stepwise_block``); parity vs the per-step host loop is pinned in
    tests/test_stepwise.py.
    """
    from trex_tpu.io import canonicalize_topology
    from trex_tpu.ops.fitch import fitch_score

    n_leaves = masks.shape[0]
    n_anc = n_leaves - 1
    length = masks.shape[-1]
    weights_np = (
        np.ones((length,), np.float32)
        if site_weights is None
        else np.asarray(site_weights, np.float32)
    )
    # Pad sites to a _SITE_CHUNKS multiple: full-mask columns (zero Fitch
    # events under any tree) with weight 0 — score-transparent.
    pad = -length % _SITE_CHUNKS
    if pad:
        masks = np.concatenate(
            [masks, np.full((n_leaves, pad), full_mask, masks.dtype)], axis=1
        )
        weights_np = np.concatenate([weights_np, np.zeros(pad, np.float32)])
    weights = jnp.asarray(weights_np)
    # Seed (slot-shift scheme): internal n = (t0, t1), induced root
    # n+1 = (n, t2), then the parked chain n+2..2n-2 in addition order.
    t0, t1, t2 = order[:3]
    children0 = np.empty((n_anc, 2), np.int32)
    children0[0] = sorted((t0, t1))
    children0[1] = sorted((n_leaves, t2))
    prev = n_leaves + 1
    for j, t in enumerate(order[3:]):
        children0[2 + j] = sorted((prev, t))
        prev = n_leaves + 2 + j
    scored0 = np.full_like(masks, full_mask)
    for t in order[:3]:
        scored0[t] = masks[t]
    added0 = np.zeros((n_leaves,), bool)
    added0[list(order[:3])] = True

    children_dev = jnp.asarray(children0)
    scored_dev = jnp.asarray(scored0.astype(np.int32))
    up0 = _initial_up(children_dev, scored_dev, n_leaves=n_leaves)
    state = (children_dev, scored_dev, jnp.asarray(added0), up0)
    order_dev = jnp.asarray(order, jnp.int32)
    masks_all = jnp.asarray(masks.astype(np.int32))
    k = 3
    while k < n_leaves:
        steps = min(block, n_leaves - k)
        state = _stepwise_block(
            *state, order_dev, masks_all, weights, jnp.int32(k),
            n_steps=steps, n_leaves=n_leaves,
        )
        k += steps

    children_np = np.asarray(state[0])
    canon, _ = canonicalize_topology(children_np)
    topo = Topology(
        children=jnp.asarray(canon),
        parents=jnp.asarray(_children_to_parents(canon, n_leaves)),
    )
    final = float(
        fitch_score(
            topo, masks_all,
            site_mask=None if site_weights is None else weights,
            sequences_are_masks=True,
        )
    )
    return topo, final


def _stepwise_scan_host(
    masks: np.ndarray,
    n_states: int,
    order: list[int],
    full_mask: np.int32,
    site_weights,
    hamming,
) -> tuple[Topology, float]:
    """Per-step host loop (the pre-superblock reference): one analytic pass
    per inserted taxon, argmin + ``io.spr_move`` applied on the host.

    Kept as the parity oracle for ``_stepwise_scan`` (tests compare the
    two); needs the native library for ``spr_move``.
    """
    from trex_tpu.io import spr_move
    from trex_tpu.ops.fitch import fitch_score
    from trex_tpu.ops.spr_scan import spr_scan

    n_leaves = masks.shape[0]
    t0, t1, t2 = order[:3]
    tree = _GrowingTree(
        root=-1, parent={t0: -1, t1: -1}, kids={-1: [t0, t1]}, next_label=-2
    )
    tree.attach(t2, None)
    children = _materialize(tree, order[3:], n_leaves)
    topo = Topology(
        children=jnp.asarray(children),
        parents=jnp.asarray(_children_to_parents(children, n_leaves)),
    )

    scored_masks = np.full_like(masks, full_mask)
    for t in order[:3]:
        scored_masks[t] = masks[t]
    weights = (
        None if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    # Masks live ON DEVICE and are updated one row per insertion — the
    # alternative re-uploads the whole (n x L) matrix every step (4 MB per
    # insertion at 1024 x 1024).
    masks_dev = jnp.asarray(masks)
    scored_dev = jnp.asarray(scored_masks)
    for t in order[3:]:
        scored_dev = scored_dev.at[t].set(masks_dev[t])
        scores, _ = spr_scan(
            topo, scored_dev, weights,
            sequences_are_masks=True,
            prune_nodes=jnp.asarray([t], jnp.int32),
        )
        row = np.asarray(scores)[0]
        v = int(np.nanargmin(np.where(np.isfinite(row), row, np.nan)))
        moved = spr_move(topo, t, v)
        if moved is not None:  # v == sibling is a no-op reattachment
            topo = moved

    final = float(
        fitch_score(
            topo, jnp.asarray(masks), site_mask=weights,
            sequences_are_masks=True,
        )
    )
    return topo, final


def stepwise_addition_multi(
    leaf_sequences,
    n_states: int,
    *,
    n_orders: int = 8,
    seed: int = 0,
    sequences_are_masks: bool = False,
    site_weights=None,
) -> tuple[Topology, float]:
    """Best of ``n_orders`` random-addition-sequence stepwise trees.

    Random addition orders are the standard way to diversify stepwise
    starting trees (each order can land in a different basin); downstream
    hill climbing / ratchet refines the best one.
    """
    rng = np.random.default_rng(seed)
    best_topo, best_score = None, np.inf
    for _ in range(n_orders):
        order = rng.permutation(np.asarray(leaf_sequences).shape[0])
        topo, score = stepwise_addition(
            leaf_sequences, n_states,
            sequences_are_masks=sequences_are_masks,
            order=order, site_weights=site_weights,
        )
        if score < best_score:
            best_topo, best_score = topo, score
    return best_topo, float(best_score)
