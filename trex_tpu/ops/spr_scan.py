"""All-SPR scan: score every SPR rearrangement without per-candidate DP.

The classical fast-parsimony identity (validated exhaustively against brute
force in ``tests/test_spr_scan.py``): for unit-cost (Fitch) parsimony,
pruning the subtree S rooted at node p and regrafting it on the edge above
node v of the remaining tree T∖S gives

    L(new) = L(T∖S) + L(S) + δ(p, v),
    δ(p, v) = 0  iff  U_p ∩ C_v ≠ ∅  else 1   (per site, weight-summed)

where ``U_p`` is S's root Fitch set (unchanged by pruning) and ``C_v`` is
the Fitch-combined up/down context of the edge above v in T∖S
(``up ∩ down`` if nonempty else ``up ∪ down``).

Batched evaluation: build all n_all−1 pruned variants as one batched
children tensor (each variant differs from the base tree in ONE row — the
pruned node's parent becomes a pass-through ``(s, s)`` row, so node indices
never shift), run ONE vmapped up pass + ONE vmapped down pass (sites
vectorized), and read every candidate's exact score from a bitwise AND over the
(variants × nodes × sites) context tensor. Per search round this replaces
O(n²) candidate DPs (and 100+ MB of host→device topology transfer) with
the equivalent of ~2n DPs and zero transfer.

Unit-cost only (the identity is Fitch-specific); ambiguity masks and
per-site weights are supported exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from trex_tpu.topology import Topology


def _combine0(a: jax.Array, b: jax.Array) -> jax.Array:
    """Fitch combine with 0 = "no information" identity element."""
    inter = a & b
    merged = jnp.where(inter == 0, a | b, inter)
    merged = jnp.where(a == 0, b, merged)
    return jnp.where(b == 0, a, merged)


@partial(jax.jit, static_argnames=("sequences_are_masks", "prune_chunk"))
def spr_scan(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    prune_nodes: jax.Array | None = None,
    prune_chunk: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact parsimony scores of ALL SPR rearrangements of one tree.

    Args:
        topology: single (unbatched) tree over n_all nodes.
        leaf_sequences: (n_leaves, L) int states, or int32 state-set masks
            with ``sequences_are_masks=True``.
        site_weights: optional (L,) per-site multiplicities.
        prune_nodes: optional (P,) int32 subset of prune nodes to evaluate
            (default: every non-root node). Stepwise addition uses a single
            prune node per step — one O(n) pass instead of the full scan.
        prune_chunk: process prune variants in chunks of this size
            (``lax.map`` batches) to bound the peak (chunk x nodes x sites)
            set tensors — needed beyond ~256 taxa x 2k sites on a 16 GB
            chip. Must divide the prune count; None = all at once.

    Returns:
        scores: (P_out, n_all) f32 — ``scores[i, v]`` is the exact unit-cost
            parsimony score of the tree obtained by pruning the subtree at
            ``prune_nodes[i]`` and regrafting it on the edge above v; +inf
            at invalid pairs (v inside the pruned subtree, v == parent(p),
            v == the remaining tree's root). With the default prune set the
            output is padded to a square (n_all, n_all) with an all-inf
            root row, and ``scores[p, sibling(p)]`` equals the current
            score (reattachment no-op).
        base_score: scalar f32 — the unmodified tree's score.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    n_anc = topology.n_ancestors
    length = leaf_sequences.shape[-1]
    root = n_all - 1

    if sequences_are_masks:
        masks = leaf_sequences.astype(jnp.int32)
    else:
        masks = (jnp.int32(1) << leaf_sequences.astype(jnp.int32)).astype(
            jnp.int32
        )
    if site_weights is None:
        weights = jnp.ones((length,), jnp.float32)
    else:
        weights = site_weights.astype(jnp.float32)

    children = topology.children.astype(jnp.int32)
    parents = topology.parents.astype(jnp.int32)

    # Pruned variants: for prune node p with parent q and sibling s, variant
    # children = base children with row (q - n_leaves) set to (s, s). The
    # pass-through row keeps every node index stable: up(q) = up(s) with no
    # event, and the down pass forwards down(q) to s unchanged.
    full_scan = prune_nodes is None
    if full_scan:
        prune_nodes = jnp.arange(n_all - 1, dtype=jnp.int32)  # every non-root
    else:
        prune_nodes = prune_nodes.astype(jnp.int32)
    q_rows = parents[prune_nodes] - n_leaves  # (P,)
    row_pair = children[q_rows]  # (P, 2)
    siblings = row_pair[:, 0] + row_pair[:, 1] - prune_nodes  # (P,)

    def variant(q_row, sib):
        return children.at[q_row].set(jnp.stack([sib, sib]))

    var_children = jax.vmap(variant)(q_rows, siblings)  # (P, n_anc, 2)

    def up_pass(ch):
        """(n_all, L) Fitch up sets + per-site event counts."""
        sets0 = jnp.zeros((n_all, length), jnp.int32)
        sets0 = sets0.at[:n_leaves].set(masks)
        events0 = jnp.zeros((length,), jnp.float32)

        def step(carry, inputs):
            sets, events = carry
            anc_offset, pair = inputs
            c = sets[pair]
            inter = c[0] & c[1]
            empty = inter == 0
            merged = jnp.where(empty, c[0] | c[1], inter)
            sets = jax.lax.dynamic_update_slice(
                sets, merged[None], (n_leaves + anc_offset, 0)
            )
            return (sets, events + empty.astype(jnp.float32)), None

        offsets = jnp.arange(n_anc, dtype=jnp.int32)
        (sets, events), _ = jax.lax.scan(step, (sets0, events0), (offsets, ch))
        return sets, events

    def down_pass(ch, up):
        """(n_all, L) down contexts (0 = none); pass-through rows forward."""
        down0 = jnp.zeros((n_all, length), jnp.int32)

        def step(down, inputs):
            anc_offset, pair = inputs
            node = n_leaves + anc_offset
            d = down[node]
            c1, c2 = pair[0], pair[1]
            is_pass = c1 == c2
            ctx1 = jnp.where(is_pass, d, _combine0(d, up[c2]))
            ctx2 = _combine0(d, up[c1])
            down = down.at[c1].set(ctx1)
            # For pass-through rows both entries are c1; writing ctx2 there
            # would clobber the forwarded context, so write ctx1 again.
            down = down.at[c2].set(jnp.where(is_pass, ctx1, ctx2))
            return down, None

        offsets = jnp.arange(n_anc, dtype=jnp.int32)
        down, _ = jax.lax.scan(
            step, down0, (offsets, ch), reverse=True
        )
        return down

    base_sets, base_events = up_pass(children)
    base_score = jnp.sum(base_events * weights)

    def chunk_scores(args):
        pn, vch = args  # (C,), (C, n_anc, 2)
        up, events = jax.vmap(up_pass)(vch)  # (C, n_all, L), (C, L)
        down = jax.vmap(down_pass)(vch, up)  # (C, n_all, L)
        # Variant totals include the pruned subtree's internal events (its
        # rows still compute below p), so total(p) = L(T∖S) + L(S) —
        # exactly the first two terms of the identity.
        totals = jnp.sum(events * weights[None, :], axis=-1)  # (C,)
        # U_p: the pruned subtree's root set — p's subtree is untouched in
        # its own variant, so read it there.
        u_p = up[jnp.arange(pn.shape[0]), pn]  # (C, L)
        # Edge contexts and per-site join penalties.
        ctx = _combine0(up, down)  # (C, n_all, L)
        empty_join = (u_p[:, None, :] & ctx) == 0
        delta = jnp.sum(
            empty_join.astype(jnp.float32) * weights[None, None, :], axis=-1
        )  # (C, n_all)
        return totals[:, None] + delta

    n_prune = prune_nodes.shape[0]
    if prune_chunk is None or prune_chunk >= n_prune:
        scores = chunk_scores((prune_nodes, var_children))
    else:
        pad = (-n_prune) % prune_chunk
        pn = jnp.concatenate(
            [prune_nodes, jnp.broadcast_to(prune_nodes[-1:], (pad,))]
        )
        vch = jnp.concatenate(
            [
                var_children,
                jnp.broadcast_to(
                    var_children[-1:], (pad,) + var_children.shape[1:]
                ),
            ]
        )
        k = pn.shape[0] // prune_chunk
        scores = jax.lax.map(
            chunk_scores,
            (
                pn.reshape(k, prune_chunk),
                vch.reshape(k, prune_chunk, n_anc, 2),
            ),
        ).reshape(-1, n_all)[:n_prune]

    # Invalid regrafts -> +inf: v inside S(p) (ancestor-or-self p of v),
    # v == parent(p) (suppressed), v == remaining root.
    # in_S[p, v]: walk v's parent chain, check if it hits p.
    idx = jnp.arange(n_all, dtype=jnp.int32)

    def mark(carry, _):
        ptr, hit = carry
        hit = hit | (ptr[None, :] == prune_nodes[:, None])
        ptr = parents[ptr]
        return (ptr, hit), None

    (_, in_s), _ = jax.lax.scan(
        mark,
        (idx, jnp.zeros((prune_nodes.shape[0], n_all), bool)),
        None,
        length=n_all,
    )
    q = parents[prune_nodes]
    rem_root = jnp.where(q == root, siblings, root)  # (P,)
    invalid = (
        in_s
        | (idx[None, :] == q[:, None])
        | (idx[None, :] == rem_root[:, None])
        | (idx[None, :] == root)
    )
    scores = jnp.where(invalid, jnp.inf, scores)

    if full_scan:
        # Pad the prune axis to n_all (root row all-inf): square output.
        scores = jnp.concatenate(
            [scores, jnp.full((1, n_all), jnp.inf, scores.dtype)]
        )
    return scores, base_score


"""Maximum prune-variants x nodes cells per scan DISPATCH.

Bounds the prune-axis extent of one dispatch (score table, validity mask,
variant tensor), which the chunked working-set budget does not. The value
is carried over from the previous accelerator and is not yet derived for
the H100; retuning it is open work.
"""
_MAX_SCAN_CELLS = 1 << 24


def spr_scan_segmented(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    prune_chunk: int | None = None,
    max_cells: int = _MAX_SCAN_CELLS,
) -> tuple[jax.Array, jax.Array]:
    """``spr_scan`` over the full prune set, split into SAFE dispatches.

    Drop-in for the full scan: returns the same (n_all, n_all) layout
    (all-inf root row appended). Each dispatch evaluates at most
    ``max_cells / n_all`` prune variants — segments are equal-sized (the
    last one padded with repeats, sliced off) so the whole climb compiles
    TWO programs regardless of segment count. Rows are computed whole per
    dispatch, so scores are bit-identical to the one-dispatch scan.
    """
    import numpy as np

    n_all = topology.n_all
    n_prune = n_all - 1
    if n_prune * n_all <= max_cells:
        scores, base = spr_scan(
            topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
            prune_chunk=prune_chunk,
        )
        return scores, base
    seg = max(1, max_cells // n_all)
    rows = []
    base = None
    for s0 in range(0, n_prune, seg):
        pn = np.arange(s0, s0 + seg, dtype=np.int32)
        pn[pn >= n_prune] = n_prune - 1  # pad with repeats; sliced off
        sc, base = spr_scan(
            topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
            prune_nodes=jnp.asarray(pn), prune_chunk=prune_chunk,
        )
        rows.append(sc)
    scores = jnp.concatenate(rows)[:n_prune]
    root_row = jnp.full((1, n_all), jnp.inf, scores.dtype)
    return jnp.concatenate([scores, root_row]), base


@jax.jit
def _segment_best(scores: jax.Array, valid_rows: jax.Array):
    """Device-side argmin over one segment's (S, n_all) score block.

    Rows at index >= valid_rows are padding (repeats of the last prune
    node) and are masked to +inf. Returns (min, flat_argmin, finite_count)
    — three scalars, so the host never reads the O(n^2) table back.
    """
    masked = jnp.where(
        (jnp.arange(scores.shape[0]) < valid_rows)[:, None],
        scores,
        jnp.inf,
    )
    flat = masked.reshape(-1)
    idx = jnp.argmin(flat)
    return flat[idx], idx.astype(jnp.int32), jnp.isfinite(flat).sum()


def spr_scan_best_segmented(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    prune_chunk: int | None = None,
    max_cells: int = _MAX_SCAN_CELLS,
) -> tuple[float, int, int, float, int]:
    """Best SPR move via segmented scans with DEVICE-SIDE argmin reduction.

    ``spr_scan_segmented`` materializes the full (n_all, n_all) table and
    the climb reads it back for one argmin — 4.3 GB per round at 16384
    taxa. Here each segment reduces on device to
    (min, argmin, finite_count) and only scalars cross to the host; the
    move picked is IDENTICAL to the full-table ``np.argmin`` (segments in
    order, strict improvement keeps the earliest minimum — the same
    first-of-ties rule). Returns
    (best_score, prune_node, regraft_node, base_score, n_finite).
    """
    import numpy as np

    n_all = topology.n_all
    n_prune = n_all - 1
    seg = max(1, min(n_prune, max_cells // n_all))
    # Dispatch EVERY segment (scan + device reduction) before reading any
    # scalar back: a per-segment blocking readback serializes the device.
    # Each
    # segment's score table is a temporary freed once its reduction runs,
    # so the queue holds only 3 scalars per segment.
    pending = []
    base = None
    for s0 in range(0, n_prune, seg):
        valid = min(seg, n_prune - s0)
        pn = np.arange(s0, s0 + seg, dtype=np.int32)
        pn[pn >= n_prune] = n_prune - 1
        sc, base = spr_scan(
            topology, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks,
            prune_nodes=jnp.asarray(pn), prune_chunk=prune_chunk,
        )
        pending.append((s0, _segment_best(sc, jnp.int32(valid))))
    best = np.inf
    best_p = best_v = 0
    n_finite = 0
    for s0, (m, idx, cnt) in pending:
        m = float(m)
        n_finite += int(cnt)
        if m < best:
            best = m
            row, best_v = divmod(int(idx), n_all)
            best_p = s0 + row
    return best, best_p, best_v, float(base), n_finite


def spr_scan_best(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """(best_score, prune_node, regraft_node, base_score) of the SPR scan."""
    best, p, v, base, _ = spr_scan_best_segmented(
        topology, leaf_sequences, site_weights,
        sequences_are_masks=sequences_are_masks,
    )
    return (
        jnp.float32(best),
        jnp.int32(p),
        jnp.int32(v),
        jnp.float32(base),
    )
