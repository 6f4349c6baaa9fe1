"""Fitch bitset parsimony — the speed-of-light path for Hamming costs.

For unit (Hamming) substitution costs on a binary tree, Fitch's algorithm
computes the same minimum-parsimony score as the Sankoff DP (classical
equivalence; asserted against the Sankoff oracle in
``tests/test_fitch.py``): carry each node's *set of optimal states* as a
bitmask, intersect children sets, and count a +1 union event whenever the
intersection is empty.

Why it's fast: a node's whole state set is ONE int32 per site (vs Q f32 DP
cells), so per ancestor the update is ~4 integer ops per site — ~8x less
arithmetic and memory than the f32 min-plus even in its closed-form Hamming
variant. Limit: n_states <= 32.

This module is the lax formulation (the CPU path and the oracle); the GPU
kernel lives in ``fitch_pallas.batched_fitch_score_pallas``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from trex_tpu.topology import Topology


def leaf_masks(leaf_sequences: jax.Array) -> jax.Array:
    """(n_leaves, L) int states -> (n_leaves, L) int32 singleton bitmasks."""
    return (jnp.int32(1) << leaf_sequences.astype(jnp.int32)).astype(jnp.int32)


def _as_masks(leaf_sequences: jax.Array, sequences_are_masks: bool) -> jax.Array:
    if sequences_are_masks:
        return leaf_sequences.astype(jnp.int32)
    return leaf_masks(leaf_sequences)


def fitch_score(
    topology: Topology,
    leaf_sequences: jax.Array,
    site_mask: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Unit-cost parsimony score of one tree via Fitch bitsets (scalar f32).

    Equivalent to ``sankoff_score(topology, ones - eye, leaf_sequences)``.

    ``sequences_are_masks=True`` treats ``leaf_sequences`` as (n_leaves, L)
    int32 state-set bitmasks instead of integer states — the encoding for
    ambiguous characters (IUPAC codes, gaps, missing taxa). Fitch over sets
    computes exactly ``min`` over all per-site resolutions of the ambiguity
    (it IS unit-cost Sankoff with a 0-cost leaf init over the allowed set),
    so a fully ambiguous leaf contributes 0 everywhere. Masks must be
    nonzero.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]

    sets0 = jnp.zeros((n_all, length), dtype=jnp.int32)
    sets0 = sets0.at[:n_leaves].set(_as_masks(leaf_sequences, sequences_are_masks))
    events0 = jnp.zeros((length,), dtype=jnp.int32)

    def step(carry, inputs):
        sets, events = carry
        anc_offset, child_pair = inputs
        c = sets[child_pair]  # (2, L)
        inter = c[0] & c[1]
        empty = inter == 0
        merged = jnp.where(empty, c[0] | c[1], inter)
        sets = jax.lax.dynamic_update_slice(
            sets, merged[None], (n_leaves + anc_offset, 0)
        )
        return (sets, events + empty.astype(jnp.int32)), None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    (_, events), _ = jax.lax.scan(
        step, (sets0, events0), (offsets, topology.children)
    )
    if site_mask is not None:
        events = events * site_mask.astype(events.dtype)
    return jnp.sum(events).astype(jnp.float32)


batched_fitch_score = jax.vmap(fitch_score, in_axes=(0, None))


def fitch_state_sets(
    topology: Topology,
    leaf_sequences: jax.Array,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Per-node optimal-state sets and their ambiguity.

    Returns:
        sets: (n_all, L) int32 bitmasks — the Fitch upward state sets (for
            ancestors: every state appearing in SOME minimum-parsimony
            labeling given the subtree below).
        ambiguity: (n_all, L) int32 popcounts — 1 means the reconstruction
            at that node/site is unambiguous.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]
    sets0 = jnp.zeros((n_all, length), dtype=jnp.int32)
    sets0 = sets0.at[:n_leaves].set(_as_masks(leaf_sequences, sequences_are_masks))

    def step(sets, inputs):
        anc_offset, child_pair = inputs
        c = sets[child_pair]
        inter = c[0] & c[1]
        merged = jnp.where(inter == 0, c[0] | c[1], inter)
        sets = jax.lax.dynamic_update_slice(
            sets, merged[None], (n_leaves + anc_offset, 0)
        )
        return sets, None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    sets, _ = jax.lax.scan(step, sets0, (offsets, topology.children))
    ambiguity = jax.lax.population_count(sets.view(jnp.uint32)).astype(jnp.int32)
    return sets, ambiguity


@partial(jax.jit, static_argnames=("n_states", "sequences_are_masks"))
def fitch_reconstruct(
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Fitch score + one optimal ancestral labeling (top-down refinement).

    Downward pass: the root takes the lowest set bit of its state set; a
    child keeps the parent's state when it is in the child's set, else takes
    the lowest bit of its own set. This yields a minimum-parsimony labeling
    (standard Fitch refinement).

    With ``sequences_are_masks=True`` (ambiguous leaves as state-set
    bitmasks), leaves are resolved by the same downward rule instead of
    passed through verbatim, yielding one minimum-parsimony resolution of
    the ambiguity.

    Returns:
        sequences: (n_all, L) int32 states (unambiguous leaves verbatim).
        score: scalar f32 parsimony score.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]

    sets0 = jnp.zeros((n_all, length), dtype=jnp.int32)
    sets0 = sets0.at[:n_leaves].set(_as_masks(leaf_sequences, sequences_are_masks))
    events0 = jnp.zeros((length,), dtype=jnp.int32)

    def up(carry, inputs):
        sets, events = carry
        anc_offset, child_pair = inputs
        c = sets[child_pair]
        inter = c[0] & c[1]
        empty = inter == 0
        merged = jnp.where(empty, c[0] | c[1], inter)
        sets = jax.lax.dynamic_update_slice(
            sets, merged[None], (n_leaves + anc_offset, 0)
        )
        return (sets, events + empty.astype(jnp.int32)), None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    (sets, events), _ = jax.lax.scan(up, (sets0, events0), (offsets, topology.children))

    def lowest_state(mask):
        # Index of the lowest set bit: isolate it, then match by comparison
        # over the (static, small) alphabet.
        lsb = mask & -mask
        states = jnp.zeros_like(mask)
        for b in range(n_states):
            states = jnp.where(lsb == (1 << b), jnp.int32(b), states)
        return states

    chosen = jnp.zeros((n_all, length), dtype=jnp.int32)
    chosen = chosen.at[-1].set(lowest_state(sets[-1]))

    def down(chosen, inputs):
        anc_offset, child_pair = inputs
        parent_state = chosen[n_leaves + anc_offset]  # (L,)
        parent_bit = jnp.int32(1) << parent_state
        for k in range(2):
            child_set = sets[child_pair[k]]
            keep = (child_set & parent_bit) != 0
            state = jnp.where(keep, parent_state, lowest_state(child_set))
            chosen = chosen.at[child_pair[k]].set(state)
        return chosen, None

    chosen, _ = jax.lax.scan(
        down, chosen, (offsets, topology.children), reverse=True
    )
    if not sequences_are_masks:
        chosen = chosen.at[:n_leaves].set(leaf_sequences.astype(jnp.int32))
    return chosen, jnp.sum(events).astype(jnp.float32)
