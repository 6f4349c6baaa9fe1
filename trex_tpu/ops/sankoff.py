"""Exact Sankoff maximum-parsimony DP, accelerator formulation.

Reference semantics (``/root/reference/src/trex/sankoff.py``):
  - leaf DP cost 0 at the observed state, 1e5 elsewhere (``:49-52, :152``);
  - ancestor cost  ``sum_children  min_{s'} (C[s, s'] + DP[child, s'])``
    (``:67-70``), ancestors processed in index order (``:87-92``);
  - total score = per-site min over root states, summed over sites (``:187``);
  - backtracking table stores argmin child states per (node, state)
    (``:80-83``), consumed root-down.

Differences from the reference (none change the numerics):
  - DP layout is ``(nodes, states, sites)`` — sites are the contiguous vector
    axis; the reference's per-site vmap layout ``(L, nodes, Q)`` leaves the
    vector width nearly empty at Q=4.
  - The tree is consumed as a ``Topology`` (per-ancestor child index pairs),
    not a dense adjacency; no ``where(adj[:, node])`` gathers in the hot loop.
  - One ``lax.scan`` over ancestors carries the DP table; each step is a
    min-plus contraction vectorized over (2 children × Q states × L sites).
  - Reconstruction is a *reverse* scan from the root: a node's optimal state
    is read before its children's, so no per-site stack/while_loop
    (cf. ``backtrack_sankoff_jit``, ``sankoff.py:191-267``).

Reduction order matches the reference exactly (per-site min over states, then
site-sum, f32 accumulation, 1e5 sentinel) so scores bit-match.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from trex_tpu.topology import Topology, topology_from_adjacency
from trex_tpu.types import BIG_COST


def leaf_dp_table(
    leaf_sequences: jax.Array,
    n_states: int,
    dtype=jnp.float32,
) -> jax.Array:
    """Initial DP block for the leaves.

    Args:
        leaf_sequences: (n_leaves, L) int states.
        n_states: alphabet size Q.

    Returns:
        (n_leaves, Q, L): 0 at the observed state, ``BIG_COST`` elsewhere.
    """
    states = jnp.arange(n_states, dtype=jnp.int32)
    observed = leaf_sequences.astype(jnp.int32)[:, None, :] == states[None, :, None]
    return jnp.where(observed, jnp.zeros((), dtype), jnp.asarray(BIG_COST, dtype))


def leaf_dp_table_from_masks(
    leaf_masks: jax.Array,
    n_states: int,
    dtype=jnp.float32,
) -> jax.Array:
    """Initial DP block for (possibly ambiguous) leaves given state-set masks.

    Args:
        leaf_masks: (n_leaves, L) int32 bitmasks of allowed states (IUPAC
            ambiguity codes, gaps/missing = full mask). Must be nonzero.
        n_states: alphabet size Q.

    Returns:
        (n_leaves, Q, L): 0 at every allowed state, ``BIG_COST`` elsewhere —
        the min-plus encoding of "min over all resolutions of the ambiguity".
    """
    states = jnp.arange(n_states, dtype=jnp.int32)
    allowed = (
        jnp.right_shift(leaf_masks.astype(jnp.int32)[:, None, :], states[None, :, None])
        & 1
    ) == 1
    return jnp.where(allowed, jnp.zeros((), dtype), jnp.asarray(BIG_COST, dtype))


def _minplus_messages(child_dp: jax.Array, cost: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Min-plus contraction for one ancestor.

    Args:
        child_dp: (2, Q, L) DP rows of the two children.
        cost: (Q, Q) substitution cost, ``cost[parent_state, child_state]``.

    Returns:
        messages (2, Q, L): per-child min cost for each parent state, and
        argmins (2, Q, L) int32: the child state realizing each minimum.
    """
    # (2, Qparent, Qchild, L) broadcast, reduced over the child-state axis.
    expanded = cost[None, :, :, None] + child_dp[:, None, :, :]
    return jnp.min(expanded, axis=2), jnp.argmin(expanded, axis=2).astype(jnp.int32)


def _hamming_messages(child_dp: jax.Array) -> jax.Array:
    """Closed-form min-plus messages for Hamming cost (ones - eye).

    msg[s] = min_{s'} (C[s,s'] + d[s']) = min(d[s], 1 + min_{s'} d[s']) —
    O(Q) per node instead of the O(Q^2) broadcast. Identical scores to the
    general path (ties in *argmins* may resolve differently, so the
    reconstruction path always uses the general messages).
    """
    return jnp.minimum(child_dp, 1.0 + jnp.min(child_dp, axis=-2, keepdims=True))


def sankoff_tables(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    dtype=jnp.float32,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Fill the Sankoff DP and backtracking tables for one tree.

    Args:
        topology: tree over ``n_all`` nodes (single, unbatched).
        cost_matrix: (Q, Q) substitution costs.
        leaf_sequences: (n_leaves, L) int states, or int32 state-set
            bitmasks when ``sequences_are_masks`` (ambiguity/gap support).

    Returns:
        dp: (n_all, Q, L) filled DP table.
        back: (n_ancestors, 2, Q, L) int32 argmin child states.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    n_states = cost_matrix.shape[-1]
    length = leaf_sequences.shape[-1]
    cost = cost_matrix.astype(dtype)

    leaf_dp = (
        leaf_dp_table_from_masks(leaf_sequences, n_states, dtype)
        if sequences_are_masks
        else leaf_dp_table(leaf_sequences, n_states, dtype)
    )
    dp0 = jnp.full((n_all, n_states, length), jnp.asarray(BIG_COST, dtype))
    dp0 = dp0.at[:n_leaves].set(leaf_dp)

    def step(dp, inputs):
        anc_offset, child_pair = inputs
        child_dp = dp[child_pair]  # (2, Q, L)
        messages, argmins = _minplus_messages(child_dp, cost)
        dp = jax.lax.dynamic_update_slice(
            dp, jnp.sum(messages, axis=0)[None], (n_leaves + anc_offset, 0, 0)
        )
        return dp, argmins

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    dp, back = jax.lax.scan(step, dp0, (offsets, topology.children))
    return dp, back


def sankoff_score(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    site_mask: jax.Array | None = None,
    dtype=jnp.float32,
    hamming: bool = False,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Exact parsimony score of one tree (scalar).

    Score = per-site min over root states, summed over (unmasked) sites —
    the reference's reduction order (``sankoff.py:187``). Pass
    ``hamming=True`` when ``cost_matrix`` is ``ones - eye`` to take the O(Q)
    closed-form message path (cost_matrix is then ignored);
    ``sequences_are_masks=True`` for ambiguous leaves as state-set bitmasks.
    """
    if hamming:
        n_leaves = topology.n_leaves
        n_all = topology.n_all
        n_states = cost_matrix.shape[-1]
        length = leaf_sequences.shape[-1]
        leaf_dp = (
            leaf_dp_table_from_masks(leaf_sequences, n_states, dtype)
            if sequences_are_masks
            else leaf_dp_table(leaf_sequences, n_states, dtype)
        )
        dp0 = jnp.full((n_all, n_states, length), jnp.asarray(BIG_COST, dtype))
        dp0 = dp0.at[:n_leaves].set(leaf_dp)

        def step(dp, inputs):
            anc_offset, child_pair = inputs
            messages = _hamming_messages(dp[child_pair])
            dp = jax.lax.dynamic_update_slice(
                dp, jnp.sum(messages, axis=0)[None], (n_leaves + anc_offset, 0, 0)
            )
            return dp, None

        offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
        dp, _ = jax.lax.scan(step, dp0, (offsets, topology.children))
    else:
        dp, _ = sankoff_tables(
            topology, cost_matrix, leaf_sequences, dtype,
            sequences_are_masks=sequences_are_masks,
        )
    per_site = jnp.min(dp[-1], axis=0)  # (L,)
    if site_mask is not None:
        per_site = per_site * site_mask.astype(per_site.dtype)
    return jnp.sum(per_site)


def sankoff_reconstruct(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    dtype=jnp.float32,
    *,
    sequences_are_masks: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Score a tree and reconstruct ancestral sequences.

    Returns:
        sequences: (n_all, L) int32 — leaves verbatim, ancestors argmin states.
        dp: (n_all, Q, L) DP table.
        score: scalar parsimony score.

    Traceback runs root-down in one reverse scan: ancestors have larger
    indices than their children, so reading the parent's chosen state before
    writing the children's is a valid schedule — this replaces the
    per-site explicit stack of the reference (``sankoff.py:212-265``) with a
    site-vectorized pass.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    length = leaf_sequences.shape[-1]

    dp, back = sankoff_tables(
        topology, cost_matrix, leaf_sequences, dtype,
        sequences_are_masks=sequences_are_masks,
    )

    chosen0 = jnp.zeros((n_all, length), dtype=jnp.int32)
    root_states = jnp.argmin(dp[-1], axis=0).astype(jnp.int32)  # (L,)
    chosen0 = chosen0.at[-1].set(root_states)

    def down_step(chosen, inputs):
        anc_offset, child_pair, argmins = inputs
        parent_states = chosen[n_leaves + anc_offset]  # (L,)
        # argmins: (2, Q, L) — select the row for the parent's chosen state.
        child_states = jnp.take_along_axis(
            argmins, parent_states[None, None, :], axis=1
        )[:, 0, :]  # (2, L)
        chosen = chosen.at[child_pair[0]].set(child_states[0])
        chosen = chosen.at[child_pair[1]].set(child_states[1])
        return chosen, None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    chosen, _ = jax.lax.scan(
        down_step, chosen0, (offsets, topology.children, back), reverse=True
    )

    # Leaves are observed: pass them through verbatim (``sankoff.py:162``).
    # With ambiguous leaves the downward pass already picked an allowed
    # (0-cost-init) state per leaf, so keep its resolution instead.
    if not sequences_are_masks:
        chosen = chosen.at[:n_leaves].set(leaf_sequences.astype(jnp.int32))
    score = jnp.sum(jnp.min(dp[-1], axis=0))
    return chosen, dp, score


# Candidate-tree batch scoring: vmap over the topology batch axis only; the
# alignment and cost matrix are shared (broadcast) across candidates.
batched_sankoff_score = jax.vmap(sankoff_score, in_axes=(0, None, None))

# Hamming-specialized batch scoring (closed-form messages; cost ignored).
batched_sankoff_score_hamming = jax.vmap(
    partial(sankoff_score, hamming=True), in_axes=(0, None, None)
)


@partial(jax.jit, static_argnames=("n_all", "n_states", "n_leaves", "return_path"))
def run_sankoff(
    adjacency_matrix: jax.Array,
    cost_matrix: jax.Array,
    sequences: jax.Array,
    n_all: int,
    n_states: int,
    n_leaves: int,
    *,
    return_path: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Adjacency-based API with the reference's exact signature and outputs.

    Drop-in counterpart of ``run_sankoff`` (``/root/reference/src/trex/sankoff.py:114-188``):
    takes a dense adjacency (root self-loop tolerated), returns
    ``(reconstructed (n_all, L), dp (L, n_all, Q), total_cost)`` — note the
    returned DP is transposed to the reference's (sites, nodes, states) layout
    for test parity; internal compute uses (nodes, states, sites).
    """
    del n_all, n_states  # shapes carry these; kept for API parity
    topo = topology_from_adjacency(adjacency_matrix, n_leaves)
    leaf_seqs = sequences[:n_leaves].astype(jnp.int32)
    if return_path:
        recon, dp, score = sankoff_reconstruct(topo, cost_matrix, leaf_seqs)
    else:
        dp, _ = sankoff_tables(topo, cost_matrix, leaf_seqs)
        score = jnp.sum(jnp.min(dp[-1], axis=0))
        recon = jnp.zeros((topo.n_all, leaf_seqs.shape[-1]), dtype=jnp.int32)
        recon = recon.at[:n_leaves].set(leaf_seqs)
    return recon, jnp.transpose(dp, (2, 0, 1)), score
