"""Differentiable (smoothed-min) Sankoff dynamic programming.

The exact DP is piecewise constant — the reference differentiates only
through quadratic *surrogates* of parsimony (``tree.py:163-266``). Here the
DP itself is made differentiable by replacing every ``min`` with the
temperature-smoothed soft minimum

    softmin_T(x) = -T * logsumexp(-x / T),

which converges to ``min`` as T -> 0 (uniformly, with error <= T*log(n)).
Gradients flow through the whole recursion:

- d(score)/d(cost_matrix): learn substitution weights against objectives;
- d(score)/d(leaf_costs): soft leaf beliefs (e.g. uncertain base calls or
  relaxed sequences) receive per-site credit assignment.

Same layout and schedule as the exact path (``ops/sankoff.py``): scan over
ancestors, (nodes, states, sites) tables, sites vectorized — so the soft DP
jits, vmaps over candidate batches, and shards exactly like the exact one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from trex_tpu.ops.sankoff import leaf_dp_table
from trex_tpu.topology import Topology


def softmin(x: jax.Array, axis: int, temperature) -> jax.Array:
    """-T * logsumexp(-x / T); exact min at the T -> 0 limit."""
    return -temperature * jax.nn.logsumexp(-x / temperature, axis=axis)


def soft_sankoff_score(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_costs: jax.Array,
    temperature: float | jax.Array = 0.1,
    site_mask: jax.Array | None = None,
) -> jax.Array:
    """Differentiable parsimony score (scalar).

    Args:
        leaf_costs: (n_leaves, Q, L) per-leaf per-state costs. For hard
            sequences use ``leaf_dp_table(seqs, Q)``; for soft beliefs use
            e.g. ``-log p`` clipped to the BIG_COST sentinel.
        temperature: smoothing temperature T; the result lies within
            ``T * log(Q) * (2 * n_ancestors + 1)`` of the exact score.

    Returns:
        Scalar f32 score; differentiable w.r.t. ``cost_matrix``,
        ``leaf_costs``, and ``temperature``.
    """
    n_leaves = topology.n_leaves
    n_all = topology.n_all
    n_states = cost_matrix.shape[-1]
    length = leaf_costs.shape[-1]

    from trex_tpu.types import BIG_COST

    dp0 = jnp.full((n_all, n_states, length), jnp.asarray(BIG_COST, jnp.float32))
    dp0 = dp0.at[:n_leaves].set(leaf_costs.astype(jnp.float32))

    def step(dp, inputs):
        anc_offset, child_pair = inputs
        child_dp = dp[child_pair]  # (2, Q, L)
        expanded = cost_matrix[None, :, :, None] + child_dp[:, None, :, :]
        messages = softmin(expanded, axis=2, temperature=temperature)
        dp = jax.lax.dynamic_update_slice(
            dp, jnp.sum(messages, axis=0)[None], (n_leaves + anc_offset, 0, 0)
        )
        return dp, None

    offsets = jnp.arange(topology.n_ancestors, dtype=jnp.int32)
    dp, _ = jax.lax.scan(step, dp0, (offsets, topology.children))
    per_site = softmin(dp[-1], axis=0, temperature=temperature)
    if site_mask is not None:
        per_site = per_site * site_mask.astype(per_site.dtype)
    return jnp.sum(per_site)


def soft_sankoff_score_from_sequences(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    temperature: float | jax.Array = 0.1,
    site_mask: jax.Array | None = None,
) -> jax.Array:
    """Convenience wrapper: hard integer leaves -> smoothed score."""
    n_states = cost_matrix.shape[-1]
    return soft_sankoff_score(
        topology,
        cost_matrix,
        leaf_dp_table(leaf_sequences, n_states),
        temperature=temperature,
        site_mask=site_mask,
    )


batched_soft_sankoff_score = jax.vmap(
    soft_sankoff_score_from_sequences, in_axes=(0, None, None, None)
)
