"""Differentiable and exact parsimony cost functions.

Counterparts of the reference's cost layer
(``/root/reference/src/trex/tree.py:163-296``), kept in the same quadratic
gram-expansion form because it is already matmul-shaped: the only
O(N^2 L Q) term is a single ``(N, L*Q) @ (L*Q, N)`` matmul, which XLA hands
to the matrix units. No N×N×L×Q tensor is ever materialized.

All matmuls request ``preferred_element_type=float32`` so bfloat16 inputs
still accumulate in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pairwise(flat_a: jax.Array, flat_b: jax.Array) -> jax.Array:
    return jax.lax.dot_general(
        flat_a,
        flat_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def surrogate_cost(soft_sequences: jax.Array, soft_adjacency: jax.Array) -> jax.Array:
    """Quadratic surrogate parsimony cost.

    ``1/2 * sum_ij A_ij ||S_i - S_j||^2`` expanded into self-energies plus one
    gram matmul — the reference's formulation (``tree.py:163-209``).

    Args:
        soft_sequences: (N, L, Q) soft state probabilities.
        soft_adjacency: (N, N) soft parent-assignment matrix (rows sum to 1).
    """
    n = soft_sequences.shape[0]
    flat = soft_sequences.reshape(n, -1)
    self_energy = jnp.sum(jnp.square(soft_sequences), axis=(-1, -2))  # (N,)
    gram = _pairwise(flat, flat)  # (N, N)
    weighted = (
        jnp.sum(soft_adjacency * self_energy[:, None])
        + jnp.sum(soft_adjacency * self_energy[None, :])
        - 2.0 * jnp.sum(soft_adjacency * gram)
    )
    return weighted / 2.0


def soft_parsimony_cost(
    soft_sequences: jax.Array,
    soft_adjacency: jax.Array,
    cost_matrix: jax.Array | None = None,
) -> jax.Array:
    """Substitution-weighted soft parsimony cost.

    ``1/2 * sum_ij A_ij (S_i - S_j)^T C (S_i - S_j)`` in the same expanded
    form (``tree.py:212-266``). ``cost_matrix`` may be a (Q, Q) matrix, a
    (Q,) diagonal, or None (identity weighting == surrogate on probabilities).
    """
    n = soft_sequences.shape[0]
    if cost_matrix is None:
        weighted_seqs = soft_sequences
    elif cost_matrix.ndim == 1:
        weighted_seqs = soft_sequences * cost_matrix
    else:
        weighted_seqs = jnp.einsum(
            "nlq,qr->nlr", soft_sequences, cost_matrix,
            preferred_element_type=jnp.float32,
        ).astype(soft_sequences.dtype)

    self_energy = jnp.sum(soft_sequences * weighted_seqs, axis=(-1, -2))
    gram = _pairwise(soft_sequences.reshape(n, -1), weighted_seqs.reshape(n, -1))
    weighted = (
        jnp.sum(soft_adjacency * self_energy[:, None])
        + jnp.sum(soft_adjacency * self_energy[None, :])
        - 2.0 * jnp.sum(soft_adjacency * gram)
    )
    return weighted / 2.0


def exact_cost(
    one_hot_sequences: jax.Array,
    adjacency: jax.Array,
    substitution_matrix: jax.Array,
) -> jax.Array:
    """Exact discrete parsimony score of (possibly soft) sequences + topology.

    Discretizes by argmax, gathers each node's parent row, and sums
    substitution costs over all non-root edges — the reference's
    ``compute_cost`` (``tree.py:269-296``). Not differentiable (piecewise
    constant); used as an evaluation oracle.
    """
    states = jnp.argmax(one_hot_sequences, axis=-1)
    parent_idx = jnp.argmax(adjacency, axis=-1)
    parent_states = states[parent_idx]
    per_site = substitution_matrix[parent_states, states]  # (N, L)
    return per_site[:-1, :].sum()
