"""Pairwise sequence distances, shaped as matmuls.

The reference has no distance methods at all; production tree search needs
them for starting trees (neighbor joining, ``search/nj.py``) and data
diagnostics. The (n, n) mismatch-count matrix is Q matmuls of one-hot
indicator matrices — ``matches = sum_q X_q @ X_q^T`` — which XLA hands to
the matrix units, instead of the O(n^2 L) elementwise broadcast a naive
port would use.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n_states",))
def hamming_distance_matrix(
    leaf_sequences: jax.Array,
    n_states: int,
    site_weights: jax.Array | None = None,
) -> jax.Array:
    """(n, n) f32 count of mismatching sites between every sequence pair.

    Args:
        leaf_sequences: (n, L) integer states.
        n_states: alphabet size Q.
        site_weights: optional (L,) weights (compressed-pattern counts /
            bootstrap weights); a mismatch at site s counts ``w[s]``.

    Computed as ``total_weight - sum_q X_q W X_q^T`` with X the one-hot
    indicators — Q weighted (n, L) @ (L, n) matmuls, f32 accumulation.
    """
    seqs = leaf_sequences.astype(jnp.int32)
    length = seqs.shape[-1]
    if site_weights is None:
        weights = jnp.ones((length,), jnp.float32)
    else:
        weights = site_weights.astype(jnp.float32)
    one_hot = (seqs[:, None, :] == jnp.arange(n_states, dtype=jnp.int32)[None, :, None])
    x = one_hot.astype(jnp.float32)  # (n, Q, L)
    xw = x * weights  # broadcast over sites
    # (n, Q, L) x (n, Q, L) -> (n, n): contract states and sites together.
    matches = jnp.einsum(
        "iql,jql->ij", xw, x, preferred_element_type=jnp.float32
    )
    return jnp.sum(weights) - matches


def p_distance_matrix(
    leaf_sequences: jax.Array,
    n_states: int,
    site_weights: jax.Array | None = None,
) -> jax.Array:
    """Proportion of differing sites per pair (normalized Hamming)."""
    length = (
        leaf_sequences.shape[-1]
        if site_weights is None
        else jnp.sum(site_weights.astype(jnp.float32))
    )
    return hamming_distance_matrix(leaf_sequences, n_states, site_weights) / length


def jc_distance_matrix(
    leaf_sequences: jax.Array,
    n_states: int,
    site_weights: jax.Array | None = None,
) -> jax.Array:
    """Jukes-Cantor-corrected evolutionary distances.

    d = -(Q-1)/Q * log(1 - Q/(Q-1) * p), the standard correction generalized
    to Q states; saturated pairs (p >= (Q-1)/Q) are clamped just below the
    pole so the result stays finite (large but ordered).
    """
    p = p_distance_matrix(leaf_sequences, n_states, site_weights)
    a = (n_states - 1) / n_states
    p = jnp.minimum(p, a * (1.0 - 1e-6))
    return -a * jnp.log1p(-p / a)
