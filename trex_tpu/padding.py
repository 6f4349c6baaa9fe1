"""Static-shape padding and bucketing utilities.

XLA compiles one program per distinct shape; without bucketing, sweeping over
problem sizes recompiles constantly. The reference caps its buckets at 256
sites / 63 nodes (``/root/reference/src/trex/padding.py:26-28``); here buckets
are open-ended powers-of-two (with a floor of 128 for the site axis, the
vector axis of the DP layout) so large alignments work too.

Padded sites/nodes are excluded from results with boolean masks; the DP gives
padded sites zero cost by construction (all-state cost 0 at padded leaf
columns), see ``trex_tpu.ops.sankoff``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Default bucket ladders. Site buckets are lane-aligned (multiples of 128)
# beyond the smallest sizes; node buckets cover 2^k-leaf binary trees.
SITE_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
K_BUCKETS: tuple[int, ...] = (2, 4, 8)
NODE_BUCKETS: tuple[int, ...] = (15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767, 65535)


def next_bucket(value: int, buckets: tuple[int, ...] = SITE_BUCKETS) -> int:
    """Smallest bucket >= value; falls back to next power of two above ladder."""
    for b in buckets:
        if value <= b:
            return b
    b = buckets[-1]
    while b < value:
        b *= 2
    return b


def site_bucket(n_sites: int) -> int:
    return next_bucket(n_sites, SITE_BUCKETS)


def node_bucket(n_nodes: int) -> int:
    return next_bucket(n_nodes, NODE_BUCKETS)


def k_bucket(k: int) -> int:
    return next_bucket(k, K_BUCKETS)


def pad_axis(x: jax.Array, axis: int, target: int, fill=0) -> jax.Array:
    """Pad one axis of ``x`` up to ``target`` with ``fill`` (no-op if already)."""
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        raise ValueError(f"axis {axis} size {cur} exceeds target {target}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - cur)
    return jnp.pad(x, widths, constant_values=fill)


def pad_sites(sequences: jax.Array, target_sites: int) -> jax.Array:
    """Pad the trailing site axis of (..., L) integer sequences with state 0."""
    return pad_axis(sequences, -1, target_sites, fill=0)


def site_mask(n_real: int, n_padded: int) -> jax.Array:
    """(n_padded,) bool mask, True at real site positions."""
    return jnp.arange(n_padded) < n_real


def node_mask(n_real: int, n_padded: int) -> jax.Array:
    """(n_padded,) bool mask, True at real node positions."""
    return jnp.arange(n_padded) < n_real


def pad_adjacency(adjacency: jax.Array, target_nodes: int) -> jax.Array:
    """Pad a dense (N, N) adjacency to (target, target) with zeros."""
    a = pad_axis(adjacency, -1, target_nodes)
    return pad_axis(a, -2, target_nodes)


def pad_nk_tables(
    fitness_tables: jax.Array,
    interactions: jax.Array,
    target_sites: int,
    target_k: int,
    n_states: int,
) -> tuple[jax.Array, jax.Array]:
    """Pad NK landscape tensors to bucketed (L, q^(K+1)) / (L, K) shapes.

    Padded interaction slots point at site 0 (neutral, like the reference's
    ``pad_interactions``, ``padding.py:185-218``); padded table entries are 0.
    """
    tables = pad_axis(fitness_tables, -1, n_states ** (target_k + 1), fill=0.0)
    tables = pad_axis(tables, -2, target_sites, fill=0.0)
    inter = pad_axis(interactions, -1, target_k, fill=0)
    inter = pad_axis(inter, -2, target_sites, fill=0)
    return tables, inter


def masked_sum(values: jax.Array, mask: jax.Array) -> jax.Array:
    """Sum over positions where ``mask`` is True."""
    return jnp.sum(values * mask)


def masked_mean(values: jax.Array, mask: jax.Array) -> jax.Array:
    """Mean over positions where ``mask`` is True."""
    return jnp.sum(values * mask) / jnp.sum(mask)
