"""Struct-of-arrays tree topology representation.

The reference stores trees as dense ``(n_all, n_all)`` adjacency matrices and
re-derives each ancestor's children inside the DP hot loop with a per-node
``jnp.where(adj[:, node] == 1, size=2)`` (``/root/reference/src/trex/sankoff.py:60``).
That is a poor fit for an accelerator: it serializes gathers over an O(N^2) matrix and
prevents batching heterogeneous candidate trees.

Here a topology is two small integer tensors:

- ``children``: ``(n_ancestors, 2)`` — the two children of ancestor ``i``
  (= tree node ``n_leaves + i``), ascending order.
- ``parents``: ``(n_all,)`` — parent index of each node; the root points to
  itself.

Invariants (the reference's numerics contract, SURVEY.md §2):

- leaves ``0..n_leaves-1``, ancestors above, root = last index,
  ``n_all = 2 * n_leaves - 1``;
- children always have smaller indices than their parent, so processing
  ancestors in index order is a valid topological (post-order-compatible)
  schedule — the same assumption the reference's ``fori_loop`` makes
  (``sankoff.py:87-92``).

A batch of candidate topologies is simply a leading axis on both tensors,
which vmaps/shards trivially.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.types import default_dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Topology:
    """A rooted binary tree over ``2 * n_leaves - 1`` indexed nodes."""

    children: jax.Array
    """(..., n_ancestors, 2) int32 — children of each ancestor node."""
    parents: jax.Array
    """(..., n_all) int32 — parent of each node; root maps to itself."""

    @property
    def n_ancestors(self) -> int:
        return self.children.shape[-2]

    @property
    def n_all(self) -> int:
        return self.parents.shape[-1]

    @property
    def n_leaves(self) -> int:
        return self.n_all - self.n_ancestors

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.parents.shape[:-1]


def balanced_topology(n_leaves: int) -> Topology:
    """Balanced binary tree in the reference's node numbering.

    Node ``j`` (for ``j < n_all - 1``) has parent ``n_leaves + j // 2``;
    equivalently ancestor ``i`` has children ``(2i, 2i+1)``. This reproduces
    both reference constructions (``ground_truth.py:183-191`` and
    ``evals/benchmark.py:781-791``).
    """
    n_anc = n_leaves - 1
    n_all = n_leaves + n_anc
    nodes = np.arange(n_all - 1)
    parents = np.concatenate([n_leaves + nodes // 2, [n_all - 1]]).astype(np.int32)
    anc = np.arange(n_anc)
    children = np.stack([2 * anc, 2 * anc + 1], axis=1).astype(np.int32)
    return Topology(children=jnp.asarray(children), parents=jnp.asarray(parents))


def balanced_adjacency(n_leaves: int, dtype=None) -> jax.Array:
    """Dense adjacency of the balanced tree (A[child, parent] = 1)."""
    return topology_to_adjacency(balanced_topology(n_leaves), dtype=dtype)


@partial(jax.jit, static_argnames=("n_leaves",))
def topology_from_adjacency(adjacency: jax.Array, n_leaves: int) -> Topology:
    """Convert a dense child->parent adjacency matrix into a ``Topology``.

    Accepts the reference's convention (``A[child, parent] = 1``, optional root
    self-loop which is ignored — cf. ``sankoff.py:141``). Children are
    extracted per ancestor column in ascending index order, matching the
    ordering ``jnp.where(..., size=2)`` produces in the reference.
    """
    n_all = adjacency.shape[-1]
    adj = adjacency.astype(jnp.float32)
    # Drop any root self-loop so it is not counted as a child edge.
    adj = adj * (1.0 - jnp.eye(n_all, dtype=adj.dtype))

    idx = jnp.arange(n_all, dtype=jnp.int32)
    # For each ancestor column: indices of set rows, ascending; absent -> n_all.
    anc_cols = adj[:, n_leaves:]  # (n_all, n_anc)
    masked = jnp.where(anc_cols > 0.5, idx[:, None], n_all)  # (n_all, n_anc)
    children = jnp.sort(masked, axis=0)[:2].T.astype(jnp.int32)  # (n_anc, 2)

    has_parent = jnp.any(adj > 0.5, axis=-1)
    parents = jnp.where(has_parent, jnp.argmax(adj, axis=-1), idx).astype(jnp.int32)
    return Topology(children=children, parents=parents)


def topology_to_adjacency(topology: Topology, dtype=None) -> jax.Array:
    """Dense (n_all, n_all) adjacency with A[child, parent] = 1, no root loop."""
    dtype = dtype or default_dtype()
    n_all = topology.n_all
    child = jnp.arange(n_all - 1, dtype=jnp.int32)
    adj = jnp.zeros((n_all, n_all), dtype=dtype)
    return adj.at[child, topology.parents[:-1]].set(1)


def parents_to_topology(parents: jax.Array, n_leaves: int) -> Topology:
    """Build a ``Topology`` from a parent vector (root self-referential).

    jit/vmap-compatible: children of ancestor ``a`` are the (exactly two)
    nodes whose parent is ``a``, in ascending index order.
    """
    n_all = parents.shape[-1]
    idx = jnp.arange(n_all, dtype=jnp.int32)
    anc_ids = jnp.arange(n_leaves, n_all, dtype=jnp.int32)
    # is_child[n, a] — node n (non-root) has parent a.
    is_child = (parents[:, None] == anc_ids[None, :]) & (idx[:, None] != anc_ids[None, :])
    masked = jnp.where(is_child, idx[:, None], n_all)
    children = jnp.sort(masked, axis=0)[:2].T.astype(jnp.int32)
    return Topology(children=children, parents=parents.astype(jnp.int32))


def random_topologies(key: jax.Array, n_leaves: int, batch: int) -> Topology:
    """Sample ``batch`` random rooted binary topologies (host-side, numpy).

    Coalescent-style: repeatedly join two uniformly random active lineages
    under the next fresh ancestor index. Guarantees every ancestor has exactly
    two children with smaller indices, so the index order is topological.

    Intended for candidate-batch generation outside the jit hot loop.
    """
    seeds = np.asarray(jax.random.key_data(key)).ravel()
    rng = np.random.default_rng(int(seeds[-1]))
    n_anc = n_leaves - 1
    n_all = n_leaves + n_anc
    children = np.empty((batch, n_anc, 2), dtype=np.int32)
    parents = np.empty((batch, n_all), dtype=np.int32)
    for b in range(batch):
        active = list(range(n_leaves))
        for a in range(n_anc):
            i, j = rng.choice(len(active), size=2, replace=False)
            c1, c2 = active[i], active[j]
            lo, hi = (c1, c2) if c1 < c2 else (c2, c1)
            node = n_leaves + a
            children[b, a] = (lo, hi)
            parents[b, lo] = node
            parents[b, hi] = node
            # Replace the two joined lineages with the new ancestor.
            active = [x for x in active if x not in (c1, c2)]
            active.append(node)
        parents[b, n_all - 1] = n_all - 1
    return Topology(children=jnp.asarray(children), parents=jnp.asarray(parents))
