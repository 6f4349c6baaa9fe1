"""Device-side tree rearrangements: jit/vmap-safe NNI proposal machinery.

The host move library (``trex_tpu.io``: native C++ + Python fallbacks)
enumerates rearrangements one tree at a time and re-canonicalizes through
Python dicts — perfect for the discrete searchers, but a hard wall for MCMC:
every generation would pay blocking host<->device round trips, bounding
the sampler far below its own compute rate.

This module re-states NNI as pure tensor ops so an entire Metropolis
generation (proposal construction included) can live inside one ``lax.scan``:

- an NNI at internal edge ``(parent(M), M)`` is a *pointer swap*: the sibling
  subtree and one grandchild subtree exchange parents. No other node's
  subtree changes, so branch lengths carry across the move BY INDEX — the
  clade-identity carry the host sampler implements with hash tables
  (``search/mcmc.py:carry_lengths_nni``) is the identity map here, exactly
  and by construction (the one changed clade keeps its slot, inheriting the
  one leftover length).
- the swap can break the engine's topological-index invariant (children
  must have smaller indices than their parent — ``topology.py:16-23``), so
  each neighbor is renumbered on device: node heights via a fixed-point
  gather/max loop, then one stable ``argsort`` (heights strictly increase
  from child to parent, so height-then-old-index order is topological and
  the root — strict maximum — stays last).

The resulting numbering is a valid topological order but NOT the structure-
determined canonical numbering the host library produces; likelihoods are
invariant under renumbering, and samplers canonicalize emitted samples on
host (``io.fallback._canonicalize``) before summarizing.

The reference has no tree-move machinery at all (its only topology object is
a dense relaxed adjacency, ``/root/reference/src/trex/tree.py:50-107``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def parents_from_children(children: jax.Array, n_leaves: int) -> jax.Array:
    """(n_all,) parent index per node (root self-referential), from children."""
    n_anc = children.shape[-2]
    n_all = n_leaves + n_anc
    anc_ids = jnp.arange(n_leaves, n_all, dtype=jnp.int32)
    parents = jnp.zeros((n_all,), jnp.int32)
    parents = parents.at[children[:, 0]].set(anc_ids)
    parents = parents.at[children[:, 1]].set(anc_ids)
    return parents.at[n_all - 1].set(n_all - 1)


def renumber_topological(
    children: jax.Array, n_leaves: int
) -> tuple[jax.Array, jax.Array]:
    """Renumber ancestors of a valid rooted binary tree topologically.

    Accepts ``children`` (n_anc, 2) whose ancestor numbering may violate the
    child<parent invariant (e.g. after a pointer-swap NNI); the tree itself
    must be a valid rooted binary tree with the root at the LAST index.

    Returns ``(new_children, order)`` where ``order[j]`` is the old ancestor
    offset placed at new offset ``j`` (so per-node payloads follow via
    ``new_payload = payload[n_leaves + order]``). Child pairs are emitted in
    ascending order (the engine convention).
    """
    n_anc = children.shape[0]
    n_all = n_leaves + n_anc
    lev = jnp.zeros((n_all,), jnp.int32)

    def body(_, lev):
        la = 1 + jnp.maximum(lev[children[:, 0]], lev[children[:, 1]])
        return lev.at[n_leaves:].set(la)

    # Heights converge in <= tree height <= n_anc sweeps.
    lev = jax.lax.fori_loop(0, n_anc, body, lev)
    order = jnp.argsort(lev[n_leaves:], stable=True).astype(jnp.int32)
    inv = jnp.zeros((n_anc,), jnp.int32).at[order].set(
        jnp.arange(n_anc, dtype=jnp.int32)
    )
    node_map = jnp.concatenate(
        [jnp.arange(n_leaves, dtype=jnp.int32), n_leaves + inv]
    )
    new_children = jnp.sort(node_map[children[order]], axis=-1)
    return new_children, order


def _nni_apply(
    children: jax.Array,
    lengths: jax.Array,
    parents: jax.Array,
    edge: jax.Array,
    variant: jax.Array,
    n_leaves: int,
) -> tuple[jax.Array, jax.Array]:
    """Pointer-swap NNI + O(1)-depth renumber (precomputed ``parents``).

    After the swap on an INDEX-ORDERED tree the only possible violation is
    the edge (c, s) where c = n_leaves + edge and s is c's old sibling with
    s > c: every other parent/child relation is unchanged. A cyclic shift of
    the ancestor slots [c .. s] (c moves to s's slot, everything between
    drops one) restores topological order:

    - nodes u in (c, s] move to u-1 >= c; their children are either < c
      (unchanged position < u-1), in (c, s) (also shifted down), or == c —
      impossible, since c's only parent is p > s;
    - c at slot s has children s (now at s-1) and b < c <= s-1;
    - nodes > s (including p, since s < p always) keep their slots, and
      their shifted children only move down.

    No fixed-point loop, no sort — the construction is O(n) gathers with
    constant sequential depth, which is what lets a whole Metropolis
    neighborhood build run inside a generation ``lax.scan`` at microsecond
    cost (a height-propagation loop here would cost more than the
    likelihood evaluation it feeds).
    """
    n_anc = children.shape[0]
    m_node = n_leaves + edge
    p_off = parents[m_node] - n_leaves
    sib = jnp.where(
        children[p_off, 0] == m_node, children[p_off, 1], children[p_off, 0]
    )
    a = children[edge, 0]
    b = children[edge, 1]
    grand = jnp.where(variant == 0, a, b)
    kept = jnp.where(variant == 0, b, a)
    swapped = children.at[p_off].set(jnp.stack([m_node, grand]))
    swapped = swapped.at[edge].set(jnp.stack([sib, kept]))
    # Cyclic-shift renumber over ancestor offsets [oc, os]; identity when
    # the sibling is a leaf or already below c (os == oc).
    oc = edge
    os_ = jnp.where(sib - n_leaves > edge, sib - n_leaves, edge)
    j = jnp.arange(n_anc, dtype=jnp.int32)
    order = jnp.where(
        j == os_, oc, jnp.where((j >= oc) & (j < os_), j + 1, j)
    )
    inv = jnp.where(
        j == oc, os_, jnp.where((j > oc) & (j <= os_), j - 1, j)
    )
    node_map = jnp.concatenate(
        [jnp.arange(n_leaves, dtype=jnp.int32), n_leaves + inv]
    )
    new_children = jnp.sort(node_map[swapped[order]], axis=-1)
    new_lengths = jnp.concatenate(
        [lengths[:n_leaves], lengths[n_leaves + order]]
    )
    return new_children, new_lengths


@partial(jax.jit, static_argnames=("n_leaves",))
def nni_neighbor_device(
    children: jax.Array,
    lengths: jax.Array,
    edge: jax.Array,
    variant: jax.Array,
    n_leaves: int,
) -> tuple[jax.Array, jax.Array]:
    """One NNI neighbor (children', lengths'), fully on device.

    ``edge`` indexes the non-root ancestor M = n_leaves + edge (the lower
    node of the internal edge being rearranged); ``variant`` in {0, 1} picks
    which of M's children swaps places with M's sibling. Both may be traced
    values — the whole construction is gathers/scatters of constant
    sequential depth (see ``_nni_apply``).

    Matches the host enumerator's move set exactly
    (``io/fallback.py:py_nni_neighbors``): the 2*(n_leaves - 2) pairs
    (edge, variant) produce the same multiset of topologies.
    """
    parents = parents_from_children(children, n_leaves)
    return _nni_apply(children, lengths, parents, edge, variant, n_leaves)


@partial(jax.jit, static_argnames=("n_leaves",))
def nni_neighborhood_device(
    children: jax.Array, lengths: jax.Array, n_leaves: int
) -> tuple[jax.Array, jax.Array]:
    """All 2*(n_leaves - 2) NNI neighbors of one tree, on device.

    Returns ``(children (K, n_anc, 2), lengths (K, n_all))`` with K =
    2*(n_leaves - 2); neighbor 2*e + v is ``nni_neighbor_device(..., e, v)``.
    The parent array is computed once and shared across the whole
    neighborhood. vmap over a chain batch for the MCMC's informed proposal.
    """
    n_anc = children.shape[0]
    parents = parents_from_children(children, n_leaves)
    edges = jnp.repeat(jnp.arange(n_anc - 1, dtype=jnp.int32), 2)
    variants = jnp.tile(jnp.arange(2, dtype=jnp.int32), n_anc - 1)
    return jax.vmap(
        lambda e, v: _nni_apply(children, lengths, parents, e, v, n_leaves)
    )(edges, variants)
