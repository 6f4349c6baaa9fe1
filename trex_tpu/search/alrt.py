"""Approximate likelihood-ratio branch supports (aLRT / SH-aLRT / RELL).

Fast per-branch confidence for ML trees without full bootstrap re-searches
(the reference has no support machinery at all; `search.bootstrap` provides
the expensive resampled-search kind). For every internal branch the test
compares the inferred resolution against the two nearest-neighbor-interchange
alternatives around that branch — the three possible resolutions of the
induced quartet — using per-site log-likelihood vectors, so the whole
resampling step is one (replicates x patterns) @ (patterns x 3) matmul per
branch batch:

- ``alrt``: the observed statistic 2*(lnL_best - lnL_second) per branch.
- ``sh_alrt``: the SH-like correction in the style of Guindon et al. 2010
  (PhyML): the statistic is compared against RELL replicates of itself
  computed from CENTERED per-site vectors (centering enforces the null that
  all three resolutions explain the data equally well); support = fraction
  of replicates the observed statistic exceeds.
- ``rell``: FastTree-style simple support — the fraction of RELL resamples
  in which the inferred resolution outscores both alternatives (uncentered).

Branch lengths are re-optimized per alternative with damped Newton sweeps
(`ops.likelihood_asr.optimize_branch_lengths_newton`), vmapped over the whole
alternative batch, so the dominant cost is ~2 pruning passes per sweep over a
(2 * internal-branches)-tree batch — the same batched scoring shape as one
hill-climb round.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.ops.likelihood import per_site_log_likelihood
from trex_tpu.ops.likelihood_asr import optimize_branch_lengths_newton
from trex_tpu.search.bootstrap import _replicate_weights, subtree_leaf_sets
from trex_tpu.topology import Topology


@dataclass
class BranchSupports:
    """Per-ancestor support values, indexed like ``topology.children``.

    Entries for trivial branches (root, and ancestors whose quartet has no
    NNI alternative — e.g. cherries attached directly to the root in a
    3-taxon-like configuration) are NaN in ``alrt`` and 1.0 in the support
    fields, matching the convention that unresolvable splits are not tested.
    """

    alrt: np.ndarray        # 2*(lnL_best - lnL_second), NaN where untested
    sh_alrt: np.ndarray     # SH-like support in [0, 1]
    rell: np.ndarray        # plain RELL win fraction in [0, 1]
    log_likelihood: float   # reference tree lnL at its Newton lengths


def _bipartition(split: frozenset[int], n_leaves: int) -> frozenset[int] | None:
    """Canonical unrooted bipartition of a rooted subtree leafset: the side
    NOT containing leaf 0; None for trivial splits (a side of size < 2)."""
    comp = frozenset(range(n_leaves)) - split
    if len(split) < 2 or len(comp) < 2:
        return None
    return split if 0 not in split else comp


def _root_edge_alternatives(
    topology: Topology,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The two quartet resolutions of the UNROOTED edge between the root's
    children. Rooted NNI enumeration only re-roots around this edge (an
    unrooted no-op under reversible models), so the genuine alternatives —
    swapping a grandchild across the root — are synthesized here. Empty when
    a root child is a leaf (the edge's bipartition is then trivial)."""
    from trex_tpu.io.fallback import _canonicalize

    children = np.asarray(topology.children)
    n_leaves = topology.n_leaves
    root = topology.n_all - 1
    a, b = (int(c) for c in children[root - n_leaves])
    if a < n_leaves or b < n_leaves:
        return [], []
    kids = {
        n_leaves + i: [int(children[i, 0]), int(children[i, 1])]
        for i in range(n_leaves - 1)
    }
    x, y = kids[a]
    u, v = kids[b]
    out_children: list[np.ndarray] = []
    out_parents: list[np.ndarray] = []
    for new_a, new_b in (([x, u], [y, v]), ([x, v], [u, y])):
        k2 = dict(kids)
        k2[a] = new_a
        k2[b] = new_b
        ch, par, _ = _canonicalize(n_leaves, k2, root)
        out_children.append(ch)
        out_parents.append(par)
    return out_children, out_parents


def _nni_alternatives_by_edge(
    topology: Topology,
) -> tuple[Topology, list[list[int]]]:
    """All NNI neighbors plus, per ancestor, the neighbor rows whose move
    destroyed that ancestor's UNROOTED bipartition (the two alternative
    resolutions of the branch above it).

    Rooted NNI enumeration also emits moves around the root that merely
    re-root the same unrooted tree (likelihood-invariant under reversible
    models) — those are skipped, and alternatives that resolve to the same
    unrooted topology are deduplicated, so each tested branch compares
    against exactly its distinct quartet resolutions. The root's two
    children share one unrooted edge and get identical entries.
    """
    from trex_tpu.io import nni_neighbors_host

    n_leaves = topology.n_leaves
    children, parents = nni_neighbors_host(topology)
    root_alt_children, root_alt_parents = _root_edge_alternatives(topology)
    if root_alt_children:
        children = np.concatenate([children, np.stack(root_alt_children)])
        parents = np.concatenate([parents, np.stack(root_alt_parents)])
    ref_biparts = [
        _bipartition(s, n_leaves) for s in subtree_leaf_sets(topology)
    ]
    ref_set = {b for b in ref_biparts if b is not None}
    n_anc = topology.n_ancestors
    by_edge: list[list[int]] = [[] for _ in range(n_anc)]
    seen_per_edge: list[set[frozenset]] = [set() for _ in range(n_anc)]
    for m in range(children.shape[0]):
        neigh = Topology(
            children=jnp.asarray(children[m]), parents=jnp.asarray(parents[m])
        )
        neigh_set = {
            b
            for s in subtree_leaf_sets(neigh)
            if (b := _bipartition(s, n_leaves)) is not None
        }
        if neigh_set == ref_set:
            continue  # re-rooting of the same unrooted tree
        missing = ref_set - neigh_set
        signature = frozenset(neigh_set)
        for i, bipart in enumerate(ref_biparts):
            if bipart is not None and bipart in missing:
                if signature not in seen_per_edge[i]:
                    seen_per_edge[i].add(signature)
                    by_edge[i].append(m)
    batch = Topology(
        children=jnp.asarray(children), parents=jnp.asarray(parents)
    )
    return batch, by_edge


def branch_supports(
    key: jax.Array,
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    n_replicates: int = 1000,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    mesh=None,
) -> BranchSupports:
    """aLRT / SH-aLRT / RELL supports for every internal branch.

    Args:
        leaf_sequences: (n_leaves, L) states (or masks) — compressed site
            patterns with ``site_weights`` are exact, as everywhere else.
        n_replicates: RELL resamples for the SH correction and win fractions.
        mesh: optional ('tree', 'site') ``jax.sharding.Mesh`` — the
            per-alternative Newton + per-site-lnL pass (the dominant cost)
            shards its candidate axis over ``tree``
            (``parallel.sharded.sharded_per_site_matrix``), bit-identical
            to the single-device map.

    Returns:
        ``BranchSupports`` with arrays indexed like ``topology.children``.
    """
    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    leaf = jnp.asarray(leaf_sequences)

    def newton_and_persite(topo):
        lengths, _ = optimize_branch_lengths_newton(
            topo, leaf, n_states, rates, freqs, weights,
            sequences_are_masks=sequences_are_masks, n_sweeps=n_sweeps,
        )
        per_site = per_site_log_likelihood(
            topo, lengths, leaf, n_states, rates, freqs,
            sequences_are_masks=sequences_are_masks,
        )
        return per_site

    ref_per_site = newton_and_persite(topology)  # (P,)
    ref_ll = float(jnp.sum(ref_per_site * weights))

    neighbors, by_edge = _nni_alternatives_by_edge(topology)
    # Score only the rows some edge actually tests (re-rootings and
    # duplicates were dropped from by_edge).
    used = sorted({m for rows in by_edge for m in rows})
    remap = {m: i for i, m in enumerate(used)}
    by_edge = [[remap[m] for m in rows] for rows in by_edge]
    idx = jnp.asarray(used, jnp.int32)
    neighbors = Topology(
        children=neighbors.children[idx], parents=neighbors.parents[idx]
    )
    n_neigh = neighbors.children.shape[0]
    n_anc = topology.n_ancestors
    alrt = np.full((n_anc,), np.nan)
    sh = np.ones((n_anc,))
    rell = np.ones((n_anc,))
    if n_neigh == 0:
        return BranchSupports(alrt, sh, rell, ref_ll)

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_per_site_matrix

        neigh_per_site = sharded_per_site_matrix(
            mesh, neighbors, leaf, n_states, rates=rates, freqs=freqs,
            weights=weights, n_sweeps=n_sweeps,
            sequences_are_masks=sequences_are_masks,
        )  # (M, P)
    else:
        neigh_per_site = jax.lax.map(
            newton_and_persite, neighbors, batch_size=64
        )  # (M, P)

    # RELL resamples, shared across branches: (R, P) counts.
    rep_w = _replicate_weights(
        key, int(weights.shape[0]), n_replicates, weights
    ).astype(jnp.float32)

    ref_rep = rep_w @ ref_per_site  # (R,)
    neigh_rep = rep_w @ jnp.transpose(neigh_per_site)  # (R, M)
    neigh_obs = neigh_per_site @ weights  # (M,)

    ref_rep_np = np.asarray(ref_rep, np.float64)
    neigh_rep_np = np.asarray(neigh_rep, np.float64)
    neigh_obs_np = np.asarray(neigh_obs, np.float64)

    for i, rows in enumerate(by_edge):
        if not rows:
            continue  # untested branch (no NNI perturbs this split)
        obs = np.concatenate([[ref_ll], neigh_obs_np[rows]])  # (K,)
        order = np.argsort(obs)[::-1]
        delta_obs = 2.0 * (obs[order[0]] - obs[order[1]])
        alrt[i] = delta_obs if order[0] == 0 else -delta_obs
        reps = np.concatenate(
            [ref_rep_np[:, None], neigh_rep_np[:, rows]], axis=1
        )  # (R, K)
        if order[0] != 0:
            # An alternative beats the inferred resolution: no support.
            sh[i] = 0.0
            rell[i] = float(np.mean(reps.argmax(axis=1) == 0))
            continue
        # SH-like: center each configuration at its observed value, compare
        # the observed statistic to the replicate null statistic.
        centered = reps - obs[None, :]
        part = np.partition(centered, centered.shape[1] - 2, axis=1)
        delta_null = 2.0 * (part[:, -1] - part[:, -2])
        sh[i] = float(np.mean(delta_obs > delta_null))
        rell[i] = float(np.mean(reps.argmax(axis=1) == 0))
    return BranchSupports(alrt, sh, rell, ref_ll)
