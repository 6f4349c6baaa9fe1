"""Ultrafast bootstrap approximation (RELL over a candidate tree set).

Full bootstrap support (`search.bootstrap`) re-runs the tree search once per
replicate — exact but expensive. The ultrafast approximation (in the spirit
of IQ-TREE's UFBoot) never re-searches: it collects a candidate set of
plausible topologies around the ML tree, computes each candidate's per-site
log-likelihood vector ONCE (branch lengths Newton-optimized per candidate),
and then scores every (replicate, candidate) pair by RELL — one
(replicates x patterns) @ (patterns x candidates) matmul. Each
replicate's winning topology votes for the splits it contains; a branch's
support is the fraction of replicates whose winner retains that split.

The reference has no support machinery at all (SURVEY.md §5); this is new
capability: the per-candidate work is one batched Newton pass
(`jax.lax.map` over the candidate batch) and the resampling is a single
matmul, so 1000 replicates cost barely more than 100.
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
class UFBootResult:
    """Split supports for the reference tree from RELL replicate winners.

    ``support`` is indexed like ``topology.children`` (per ancestor); the
    root's entry and other trivial splits are 1.0 by convention.
    """

    support: np.ndarray         # (n_ancestors,) in [0, 1]
    n_candidates: int           # deduplicated candidate count
    winner_counts: np.ndarray   # (n_candidates,) replicates won
    log_likelihoods: np.ndarray  # (n_candidates,) observed lnL per candidate
    reference_index: int        # row of the reference tree in the candidates


def _unrooted_bipartitions(topo: Topology) -> set[frozenset[int]]:
    """Nontrivial unrooted splits, normalized to the side without leaf 0."""
    n_leaves = topo.n_leaves
    every = frozenset(range(n_leaves))
    out = set()
    for clade in subtree_leaf_sets(topo):
        side = every - clade if 0 in clade else clade
        if 1 < len(side) < n_leaves - 1:
            out.add(side)
    return out


def default_candidates(
    topology: Topology, *, extra_tbr: int = 64, seed: int = 0
) -> Topology:
    """Reference + full NNI neighborhood + a seeded TBR sample (if native).

    The candidate set determines what alternatives the replicates may vote
    for; NNI covers every single-branch rearrangement, the TBR sample adds
    more distant credible trees cheaply.
    """
    from trex_tpu.io import nni_neighbors_host, tbr_neighborhood_host

    children = [np.asarray(topology.children)[None]]
    parents = [np.asarray(topology.parents)[None]]
    nc, npar = nni_neighbors_host(topology)
    if nc.shape[0]:
        children.append(nc)
        parents.append(npar)
    if extra_tbr > 0:
        tc, tp = tbr_neighborhood_host(
            topology, max_trees=extra_tbr, seed=seed
        )
        if tc.shape[0]:
            children.append(tc.copy())
            parents.append(tp.copy())
    all_children = np.concatenate(children)
    all_parents = np.concatenate(parents)
    # Dedup by UNROOTED topology: rooted NNI/TBR enumeration emits
    # re-rootings of the same unrooted tree, which are likelihood-identical
    # under reversible models and would split a replicate's vote across
    # numerically-tied rows.
    seen: set[frozenset] = set()
    keep = []
    for i in range(all_children.shape[0]):
        topo_i = Topology(
            children=jnp.asarray(all_children[i]),
            parents=jnp.asarray(all_parents[i]),
        )
        sig = frozenset(_unrooted_bipartitions(topo_i))
        if sig not in seen:
            seen.add(sig)
            keep.append(i)
    keep_idx = np.asarray(keep)
    return Topology(
        children=jnp.asarray(all_children[keep_idx]),
        parents=jnp.asarray(all_parents[keep_idx]),
    )


def ultrafast_bootstrap(
    key: jax.Array,
    topology: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    candidates: Topology | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    site_weights: jax.Array | None = None,
    n_replicates: int = 1000,
    n_sweeps: int = 8,
    extra_tbr: int = 64,
    sequences_are_masks: bool = False,
    mesh=None,
) -> UFBootResult:
    """RELL ultrafast bootstrap supports for ``topology``'s internal branches.

    Args:
        candidates: batched Topology of candidate trees (the reference is
            added if absent). Default: ``default_candidates`` — reference +
            NNI neighborhood + ``extra_tbr`` sampled TBR trees.
        site_weights: per-site multiplicities (compressed patterns); the
            replicate resampler draws sites with these weights, so pattern
            compression is exact here too.
        mesh: optional ('tree', 'site') ``jax.sharding.Mesh`` — the
            per-candidate Newton + per-site-lnL pass (the expensive part)
            shards its candidate axis over the mesh's ``tree`` axis
            (``parallel.sharded.sharded_per_site_matrix``), bit-identical
            to the single-device map (tests/test_sharding.py).

    Returns:
        ``UFBootResult``; ``support[i]`` is the fraction of replicates whose
        winning candidate contains the unrooted split below ancestor ``i``.
    """
    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    leaf = jnp.asarray(leaf_sequences)

    if candidates is None:
        seeds = np.asarray(jax.random.key_data(key)).ravel()
        candidates = default_candidates(
            topology, extra_tbr=extra_tbr, seed=int(seeds[-1])
        )
    cand_children = np.asarray(candidates.children)
    ref_key = np.asarray(topology.children).tobytes()
    ref_idx = next(
        (
            i
            for i in range(cand_children.shape[0])
            if cand_children[i].tobytes() == ref_key
        ),
        None,
    )
    if ref_idx is None:
        candidates = Topology(
            children=jnp.concatenate(
                [jnp.asarray(topology.children)[None], candidates.children]
            ),
            parents=jnp.concatenate(
                [jnp.asarray(topology.parents)[None], candidates.parents]
            ),
        )
        cand_children = np.asarray(candidates.children)
        ref_idx = 0
    n_cand = cand_children.shape[0]

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_per_site_matrix

        per_site = sharded_per_site_matrix(
            mesh, candidates, leaf, n_states, rates=rates, freqs=freqs,
            weights=weights, n_sweeps=n_sweeps,
            sequences_are_masks=sequences_are_masks,
        )  # (M, P)
    else:
        def newton_and_persite(topo):
            lengths, _ = optimize_branch_lengths_newton(
                topo, leaf, n_states, rates, freqs, weights,
                sequences_are_masks=sequences_are_masks, n_sweeps=n_sweeps,
            )
            return per_site_log_likelihood(
                topo, lengths, leaf, n_states, rates, freqs,
                sequences_are_masks=sequences_are_masks,
            )

        per_site = jax.lax.map(
            newton_and_persite, candidates, batch_size=64
        )  # (M, P)
    obs_ll = np.asarray(per_site @ weights, np.float64)  # (M,)

    rep_w = _replicate_weights(
        key, int(weights.shape[0]), n_replicates, weights
    ).astype(jnp.float32)  # (R, P)
    rell = rep_w @ jnp.transpose(per_site)  # (R, M) — one matmul
    winners = np.asarray(jnp.argmax(rell, axis=1))  # (R,)
    winner_counts = np.bincount(winners, minlength=n_cand)

    # Split membership: does candidate m contain reference split i?
    n_leaves = topology.n_leaves
    every = frozenset(range(n_leaves))
    ref_splits = []  # aligned with ancestors (children rows)
    for clade in subtree_leaf_sets(topology):
        side = every - clade if 0 in clade else clade
        ref_splits.append(side if 1 < len(side) < n_leaves - 1 else None)
    contains = np.ones((n_cand, topology.n_ancestors), dtype=np.float64)
    for m in range(n_cand):
        cand = Topology(
            children=candidates.children[m], parents=candidates.parents[m]
        )
        cand_splits = _unrooted_bipartitions(cand)
        for i, split in enumerate(ref_splits):
            if split is not None:
                contains[m, i] = 1.0 if split in cand_splits else 0.0
    support = (
        winner_counts[:, None] * contains
    ).sum(axis=0) / max(int(winners.shape[0]), 1)
    return UFBootResult(
        support=support,
        n_candidates=n_cand,
        winner_counts=winner_counts,
        log_likelihoods=obs_ll,
        reference_index=int(ref_idx),
    )
