"""Parsimony ratchet and tree-distance utilities.

The ratchet (Nixon 1999) is the standard escape mechanism for large
parsimony searches: alternate hill climbing on *reweighted* data (a random
subset of sites upweighted, distorting the landscape) with climbing on the
original data, keeping the overall best. Builds entirely on the engine's
weighted scoring (``site_mask``) and SPR/NNI climbing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.search.bootstrap import subtree_leaf_sets
from trex_tpu.search.hillclimb import SearchResult, parsimony_hill_climb
from trex_tpu.topology import Topology


def robinson_foulds(a: Topology, b: Topology) -> int:
    """Rooted RF distance: clades present in exactly one tree."""
    sa = set(subtree_leaf_sets(a))
    sb = set(subtree_leaf_sets(b))
    return len(sa ^ sb)


def unrooted_splits(topology: Topology) -> set[frozenset[int]]:
    """Canonical nontrivial bipartitions, root placement ignored.

    Each clade is normalized to whichever side of the split excludes leaf 0;
    trivial splits (single leaf / all-but-root) are dropped. Two rootings of
    the same unrooted tree yield identical sets.
    """
    n_leaves = topology.n_leaves
    all_leaves = frozenset(range(n_leaves))
    out = set()
    for clade in subtree_leaf_sets(topology):
        side = all_leaves - clade if 0 in clade else clade
        if 1 < len(side) < n_leaves - 1:
            out.add(side)
    return out


def rf_distance_unrooted(a: Topology, b: Topology) -> int:
    """Robinson-Foulds distance on unrooted splits (root-invariant)."""
    return len(unrooted_splits(a) ^ unrooted_splits(b))


def parsimony_ratchet(
    key: jax.Array,
    start: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    *,
    n_iterations: int = 10,
    perturb_fraction: float = 0.25,
    perturb_weight: float = 3.0,
    climb_rounds: int = 30,
    neighborhood: str = "spr",
    progress_dir: str | None = None,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    mesh=None,
) -> SearchResult:
    """Run the parsimony ratchet from ``start``.

    ``mesh``: optional ('tree', 'site') ``jax.sharding.Mesh``; every climb
    (perturbed and true) scores across the whole mesh — see
    ``parsimony_hill_climb``.

    Each iteration: (1) upweight a random ``perturb_fraction`` of sites by
    ``perturb_weight`` and hill climb under the distorted objective;
    (2) re-climb under the true objective from wherever that landed;
    (3) keep the best true-score tree seen.

    ``progress_dir``: when set, the best tree so far (newick) and the score
    trace (JSON lines) are written after every iteration, so long runs
    survive interruption with their best result on disk.

    ``site_weights``: base per-site multiplicities (compressed patterns);
    the ratchet's perturbation multiplies them. ``sequences_are_masks``:
    leaves are int32 state-set bitmasks (IUPAC ambiguity / gaps). All
    scoring goes through the fastest dispatch (``ops.dispatch``).

    Returns the best ``SearchResult`` (trace = best true score per iteration).
    """
    import json
    import os

    from trex_tpu.ops.dispatch import batched_scores_fastest

    def dump_progress(iteration: int) -> None:
        if progress_dir is None:
            return
        from trex_tpu.io import save_newick

        os.makedirs(progress_dir, exist_ok=True)
        with open(os.path.join(progress_dir, "best.nwk"), "w") as fh:
            fh.write(save_newick(best_topo) + "\n")
        with open(os.path.join(progress_dir, "trace.jsonl"), "a") as fh:
            fh.write(
                json.dumps(
                    {"iteration": iteration, "best_score": best_score,
                     "evaluations": evaluations}
                )
                + "\n"
            )
    length = leaf_sequences.shape[-1]
    base_weights = (
        jnp.ones((length,), jnp.float32)
        if site_weights is None
        else site_weights.astype(jnp.float32)
    )

    scan = neighborhood == "spr-scan"

    def scores_with(w):
        if scan:
            return None  # spr-scan takes weights directly
        if mesh is not None:
            from trex_tpu.search.hillclimb import _mesh_score_batch

            return _mesh_score_batch(
                mesh, leaf_sequences, w, sequences_are_masks
            )

        def fn(topos, cost, leaves):
            return batched_scores_fastest(
                topos, cost, leaves, site_weights=w,
                sequences_are_masks=sequences_are_masks,
            )

        return fn

    def climb(topo, w, score_fn):
        return parsimony_hill_climb(
            topo,
            cost_matrix,
            leaf_sequences,
            max_rounds=climb_rounds,
            score_batch_fn=score_fn,
            neighborhood=neighborhood,
            site_weights=w if scan else None,
            sequences_are_masks=sequences_are_masks if scan else False,
            mesh=mesh if scan else None,
        )

    true_scores = scores_with(base_weights)

    current = start
    best_result = climb(current, base_weights, true_scores)
    current = best_result.topology
    best_topo, best_score = best_result.topology, best_result.score
    trace = [best_score]
    evaluations = best_result.evaluations
    dump_progress(0)

    for i in range(n_iterations):
        key, perturb_key = jax.random.split(key)
        upweighted = jax.random.bernoulli(
            perturb_key, perturb_fraction, (length,)
        )
        weights = base_weights * jnp.where(upweighted, perturb_weight, 1.0)
        weighted_scores = scores_with(weights)

        perturbed = climb(current, weights, weighted_scores)
        evaluations += perturbed.evaluations
        reclimbed = climb(perturbed.topology, base_weights, true_scores)
        evaluations += reclimbed.evaluations
        current = reclimbed.topology
        if reclimbed.score < best_score:
            best_topo, best_score = reclimbed.topology, reclimbed.score
        trace.append(best_score)
        dump_progress(i + 1)

    return SearchResult(
        topology=best_topo,
        score=best_score,
        rounds=n_iterations,
        evaluations=evaluations,
        trace=trace,
    )
