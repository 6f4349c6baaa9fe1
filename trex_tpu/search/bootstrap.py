"""Bootstrap analysis: site-resampled scoring and split support.

Classic phylogenetic uncertainty quantification (absent from the reference):

1. Bootstrap replicates resample alignment sites with replacement. Because
   every score in this engine is a *site-sum* (``sankoff_score``/
   ``fitch_score`` already accept a per-site multiplier via ``site_mask``),
   a replicate is just an integer site-weight vector — no data copying, and
   all replicates score in one vmap over the weights axis.
2. Split support: the fraction of replicate best trees containing each
   bipartition (internal edge) of a reference tree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.ops.fitch import fitch_score
from trex_tpu.ops.sankoff import sankoff_score
from trex_tpu.topology import Topology


def bootstrap_site_weights(
    key: jax.Array, length: int, n_replicates: int
) -> jax.Array:
    """(R, L) integer site counts; each row sums to L (multinomial(1/L))."""

    def one(k):
        picks = jax.random.randint(k, (length,), 0, length)
        return jnp.zeros((length,), jnp.int32).at[picks].add(1)

    return jax.vmap(one)(jax.random.split(key, n_replicates))


def bootstrap_scores(
    topology: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    weights: jax.Array,
    use_fitch: bool = True,
) -> jax.Array:
    """(R,) parsimony scores of one topology under R site-weight vectors."""
    if use_fitch:
        fn = lambda w: fitch_score(topology, leaf_sequences, site_mask=w)
    else:
        fn = lambda w: sankoff_score(
            topology, cost_matrix, leaf_sequences, site_mask=w
        )
    return jax.vmap(fn)(weights)


def bootstrap_log_likelihoods(
    topology: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    weights: jax.Array,
) -> jax.Array:
    """(R,) log-likelihoods of one tree under R bootstrap weight vectors.

    Works because the pruning log-likelihood is also a site-sum
    (``tree_log_likelihood``'s ``site_mask`` doubles as weights).
    """
    from trex_tpu.ops.likelihood import tree_log_likelihood

    return jax.vmap(
        lambda w: tree_log_likelihood(
            topology, branch_lengths, leaf_sequences, n_states, site_mask=w
        )
    )(weights)


def subtree_leaf_sets(topology: Topology) -> list[frozenset[int]]:
    """Leaf set (bipartition) below each ancestor, host-side."""
    children = np.asarray(topology.children)
    n_leaves = topology.n_leaves
    sets: dict[int, frozenset[int]] = {i: frozenset([i]) for i in range(n_leaves)}
    for a in range(n_leaves - 1):
        node = n_leaves + a
        sets[node] = sets[int(children[a, 0])] | sets[int(children[a, 1])]
    return [sets[n_leaves + a] for a in range(n_leaves - 1)]


def split_support(
    reference: Topology, replicate_best: list[Topology]
) -> np.ndarray:
    """Per-ancestor support: fraction of replicate trees with the same split.

    The root split (all leaves) is trivially 1. Returns (n_ancestors,) in
    [0, 1], indexed like ``reference.children``.
    """
    ref_splits = subtree_leaf_sets(reference)
    counts = np.zeros(len(ref_splits))
    for topo in replicate_best:
        rep = set(subtree_leaf_sets(topo))
        for i, split in enumerate(ref_splits):
            if split in rep:
                counts[i] += 1
    return counts / max(len(replicate_best), 1)


def _replicate_weights(
    key: jax.Array,
    length: int,
    n_replicates: int,
    site_weights: jax.Array | None,
) -> jax.Array:
    """(R, L) bootstrap site counts; with base weights, resample PATTERN
    occurrences (multinomial proportional to the weights, total preserved)."""
    if site_weights is None:
        return bootstrap_site_weights(key, length, n_replicates)
    base = jnp.asarray(site_weights, jnp.float32)
    total = int(jnp.sum(base))
    probs = base / jnp.sum(base)

    def one(k):
        picks = jax.random.choice(k, length, (total,), p=probs)
        return jnp.zeros((length,), jnp.int32).at[picks].add(1)

    return jax.vmap(one)(jax.random.split(key, n_replicates))


def ml_bootstrap_analysis(
    key: jax.Array,
    reference: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    n_replicates: int = 100,
    search_rounds: int = 10,
    neighborhood: str = "nni",
    ranking_branch_length: float = 0.1,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    mesh=None,
) -> tuple[np.ndarray, list[Topology]]:
    """Bootstrap split support under the likelihood criterion.

    Each replicate reweights sites and hill-climbs from ``reference`` with
    candidates ranked by pruning log-likelihood at a fixed per-branch length
    (the same fast heuristic as ``search.ml.ml_hill_climb``). Support is the
    fraction of replicate optima retaining each reference split.

    ``mesh``: optional ('tree', 'site') ``jax.sharding.Mesh`` — each
    replicate climb's candidate ranking shards candidates over ``tree``
    and sites over ``site`` (one psum of weighted per-site lnL partials,
    ``parallel.sharded.sharded_log_likelihoods``).
    """
    from trex_tpu.search.hillclimb import parsimony_hill_climb

    weights = _replicate_weights(
        key, leaf_sequences.shape[-1], n_replicates, site_weights
    )
    from trex_tpu.ops.likelihood import batched_log_likelihood

    n_all = reference.n_all
    dummy_cost = jnp.zeros((n_states, n_states))
    best: list[Topology] = []
    for r in range(n_replicates):
        w = weights[r].astype(jnp.float32)

        if mesh is not None:
            score_batch = _mesh_ml_score_batch(
                mesh, leaf_sequences, n_states, w, ranking_branch_length,
                sequences_are_masks,
            )
        else:
            def score_batch(topos, cost, leaves):
                batch = topos.children.shape[0]
                blens = jnp.full((batch, n_all), ranking_branch_length)
                return -batched_log_likelihood(
                    topos, blens, leaves, n_states, site_weights=w,
                    sequences_are_masks=sequences_are_masks,
                )

        result = parsimony_hill_climb(
            reference,
            dummy_cost,
            leaf_sequences,
            max_rounds=search_rounds,
            score_batch_fn=score_batch,
            neighborhood=neighborhood,
        )
        best.append(result.topology)
    return split_support(reference, best), best


def _mesh_ml_score_batch(
    mesh, leaf_sequences, n_states, w, ranking_branch_length,
    sequences_are_masks,
):
    """Mesh-sharded ML ranking ``score_batch_fn`` for one replicate.

    Candidates pad to a multiple of the ``tree`` axis (repeat-last, sliced
    back), sites to a multiple of the ``site`` axis with weight-0 columns
    (fully-ambiguous mask / state-0 leaves contribute only weight-0 site
    terms). Mirrors ``search.hillclimb._mesh_score_batch`` for likelihoods.
    """
    from trex_tpu.parallel.mesh import SITE_AXIS, TREE_AXIS
    from trex_tpu.parallel.sharded import sharded_log_likelihoods

    n_tree = mesh.shape[TREE_AXIS]
    n_site = mesh.shape[SITE_AXIS]
    length = leaf_sequences.shape[-1]
    pad_l = -length % n_site
    mesh_leaves = jnp.asarray(leaf_sequences)
    mesh_w = jnp.asarray(w, jnp.float32)
    if pad_l:
        mesh_leaves = jnp.pad(
            mesh_leaves, ((0, 0), (0, pad_l)),
            constant_values=(2 ** n_states - 1) if sequences_are_masks else 0,
        )
        mesh_w = jnp.pad(mesh_w, (0, pad_l))
    n_all_rows = 2 * leaf_sequences.shape[0] - 1

    def score_batch(topos, cost, _leaves):
        b = topos.children.shape[0]
        pad_b = -b % n_tree
        if pad_b:
            topos = jax.tree_util.tree_map(
                lambda x: jnp.concatenate(
                    [x, jnp.broadcast_to(x[-1:], (pad_b,) + x.shape[1:])]
                ),
                topos,
            )
        blens = jnp.full((b + pad_b, n_all_rows), ranking_branch_length)
        return -sharded_log_likelihoods(
            mesh, topos, blens, mesh_leaves, n_states,
            site_weights=mesh_w, sequences_are_masks=sequences_are_masks,
        )[:b]

    return score_batch


def bootstrap_analysis(
    key: jax.Array,
    reference: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    n_replicates: int = 100,
    search_rounds: int = 20,
    neighborhood: str = "nni",
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    mesh=None,
) -> tuple[np.ndarray, list[Topology]]:
    """Bootstrap split support for ``reference``.

    For each replicate, reweight sites and hill-climb from the reference
    tree; support is the fraction of replicate optima retaining each
    reference split.

    ``site_weights``: base pattern multiplicities (compressed alignments) —
    the bootstrap then resamples PATTERN OCCURRENCES: replicate weights are
    multinomial over patterns with probabilities proportional to the base
    weights, total count preserved. ``sequences_are_masks``: leaves are
    int32 state-set bitmasks.

    ``mesh``: optional ('tree', 'site') ``jax.sharding.Mesh`` — each
    replicate climb scores its candidate batches across the mesh
    (``search.hillclimb._mesh_score_batch`` with the replicate's weights),
    bit-identical to single-device (integer parsimony site sums).

    Returns (support (n_ancestors,), replicate best topologies).
    """
    from trex_tpu.search.hillclimb import _mesh_score_batch, parsimony_hill_climb

    from trex_tpu.ops.dispatch import batched_scores_fastest

    weights = _replicate_weights(
        key, leaf_sequences.shape[-1], n_replicates, site_weights
    )
    best: list[Topology] = []
    for r in range(n_replicates):
        w = weights[r].astype(jnp.float32)

        if mesh is not None:
            score_batch = _mesh_score_batch(
                mesh, leaf_sequences, w, sequences_are_masks
            )
        else:
            def score_batch(topos, cost, leaves):
                return batched_scores_fastest(
                    topos, cost_matrix, leaves, w,
                    sequences_are_masks=sequences_are_masks,
                )

        result = parsimony_hill_climb(
            reference,
            cost_matrix,
            leaf_sequences,
            max_rounds=search_rounds,
            score_batch_fn=score_batch,
            neighborhood=neighborhood,
        )
        best.append(result.topology)
    return split_support(reference, best), best
