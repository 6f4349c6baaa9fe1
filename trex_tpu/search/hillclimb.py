"""Discrete parsimony tree search: NNI hill climbing over batched scoring.

The reference only searches topology space through the Gumbel-softmax
relaxation; production parsimony engines also need *discrete* search. This
driver alternates:

  host   — enumerate the NNI neighborhood of the incumbent (native C++,
           ``trex_tpu.io.nni_neighbors``), optionally plus random SPR kicks;
  device — score the whole neighborhood as ONE batched Sankoff call (the
           vmapped/Pallas hot path).

Each round is one fused batch on the accelerator, so the accelerator cost is
~(neighborhood size / candidate throughput), and the host cost is O(n^2)
pointer work per round.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.topology import Topology


@dataclasses.dataclass
class SearchResult:
    topology: Topology
    score: float
    rounds: int
    evaluations: int
    trace: list[float]


def constraint_mask(
    required_splits: list[frozenset[int]],
    n_leaves: int,
    constraint_taxa: frozenset[int] | None = None,
):
    """Vectorized candidate filter for constrained search (IQ-TREE -g).

    Returns ``fn(children_batch (B, n_anc, 2)) -> (B,) bool`` that is True
    where the candidate's induced subtree on ``constraint_taxa`` contains
    every required split (the split or its within-taxa complement as a
    restricted clade). Restriction is free: taxa OUTSIDE the constraint
    set get salt 0, so each candidate clade hashes to the hash of its
    restriction. Membership uses the additive uint64 clade hashes from the
    MCMC carry machinery (collision probability ~ B n / 2^64).
    """
    from trex_tpu.search.mcmc import _clade_hash_batch

    if constraint_taxa is None:
        constraint_taxa = frozenset(range(n_leaves))
    rng = np.random.default_rng(0xC0FFEE)
    salt = rng.integers(1, 2**62, size=n_leaves, dtype=np.uint64) * 2 + 1
    mask = np.zeros(n_leaves, bool)
    mask[sorted(constraint_taxa)] = True
    salt = np.where(mask, salt, np.uint64(0))
    total = salt.sum(dtype=np.uint64)
    wanted = []
    for s in required_splits:
        if not s <= constraint_taxa:
            raise ValueError("required split not within constraint_taxa")
        h = salt[sorted(s)].sum(dtype=np.uint64)
        # Complement hash with explicit mod-2^64 wraparound (numpy warns on
        # unsigned scalar overflow even though it is the intended algebra).
        comp = np.uint64((int(total) - int(h)) % (1 << 64))
        wanted.append((h, comp))
    if not wanted:
        return lambda children_batch: np.ones(
            np.asarray(children_batch).shape[0], bool
        )

    def check(children_batch: np.ndarray) -> np.ndarray:
        children_batch = np.asarray(children_batch)
        anc = _clade_hash_batch(children_batch, n_leaves, salt)[:, n_leaves:]
        ok = np.ones(children_batch.shape[0], bool)
        for h, comp in wanted:
            ok &= (anc == h).any(axis=1) | (anc == comp).any(axis=1)
        return ok

    return check


def constrained_start(
    constraint: Topology,
    constraint_leaf_ids: list[int],
    n_leaves: int,
    seed: int = 0,
) -> Topology:
    """A full-taxa starting topology containing a (partial) constraint.

    Begins with the constraint tree (its leaf ``i`` is global taxon
    ``constraint_leaf_ids[i]``) and grafts every remaining taxon onto a
    uniformly random edge — inserting a NEW leaf never changes the induced
    subtree on the constraint taxa, so the result always satisfies the
    constraint. Feed to ``parsimony_hill_climb``/``ml_hill_climb`` with
    ``constraint_splits`` for the constrained refinement.
    """
    from trex_tpu.io.fallback import _canonicalize

    rng = np.random.default_rng(seed)
    c_children = np.asarray(constraint.children)
    k = constraint.n_leaves
    # Engine node ids: globals for leaves, fresh ids for internals.
    next_id = n_leaves
    node_of = {i: constraint_leaf_ids[i] for i in range(k)}
    kids: dict[int, list[int]] = {}
    for a in range(k - 1):
        node_of[k + a] = next_id
        next_id += 1
    for a in range(k - 1):
        kids[node_of[k + a]] = [
            node_of[int(c_children[a, 0])], node_of[int(c_children[a, 1])]
        ]
    root = node_of[2 * k - 2]
    remaining = sorted(set(range(n_leaves)) - set(constraint_leaf_ids))
    edges = [
        (parent, child) for parent, cs in kids.items() for child in cs
    ]
    for taxon in remaining:
        parent, child = edges[rng.integers(len(edges))]
        joint = next_id
        next_id += 1
        kids[parent][kids[parent].index(child)] = joint
        kids[joint] = [child, taxon]
        edges.append((joint, child))
        edges.append((joint, taxon))
        edges[edges.index((parent, child))] = (parent, joint)
    ch, par, _ = _canonicalize(n_leaves, kids, root)
    import jax.numpy as _jnp

    return Topology(children=_jnp.asarray(ch), parents=_jnp.asarray(par))


def parsimony_hill_climb(
    start: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    *,
    max_rounds: int = 100,
    score_batch_fn=None,
    random_kicks: int = 0,
    key: jax.Array | None = None,
    neighborhood: str = "nni",
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    tbr_budget: int = 16384,
    constraint_splits: list[frozenset[int]] | None = None,
    constraint_taxa: frozenset[int] | None = None,
    scan_budget_bytes: int = 2 << 30,
    mesh=None,
) -> SearchResult:
    """Greedy hill climb from ``start``; stops at a local optimum.

    Args:
        score_batch_fn: ``(Topology batch, cost, leaves) -> (B,) scores``;
            defaults to the fastest backend (``ops.dispatch``). Contract: may
            read ``children`` (and shapes) but NOT ``parents`` values — the
            candidate batch carries a broadcast parents placeholder to halve
            host->device transfer (every built-in scorer qualifies; the DP
            consumes child index pairs only).
        mesh: optional ``jax.sharding.Mesh`` with ('tree', 'site') axes
            (``parallel.mesh.make_mesh``): candidate scoring runs across
            the whole mesh instead of one device. Enumerating
            neighborhoods shard the candidate batch over ``tree`` and the
            site axis over ``site`` (``parallel.sharded.sharded_batch_scores``;
            scores bit-identical — parsimony site sums are integer-valued,
            so the psum reorder is exact); "spr-scan" shards the scan's
            PRUNE axis over ``tree`` (``sharded_spr_scan``), dividing the
            per-device scan working set by the tree-axis size — the memory
            lever at large taxon counts. Ignored when a custom
            ``score_batch_fn`` is given (the custom scorer owns its
            devices).
        random_kicks: extra random SPR moves added to each neighborhood
            (cheap diversification; 0 = none).
        key: PRNG key, only needed when ``random_kicks > 0``.
        neighborhood: "nni" (2(n-2) moves/round), "spr" (O(n^2)
            moves/round, stronger optima, needs the native library),
            "spr-scan" (the same SPR neighborhood evaluated analytically by
            ``ops.spr_scan`` — one up/down pass per round instead of O(n^2)
            candidate DPs; unit-cost only, incompatible with a custom
            ``score_batch_fn``; ``site_weights``/``sequences_are_masks``
            apply), or "tbr" (the O(n^3) TBR set — SPR plus re-rooted
            regrafts — sampled to ``tbr_budget`` candidates/round with a
            per-round seed; the strongest and most expensive neighborhood).
        tbr_budget: candidate cap per TBR round (seeded unbiased sample of
            the full set when it exceeds the budget).
        constraint_splits: splits (leaf-index frozensets) the induced
            subtree on ``constraint_taxa`` (default: all leaves) of every
            visited topology must contain — IQ-TREE ``-g``-style
            constrained search; candidates violating any are dropped
            before scoring. ``start`` must satisfy them (build one with
            ``constrained_start``). Not supported with "spr-scan" (the
            analytic scan has no per-move filter).

    Returns:
        ``SearchResult`` with the best topology found and the score trace.
    """
    from trex_tpu.io import (
        nni_neighbors_host,
        spr_move_host,
        spr_neighborhood_host,
        tbr_move_host,
        tbr_neighborhood_host,
    )
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.padding import next_bucket

    check_constraint = None
    if constraint_splits:
        if neighborhood == "spr-scan":
            raise ValueError(
                "constrained search is not supported with spr-scan "
                "(use neighborhood='spr')"
            )
        check_constraint = constraint_mask(
            constraint_splits, start.n_leaves, constraint_taxa
        )
        if not check_constraint(np.asarray(start.children)[None])[0]:
            raise ValueError(
                "the starting topology violates the constraint splits"
            )

    if neighborhood == "spr-scan":
        if score_batch_fn is not None:
            raise ValueError(
                "spr-scan evaluates candidates analytically; custom "
                "score_batch_fn is not supported"
            )
        return _spr_scan_climb(
            start, leaf_sequences, max_rounds,
            site_weights=site_weights,
            sequences_are_masks=sequences_are_masks,
            scan_budget_bytes=scan_budget_bytes,
            mesh=mesh,
        )

    if score_batch_fn is None and mesh is not None:
        score_batch_fn = _mesh_score_batch(
            mesh, leaf_sequences, site_weights, sequences_are_masks
        )
    if score_batch_fn is None:
        score_batch_fn = batched_scores_fastest

    def single_score(topo):
        batch = jax.tree_util.tree_map(lambda x: x[None], topo)
        return float(score_batch_fn(batch, cost_matrix, leaf_sequences)[0])

    current = start
    current_score = single_score(current)
    trace = [current_score]
    evaluations = 1
    rng = np.random.default_rng(
        int(jax.random.key_data(key).ravel()[-1]) if key is not None else 0
    )
    n_all = start.n_all

    if neighborhood == "tbr":
        def neighbors_fn(topo):
            # Fresh seed per round: a truncated TBR set is re-sampled each
            # climb step instead of repeating one fixed subset.
            return tbr_neighborhood_host(
                topo, max_trees=tbr_budget,
                seed=int(rng.integers(0, 2**63 - 1)),
            )
    elif neighborhood == "spr":
        neighbors_fn = spr_neighborhood_host
    else:
        neighbors_fn = nni_neighbors_host
    for round_idx in range(max_rounds):
        # Candidate generation stays HOST-side numpy; only the children
        # tensors cross to the device (scoring never reads parents values,
        # so the device batch carries a broadcast placeholder — half the
        # transfer at O(n^2)-candidate neighborhoods).
        nbr_children, nbr_parents = neighbors_fn(current)
        if random_kicks > 0:
            extra_c, extra_p = [], []
            children_np = np.asarray(current.children)
            while len(extra_c) < random_kicks:
                prune = int(rng.integers(0, n_all - 1))
                regraft = int(rng.integers(0, n_all - 1))
                reroot = int(rng.integers(0, n_all))
                # Alternate SPR and TBR kicks for diversification.
                if len(extra_c) % 2 == 0:
                    moved = spr_move_host(children_np, prune, regraft)
                else:
                    moved = tbr_move_host(children_np, prune, reroot, regraft)
                if moved is not None:
                    extra_c.append(moved[0])
                    extra_p.append(moved[1])
            nbr_children = np.concatenate([nbr_children, np.stack(extra_c)])
            nbr_parents = np.concatenate([nbr_parents, np.stack(extra_p)])
        if check_constraint is not None:
            keep = check_constraint(nbr_children)
            if not keep.any():
                return SearchResult(
                    current, current_score, round_idx, evaluations, trace
                )
            nbr_children = nbr_children[keep]
            nbr_parents = nbr_parents[keep]
        # Bucket the candidate batch so XLA compiles one program per bucket,
        # not one per (varying) neighborhood size; pad host-side.
        n_real = int(nbr_children.shape[0])
        bucket = next_bucket(n_real, (8, 16, 32, 64, 128, 256, 512, 1024))
        children_dev = jnp.asarray(nbr_children)
        if bucket != n_real:
            children_dev = jnp.concatenate(
                [
                    children_dev,
                    jnp.broadcast_to(
                        children_dev[-1:],
                        (bucket - n_real,) + children_dev.shape[1:],
                    ),
                ]
            )
        batch_topo = Topology(
            children=children_dev,
            parents=jnp.broadcast_to(
                jnp.asarray(nbr_parents[0])[None], (bucket, n_all)
            ),
        )
        scores = np.asarray(
            score_batch_fn(batch_topo, cost_matrix, leaf_sequences)
        )[:n_real]
        evaluations += n_real
        best = int(scores.argmin())
        if scores[best] >= current_score:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current = Topology(
            children=jnp.asarray(nbr_children[best].copy()),
            parents=jnp.asarray(nbr_parents[best].copy()),
        )
        current_score = float(scores[best])
        trace.append(current_score)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)


def _mesh_score_batch(mesh, leaf_sequences, site_weights, sequences_are_masks):
    """Build a ``score_batch_fn`` that spans a ('tree', 'site') mesh.

    Candidates shard over ``tree`` (batch padded to a multiple of the axis
    by repeating the last candidate; scores sliced back), sites over
    ``site`` (alignment padded to a multiple with weight-0 columns — state
    0 / full-set masks, zero extra cost under any zero-diagonal cost
    matrix, and the weights kill them anyway). Scores are bit-identical to
    the single-device dispatcher: parsimony site sums are integer-valued,
    so the psum's reordering is exact in f32.
    """
    from trex_tpu.parallel.mesh import SITE_AXIS, TREE_AXIS
    from trex_tpu.parallel.sharded import sharded_batch_scores

    n_tree = mesh.shape[TREE_AXIS]
    n_site = mesh.shape[SITE_AXIS]
    length = leaf_sequences.shape[-1]
    pad_l = -length % n_site
    mesh_leaves = jnp.asarray(leaf_sequences)
    mesh_weights = (
        jnp.ones((length,), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )
    if pad_l:
        mesh_leaves = jnp.pad(
            mesh_leaves, ((0, 0), (0, pad_l)),
            constant_values=1 if sequences_are_masks else 0,
        )
        mesh_weights = jnp.pad(mesh_weights, (0, pad_l))

    def score(topos, cost, _leaves):
        b = topos.children.shape[0]
        pad_b = -b % n_tree
        if pad_b:
            topos = jax.tree_util.tree_map(
                lambda x: jnp.concatenate(
                    [x, jnp.broadcast_to(x[-1:], (pad_b,) + x.shape[1:])]
                ),
                topos,
            )
        return sharded_batch_scores(
            mesh, topos, cost, mesh_leaves,
            site_weights=mesh_weights,
            sequences_are_masks=sequences_are_masks,
        )[:b]

    return score


def _spr_scan_climb(
    start: Topology,
    leaf_sequences: jax.Array,
    max_rounds: int,
    *,
    site_weights: jax.Array | None,
    sequences_are_masks: bool,
    scan_budget_bytes: int = 2 << 30,
    mesh=None,
) -> SearchResult:
    """Hill climb where each round is ONE analytic all-SPR scan.

    Per round: ``ops.spr_scan`` scores the entire O(n^2) SPR neighborhood
    from a batched up/down pass on device (no candidate topologies are
    built or transferred), the argmin move is applied host-side with the
    native ``spr_move``, repeat until no move improves. ``evaluations``
    counts scored candidates (finite scan entries) for comparability with
    the enumerating climber. With ``mesh``, each round's scan runs with
    its prune axis sharded over the mesh's ``tree`` axis
    (``parallel.sharded.sharded_spr_scan``), bit-identical per row.
    """
    import numpy as np

    from trex_tpu.io import spr_move
    from trex_tpu.ops.spr_scan import spr_scan_best_segmented

    # Bound the scan's peak (chunk x nodes x sites) set tensors to ~2 GB
    # (a budget carried over from the previous accelerator, not yet
    # derived for the H100).
    from trex_tpu.utils.chunking import auto_prune_chunk

    n_all = start.n_all
    length = leaf_sequences.shape[-1]
    prune_chunk = auto_prune_chunk(
        n_all - 1, n_all * length * 4 * 2, scan_budget_bytes
    )

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_spr_scan

        def run_scan(topo):
            scores, base = sharded_spr_scan(
                mesh, topo, leaf_sequences, site_weights,
                sequences_are_masks=sequences_are_masks,
                scan_budget_bytes=scan_budget_bytes,
            )
            scores_np = np.asarray(scores)
            flat = int(np.argmin(scores_np))
            p, v = divmod(flat, scores_np.shape[-1])
            return (
                float(scores_np[p, v]), p, v, float(base),
                int(np.isfinite(scores_np).sum()),
            )
    else:
        def run_scan(topo):
            # Segmented dispatches under the per-dispatch cell cap
            # (ops/spr_scan.py:_MAX_SCAN_CELLS) AND device-side argmin
            # reduction — only scalars cross back per round (the full
            # table is 4.3 GB at 16384 taxa).
            return spr_scan_best_segmented(
                topo, leaf_sequences, site_weights,
                sequences_are_masks=sequences_are_masks,
                prune_chunk=prune_chunk,
            )

    current = start
    best, p, v, base, n_finite = run_scan(current)
    current_score = float(base)
    trace = [current_score]
    evaluations = 1
    for round_idx in range(max_rounds):
        evaluations += n_finite
        if best >= current_score:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        moved = spr_move(current, p, v)
        if moved is None:  # defensive; scan-valid moves are spr_move-valid
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current, current_score = moved, best
        trace.append(current_score)
        best, p, v, _, n_finite = run_scan(current)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)


def batched_random_restarts(
    key: jax.Array,
    n_leaves: int,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    *,
    n_starts: int = 8,
    max_rounds: int = 100,
    score_batch_fn=None,
    neighborhood: str = "nni",
) -> SearchResult:
    """Hill climb from several random starting topologies; return the best."""
    from trex_tpu.io import sample_topologies

    seeds = np.asarray(jax.random.key_data(key)).ravel()
    starts = sample_topologies(int(seeds[-1]), n_leaves, n_starts)
    best: SearchResult | None = None
    for s in range(n_starts):
        start = jax.tree_util.tree_map(lambda x: x[s], starts)
        result = parsimony_hill_climb(
            start,
            cost_matrix,
            leaf_sequences,
            max_rounds=max_rounds,
            score_batch_fn=score_batch_fn,
            neighborhood=neighborhood,
        )
        if best is None or result.score < best.score:
            best = result
    assert best is not None
    return best
