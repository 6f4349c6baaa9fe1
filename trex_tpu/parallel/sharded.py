"""Sharded candidate scoring and training steps (shard_map + collectives).

Explicit-collective formulations of the engine's two distributed workloads.
Nothing here exists in the reference (it is single-device; SURVEY.md §2) —
these are the scaling components the north star demands.

Key fact making both cheap: every objective in this engine is a *sum over
sites* (Sankoff total = site-sum of root minima, ``ops/sankoff.py``;
surrogate/soft costs = site-sum of quadratic forms, ``ops/costs.py``). So a
site-sharded loss is ``psum`` of per-shard losses, and gradients w.r.t.
site-sharded parameters (ancestor logits) need *no* communication at all —
only the replicated topology logits' gradients are psum-merged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from trex_tpu.ops.costs import surrogate_cost
from trex_tpu.ops.relax import binary_tree_penalty, soft_sequences, soft_topology
from trex_tpu.ops.sankoff import sankoff_score
from trex_tpu.parallel.mesh import SITE_AXIS, TREE_AXIS
from trex_tpu.topology import Topology


def sharded_batch_scores(
    mesh: Mesh,
    topologies: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    use_fitch: bool | None = None,
    *,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Score a candidate-tree batch across the whole mesh.

    Layout: topology batch sharded over ``tree``; alignment sites sharded over
    ``site`` (leaves replicated over ``tree``). Each device runs the DP on its
    (trees x sites) tile; per-tree site-partial scores merge with one
    ``psum`` over ``site``.

    Args:
        topologies: batched ``Topology`` (leading axis divisible by the tree
            axis size).
        leaf_sequences: (n_leaves, L) with L divisible by the site axis size.
        site_weights: optional (L,) per-site multiplicities (compressed
            patterns / bootstrap); sharded over ``site`` with the leaves.
            Parsimony site costs and weights are integer-valued, so the
            psum-reordered weighted sum stays exact (f32 is exact to 2^24).
        sequences_are_masks: leaves are int32 state-set bitmasks.

    Returns:
        (batch,) scores, sharded over ``tree`` (replicated over ``site``).

    ``use_fitch`` selects the bitset fast path for Hamming costs (GPU
    kernel per shard on a GPU, lax elsewhere; ``ops.dispatch``);
    auto-detected from a concrete cost matrix when None.
    """
    from trex_tpu.ops.dispatch import _is_hamming, batched_fitch_scores

    n_states = cost_matrix.shape[-1]
    if use_fitch is None:
        use_fitch = _is_hamming(cost_matrix) and n_states <= 32
    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            Topology(children=P(TREE_AXIS), parents=P(TREE_AXIS)),
            P(),
            P(None, SITE_AXIS),
            P(SITE_AXIS),
        ),
        out_specs=P(TREE_AXIS),
        check_vma=False,
    )
    def score_shard(topos, cost, leaf_shard, w_shard):
        if use_fitch:
            partial_scores = batched_fitch_scores(
                topos, leaf_shard, w_shard,
                sequences_are_masks=sequences_are_masks, n_states=n_states,
            )
        else:
            partial_scores = jax.vmap(
                lambda t: sankoff_score(
                    t, cost, leaf_shard, w_shard,
                    sequences_are_masks=sequences_are_masks,
                )
            )(topos)
        return jax.lax.psum(partial_scores, SITE_AXIS)

    return score_shard(topologies, cost_matrix, leaf_sequences, weights)


def sharded_log_likelihoods(
    mesh: Mesh,
    topologies: Topology,
    branch_lengths: jax.Array,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Log-likelihoods of a candidate batch across the whole mesh (JC69).

    Same layout as ``sharded_batch_scores``: topology batch (and its
    branch-length rows) sharded over ``tree``, alignment sites over
    ``site``. The pruning log-likelihood is a per-site sum, so per-shard
    totals merge with one ``psum`` over ``site`` — exactly the parsimony
    communication pattern (one f32 per tree per step).

    ``site_weights``: optional (L,) per-site multiplicities (compressed
    patterns / bootstrap replicates), sharded over ``site`` with the
    leaves.

    Returns (batch,) log-likelihoods, sharded over ``tree``.
    """
    from trex_tpu.ops.likelihood import batched_log_likelihood

    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            Topology(children=P(TREE_AXIS), parents=P(TREE_AXIS)),
            P(TREE_AXIS),
            P(None, SITE_AXIS),
            P(SITE_AXIS),
        ),
        out_specs=P(TREE_AXIS),
        check_vma=False,
    )
    def score_shard(topos, blens, leaf_shard, w_shard):
        partial_lls = batched_log_likelihood(
            topos, blens, leaf_shard, n_states, site_weights=w_shard,
            sequences_are_masks=sequences_are_masks,
        )
        return jax.lax.psum(partial_lls, SITE_AXIS)

    return score_shard(topologies, branch_lengths, leaf_sequences, weights)


def sharded_per_site_matrix(
    mesh: Mesh,
    trees: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    weights: jax.Array | None = None,
    n_sweeps: int = 8,
    sequences_are_masks: bool = False,
    batch_size: int = 64,
) -> jax.Array:
    """(T, P) per-site log-likelihood rows, candidate axis over ``tree``.

    The RELL primitive shared by ``search.ufboot`` and ``search.topotest``:
    per candidate, Newton-optimize branch lengths then take the per-site
    log-likelihood vector. Each candidate is independent, so the T axis is
    pure data parallelism: the batch pads to a multiple of the mesh's
    ``tree`` axis (repeats of the last tree, sliced off) and each shard
    runs its local ``lax.map``. Per-candidate results do not depend on the
    batch grouping, so rows match the single-device map bit for bit
    (pinned in tests/test_sharding.py). Sites stay replicated: the
    downstream RELL matmul wants whole rows.
    """
    from trex_tpu.ops.likelihood import per_site_log_likelihood
    from trex_tpu.ops.likelihood_asr import optimize_branch_lengths_newton

    n_tree = mesh.shape[TREE_AXIS]
    n_cand = int(trees.children.shape[0])
    pad = -n_cand % n_tree
    if pad:
        trees = jax.tree_util.tree_map(
            lambda x: jnp.concatenate(
                [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])]
            ),
            trees,
        )
    w = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            Topology(children=P(TREE_AXIS), parents=P(TREE_AXIS)),
            P(),
            P(),
        ),
        out_specs=P(TREE_AXIS),
        check_vma=False,
    )
    def run(topos, leaf, w_full):
        def one(topo):
            lengths, _ = optimize_branch_lengths_newton(
                topo, leaf, n_states, rates, freqs, w_full,
                sequences_are_masks=sequences_are_masks, n_sweeps=n_sweeps,
            )
            return per_site_log_likelihood(
                topo, lengths, leaf, n_states, rates, freqs,
                sequences_are_masks=sequences_are_masks,
            )

        return jax.lax.map(one, topos, batch_size=batch_size)

    return run(trees, jnp.asarray(leaf_sequences), w)[:n_cand]


def sharded_best_tree(
    mesh: Mesh,
    topologies: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    use_fitch: bool | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Score a sharded candidate batch and select the global best on-device.

    Per tree-shard local argmin, then one ``all_gather`` of (min, index)
    pairs over the ``tree`` axis — the best-tree reduction never leaves the
    mesh (SURVEY.md §7 M5). Returns (global_index, best_score), replicated.
    """
    from trex_tpu.ops.dispatch import _is_hamming, batched_fitch_scores

    n_states = cost_matrix.shape[-1]
    if use_fitch is None:
        use_fitch = _is_hamming(cost_matrix) and n_states <= 32

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            Topology(children=P(TREE_AXIS), parents=P(TREE_AXIS)),
            P(),
            P(None, SITE_AXIS),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def select_shard(topos, cost, leaf_shard):
        if use_fitch:
            partial_scores = batched_fitch_scores(
                topos, leaf_shard, n_states=n_states
            )
        else:
            partial_scores = jax.vmap(sankoff_score, in_axes=(0, None, None))(
                topos, cost, leaf_shard
            )
        scores = jax.lax.psum(partial_scores, SITE_AXIS)  # (B_local,)
        local_size = scores.shape[0]
        local_best = jnp.argmin(scores)
        tree_rank = jax.lax.axis_index(TREE_AXIS)
        global_idx = tree_rank * local_size + local_best
        mins = jax.lax.all_gather(scores[local_best], TREE_AXIS)  # (n_tree,)
        idxs = jax.lax.all_gather(global_idx, TREE_AXIS)
        winner = jnp.argmin(mins)
        return idxs[winner].astype(jnp.int32), mins[winner]

    return select_shard(topologies, cost_matrix, leaf_sequences)


def _local_joint_loss(params, leaf_shard, step_key, temperature, constraint_scale,
                      n_leaves, site_weight):
    """Per-shard joint loss: local surrogate + (weighted) constraint penalty.

    ``site_weight`` = 1/n_site_shards so the replicated penalty isn't
    multiply-counted by the loss psum.
    """
    seqs = soft_sequences(params["ancestors"], leaf_shard, n_leaves, temperature)
    tree = soft_topology(step_key, params["tree_params"])
    penalty = temperature * binary_tree_penalty(tree, constraint_scale)
    return surrogate_cost(seqs, tree) + site_weight * penalty


def make_sharded_joint_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    n_leaves: int,
    constraint_scale: float = 10.0,
):
    """Build a jitted multi-chip training step for the joint search.

    Sharding: ancestor logits and the leaf tensor are sharded over ``site``
    (axis 1 = L) and over ``tree`` on the restart batch axis (axis 0 of the
    restart-batched params); topology logits are replicated within a restart.
    The step: each device takes grad of its local loss; ancestor grads are
    already exact (site-local params), topology grads psum over ``site``.
    The loss returned is the psum over sites (the true global loss).

    Returns a function
    ``step(params, opt_state, leaf_tensor, key, temperature) ->
    (params, opt_state, loss)`` operating on ONE restart; vmap it over a
    restart batch sharded on ``tree``.
    """
    n_site = mesh.shape[SITE_AXIS]

    def local_step(params, opt_state, leaf_shard, step_key, temperature):
        def loss_fn(p):
            return _local_joint_loss(
                p, leaf_shard, step_key, temperature, constraint_scale,
                n_leaves, 1.0 / n_site,
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, SITE_AXIS)
        # Ancestor logits are site-local parameters: their grads are exact.
        # Topology logits are replicated across site shards: merge grads.
        grads = {
            "ancestors": grads["ancestors"],
            "tree_params": jax.lax.psum(grads["tree_params"], SITE_AXIS),
        }
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    params_spec = {"ancestors": P(None, SITE_AXIS, None), "tree_params": P()}

    def step(params, opt_state, leaf_tensor, key, temperature):
        opt_spec = jax.tree_util.tree_map(
            lambda x: params_spec["ancestors"]
            if (hasattr(x, "ndim") and x.ndim == 3)
            else P(),
            opt_state,
            is_leaf=lambda x: hasattr(x, "ndim"),
        )
        sharded = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(params_spec, opt_spec, P(None, SITE_AXIS, None), P(), P()),
            out_specs=(params_spec, opt_spec, P()),
            check_vma=False,
        )
        return sharded(params, opt_state, leaf_tensor, key, temperature)

    return step


def make_sharded_restart_joint_step(
    mesh: Mesh,
    optimizer: optax.GradientTransformation,
    n_leaves: int,
    constraint_scale: float = 10.0,
):
    """Full training step over a restart batch: dp x sp over the whole mesh.

    Sharding layout (the engine's production configuration):
      - restart batch axis  -> ``tree``  (data parallel; no cross-talk)
      - alignment site axis -> ``site``  (sequence parallel; loss/grads psum)
      - topology logits replicated across ``site`` within each restart.

    ``params`` carry a leading restart axis: ``ancestors (R, n_anc, L, Q)``
    sharded P(tree, None, site, None); ``tree_params (R, n_all-1, n_anc)``
    sharded P(tree). Returns per-restart losses (R,).
    """
    n_site = mesh.shape[SITE_AXIS]

    def local_step(params, opt_state, leaf_shard, step_keys, temperature):
        def one_restart_loss(p, step_key):
            return _local_joint_loss(
                p, leaf_shard, step_key, temperature, constraint_scale,
                n_leaves, 1.0 / n_site,
            )

        def batched_loss(p):
            losses = jax.vmap(one_restart_loss)(p, step_keys)
            return jnp.sum(losses), losses

        grads, losses = jax.grad(batched_loss, has_aux=True)(params)
        losses = jax.lax.psum(losses, SITE_AXIS)
        grads = {
            "ancestors": grads["ancestors"],
            "tree_params": jax.lax.psum(grads["tree_params"], SITE_AXIS),
        }
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, losses

    params_spec = {
        "ancestors": P(TREE_AXIS, None, SITE_AXIS, None),
        "tree_params": P(TREE_AXIS),
    }

    def step(params, opt_state, leaf_tensor, step_keys, temperature):
        opt_spec = jax.tree_util.tree_map(
            lambda x: params_spec["ancestors"]
            if (hasattr(x, "ndim") and x.ndim == 4)
            else (params_spec["tree_params"] if hasattr(x, "ndim") and x.ndim == 3 else P()),
            opt_state,
            is_leaf=lambda x: hasattr(x, "ndim"),
        )
        sharded = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                params_spec,
                opt_spec,
                P(None, SITE_AXIS, None),
                P(TREE_AXIS),
                P(),
            ),
            out_specs=(params_spec, opt_spec, P(TREE_AXIS)),
            check_vma=False,
        )
        return sharded(params, opt_state, leaf_tensor, step_keys, temperature)

    return step


def sharded_joint_step(
    mesh: Mesh,
    params,
    opt_state,
    leaf_tensor,
    key,
    temperature,
    optimizer,
    n_leaves,
    constraint_scale: float = 10.0,
):
    """One-shot convenience wrapper around ``make_sharded_joint_step``."""
    step = make_sharded_joint_step(mesh, optimizer, n_leaves, constraint_scale)
    return step(params, opt_state, leaf_tensor, key, temperature)


def sharded_spr_scan(
    mesh: Mesh,
    topology: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    criterion: str = "parsimony",
    ranking_branch_length: float = 0.1,
    n_states: int | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | jax.Array | None = None,
    category_rates: jax.Array | None = None,
    category_weights: jax.Array | None = None,
    scan_budget_bytes: int = 2 << 30,
    max_cells: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """The analytic all-SPR scan with the PRUNE axis sharded over ``tree``.

    Each prune variant's up/down pass is independent, so the O(n) variants
    distribute embarrassingly over the mesh's candidate axis: device d
    scans prune nodes d, d+D, ... and the (n_all-1, n_all) score matrix is
    reassembled by the output sharding (one all_gather). Criterion
    "parsimony" (unit-cost Fitch identity) or "ml" (fixed ranking lengths,
    optional GTR/+Gamma — the model-aware scan).

    ``scan_budget_bytes`` bounds each DEVICE's peak scan working set (the
    per-prune set tensors), exactly like the single-device climbers'
    budget — but here the prune axis is already divided by the mesh, so a
    given budget admits ``n_dev``-times more prune parallelism per round.

    ``max_cells`` caps each DISPATCH's per-device prune-axis extent
    (prune rows x n_all cells), mirroring ``ops.spr_scan._MAX_SCAN_CELLS``
    (the chunk budget does NOT bound the one-dispatch program's extent).
    When a shard's local prune set exceeds the cap, the scan runs as
    several equal-shaped shard_map dispatches (one compile), each scoring a
    slice of every device's rows; rows are computed whole per dispatch so
    the reassembled table is bit-identical to the one-dispatch scan.

    Returns (scores (n_all-1, n_all), base_score), numerically identical
    to the single-device scans (verified in tests/test_sharding.py).
    """
    import numpy as np

    from trex_tpu.ops.spr_scan import _MAX_SCAN_CELLS
    from trex_tpu.utils.chunking import auto_prune_chunk

    if max_cells is None:
        max_cells = _MAX_SCAN_CELLS
    n_all = topology.n_all
    n_dev = mesh.shape[TREE_AXIS]
    n_prune = n_all - 1
    padded = ((n_prune + n_dev - 1) // n_dev) * n_dev
    local_prune = padded // n_dev
    length = leaf_sequences.shape[-1]

    # Per-device per-dispatch prune extent under the runtime-kill cap.
    local_seg = min(local_prune, max(1, max_cells // n_all))
    n_seg = (local_prune + local_seg - 1) // local_seg
    # dev_rows[d]: device d's prune nodes, padded to n_seg*local_seg with
    # repeats of its last valid node (duplicate rows dropped on reassembly).
    dev_rows = np.minimum(
        np.arange(n_dev, dtype=np.int32)[:, None] * local_prune
        + np.minimum(np.arange(n_seg * local_seg, dtype=np.int32), local_prune - 1)[None, :],
        n_prune - 1,
    )

    if criterion == "parsimony":
        from trex_tpu.ops.spr_scan import spr_scan as scan_fn

        # Per-prune working set: f32 set tensors x (inside + upstream),
        # matching search/hillclimb.py's single-device accounting.
        prune_chunk = auto_prune_chunk(
            local_seg, n_all * length * 4 * 2, scan_budget_bytes
        )

        def run(pn, leaves, w):
            return scan_fn(
                topology, leaves, w,
                sequences_are_masks=sequences_are_masks,
                prune_nodes=pn, prune_chunk=prune_chunk,
            )
    elif criterion == "ml":
        from trex_tpu.ops.likelihood_scan import likelihood_spr_scan

        q = n_states or int(leaf_sequences.max()) + 1
        prune_chunk = auto_prune_chunk(
            local_seg, n_all * length * (q + 1) * 4 * 2, scan_budget_bytes
        )

        def run(pn, leaves, w):
            return likelihood_spr_scan(
                topology, leaves, q, ranking_branch_length, w,
                rates=rates, freqs=freqs, gamma_shape=gamma_shape,
                category_rates=category_rates,
                category_weights=category_weights,
                sequences_are_masks=sequences_are_masks,
                prune_nodes=pn, prune_chunk=prune_chunk,
            )
    else:
        raise ValueError(f"unknown criterion {criterion!r}")

    weights = (
        jnp.ones((leaf_sequences.shape[-1],), jnp.float32)
        if site_weights is None
        else jnp.asarray(site_weights, jnp.float32)
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(TREE_AXIS), P(), P()),
        out_specs=(P(TREE_AXIS), P()),
        check_vma=False,
    )
    def scan_shard(pn, leaves, w):
        scores, base = run(pn, leaves, w)
        return scores, base

    leaves = jnp.asarray(leaf_sequences)
    # One dispatch per segment slice; every dispatch has identical shapes,
    # so the whole loop compiles ONE program regardless of segment count.
    seg_scores = []
    base = None
    for s in range(n_seg):
        pn = jnp.asarray(
            dev_rows[:, s * local_seg:(s + 1) * local_seg].reshape(-1)
        )
        sc, base = scan_shard(pn, leaves, weights)
        seg_scores.append(sc)
    # seg_scores[s] rows are device-major within the dispatch; reassemble
    # per-device row blocks back into global prune order.
    stacked = jnp.stack(seg_scores)  # (n_seg, n_dev*local_seg, n_all)
    scores = (
        stacked.reshape(n_seg, n_dev, local_seg, n_all)
        .transpose(1, 0, 2, 3)
        .reshape(n_dev, n_seg * local_seg, n_all)[:, :local_prune]
        .reshape(padded, n_all)[:n_prune]
    )
    # Match the single-device full-scan layout: one row per node incl. an
    # all-inf root row, so argmin/divmod consumers are drop-in.
    root_row = jnp.full((1, scores.shape[-1]), jnp.inf, scores.dtype)
    return jnp.concatenate([scores, root_row]), base
