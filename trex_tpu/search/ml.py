"""Maximum-likelihood tree search.

Reuses the discrete search machinery (NNI/SPR neighborhoods, batched device
scoring) with the Felsenstein pruning likelihood as the objective: candidate
ranking uses a fixed per-branch length (standard fast heuristic), and the
winner gets gradient-optimized branch lengths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from trex_tpu.ops.likelihood import optimize_branch_lengths
from trex_tpu.search.hillclimb import SearchResult, parsimony_hill_climb
from trex_tpu.topology import Topology


def ml_hill_climb(
    start: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    neighborhood: str = "spr",
    optimize_final_lengths: bool = True,
    n_length_iterations: int = 400,
    length_optimizer: str = "newton",
    sequences_are_masks: bool = False,
    site_weights: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | jax.Array | None = None,
    category_rates: jax.Array | None = None,
    category_weights: jax.Array | None = None,
    constraint_splits: list[frozenset[int]] | None = None,
    constraint_taxa: frozenset[int] | None = None,
    mesh=None,
) -> tuple[SearchResult, jax.Array, jax.Array]:
    """Greedy ML topology search + final branch-length optimization.

    ``mesh``: optional ('tree', 'site') ``jax.sharding.Mesh`` — with
    ``neighborhood="spr-scan"`` each ranking round's analytic likelihood
    scan shards its prune axis over the mesh's ``tree`` axis
    (``parallel.sharded.sharded_spr_scan(criterion="ml")``), dividing the
    per-device scan working set; rows are computed whole per device, so
    the ranking matrix is bit-identical to single-device. Enumerating
    neighborhoods ignore it (their ranking kernel is single-device).

    ``gamma_shape``: +Gamma-aware candidate ranking (the per-site category
    mixture of ``tree_log_likelihood_gamma``). Supported by the analytic
    ``spr-scan`` neighborhood only — the fused enumerating kernel returns
    site-summed scores, which cannot be mixed per site after the fact.

    Candidates are ranked by log-likelihood with every branch fixed at
    ``ranking_branch_length`` (negated so the hill climber minimizes).
    ``neighborhood="spr-scan"`` evaluates the whole SPR neighborhood
    analytically per round (``ops.likelihood_scan``) — exact for the same
    all-fixed-length candidates the enumerating ranker scores, at ~2n
    pruning passes per round instead of O(n^2).
    ``sequences_are_masks``: leaves are int32 state-set bitmasks (IUPAC
    ambiguity / gaps). ``site_weights``: per-site log-lik multiplicities
    (compressed site patterns / bootstrap) — exact, since the total
    log-likelihood is a weighted site-sum. ``length_optimizer``: "newton"
    (default — damped analytic Newton sweeps, ~10x fewer likelihood passes)
    or "adam" (``n_length_iterations`` gradient steps).

    Returns:
        (search_result, branch_lengths, loss_curve): the result's ``score``
        is the negative ranking log-likelihood; ``branch_lengths`` are the
        ML-optimized lengths of the best topology (or the fixed lengths when
        ``optimize_final_lengths`` is False).
    """
    n_all = start.n_all
    q = n_states

    if (
        gamma_shape is not None or category_rates is not None
    ) and neighborhood != "spr-scan":
        raise ValueError(
            "rate-mixture-aware ranking needs neighborhood='spr-scan'"
        )
    if constraint_splits and neighborhood == "spr-scan":
        raise ValueError(
            "constrained ML search needs an enumerating neighborhood "
            "(nni/spr/tbr), not spr-scan"
        )
    if neighborhood == "spr-scan":
        result = _ml_scan_climb(
            start, leaf_sequences, n_states,
            ranking_branch_length=ranking_branch_length,
            max_rounds=max_rounds,
            site_weights=site_weights,
            rates=rates, freqs=freqs, gamma_shape=gamma_shape,
            category_rates=category_rates,
            category_weights=category_weights,
            sequences_are_masks=sequences_are_masks,
            mesh=mesh,
        )
        if optimize_final_lengths:
            from trex_tpu.ops.likelihood_asr import (
                optimize_branch_lengths_newton,
            )

            lengths, losses = optimize_branch_lengths_newton(
                result.topology, leaf_sequences, n_states,
                rates, freqs,
                site_weights=site_weights,
                sequences_are_masks=sequences_are_masks,
                init_length=ranking_branch_length,
            )
        else:
            lengths = jnp.full((n_all,), ranking_branch_length)
            losses = jnp.asarray([result.score])
        return result, lengths, losses

    # Ranking: every candidate branch shares one fixed length, so ONE
    # (Q, Q) transition matrix (JC69, or GTR from the eigensystem) and the
    # stationary prior cover the whole batch.
    from trex_tpu.ops.likelihood import batched_log_likelihood, jc69_transition

    prior = None
    if rates is not None or freqs is not None:
        from trex_tpu.ops.likelihood import gtr_eigensystem, gtr_transition

        model_rates = (
            rates if rates is not None else jnp.ones((q, q)) - jnp.eye(q)
        )
        model_freqs = freqs if freqs is not None else jnp.full((q,), 1.0 / q)
        eig = gtr_eigensystem(jnp.asarray(model_rates), jnp.asarray(model_freqs))
        shared = gtr_transition(jnp.asarray(ranking_branch_length), *eig)
        prior = jnp.asarray(model_freqs)
    else:
        shared = jc69_transition(jnp.asarray(ranking_branch_length), q)

    def score_batch(topos, _cost, leaves):
        batch = topos.children.shape[0]
        blens = jnp.full((batch, n_all), ranking_branch_length)
        return -batched_log_likelihood(
            topos, blens, leaves, n_states,
            shared_transition=shared, root_prior=prior,
            site_weights=site_weights,
            sequences_are_masks=sequences_are_masks,
        )

    dummy_cost = jnp.zeros((n_states, n_states))
    result = parsimony_hill_climb(  # generic greedy climber, ML objective
        start,
        dummy_cost,
        leaf_sequences,
        max_rounds=max_rounds,
        score_batch_fn=score_batch,
        neighborhood=neighborhood,
        constraint_splits=constraint_splits,
        constraint_taxa=constraint_taxa,
    )
    if optimize_final_lengths:
        if length_optimizer == "newton":
            from trex_tpu.ops.likelihood_asr import (
                optimize_branch_lengths_newton,
            )

            lengths, losses = optimize_branch_lengths_newton(
                result.topology,
                leaf_sequences,
                n_states,
                rates,
                freqs,
                site_weights=site_weights,
                sequences_are_masks=sequences_are_masks,
                init_length=ranking_branch_length,
            )
        else:
            lengths, losses = optimize_branch_lengths(
                result.topology,
                leaf_sequences,
                n_states,
                init_length=ranking_branch_length,
                n_iterations=n_length_iterations,
                rates=rates,
                freqs=freqs,
                sequences_are_masks=sequences_are_masks,
                site_weights=site_weights,
            )
    else:
        lengths = jnp.full((n_all,), ranking_branch_length)
        losses = jnp.asarray([result.score])
    return result, lengths, losses


def ml_iterated_search(
    key: jax.Array,
    start: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    n_iterations: int = 10,
    perturb_moves: int = 3,
    stop_after: int = 5,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    neighborhood: str = "spr-scan",
    sequences_are_masks: bool = False,
    site_weights: jax.Array | None = None,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    progress_dir: str | None = None,
    mesh=None,
) -> tuple[SearchResult, jax.Array, jax.Array]:
    """Iterated ML search: random perturbation + reclimb, keep the best.

    ``progress_dir``: when set, the best tree so far (newick) and the score
    trace (JSON lines) are written after every iteration, so long runs
    survive interruption with their best result on disk (the parsimony
    ratchet's convention). If the directory already holds a ``best.nwk``
    from an interrupted run, the search RESUMES from it (the saved tree
    replaces ``start`` when it exists).

    The ML analogue of the parsimony ratchet (and of IQ-TREE's iterated NNI
    core): each iteration applies ``perturb_moves`` random SPR/TBR kicks to
    the incumbent (escaping its basin), reclimbs with ``ml_hill_climb``
    (model-aware when ``rates``/``freqs`` are given), and keeps the best
    ranking score seen. Stops early after ``stop_after`` consecutive
    non-improving iterations. Needs the native library for the kicks.

    Returns:
        (best SearchResult, branch lengths, loss curve) — lengths Newton-
        optimized on the final best topology; ``trace`` records the best
        score per iteration.
    """
    import numpy as np

    from trex_tpu.io import spr_move_host, tbr_move_host
    from trex_tpu.ops.likelihood_asr import optimize_branch_lengths_newton
    if progress_dir is not None:
        import os

        best_path = os.path.join(progress_dir, "best.nwk")
        if os.path.exists(best_path):
            # Resume: the saved best tree replaces the start. Leaves were
            # saved under their canonical index names (L<i>), so the parsed
            # tree's leaf order must be mapped back by name.
            from trex_tpu.io import load_newick, renumber_leaves

            with open(best_path) as fh:
                saved, _, names = load_newick(fh.read())
            ids = [int(n[1:]) if n.startswith("L") else int(n) for n in names]
            start = renumber_leaves(saved, ids)
    rng = np.random.default_rng(
        int(np.asarray(jax.random.key_data(key)).ravel()[-1])
    )
    climb_kwargs = dict(
        ranking_branch_length=ranking_branch_length,
        max_rounds=max_rounds,
        neighborhood=neighborhood,
        optimize_final_lengths=False,
        sequences_are_masks=sequences_are_masks,
        site_weights=site_weights,
        rates=rates,
        freqs=freqs,
        mesh=mesh,
    )
    def dump_progress(iteration: int, best) -> None:
        if progress_dir is None:
            return
        import json
        import os

        from trex_tpu.io import save_newick

        os.makedirs(progress_dir, exist_ok=True)
        with open(os.path.join(progress_dir, "best.nwk"), "w") as fh:
            fh.write(save_newick(best.topology) + "\n")
        with open(os.path.join(progress_dir, "trace.jsonl"), "a") as fh:
            fh.write(
                json.dumps({"iteration": iteration, "score": best.score})
                + "\n"
            )

    best, _, _ = ml_hill_climb(
        start, leaf_sequences, n_states, **climb_kwargs
    )
    trace = [best.score]
    evaluations = best.evaluations
    n_all = start.n_all
    stale = 0
    dump_progress(0, best)
    for _ in range(n_iterations):
        if stale >= stop_after:
            break
        # Random kicks (alternating SPR and TBR, like the ratchet's).
        children_np = np.asarray(best.topology.children)
        parents_np = np.asarray(best.topology.parents)
        kicked = None
        applied = 0
        while applied < perturb_moves:
            prune = int(rng.integers(0, n_all - 1))
            regraft = int(rng.integers(0, n_all - 1))
            reroot = int(rng.integers(0, n_all))
            if applied % 2 == 0:
                moved = spr_move_host(children_np, prune, regraft)
            else:
                moved = tbr_move_host(children_np, prune, reroot, regraft)
            if moved is None:
                continue
            children_np, parents_np = moved
            applied += 1
        kicked = Topology(
            children=jnp.asarray(children_np.copy()),
            parents=jnp.asarray(parents_np.copy()),
        )
        attempt, _, _ = ml_hill_climb(
            kicked, leaf_sequences, n_states, **climb_kwargs
        )
        evaluations += attempt.evaluations
        if attempt.score < best.score - 1e-6:
            best = attempt
            stale = 0
        else:
            stale += 1
        trace.append(best.score)
        dump_progress(len(trace) - 1, best)
    lengths, losses = optimize_branch_lengths_newton(
        best.topology, leaf_sequences, n_states, rates, freqs,
        site_weights=site_weights,
        sequences_are_masks=sequences_are_masks,
        init_length=ranking_branch_length,
    )
    result = SearchResult(
        best.topology, best.score, len(trace) - 1, evaluations, trace
    )
    return result, lengths, losses


def _ml_scan_climb(
    start: Topology,
    leaf_sequences: jax.Array,
    n_states: int,
    *,
    ranking_branch_length: float,
    max_rounds: int,
    site_weights: jax.Array | None,
    sequences_are_masks: bool,
    rates: jax.Array | None = None,
    freqs: jax.Array | None = None,
    gamma_shape: float | jax.Array | None = None,
    category_rates: jax.Array | None = None,
    category_weights: jax.Array | None = None,
    mesh=None,
) -> SearchResult:
    """Greedy ML climb where each round is one analytic likelihood scan."""
    import numpy as np

    from trex_tpu.io import spr_move
    from trex_tpu.ops.likelihood_scan import likelihood_spr_scan

    n_all = start.n_all
    length = leaf_sequences.shape[-1]
    # f32 (Q+1)-wide set tensors x (inside + upstream): ~2 GB working set.
    from trex_tpu.utils.chunking import auto_prune_chunk

    prune_chunk = auto_prune_chunk(
        n_all - 1, n_all * length * (n_states + 1) * 4 * 2
    )

    if mesh is not None:
        from trex_tpu.parallel.sharded import sharded_spr_scan

        def run_scan(topo):
            scores, base = sharded_spr_scan(
                mesh, topo, leaf_sequences, site_weights,
                sequences_are_masks=sequences_are_masks,
                criterion="ml",
                ranking_branch_length=ranking_branch_length,
                n_states=n_states, rates=rates, freqs=freqs,
                gamma_shape=gamma_shape, category_rates=category_rates,
                category_weights=category_weights,
            )
            scores_np = np.asarray(scores)
            flat = int(np.argmin(scores_np))
            p, v = divmod(flat, scores_np.shape[-1])
            return (
                float(scores_np[p, v]), p, v, float(base),
                int(np.isfinite(scores_np).sum()),
            )
    else:
        from trex_tpu.ops.likelihood_scan import (
            likelihood_spr_scan_best_segmented,
        )

        def run_scan(topo):
            # Segmented dispatches + device-side argmin reduction: only
            # scalars cross back per round (ops/spr_scan.py's rationale).
            return likelihood_spr_scan_best_segmented(
                topo, leaf_sequences, n_states, ranking_branch_length,
                site_weights, rates=rates, freqs=freqs,
                gamma_shape=gamma_shape,
                category_rates=category_rates,
                category_weights=category_weights,
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
        if moved is None:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current, current_score = moved, best
        trace.append(current_score)
        best, p, v, _, n_finite = run_scan(current)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)


def ml_partitioned_scan_climb(
    start: Topology,
    partitions: list[dict],
    n_states: int,
    *,
    ranking_branch_length: float = 0.1,
    max_rounds: int = 50,
    sequences_are_masks: bool = False,
) -> SearchResult:
    """Greedy ML climb under a PARTITIONED model via summed analytic scans.

    The partitioned log-likelihood is the sum of per-partition lnLs, so the
    all-SPR ranking matrix of the joint model is the elementwise SUM of each
    partition's scan (each evaluated with its own rates/freqs and its
    proportional rate multiplier scaling the shared ranking length).

    Args:
        partitions: per-partition dicts with keys ``leaf_sequences``
            ((n_leaves, L_p) states/masks), optional ``site_weights``,
            ``rates``, ``freqs``, ``gamma_shape``, and ``rate_multiplier``
            (default 1.0).

    Returns a ``SearchResult`` whose score is the summed negative ranking
    log-likelihood (all branches at multiplier-scaled t0).
    """
    import numpy as np

    from trex_tpu.io import spr_move
    from trex_tpu.ops.likelihood_scan import likelihood_spr_scan

    n_all = start.n_all

    def all_scores(topo):
        total = None
        base_total = 0.0
        for part in partitions:
            leaf = part["leaf_sequences"]
            length = leaf.shape[-1]
            q = n_states
            from trex_tpu.utils.chunking import auto_prune_chunk

            prune_chunk = auto_prune_chunk(
                n_all - 1, n_all * length * (q + 1) * 4 * 2
            )
            mult = float(part.get("rate_multiplier", 1.0))
            scores, base = likelihood_spr_scan(
                topo, leaf, n_states,
                ranking_branch_length * mult,
                part.get("site_weights"),
                rates=part.get("rates"),
                freqs=part.get("freqs"),
                gamma_shape=part.get("gamma_shape"),
                sequences_are_masks=sequences_are_masks,
                prune_chunk=prune_chunk,
            )
            total = scores if total is None else total + scores
            base_total = base_total + float(base)
        return total, base_total

    current = start
    scores, current_score = all_scores(current)
    trace = [current_score]
    evaluations = 1
    for round_idx in range(max_rounds):
        scores_np = np.asarray(scores)
        evaluations += int(np.isfinite(scores_np).sum())
        flat = int(np.argmin(scores_np))
        p, v = divmod(flat, scores_np.shape[-1])
        best = float(scores_np[p, v])
        if best >= current_score:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        moved = spr_move(current, p, v)
        if moved is None:
            return SearchResult(
                current, current_score, round_idx, evaluations, trace
            )
        current, current_score = moved, best
        trace.append(current_score)
        scores, _ = all_scores(current)
    return SearchResult(current, current_score, max_rounds, evaluations, trace)
