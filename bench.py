"""Headline benchmark: candidate-tree evaluations/s/chip.

Config from BASELINE.md: 64 taxa x 1k sites, Hamming cost, batched candidate
topologies scored with the exact Sankoff DP. Target >= 10,000 trees/s/chip
(``vs_baseline`` = measured / 10,000; the reference publishes no numbers of
its own — SURVEY.md §6).

Prints one JSON line per metric; the HEADLINE metric is the LAST line:
  {"metric": ..., "value": N, "unit": "...", "vs_baseline": N, "device": ...}
The three canary lines before it: ML ranking evals/s, topology-MCMC
generations/s, and the differentiable joint-search score vs the same-data
true-tree score. Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _device() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _emit(
    metric: str, value: float, unit: str, vs_baseline: float | None = None
) -> None:
    line = {"metric": metric, "value": round(value, 3), "unit": unit}
    if vs_baseline is not None:
        line["vs_baseline"] = round(vs_baseline, 3)
    line["device"] = _device()
    print(json.dumps(line), flush=True)


def bench_ml() -> None:
    """Shared-P ML ranking throughput (the scorer ``search.ml`` uses)."""
    from trex_tpu.ops.likelihood import batched_log_likelihood, jc69_transition
    from trex_tpu.topology import random_topologies

    n, length, batch, reps = 64, 1024, 1024, 20
    topos = random_topologies(jax.random.PRNGKey(0), n, batch)
    leaf = jax.random.randint(jax.random.PRNGKey(1), (n, length), 0, 4)
    bl = jnp.full((batch, 2 * n - 1), 0.1)
    p0 = jc69_transition(jnp.float32(0.1), 4)

    run = jax.jit(
        lambda: batched_log_likelihood(
            topos, bl, leaf, 4, shared_transition=p0
        )
    )

    run().block_until_ready()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        run().block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = run()
        out.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    rate = batch * reps / best
    _emit("ML ranking evals/s (64 taxa, 1k sites)", rate, "trees/s")


def bench_mcmc() -> None:
    """Topology MCMC generations/s, informed proposal, 64 x 2048 x 8."""
    from trex_tpu.io import sample_topologies
    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.search.mcmc import mcmc_sample

    leaves_n, sites, chains = 64, 2048, 8
    truth = jax.tree_util.tree_map(
        lambda x: x[0], sample_topologies(3, leaves_n, 1)
    )
    aln = simulate_alignment(
        jax.random.PRNGKey(0), truth,
        np.full(2 * leaves_n - 1, 0.1, np.float32), n_sites=sites,
    )
    leaves = jnp.asarray(aln.astype(np.int32))
    common = dict(
        n_runs=1, n_chains=chains, sample_every=20, burnin_frac=0.0,
        branch_moves_per_gen=2, topo_proposal="informed",
    )
    # mcmc_sample re-traces its generation program per call, but the XLA
    # executable is compile-cached across calls, so ONE warmup run with the
    # SAME generation count leaves no fresh compile inside the timed run.
    gens = 640

    def timed(seed):
        t0 = time.perf_counter()
        mcmc_sample(
            jax.random.PRNGKey(seed), leaves, 4, n_generations=gens, **common
        )
        return time.perf_counter() - t0

    timed(1)  # warmup: compiles every superblock size the run uses
    dt = timed(2)
    rate = gens / dt
    # A sub-100 ms wall for 640 generations is a measurement artifact,
    # not a rate: refuse to report it.
    if dt < 0.1:
        print(
            json.dumps(
                {
                    "metric": "topology MCMC gen/s (64 taxa, 2048 sites, "
                    "8 chains)",
                    "error": "unstable-measurement",
                    "wall_s": round(dt, 4),
                }
            ),
            flush=True,
        )
        return
    _emit("topology MCMC gen/s (64 taxa, 2048 sites, 8 chains)", rate,
          "gen/s")


def bench_diff_search() -> None:
    """Differentiable joint search score ratio vs the true tree's score."""
    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.ops.relax import project_topology, soft_topology
    from trex_tpu.search.joint import JointConfig, init_params, joint_optimize
    from trex_tpu.topology import random_topologies
    from trex_tpu.types import CostModel

    n, length, q, iters, restarts = 64, 1024, 4, 600, 4
    n_all = 2 * n - 1
    cost = CostModel.hamming(q).matrix
    true_topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(0), n, 1)
    )
    seqs = jnp.asarray(
        simulate_alignment(
            jax.random.PRNGKey(1), true_topo, np.full(n_all, 0.15),
            n_sites=length, n_states=q,
        )
    )
    true_score = float(
        batched_scores_fastest(
            jax.tree_util.tree_map(lambda x: x[None], true_topo), cost, seqs
        )[0]
    )
    leaf_tensor = jnp.zeros((n_all, length, q))
    leaf_tensor = leaf_tensor.at[:n].set(jax.nn.one_hot(seqs, q))
    cfg = JointConfig(n_iterations=iters)

    def one_restart(key):
        k_init, k_run = jax.random.split(key)
        params = init_params(k_init, n, length, q)
        params, losses = joint_optimize(k_run, params, leaf_tensor, cfg)
        return params

    keys = jax.random.split(jax.random.PRNGKey(3), restarts)
    params_b = jax.jit(jax.vmap(one_restart))(keys)
    proj = jax.jit(
        jax.vmap(
            lambda p, k: project_topology(
                soft_topology(k, p["tree_params"], 0.01)
            )
        )
    )
    topos = proj(params_b, jax.random.split(jax.random.PRNGKey(4), restarts))
    score = float(batched_scores_fastest(topos, cost, seqs).min())
    # vs_baseline = true_score / score (1.0 would be exact recovery).
    _emit("diff joint-search best score (64 taxa, 1k sites)", score,
          "parsimony", true_score / max(score, 1.0))


def bench_fitch() -> None:
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.topology import random_topologies
    from trex_tpu.types import CostModel

    n_leaves, n_states, length, batch = 64, 4, 1024, 2048
    reps = 20

    topos = random_topologies(jax.random.PRNGKey(0), n_leaves, batch)
    cost = CostModel.hamming(n_states).matrix
    leaf = jax.random.randint(
        jax.random.PRNGKey(1), (n_leaves, length), 0, n_states
    )

    # NOTE: the dispatcher must NOT be wrapped in jax.jit — it inspects the
    # concrete cost matrix to pick the Fitch/Hamming fast paths, and its
    # targets are already jitted.
    score_fn = batched_scores_fastest
    # Warmup: compile, then run untimed until clocks settle.
    scores = score_fn(topos, cost, leaf)
    scores.block_until_ready()
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < 3.0:
        scores = score_fn(topos, cost, leaf)
        scores.block_until_ready()

    # 5 timestamped trials (steady-state throughput); every trial's rate is
    # emitted, and a trial >25% below the median is flagged as a stall.
    # Headline = max rate; median also reported.
    reps = 25
    bench_start = time.perf_counter()
    trials = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            scores = score_fn(topos, cost, leaf)
        scores.block_until_ready()
        trials.append((t0 - bench_start, time.perf_counter() - t0))

    rates = [batch * reps / t for _, t in trials]
    median = float(np.median(rates))
    stalls = [i for i, r in enumerate(rates) if r < 0.75 * median]
    print(
        json.dumps(
            {
                "metric": "candidate-tree evals/s trial protocol",
                "trials": [
                    {"t_start_s": round(ts, 2), "rate": round(r, 1)}
                    for (ts, _), r in zip(trials, rates)
                ],
                "median": round(median, 1),
                "spread_pct": round(
                    100 * (max(rates) - min(rates)) / max(rates), 2
                ),
                "stall_trials": stalls,
            }
        ),
        flush=True,
    )
    trees_per_s = max(rates)
    _emit("candidate-tree evals/s/chip (64 taxa, 1k sites)", trees_per_s,
          "trees/s", trees_per_s / 10000.0)


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("bench.py measures the GPU; JAX found none", file=sys.stderr)
        return 2
    for fn in (bench_ml, bench_mcmc, bench_diff_search, bench_fitch):
        fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
