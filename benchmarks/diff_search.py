"""Device-scale differentiable tree search vs discrete climbers.

The reference's signature capability is differentiable tree search by
annealed Gumbel-softmax over topologies + soft ancestor sequences
(``/root/reference/src/trex/tree.py:50-107``, exercised there only at 4-8
leaves in ``tests/test_convergence.py:208-299``). This benchmark runs the
same joint relaxation at 64 taxa x 1024 sites on the device, projects the
learned soft adjacency onto a valid topology (``ops.relax.project_topology``),
and scores it with exact Fitch against:

  - the true simulated tree's parsimony score,
  - random-start NNI and analytic SPR-scan hill climbs (same data),
  - a random-topology baseline.

All restarts of the differentiable search run as ONE vmapped jitted scan
(restarts are a batch axis on the device). Prints one JSON line per method:
  {"method": ..., "score": N, "seconds": N, "evals": N}

Usage: python benchmarks/diff_search.py [--taxa 64] [--sites 1024]
       [--iters 3000] [--restarts 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--sites", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--branch-length", type=float, default=0.15)
    args = ap.parse_args()

    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.ops.relax import project_topology, soft_topology
    from trex_tpu.search import parsimony_hill_climb
    from trex_tpu.search.joint import JointConfig, init_params, joint_optimize
    from trex_tpu.topology import random_topologies, topology_to_adjacency
    from trex_tpu.types import CostModel

    n, length, q = args.taxa, args.sites, 4
    n_all = 2 * n - 1
    cost = CostModel.hamming(q).matrix

    true_topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(0), n, 1)
    )
    seqs = jnp.asarray(
        simulate_alignment(
            jax.random.PRNGKey(1), true_topo, np.full(n_all, args.branch_length),
            n_sites=length, n_states=q,
        )
    )

    def fitch1(topo):
        batch = jax.tree_util.tree_map(lambda x: x[None], topo)
        return float(batched_scores_fastest(batch, cost, seqs)[0])

    true_score = fitch1(true_topo)
    rand_topos = random_topologies(jax.random.PRNGKey(2), n, 64)
    rand_scores = batched_scores_fastest(rand_topos, cost, seqs)
    print(json.dumps({"method": "true-tree", "score": true_score,
                      "seconds": 0.0, "evals": 0}))
    print(json.dumps({"method": "random-best-of-64",
                      "score": float(rand_scores.min()),
                      "seconds": 0.0, "evals": 64}))

    # ---- differentiable joint search (Gumbel-softmax topology + soft
    # ancestors), restarts vmapped on chip --------------------------------
    leaf_tensor = jnp.zeros((n_all, length, q))
    leaf_tensor = leaf_tensor.at[:n].set(jax.nn.one_hot(seqs, q))
    cfg = JointConfig(n_iterations=args.iters)

    def one_restart(key):
        k_init, k_run = jax.random.split(key)
        params = init_params(k_init, n, length, q)
        params, losses = joint_optimize(k_run, params, leaf_tensor, cfg)
        return params, losses[-1]

    keys = jax.random.split(jax.random.PRNGKey(3), args.restarts)
    run = jax.jit(jax.vmap(one_restart))
    params_b, _ = jax.tree_util.tree_map(
        lambda x: x.block_until_ready(), run(keys)
    )  # compile + run once for timing separation below
    t0 = time.perf_counter()
    params_b, final_losses = run(keys)
    jax.block_until_ready(params_b)
    diff_seconds = time.perf_counter() - t0

    # Project each restart's soft adjacency to a valid topology; score with
    # the exact kernel; greedy projection is temperature-insensitive, use a
    # cold readout.
    proj = jax.jit(
        jax.vmap(
            lambda p, k: project_topology(
                soft_topology(k, p["tree_params"], 0.01)
            )
        )
    )
    topos = proj(params_b, jax.random.split(jax.random.PRNGKey(4), args.restarts))
    diff_scores = batched_scores_fastest(topos, cost, seqs)
    print(json.dumps({
        "method": f"diff-joint-gumbel x{args.restarts}",
        "score": float(diff_scores.min()),
        "seconds": round(diff_seconds, 2),
        "evals": args.iters * args.restarts,
    }))

    # ---- discrete climbers (same data) ----------------------------------
    for name, kwargs in (
        ("nni-climb", {"neighborhood": "nni"}),
        ("spr-scan-climb", {"neighborhood": "spr-scan"}),
    ):
        start = jax.tree_util.tree_map(
            lambda x: x[0], random_topologies(jax.random.PRNGKey(5), n, 1)
        )
        t0 = time.perf_counter()
        res = parsimony_hill_climb(start, cost, seqs, max_rounds=200, **kwargs)
        secs = time.perf_counter() - t0
        print(json.dumps({"method": name, "score": float(res.score),
                          "seconds": round(secs, 2),
                          "evals": int(res.evaluations)}))


if __name__ == "__main__":
    main()
