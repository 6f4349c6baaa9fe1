"""Bayesian MCMC throughput on the real accelerator.

Measures generations/s, candidate-likelihood evals/s AND cold-chain lnL
ESS/s for `search.mcmc.mcmc_sample` at a production-ish configuration —
ESS/s is the metric that matters for a sampler: the informed proposal
costs 2 x chains x 2(n-2) kernel evals per generation vs 1 for uniform,
and only mixing-per-second says whether that price is justified.

Usage:  python benchmarks/mcmc_bench.py [--leaves 32] [--sites 1024]
        [--chains 8] [--generations 200] [--proposal informed|uniform|both]

Never run concurrently with another JAX process on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=32)
    ap.add_argument("--sites", type=int, default=1024)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--generations", type=int, default=200)
    ap.add_argument("--branch-moves", type=int, default=2)
    ap.add_argument("--proposal", default="both",
                    choices=["informed", "uniform", "both"])
    ap.add_argument("--informed-power", type=float, default=0.5)
    ap.add_argument("--sample-every", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from trex_tpu.io import sample_topologies
    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.search.mcmc import mcmc_sample

    truth = jax.tree_util.tree_map(
        lambda x: x[0], sample_topologies(3, args.leaves, 1)
    )
    n_all = 2 * args.leaves - 1
    aln = simulate_alignment(
        jax.random.PRNGKey(0), truth, np.full(n_all, 0.1, np.float32),
        n_sites=args.sites,
    )
    leaves = jnp.asarray(aln.astype(np.int32))

    proposals = (
        ["informed", "uniform"] if args.proposal == "both" else [args.proposal]
    )
    for proposal in proposals:
        common = dict(
            n_runs=args.runs, n_chains=args.chains,
            sample_every=args.sample_every, burnin_frac=0.0,
            branch_moves_per_gen=args.branch_moves,
            topo_proposal=proposal,
            topo_informed_power=args.informed_power,
        )
        # Warmup with the FULL generation count: the superblock dispatch
        # compiles per distinct blocks-per-dispatch size, so a short
        # warmup would leave a fresh compile inside the timed run.
        mcmc_sample(
            jax.random.PRNGKey(1), leaves, 4,
            n_generations=args.generations, **common,
        )
        t0 = time.perf_counter()
        res = mcmc_sample(
            jax.random.PRNGKey(2), leaves, 4,
            n_generations=args.generations, **common,
        )
        dt = time.perf_counter() - t0

        n_total = args.runs * args.chains
        n_nbr = 2 * (args.leaves - 2)
        evals_per_gen = n_total * (
            args.branch_moves
            + (2 * n_nbr if proposal == "informed" else 1)
        )
        print(
            json.dumps(
                {
                    "backend": jax.default_backend(),
                    "leaves": args.leaves,
                    "sites": args.sites,
                    "chains_total": n_total,
                    "proposal": proposal,
                    "informed_power": (
                        args.informed_power if proposal == "informed" else None
                    ),
                    "generations_per_s": round(args.generations / dt, 2),
                    "tree_evals_per_s": round(
                        args.generations * evals_per_gen / dt
                    ),
                    "ess_lnl": round(res.ess_lnl, 1),
                    "ess_per_s": round(res.ess_lnl / dt, 3),
                    "seconds": round(dt, 2),
                    "acceptance": {
                        k: round(v, 3) for k, v in res.acceptance.items()
                    },
                }
            )
        )


if __name__ == "__main__":
    main()
