"""Scale-ceiling probe: stepwise + SPR-scan search at 2048-4096 taxa.

This probe pushes to 2048 and 4096 taxa x up-to-4k sites on one card and
records where the memory/chunking guards engage and what each phase costs.
Known guards exercised:

- ``search.hillclimb`` bounds the scan's peak set tensors to ~2 GB via
  ``prune_chunk`` (engages above ~1 GB full-scan footprint);
- ``ops.spr_scan`` pads chunks; stepwise's per-insertion scan is O(n L)
  per step.

Prints one JSON line per phase:
  {"phase": ..., "taxa": N, "sites": N, "seconds": N, ...}

Usage: python benchmarks/scale_probe.py --taxa 2048 --sites 4096
       [--start stepwise|nj] [--rounds 3]
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


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=2048)
    ap.add_argument("--sites", type=int, default=4096)
    ap.add_argument("--start", default="stepwise",
                    choices=["stepwise", "nj"])
    ap.add_argument("--rounds", type=int, default=3,
                    help="SPR-scan climb rounds to time (cap)")
    ap.add_argument("--branch-length", type=float, default=0.1)
    ap.add_argument("--budget-mb", type=int, default=2048,
                    help="SPR-scan working-set budget (MB)")
    ap.add_argument("--mesh", action="store_true",
                    help="route the climb through the mesh drivers over a "
                         "1x1 mesh on this chip (exercises the segmented "
                         "sharded_spr_scan path at scale)")
    ap.add_argument("--sim-device", default="auto",
                    choices=["auto", "host", "device"],
                    help="CTMC simulator path (device = the round-5 scan)")
    args = ap.parse_args()

    from trex_tpu.models.simulate import simulate_alignment
    from trex_tpu.search import parsimony_hill_climb, stepwise_addition
    from trex_tpu.search.nj import nj_start_tree
    from trex_tpu.search.ratchet import rf_distance_unrooted
    from trex_tpu.topology import random_topologies

    n, length = args.taxa, args.sites
    n_all = 2 * n - 1

    t0 = time.perf_counter()
    truth = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(0), n, 1)
    )
    sim_device = {"auto": None, "host": False, "device": True}[args.sim_device]
    aln = simulate_alignment(
        jax.random.PRNGKey(1), truth,
        np.full(n_all, args.branch_length, np.float32), n_sites=length,
        device=sim_device,
    )
    seqs = jnp.asarray(aln.astype(np.int32))
    emit(phase="simulate", taxa=n, sites=length, sim_path=args.sim_device,
         seconds=round(time.perf_counter() - t0, 1))

    t0 = time.perf_counter()
    if args.start == "stepwise":
        start, start_score = stepwise_addition(seqs, 4)
    else:
        start, _ = nj_start_tree(seqs, 4)
        start_score = -1.0
    emit(phase=f"start-{args.start}", taxa=n, sites=length,
         seconds=round(time.perf_counter() - t0, 1),
         score=float(start_score),
         rf_to_truth=int(rf_distance_unrooted(start, truth)))

    from trex_tpu.types import CostModel

    cost = CostModel.hamming(4).matrix
    mesh = None
    if args.mesh:
        from trex_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(jax.devices()[:1], tree_parallelism=1)
    t0 = time.perf_counter()
    res = parsimony_hill_climb(
        start, cost, seqs, max_rounds=args.rounds, neighborhood="spr-scan",
        scan_budget_bytes=args.budget_mb << 20, mesh=mesh,
    )
    dt = time.perf_counter() - t0
    emit(phase="spr-scan-climb", taxa=n, sites=length,
         mesh=bool(args.mesh),
         seconds=round(dt, 1), rounds=int(res.rounds),
         evals=int(res.evaluations),
         evals_per_s=round(res.evaluations / dt),
         score=float(res.score),
         rf_to_truth=int(rf_distance_unrooted(res.topology, truth)))


if __name__ == "__main__":
    main()
