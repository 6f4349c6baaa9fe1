"""Scaling-efficiency harness: trees/s vs device count on one mesh.

Usage (real GPUs or virtual CPU devices):

    # 8-way virtual CPU mesh
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --leaves 64 --sites 1024 --batch 256

Measures batched candidate scoring on meshes of 1..N devices and reports
parallel efficiency (speedup / device count) as JSON lines — the "scaling
efficiency at N hosts" metric of BASELINE.md. Across hosts, run under
``jax.distributed`` (``trex_tpu.parallel.initialize_distributed``) and the
same mesh logic spans hosts; tree goes over the inter-host links, site
stays on NVLink.

NOTE: on a VIRTUAL CPU mesh (xla_force_host_platform_device_count) the
devices timeshare the same physical cores, so throughput cannot scale;
virtual-mesh runs validate sharded-program *correctness* only (see
tests/test_sharding.py). Real efficiency numbers require real GPUs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--leaves", type=int, default=64)
    parser.add_argument("--sites", type=int, default=1024)
    parser.add_argument("--states", type=int, default=4)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    from trex_tpu.parallel.mesh import make_mesh
    from trex_tpu.parallel.sharded import sharded_batch_scores
    from trex_tpu.topology import random_topologies
    from trex_tpu.types import CostModel
    from trex_tpu.utils.profiling import timed

    devices = jax.devices()
    topos = random_topologies(jax.random.PRNGKey(0), args.leaves, args.batch)
    cost = CostModel.hamming(args.states).matrix
    leaf = jax.random.randint(
        jax.random.PRNGKey(1), (args.leaves, args.sites), 0, args.states
    )

    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base_rate = None
    for n in counts:
        mesh = make_mesh(devices[:n])

        def run():
            return sharded_batch_scores(mesh, topos, cost, leaf)

        mean_s, _ = timed(run, reps=args.reps)
        rate = args.batch / mean_s
        if base_rate is None:
            base_rate = rate
        efficiency = rate / (base_rate * n)
        print(
            json.dumps(
                {
                    "devices": n,
                    "mesh": dict(mesh.shape),
                    "trees_per_s": round(rate, 1),
                    "speedup": round(rate / base_rate, 3),
                    "efficiency": round(efficiency, 3),
                }
            )
        )


if __name__ == "__main__":
    main()
