"""A/B: ``infer --start diff`` vs ``--start random`` end to end on the GPU.

The measurement bar: does the differentiable coarse
initializer (8 vmapped joint-relaxation restarts -> project -> best exact
score, ``cli/_common.py::_start_tree('diff')``) beat a random start on
end-to-end wall time to an equal final score at 128 taxa?

Both arms run the REAL CLI handler (``trex_tpu.cli.main``) in one process
(one JAX process per card, CLAUDE.md). A
throwaway ``--rounds 1`` warmup pays the hill-climb/scan compile for the
128-taxa shape so neither timed arm carries it; the diff arm's own
relaxation compile stays INSIDE its timed run (charged against diff —
conservative). Prints one JSON line per arm.

Usage: python benchmarks/diff_start_ab.py [--taxa 128] [--sites 1024]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_infer(fasta: str, start: str, seed: int, *extra: str) -> dict:
    from trex_tpu.cli.parser import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main([
            "infer", "--fasta", fasta, "--start", start,
            "--seed", str(seed), "--criterion", "parsimony", *extra,
        ])
    wall = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {
        "start": start,
        "seed": seed,
        "wall_s": round(wall, 2),
        "score": out["parsimony_score"],
        "rounds": out.get("rounds"),
    }


def main_ab() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=128)
    ap.add_argument("--sites", type=int, default=1024)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument(
        "--starts", nargs="+", default=["random", "diff"],
        help="start strategies to A/B (e.g. random diff stepwise)",
    )
    args = ap.parse_args()

    from trex_tpu.cli.parser import main as cli_main

    fasta = f"/tmp/ab_{args.taxa}x{args.sites}.fasta"
    if not os.path.exists(fasta):
        cli_main([
            "simulate", "--leaves", str(args.taxa), "--sites",
            str(args.sites), "--seed", "7", "--output", fasta,
        ])

    # Warmup: a single-round run pays the SPR-scan + scoring compiles for
    # this shape without the cost of a full climb.
    warm = run_infer(fasta, "random", 99, "--rounds", "1")
    print(json.dumps({"warmup": warm}), flush=True)

    for seed in args.seeds:
        for start in args.starts:
            print(json.dumps(run_infer(fasta, start, seed)), flush=True)


if __name__ == "__main__":
    main_ab()
