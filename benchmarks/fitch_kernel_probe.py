"""Fitch row-walk kernels (``ops.fitch_pallas``) against XLA's lax versions.

Needs a GPU. Three parts, each chosen by a flag:

  --sweep      site-block sweep of both kernels against the lax path, each
               output checked for exact equality: candidate scoring at
               64 x 1024 x 2048 and 1024 x 1024 x 256 (taxa x sites x
               trees), one insertion at 2048 x 4096 and 1024 x 1024;
  --trace      one profiler trace of the lax insertion delta
               (``search.stepwise.insertion_delta_lax``) at 2048 x 4096,
               printing the device ops by count and summed time;
  --stepwise N L
               the whole ``stepwise_addition`` on a simulated N x L
               alignment, kernel then lax (the dispatcher forced to its
               CPU branch) then kernel again; the lax pass at 2048 x 4096
               takes about seven minutes on an H100.

Times are best and median of repeated calls after one compiling call.

    python benchmarks/fitch_kernel_probe.py --sweep --trace [--trace-dir D]
    python benchmarks/fitch_kernel_probe.py --stepwise 1024 1024
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from trex_tpu.ops import dispatch  # noqa: E402
from trex_tpu.ops import fitch_pallas as fp  # noqa: E402
from trex_tpu.ops.fitch import fitch_score  # noqa: E402
from trex_tpu.search.stepwise import insertion_delta_lax  # noqa: E402
from trex_tpu.topology import random_topologies  # noqa: E402

SCORING = ((64, 1024, 2048), (1024, 1024, 256))  # taxa, sites, trees
INSERTION = ((2048, 4096), (1024, 1024))  # taxa, sites
TRACE = (2048, 4096)


def _time(fn, reps: int = 5):
    out = jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, min(times) * 1e3, float(np.median(times)) * 1e3


def _insertion_inputs(n: int, length: int):
    """A pruned variant (leaf 5 dissolved) and its flagless up sets."""
    rng = np.random.default_rng(0)
    topo = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(jax.random.PRNGKey(7), n, 1)
    )
    masks = 1 << rng.integers(0, 4, (n, length)).astype(np.int32)
    t = 5
    children = np.asarray(topo.children)
    q_row = int(np.asarray(topo.parents)[t]) - n
    sib = int(children[q_row].sum() - t)
    var = children.copy()
    var[q_row] = (sib, sib)
    up = np.zeros((2 * n - 1, length), np.int32)
    up[:n] = masks
    for a in range(n - 1):
        c0, c1 = var[a]
        inter = up[c0] & up[c1]
        up[n + a] = np.where(inter == 0, up[c0] | up[c1], inter)
    weights = jnp.asarray(rng.integers(1, 4, length).astype(np.float32))
    return jnp.asarray(var), jnp.asarray(up), t, weights


def sweep() -> None:
    lax_scores = jax.jit(jax.vmap(fitch_score, in_axes=(0, None)))
    for n, length, batch in SCORING:
        topos = random_topologies(jax.random.PRNGKey(0), n, batch)
        leaf = jax.random.randint(jax.random.PRNGKey(1), (n, length), 0, 4)
        want, best, med = _time(lambda: lax_scores(topos, leaf), reps=3)
        print(f"fitch lax {n}x{length}x{batch}: best {best:.3f} ms "
              f"median {med:.3f} ms", flush=True)
        for block in (32, 64, 128, 256):
            got, best, med = _time(lambda: fp._fitch_scores(
                topos, leaf, None, sequences_are_masks=False,
                site_block=block, table_budget=fp.TABLE_BUDGET_BYTES,
                interpret=False,
            ))
            exact = bool(np.array_equal(np.asarray(got), np.asarray(want)))
            print(f"  kernel block {block}: best {best:.3f} ms median "
                  f"{med:.3f} ms exact={exact}", flush=True)
    lax_delta = jax.jit(insertion_delta_lax)
    for n, length in INSERTION:
        var, up, t, weights = _insertion_inputs(n, length)
        want, best, med = _time(lambda: lax_delta(var, up, up[t], weights), 3)
        print(f"insertion lax {n}x{length}: best {best:.3f} ms median "
              f"{med:.3f} ms", flush=True)
        for block in (16, 32, 64, 128):
            got, best, med = _time(lambda: fp._insertion_delta(
                var, up, jnp.int32(t), weights, n_leaves=n,
                site_block=block, interpret=False,
            ))
            exact = bool(np.array_equal(np.asarray(got), np.asarray(want)))
            print(f"  kernel block {block}: best {best:.3f} ms median "
                  f"{med:.3f} ms exact={exact}", flush=True)


def trace(trace_dir: str) -> None:
    var, up, t, weights = _insertion_inputs(*TRACE)
    lax_delta = jax.jit(insertion_delta_lax)
    jax.block_until_ready(lax_delta(var, up, up[t], weights))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(lax_delta(var, up, up[t], weights))
    path = sorted(glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    ))[-1]
    count, ns = Counter(), Counter()
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                for ev in line.events:
                    count[ev.name] += 1
                    ns[ev.name] += ev.duration_ns
    print(f"lax insertion delta {TRACE[0]}x{TRACE[1]}, one call, device "
          f"ops ({path}):",
          flush=True)
    for name, c in count.most_common(10):
        print(f"  {c:7d} x  {ns[name] / 1e6:9.3f} ms  {name[:100]}", flush=True)


def stepwise(n: int, length: int) -> None:
    from trex_tpu.cli.parser import main as cli_main
    from trex_tpu.io import parse_fasta_masks
    from trex_tpu.search.stepwise import stepwise_addition

    aln = os.path.join(tempfile.mkdtemp(), "a.fasta")
    with contextlib.redirect_stderr(io.StringIO()):
        cli_main(["simulate", "--leaves", str(n), "--sites", str(length),
                  "--model", "gtr+g", "--seed", "2", "--output", aln])
    with open(aln) as fh:
        _, masks = parse_fasta_masks(fh.read())
    masks = np.asarray(masks, np.int32)
    real = dispatch._platform
    trees = []
    try:
        for mode in ("kernel", "lax", "kernel"):
            jax.clear_caches()
            dispatch._platform = real if mode == "kernel" else (lambda: "cpu")
            t0 = time.perf_counter()
            topo, score = stepwise_addition(
                masks, 4, sequences_are_masks=True, seed=0
            )
            print(f"stepwise {mode} {n}x{length}: "
                  f"{time.perf_counter() - t0:.3f} s incl. compile, "
                  f"score {score}", flush=True)
            trees.append(np.asarray(topo.children))
    finally:
        dispatch._platform = real
    print("same tree:", all(np.array_equal(trees[0], c) for c in trees),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--stepwise", nargs=2, type=int, metavar=("N", "L"))
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    if args.sweep:
        sweep()
    if args.trace:
        trace(args.trace_dir or tempfile.mkdtemp())
    if args.stepwise:
        stepwise(*args.stepwise)
    return 0


if __name__ == "__main__":
    sys.exit(main())
