#!/usr/bin/env python3
"""Drive trex_tpu's main path once on one GPU and check it against references.

    python chip_smoke.py            # every one-card phase (needs one GPU)
    python chip_smoke.py --cards 4  # only the mesh phase (needs four GPUs)

One process does everything; every CLI phase goes through
``trex_tpu.cli.parser.main(argv)``, as ``python -m trex_tpu.cli`` would.
Data comes from seeds. One line per phase gives its wall time with the
compile time apart, the process's ``peak_bytes_in_use`` so far, and the
comparison with the plain reference (tolerance and precision). The last
line is one JSON object naming the device. Any failed phase or comparison
exits non-zero without that line, and so does a run that finds no GPU.

Phases (one card):
  simulate   1024 taxa x 1024 sites, GTR+G;
  parsimony  ``infer`` (stepwise start + analytic SPR-scan climb); the final
             tree re-scored by the lax min-plus ``ops.sankoff.sankoff_score``
             (independent of Fitch) must equal the reported score exactly;
  ml         ``infer --criterion ml --model gtr+g`` on 256 x 2048; the
             reported lnL recomputed by ``ops.likelihood`` on the output tree
             with its lengths and model, relative 1e-5 in float32;
  scoring    ``ops.dispatch.batched_scores_fastest`` at 64 x 1024 x 2048 trees
             and 1024 x 1024 x 256 trees; the Fitch kernel against the lax
             Fitch, exactly;
  stepwise   ``stepwise_addition`` at 2048 x 4096, its score against Sankoff,
             and the insertion kernel against ``insertion_delta_lax`` on one
             insertion, exactly.

With ``--cards 4``: ``infer --mesh auto`` (2 x 2 tree x site mesh) against
``--mesh 1,1`` on the same alignments, parsimony with the SPR-scan climb and
with the enumerating NNI climb (whose candidate batches the Fitch kernel
scores inside ``shard_map`` on the mesh) (same tree and score each), ML
(lnL, relative 1e-5), and the collective time of one traced sharded SPR
scan. To spend four cards only on what the mesh changes, these runs take
one stepwise order and one climb round, and the ML pair ranks and fits JC:
the GTR+G model fit runs on one device in both arms.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


# Sizes: (taxa, sites[, trees]) of each phase.
PARSIMONY = (1024, 1024)
ML = (256, 2048)
SCORING = ((64, 1024, 2048), (1024, 1024, 256))
STEPWISE = (2048, 4096)
ROUNDS = "2"  # SPR-scan climb rounds per infer
MESH_ARGS = ["--rounds", "1", "--orders", "1"]  # per infer, --cards 4


class PhaseFailed(RuntimeError):
    pass


_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_secs = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_secs[0] += duration


def _peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", -1))


@contextlib.contextmanager
def phase(name: str, size: str, results: list):
    """Time one phase; the body appends its comparison text to ``note``."""
    note: list[str] = []
    c0 = _compile_secs[0]
    t0 = time.perf_counter()
    try:
        yield note
    except Exception as exc:  # report, then fail the run
        print(f"phase {name} [{size}]: FAILED {type(exc).__name__}: {exc}",
              flush=True)
        results.append((name, False))
        raise
    wall = time.perf_counter() - t0
    comp = _compile_secs[0] - c0
    print(
        f"phase {name} [{size}]: wall {wall:.3f} s (compile {comp:.3f} s, "
        f"run {wall - comp:.3f} s) peak_bytes_in_use {_peak_bytes()} | "
        + "; ".join(note),
        flush=True,
    )
    results.append((name, True))


def cli(argv: list[str]) -> dict:
    """Run one CLI command in-process; return its JSON result line.

    Commands print it on stdout, or on stderr when stdout may carry data.
    """
    from trex_tpu.cli.parser import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    text = out.getvalue() + "\n" + err.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if not lines:
        raise PhaseFailed(f"no JSON result from {argv[0]}")
    return json.loads(lines[-1])


def simulate(n_taxa: int, n_sites: int, seed: int, path: str) -> None:
    cli(["simulate", "--leaves", str(n_taxa), "--sites", str(n_sites),
         "--model", "gtr+g", "--seed", str(seed), "--output", path])


def require(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def load_tree_and_leaves(tree_path: str, fasta_path: str):
    """Output tree + alignment masks with rows in the tree's leaf order."""
    from trex_tpu.io import load_newick, parse_fasta_masks

    with open(tree_path) as fh:
        topo, blens, tree_names = load_newick(fh.read())
    with open(fasta_path) as fh:
        names, masks = parse_fasta_masks(fh.read())
    require(sorted(tree_names) == sorted(names), "tree taxa != alignment taxa")
    order = [names.index(n) for n in tree_names]
    return topo, np.asarray(blens, np.float32), np.asarray(masks)[order]


def sankoff_rescore(tree_path: str, fasta_path: str) -> float:
    import jax.numpy as jnp

    from trex_tpu.ops.sankoff import sankoff_score
    from trex_tpu.types import CostModel

    topo, _, leaves = load_tree_and_leaves(tree_path, fasta_path)
    return float(
        sankoff_score(
            topo, CostModel.hamming(4).matrix, jnp.asarray(leaves),
            sequences_are_masks=True,
        )
    )


def ml_recompute(tree_path: str, fasta_path: str, out: dict) -> float:
    """lnL of the output tree, its lengths and the reported GTR+G model."""
    import jax.numpy as jnp

    from trex_tpu.ops.likelihood import tree_log_likelihood_gamma

    topo, blens, leaves = load_tree_and_leaves(tree_path, fasta_path)
    return float(
        tree_log_likelihood_gamma(
            topo, jnp.asarray(blens), jnp.asarray(leaves), 4,
            gamma_shape=float(out["gamma_shape"]), n_categories=4,
            rates=jnp.asarray(out["gtr_rates"], jnp.float32),
            freqs=jnp.asarray(out["base_frequencies"], jnp.float32),
            sequences_are_masks=True,
        )
    )


def timed(fn, reps: int = 3) -> tuple[object, float]:
    """Result and best wall time of ``reps`` calls after one warm-up."""
    import jax

    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


def random_batch(n_leaves: int, length: int, batch: int, seed: int):
    import jax

    from trex_tpu.topology import random_topologies

    topos = random_topologies(jax.random.PRNGKey(seed), n_leaves, batch)
    leaves = jax.random.randint(
        jax.random.PRNGKey(seed + 1), (n_leaves, length), 0, 4
    )
    return topos, leaves


def pruned_variant(children: np.ndarray, masks: np.ndarray, t: int):
    """Children and flagless up sets of a tree with leaf ``t`` pruned."""
    n = masks.shape[0]
    parents = np.zeros(2 * n - 1, np.int64)
    for a, (c0, c1) in enumerate(children):
        parents[c0] = parents[c1] = n + a
    row = parents[t] - n
    sib = int(children[row].sum() - t)
    var = children.copy()
    var[row] = (sib, sib)
    up = np.zeros((2 * n - 1, masks.shape[1]), np.int32)
    up[:n] = masks
    for a, (c0, c1) in enumerate(var):
        inter = up[c0] & up[c1]
        up[n + a] = np.where(inter == 0, up[c0] | up[c1], inter)
    return var, up


def one_card(work: str, results: list) -> None:
    import jax
    import jax.numpy as jnp

    from trex_tpu.ops.dispatch import batched_scores_fastest
    from trex_tpu.ops.fitch import fitch_score
    from trex_tpu.ops.fitch_pallas import insertion_delta_pallas
    from trex_tpu.search.stepwise import insertion_delta_lax, stepwise_addition
    from trex_tpu.types import CostModel

    n_taxa, n_sites = PARSIMONY
    aln = os.path.join(work, "aln_pars.fasta")
    with phase("simulate", f"{n_taxa} taxa x {n_sites} sites, gtr+g",
               results) as note:
        simulate(n_taxa, n_sites, 0, aln)
        require(os.path.getsize(aln) > n_taxa * n_sites, "alignment too small")
        note.append("alignment written")

    tree = os.path.join(work, "pars.nwk")
    with phase("parsimony", f"infer {n_taxa} x {n_sites}, stepwise + "
               "spr-scan", results) as note:
        out = cli(["infer", "--alignment", aln, "--rounds", ROUNDS,
                   "--output-tree", tree])
        ref = sankoff_rescore(tree, aln)
        got = float(out["parsimony_score"])
        note.append(
            f"score {got} vs lax min-plus sankoff_score {ref} "
            "(tolerance exact, float32 integer-valued sums)"
        )
        require(np.isfinite(got) and got == ref, "parsimony score != Sankoff")

    aln_ml = os.path.join(work, "aln_ml.fasta")
    tree_ml = os.path.join(work, "ml.nwk")
    with phase("ml", f"infer {ML[0]} x {ML[1]}, gtr+g", results) as note:
        simulate(*ML, 1, aln_ml)
        out = cli(["infer", "--alignment", aln_ml, "--criterion", "ml",
                   "--model", "gtr+g", "--rounds", ROUNDS,
                   "--output-tree", tree_ml])
        got = -float(out["neg_log_likelihood"])
        ref = ml_recompute(tree_ml, aln_ml, out)
        rel = abs(got - ref) / abs(ref)
        note.append(
            f"lnL {got:.4f} vs ops.likelihood {ref:.4f}, rel {rel:.2e} "
            "(tolerance rel 1e-5, float32, matmul precision highest)"
        )
        require(np.isfinite(got) and rel <= 1e-5, "lnL off the reference")

    hamming = CostModel.hamming(4).matrix
    lax_fitch = jax.jit(jax.vmap(fitch_score, in_axes=(0, None)))
    for n_leaves, length, batch in SCORING:
        size = f"{n_leaves} taxa x {length} sites x {batch} trees"
        with phase("scoring", size, results) as note:
            topos, leaves = random_batch(n_leaves, length, batch, seed=3)
            got, t_kernel = timed(
                lambda: batched_scores_fastest(topos, hamming, leaves)
            )
            ref, t_lax = timed(lambda: lax_fitch(topos, leaves))
            got, ref = np.asarray(got), np.asarray(ref)
            note.append(
                f"Fitch kernel {t_kernel * 1e3:.3f} ms vs lax "
                f"{t_lax * 1e3:.3f} ms; {batch} scores vs lax Fitch "
                "(tolerance exact, float32 integer-valued sums)"
            )
            require(got.shape == (batch,) and np.isfinite(got).all(),
                    "bad score shape")
            require(np.array_equal(got, ref), "Fitch kernel != lax Fitch")

    aln_sw = os.path.join(work, "aln_sw.fasta")
    with phase("stepwise", f"{STEPWISE[0]} taxa x {STEPWISE[1]} sites",
               results) as note:
        from trex_tpu.io import parse_fasta_masks
        from trex_tpu.ops.sankoff import sankoff_score

        simulate(*STEPWISE, 2, aln_sw)
        with open(aln_sw) as fh:
            _, masks = parse_fasta_masks(fh.read())
        masks = np.asarray(masks, np.int32)
        t0 = time.perf_counter()
        topo, score = stepwise_addition(
            masks, 4, sequences_are_masks=True, seed=0
        )
        t_sw = time.perf_counter() - t0
        ref = float(
            sankoff_score(topo, hamming, jnp.asarray(masks),
                          sequences_are_masks=True)
        )
        note.append(
            f"stepwise_addition {t_sw:.3f} s; score {score} vs lax min-plus "
            f"sankoff_score {ref} (tolerance exact, float32 integer sums)"
        )
        require(score == ref, "stepwise score != Sankoff")
        var, up = pruned_variant(np.asarray(topo.children), masks, t=5)
        weights = jnp.asarray(
            np.random.default_rng(4).integers(1, 4, masks.shape[1]),
            jnp.float32,
        )
        var_d, up_d = jnp.asarray(var), jnp.asarray(up)
        got, t_kernel = timed(
            lambda: insertion_delta_pallas(
                var_d, up_d, jnp.int32(5), weights, n_leaves=masks.shape[0]
            )
        )
        lax_delta = jax.jit(insertion_delta_lax)
        ref, t_lax = timed(lambda: lax_delta(var_d, up_d, up_d[5], weights), 1)
        note.append(
            f"insertion kernel {t_kernel * 1e3:.3f} ms vs lax "
            f"{t_lax * 1e3:.3f} ms per insertion; deltas vs lax "
            "(tolerance exact, float32 integer weights)"
        )
        require(np.array_equal(np.asarray(got), np.asarray(ref)),
                "insertion kernel != lax")


def collective_seconds(trace_dir: str) -> tuple[float, int]:
    """Device time of collective ops in one trace, and their count."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    require(bool(paths), "no profiler trace written")
    data = jax.profiler.ProfileData.from_file(paths[0])
    keys = ("all-reduce", "all-gather", "all_reduce", "all_gather",
            "collective", "nccl", "reduce-scatter", "all-to-all")
    total, count = 0, 0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if any(k in ev.name.lower() for k in keys):
                    total += ev.duration_ns
                    count += 1
    return total / 1e9, count


def four_cards(work: str, results: list) -> None:
    import jax
    import jax.numpy as jnp

    from trex_tpu.cli._common import _load_alignment
    from trex_tpu.io import load_newick
    from trex_tpu.parallel.mesh import make_mesh
    from trex_tpu.parallel.sharded import sharded_spr_scan

    require(len(jax.devices()) == 4, "--cards 4 needs four devices")
    aln = os.path.join(work, "aln_pars.fasta")
    simulate(*PARSIMONY, 0, aln)
    runs = {}
    for mesh in ("auto", "1,1"):
        tree = os.path.join(work, f"pars_{mesh}.nwk")
        with phase(f"parsimony_mesh_{mesh}",
                   f"infer {PARSIMONY[0]} x {PARSIMONY[1]}", results) as note:
            out = cli(["infer", "--alignment", aln, *MESH_ARGS,
                       "--mesh", mesh, "--output-tree", tree])
            note.append(f"score {out['parsimony_score']} mesh "
                        f"{out.get('mesh', 'single device')}")
        runs[mesh] = out
    with phase("parsimony_compare", "mesh auto vs 1,1", results) as note:
        same_tree = runs["auto"]["tree"] == runs["1,1"]["tree"]
        a, b = runs["auto"]["parsimony_score"], runs["1,1"]["parsimony_score"]
        note.append(f"score {a} vs {b} (tolerance exact), same tree "
                    f"{same_tree}")
        require(a == b and same_tree, "mesh parsimony differs")

    for mesh in ("auto", "1,1"):
        with phase(f"nni_mesh_{mesh}",
                   f"infer {PARSIMONY[0]} x {PARSIMONY[1]}, nni", results) as note:
            out = cli(["infer", "--alignment", aln, *MESH_ARGS,
                       "--neighborhood", "nni", "--mesh", mesh])
            note.append(f"score {out['parsimony_score']} mesh "
                        f"{out.get('mesh', 'single device')}")
        runs["nni_" + mesh] = out
    with phase("nni_compare", "mesh auto vs 1,1", results) as note:
        same_tree = runs["nni_auto"]["tree"] == runs["nni_1,1"]["tree"]
        a = runs["nni_auto"]["parsimony_score"]
        b = runs["nni_1,1"]["parsimony_score"]
        note.append(f"score {a} vs {b} (tolerance exact), same tree "
                    f"{same_tree}")
        require(a == b and same_tree, "mesh NNI parsimony differs")

    aln_ml = os.path.join(work, "aln_ml.fasta")
    simulate(*ML, 1, aln_ml)
    for mesh in ("auto", "1,1"):
        with phase(f"ml_mesh_{mesh}", f"infer {ML[0]} x {ML[1]}, jc",
                   results) as note:
            out = cli(["infer", "--alignment", aln_ml, "--criterion", "ml",
                       "--model", "jc", *MESH_ARGS, "--mesh", mesh])
            note.append(f"lnL {-out['neg_log_likelihood']:.4f}")
        runs["ml_" + mesh] = out
    with phase("ml_compare", "mesh auto vs 1,1", results) as note:
        a = runs["ml_auto"]["neg_log_likelihood"]
        b = runs["ml_1,1"]["neg_log_likelihood"]
        rel = abs(a - b) / abs(b)
        same_tree = runs["ml_auto"]["tree"] == runs["ml_1,1"]["tree"]
        note.append(f"lnL rel {rel:.2e} (tolerance rel 1e-5, float32), "
                    f"same tree {same_tree}")
        require(rel <= 1e-5, "mesh lnL differs")

    with phase("collectives", "one sharded SPR scan, 2 x 2 mesh",
               results) as note:
        names, masks, _ = _load_alignment(aln, "dna")
        with open(os.path.join(work, "pars_auto.nwk")) as fh:
            topo, _, tree_names = load_newick(fh.read())
        leaves = jnp.asarray(masks[[names.index(n) for n in tree_names]])
        mesh = make_mesh()

        def scan():
            return sharded_spr_scan(mesh, topo, leaves,
                                    sequences_are_masks=True)

        # The mesh infer above compiled this scan; the trace measures it.
        trace_dir = os.path.join(work, "trace")
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(scan())
        wall = time.perf_counter() - t0
        secs, count = collective_seconds(trace_dir)
        note.append(f"mesh {dict(mesh.shape)}: {count} collective ops, "
                    f"{secs * 1e3:.3f} ms device time in a {wall:.3f} s "
                    "traced scan (summed over the 4 devices)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args()

    import jax

    from trex_tpu.io import native
    from trex_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(
        f"jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}; "
        f"native library loaded: {native.available()}; compile cache "
        f"{enable_compile_cache()}",
        flush=True,
    )
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    results: list = []
    try:
        (four_cards if args.cards == 4 else one_card)(work, results)
    except Exception as exc:
        print(f"FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    banned = [m for m in ("orbax", "jaxtyping", "matplotlib")
              if any(k == m or k.startswith(m + ".") for k in sys.modules)]
    if banned:
        print(f"FAILED: main path imported {banned}", file=sys.stderr)
        return 1
    if not results or not all(ok for _, ok in results):
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
