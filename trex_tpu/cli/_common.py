"""Shared helpers for the CLI command modules."""

from __future__ import annotations

import argparse

import jax

def _make_cli_mesh(spec: str | None, divides: int | None = None):
    """Build a ('tree', 'site') mesh from a ``--mesh T,S`` CLI spec.

    ``"T,S"`` = explicit axis sizes (T*S must equal the addressable device
    count); ``"auto"`` = the ``make_mesh`` heuristic over all devices;
    ``"1,1"`` = explicit single-device opt-out. None (no flag) defaults to
    ``auto`` whenever MORE than one device is addressable — a pod user gets
    the sharded drivers without knowing the flag (safe: the mesh paths are
    bit-identical to single-device, tests/test_sharding.py) — and to
    single-device otherwise.

    ``divides``: when given (drivers that shard a fixed batch axis without
    padding, e.g. the MCMC's runs x chains), 'auto' picks the LARGEST tree
    axis dividing both the device count and ``divides`` instead of the
    balanced heuristic, so the implicit default never trips the driver's
    divisibility check.
    """
    if spec == "1,1":
        return None
    if spec is None:
        if len(jax.devices()) <= 1:
            return None
        spec = "auto"
    from trex_tpu.parallel.mesh import make_mesh

    if spec == "auto":
        if divides is not None:
            n = len(jax.devices())
            t = max(
                t for t in range(1, n + 1)
                if n % t == 0 and divides % t == 0
            )
            return make_mesh(tree_parallelism=t)
        return make_mesh()
    try:
        t_str, s_str = spec.split(",")
        t, s = int(t_str), int(s_str)
    except ValueError:
        raise SystemExit(f"--mesh wants 'T,S' or 'auto', got {spec!r}")
    n = len(jax.devices())
    if t * s != n:
        raise SystemExit(
            f"--mesh {t},{s}: {t}*{s} != {n} addressable devices"
        )
    return make_mesh(tree_parallelism=t)


def _add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--mesh", type=str, default=None, metavar="T,S",
        help="shard work over a ('tree','site') device mesh: T,S axis "
        "sizes (product = device count), 'auto', or '1,1' to force single "
        "device. Default: auto when >1 device is addressable, else single",
    )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--leaves", type=int, default=16)
    p.add_argument("--sites", type=int, default=128)
    p.add_argument("--states", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-file", type=str, default=None)


def _load_alignment(path: str, alphabet_name: str):
    """Read an alignment -> (names, (n, L) int32 state-set masks, n_states).

    Format auto-detected: NEXUS (``#NEXUS`` header), PHYLIP (numeric
    ``ntax nchar`` header), else FASTA. Always encodes through the
    ambiguity-preserving path so gaps and IUPAC codes get standard
    missing-data semantics.
    """
    import numpy as np

    from trex_tpu.io import (
        DNA,
        PROTEIN,
        encode_alignment_masks,
        parse_fasta_masks,
        parse_nexus,
        parse_phylip,
    )

    alphabet = {"dna": DNA, "protein": PROTEIN}[alphabet_name]
    with open(path) as fh:
        text = fh.read()
    head = text.lstrip()[:40].lower()
    if head.startswith("#nexus"):
        names, rows, _ = parse_nexus(text)
        if rows is None:
            raise SystemExit(f"{path}: NEXUS file has no DATA/CHARACTERS block")
        masks = encode_alignment_masks(rows, alphabet)
    elif head.split()[:2] and head.split()[0].isdigit():
        names, rows = parse_phylip(text)
        masks = encode_alignment_masks(rows, alphabet)
    else:
        names, masks = parse_fasta_masks(text, alphabet)
    return names, np.asarray(masks, dtype=np.int32), len(alphabet)


def _outgroup_indices(names: list[str], outgroup: str) -> list[int]:
    """Resolve a comma-separated outgroup name list to leaf indices."""
    wanted = [s.strip() for s in outgroup.split(",") if s.strip()]
    missing = [w for w in wanted if w not in names]
    if missing:
        raise SystemExit(f"outgroup taxa not in the alignment: {missing}")
    return [names.index(w) for w in wanted]


def _start_tree(kind: str, masks, n_states: int, seed: int, weights, orders: int):
    """Build the requested starting topology from (possibly ambiguous) leaves."""
    import numpy as np

    from trex_tpu.search.nj import nj_start_tree
    from trex_tpu.search.stepwise import stepwise_addition_multi
    from trex_tpu.topology import balanced_topology, random_topologies

    n_leaves = masks.shape[0]
    if kind == "stepwise":
        topo, _ = stepwise_addition_multi(
            masks, n_states, n_orders=orders, seed=seed,
            sequences_are_masks=True, site_weights=weights,
        )
        return topo
    if kind in ("nj", "upgma"):
        # Distance matrices want integer states; resolve ambiguity to the
        # lowest allowed state (heuristic — the search refines from here).
        ints = np.zeros_like(masks)
        lsb = masks & -masks
        for b in range(n_states):
            ints[lsb == (1 << b)] = b
        topo, _ = nj_start_tree(ints, n_states, weights, method=kind)
        return topo
    if kind == "random":
        return jax.tree_util.tree_map(
            lambda x: x[0], random_topologies(jax.random.key(seed), n_leaves, 1)
        )
    if kind == "balanced":
        if n_leaves & (n_leaves - 1):
            raise SystemExit(
                f"--start balanced needs a power-of-two taxon count, got {n_leaves}"
            )
        return balanced_topology(n_leaves)
    if kind == "diff":
        # Differentiable coarse initializer (the reference's signature
        # capability, /root/reference/src/trex/tree.py:50-107): 8 vmapped
        # joint-relaxation restarts -> project to valid trees -> best
        # exact score — a fast basin-finder for the discrete refinement
        # that follows.
        import jax.numpy as jnp

        from trex_tpu.ops.dispatch import batched_scores_fastest
        from trex_tpu.ops.relax import project_topology, soft_topology
        from trex_tpu.search.joint import (
            JointConfig,
            init_params,
            joint_optimize,
        )
        from trex_tpu.types import CostModel

        n_all = 2 * n_leaves - 1
        length = masks.shape[1]
        restarts = 8
        # The relaxation wants one-hot leaves: resolve ambiguity to the
        # lowest allowed state (same heuristic as the distance starts; the
        # exact ranking below uses the true masks).
        ints = np.zeros_like(masks)
        lsb = masks & -masks
        for b in range(n_states):
            ints[lsb == (1 << b)] = b
        leaf_tensor = jnp.zeros((n_all, length, n_states))
        leaf_tensor = leaf_tensor.at[:n_leaves].set(
            jax.nn.one_hot(jnp.asarray(ints), n_states)
        )
        cfg = JointConfig(n_iterations=600)

        def one_restart(key):
            k_init, k_run = jax.random.split(key)
            params = init_params(k_init, n_leaves, length, n_states)
            params, _ = joint_optimize(k_run, params, leaf_tensor, cfg)
            return params

        keys = jax.random.split(jax.random.key(seed), restarts)
        params_b = jax.jit(jax.vmap(one_restart))(keys)
        proj = jax.jit(
            jax.vmap(
                lambda p, k: project_topology(
                    soft_topology(k, p["tree_params"], 0.01)
                )
            )
        )
        topos = proj(
            params_b, jax.random.split(jax.random.key(seed + 1), restarts)
        )
        cost = CostModel.hamming(n_states).matrix
        scores = batched_scores_fastest(
            topos, cost, jnp.asarray(masks), site_weights=weights,
            sequences_are_masks=True,
        )
        best = int(np.argmin(np.asarray(scores)))
        return jax.tree_util.tree_map(lambda x: x[best], topos)
    raise SystemExit(f"unknown --start {kind!r}")
