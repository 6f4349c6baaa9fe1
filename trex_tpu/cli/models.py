"""Model-centric commands: partition, modeltest, dnds."""

from __future__ import annotations

import json

import jax.numpy as jnp

from trex_tpu.cli._common import _load_alignment

def cmd_partition(args) -> None:
    """Partitioned ML model fit: per-partition models, shared tree."""
    import numpy as np

    from trex_tpu.io import parse_partitions
    from trex_tpu.ops.likelihood import optimize_model_partitioned

    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    with open(args.partitions) as fh:
        pids, part_names, part_types = parse_partitions(
            fh.read(), int(masks.shape[1])
        )
    if args.tree:
        from trex_tpu.io import align_leaf_order, load_newick

        with open(args.tree) as fh:
            topo, _, tree_names = load_newick(fh.read())
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree and alignment taxa differ")
        topo = align_leaf_order(topo, tree_names, names)
    else:
        from trex_tpu.search.stepwise import stepwise_addition

        topo, _ = stepwise_addition(
            masks, n_states, sequences_are_masks=True, seed=args.seed
        )
    n_parts = len(part_names)
    models = (
        [m.strip() for m in args.models.split(",")]
        if args.models
        else [args.model] * n_parts
    )
    result, losses = optimize_model_partitioned(
        topo,
        jnp.asarray(masks),
        n_states,
        jnp.asarray(pids),
        models=models,
        linked=args.linked,
        n_iterations=args.iterations,
        sequences_are_masks=True,
    )
    search_rounds = None
    if args.search:
        # Partitioned tree search: the joint ranking matrix is the SUM of
        # per-partition analytic scans (each with its own fitted model and
        # proportional rate multiplier); refit on the winning topology.
        from trex_tpu.search.ml import ml_partitioned_scan_climb

        parts = []
        for p in range(n_parts):
            pp = result["partitions"][p]
            parts.append(
                dict(
                    leaf_sequences=jnp.asarray(masks[:, pids == p]),
                    rates=(
                        jnp.asarray(pp["rates"]) if "rates" in pp else None
                    ),
                    freqs=(
                        jnp.asarray(pp["freqs"]) if "freqs" in pp else None
                    ),
                    gamma_shape=(
                        float(pp["gamma_shape"])
                        if "gamma_shape" in pp
                        else None
                    ),
                    rate_multiplier=float(result["rate_multipliers"][p]),
                )
            )
        sr = ml_partitioned_scan_climb(
            topo, parts, n_states, sequences_are_masks=True
        )
        search_rounds = sr.rounds
        if (
            np.asarray(sr.topology.children).tobytes()
            != np.asarray(topo.children).tobytes()
        ):
            topo = sr.topology
            result, losses = optimize_model_partitioned(
                topo,
                jnp.asarray(masks),
                n_states,
                jnp.asarray(pids),
                models=models,
                linked=args.linked,
                n_iterations=args.iterations,
                sequences_are_masks=True,
            )
    out = {
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "linked": args.linked,
        # Sum of per-partition lnLs at the final parameters.
        "log_likelihood": float(
            sum(
                float(result["partitions"][p]["log_likelihood"])
                for p in range(n_parts)
            )
        ),
        "tree_length": float(
            np.asarray(result["branch_lengths"])[:-1].sum()
        ),
        "partitions": [],
    }
    if search_rounds is not None:
        out["search_rounds"] = search_rounds
    for p in range(n_parts):
        entry = {
            "name": part_names[p],
            "type": part_types[p],
            "model": models[p],
            "n_sites": int((pids == p).sum()),
            "rate_multiplier": round(
                float(result["rate_multipliers"][p]), 4
            ),
            "log_likelihood": float(
                result["partitions"][p]["log_likelihood"]
            ),
        }
        part_params = result["partitions"][p]
        if "gamma_shape" in part_params:
            entry["gamma_shape"] = round(float(part_params["gamma_shape"]), 4)
        if "freqs" in part_params:
            entry["frequencies"] = np.round(
                np.asarray(part_params["freqs"]), 4
            ).tolist()
        out["partitions"].append(entry)
    if args.output_tree:
        from trex_tpu.io import save_newick

        with open(args.output_tree, "w") as fh:
            fh.write(
                save_newick(
                    topo, names, np.asarray(result["branch_lengths"])
                )
                + "\n"
            )
        out["output_tree"] = args.output_tree
    print(json.dumps(out))
def cmd_modeltest(args) -> None:
    """Substitution-model selection by AIC/AICc/BIC on a fixed topology."""
    import numpy as np

    from trex_tpu.alignment import compress_alignment
    from trex_tpu.search.model_select import compare_models

    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    patterns, weights = compress_alignment(masks)
    if args.tree:
        from trex_tpu.io import align_leaf_order, load_newick

        with open(args.tree) as fh:
            topo, _, tree_names = load_newick(fh.read())
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree and alignment taxa differ")
        topo = align_leaf_order(topo, tree_names, names)
    else:
        from trex_tpu.search.stepwise import stepwise_addition

        topo, _ = stepwise_addition(
            masks, n_states, sequences_are_masks=True, seed=args.seed
        )
    fixed_rates = fixed_freqs = None
    models = tuple(m.strip() for m in args.models.split(",") if m.strip())
    if args.model_file:
        from trex_tpu.io import parse_paml_rates

        with open(args.model_file) as fh:
            fixed_rates, fixed_freqs = parse_paml_rates(fh.read(), n_states)
    fits = compare_models(
        topo,
        jnp.asarray(np.asarray(patterns), jnp.int32),
        n_states,
        models=models,
        criterion=args.criterion,
        site_weights=jnp.asarray(weights, jnp.float32),
        sequences_are_masks=True,
        n_iterations=args.iterations,
        fixed_rates=fixed_rates,
        fixed_freqs=fixed_freqs,
    )
    print(
        json.dumps(
            {
                "criterion": args.criterion,
                "best": fits[0].model,
                "n_taxa": len(names),
                "n_sites": int(masks.shape[1]),
                "table": [
                    {
                        "model": f.model,
                        "log_likelihood": round(f.log_likelihood, 3),
                        "n_parameters": f.n_parameters,
                        "aic": round(f.aic, 3),
                        "aicc": round(f.aicc, 3),
                        "bic": round(f.bic, 3),
                    }
                    for f in fits
                ],
            }
        )
    )
def cmd_dnds(args) -> None:
    """GY94 codon-model fit (dN/dS) on a coding nucleotide alignment."""
    import numpy as np

    from trex_tpu.alignment import compress_alignment
    from trex_tpu.io import save_newick
    from trex_tpu.models import codon as cd

    names, masks, n_states = _load_alignment(args.fasta, "dna")
    # Codon states want plain ints: single-bit mask -> base index, anything
    # ambiguous (gap/IUPAC multi-state) -> -1 so the whole codon goes missing.
    ints = np.full(masks.shape, -1, dtype=np.int32)
    for b in range(4):
        ints[masks == (1 << b)] = b
    codons = cd.encode_codons(ints, stops=args.stops)
    n_missing = int((codons < 0).sum())

    if args.tree:
        from trex_tpu.io import align_leaf_order, load_newick

        with open(args.tree) as fh:
            topo, _, tree_names = load_newick(fh.read())
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree and alignment taxa differ")
        topo = align_leaf_order(topo, tree_names, names)
        tree_source = args.tree
    else:
        from trex_tpu.search.stepwise import stepwise_addition

        topo, _ = stepwise_addition(
            masks, n_states, sequences_are_masks=True, seed=args.seed
        )
        tree_source = "stepwise addition (nucleotide parsimony)"

    freqs = cd.codon_frequencies(codons, mode=args.freqs, nuc_states=ints)
    patterns, weights = compress_alignment(codons)
    params, losses = cd.optimize_gy94(
        topo,
        jnp.asarray(patterns, jnp.int32),
        freqs=freqs,
        model=args.model,
        n_iterations=args.iterations,
        site_weights=jnp.asarray(weights, jnp.float32),
    )
    if args.search:
        # Codon-model tree search: rank SPR candidates under GY94 at the
        # fitted kappa/omega (the model-aware analytic scan works at Q=61
        # because GY94 is reversible: S_ij * pi_j generator), then refit
        # the full model on the winning topology.
        from trex_tpu.search.ml import ml_hill_climb

        s_matrix = cd.gy94_exchangeabilities(
            jnp.asarray(params["kappa"]), jnp.asarray(params["omega"])
        )
        result, _, _ = ml_hill_climb(
            topo,
            jnp.asarray(patterns, jnp.int32),
            cd.N_CODONS,
            neighborhood="spr-scan",
            site_weights=jnp.asarray(weights, jnp.float32),
            rates=jnp.asarray(s_matrix, jnp.float32),
            freqs=jnp.asarray(freqs, jnp.float32),
            optimize_final_lengths=False,
        )
        if (
            np.asarray(result.topology.children).tobytes()
            != np.asarray(topo.children).tobytes()
        ):
            topo = result.topology
            params, losses = cd.optimize_gy94(
                topo,
                jnp.asarray(patterns, jnp.int32),
                freqs=freqs,
                model=args.model,
                n_iterations=args.iterations,
                site_weights=jnp.asarray(weights, jnp.float32),
            )
        tree_source = f"{tree_source} + GY94 SPR-scan search"
    lengths = np.asarray(params["branch_lengths"])
    out = {
        "model": args.model,
        "codon_frequencies": args.freqs,
        "tree_source": tree_source,
        "n_taxa": len(names),
        "n_codons": int(codons.shape[1]),
        "unique_codon_patterns": int(patterns.shape[1]),
        "missing_codons": n_missing,
        "kappa": round(float(params["kappa"]), 4),
        "omega": round(float(params["omega"]), 4),
        "log_likelihood": -float(losses[-1]),
        "tree_length": float(lengths[:-1].sum()),
    }
    if "gamma_shape" in params:
        out["gamma_shape"] = round(float(params["gamma_shape"]), 4)
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(save_newick(topo, names, lengths) + "\n")
        out["output_tree"] = args.output_tree
    print(json.dumps(out))
