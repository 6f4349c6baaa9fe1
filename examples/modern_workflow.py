"""The "modern pipeline" workflow: simulate -> model-aware search -> supports
-> topology tests, all through the same surfaces the CLI exposes.

    JAX_PLATFORMS=cpu python examples/modern_workflow.py

Demonstrates the session's library surface end to end:
  1. seq-gen-style CTMC simulation (GTR+G, known tree),
  2. NJ start + model-aware spr-scan ML search with model/tree iteration,
  3. ultrafast bootstrap supports on the inferred tree,
  4. KH/SH topology tests of the inferred tree vs the NJ start,
  5. outgroup rooting + annotated newick export.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from trex_tpu.alignment import compress_alignment
from trex_tpu.io import reroot_on_outgroup, save_newick
from trex_tpu.models.simulate import simulate_alignment
from trex_tpu.ops.likelihood import optimize_model
from trex_tpu.search.ml import ml_hill_climb
from trex_tpu.search.nj import nj_start_tree
from trex_tpu.search.ratchet import rf_distance_unrooted
from trex_tpu.search.topotest import topology_tests
from trex_tpu.search.ufboot import ultrafast_bootstrap
from trex_tpu.topology import Topology, random_topologies


def main() -> None:
    key = jax.random.key(0)
    n_leaves, n_sites = 16, 1200

    # 1. Simulate a GTR+G alignment down a known tree.
    truth = jax.tree_util.tree_map(
        lambda x: x[0], random_topologies(key, n_leaves, 1)
    )
    rng = np.random.default_rng(0)
    blens = rng.uniform(0.05, 0.3, size=(truth.n_all,))
    rates = np.ones((4, 4)) - np.eye(4)
    rates[0, 2] = rates[2, 0] = 6.0
    rates[1, 3] = rates[3, 1] = 6.0
    freqs = np.array([0.35, 0.2, 0.3, 0.15])
    leaves = simulate_alignment(
        jax.random.key(1), truth, blens, n_sites=n_sites,
        rates=rates, freqs=freqs, gamma_shape=0.6,
    )
    patterns, weights = compress_alignment(np.asarray(leaves))
    patterns = jnp.asarray(np.asarray(patterns), jnp.int32)
    weights = jnp.asarray(weights, jnp.float32)
    print(f"simulated {n_leaves} x {n_sites} (GTR+G), "
          f"{int((np.asarray(weights) > 0).sum())} unique patterns")

    # 2. NJ start, JC scan climb, then one model-aware round.
    start, _ = nj_start_tree(np.asarray(leaves), 4, None)
    result, lengths, losses = ml_hill_climb(
        start, patterns, 4, neighborhood="spr-scan", site_weights=weights
    )
    params, model_losses = optimize_model(
        result.topology, patterns, 4, model="gtr+g", site_weights=weights
    )
    result2, lengths, _ = ml_hill_climb(
        result.topology, patterns, 4, neighborhood="spr-scan",
        site_weights=weights,
        rates=jnp.asarray(params["rates"]), freqs=jnp.asarray(params["freqs"]),
    )
    print(f"search: RF(truth) = {rf_distance_unrooted(result2.topology, truth)}, "
          f"lnL = {-float(model_losses[-1]):.1f}, "
          f"alpha = {float(params['gamma_shape']):.2f}")

    # 3. Ultrafast bootstrap supports.
    ub = ultrafast_bootstrap(
        jax.random.key(2), result2.topology, patterns, 4,
        site_weights=weights, n_replicates=500,
        rates=jnp.asarray(params["rates"]), freqs=jnp.asarray(params["freqs"]),
    )
    print(f"ufboot: {ub.n_candidates} candidates, "
          f"mean support {float(ub.support.mean()):.3f}")

    # 4. Topology tests: inferred vs the NJ start.
    tests = topology_tests(
        jax.random.key(3),
        Topology(
            children=jnp.stack([result2.topology.children, start.children]),
            parents=jnp.stack([result2.topology.parents, start.parents]),
        ),
        patterns, 4, site_weights=weights, n_replicates=2000,
        rates=jnp.asarray(params["rates"]), freqs=jnp.asarray(params["freqs"]),
    )
    print(f"topotest: best = tree {tests.best_index}, "
          f"delta(NJ) = {tests.delta[1]:.1f}, p_SH = {tests.p_sh[1]:.3f}")

    # 5. Root on taxon 0 and export with supports as node labels.
    rooted, rooted_lengths = reroot_on_outgroup(
        result2.topology, [0], np.asarray(lengths)
    )
    newick = save_newick(
        rooted, [f"t{i}" for i in range(n_leaves)], rooted_lengths
    )
    print("rooted newick:", newick[:100], "...")


if __name__ == "__main__":
    main()
