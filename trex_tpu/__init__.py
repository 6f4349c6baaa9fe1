"""trex_tpu — a differentiable phylogenetics engine on JAX/XLA.

A ground-up JAX/XLA/Pallas implementation of differentiable maximum-parsimony
phylogenetics with the capabilities of the reference library maraxen/trex
(differentiable evolution tree search):

- Exact Sankoff min-plus dynamic programming for parsimony scoring and
  ancestral sequence reconstruction (``trex_tpu.ops.sankoff``), Fitch
  bitsets for unit costs, and GPU kernels for batched candidate-tree
  scoring and stepwise insertion (``trex_tpu.ops.fitch_pallas``).
- Differentiable relaxations: Gumbel-softmax tree topologies, soft ancestor
  sequences, quadratic surrogate / substitution-weighted soft parsimony costs,
  and binary-tree constraint penalties (``trex_tpu.ops``).
- Synthetic data generation: balanced mutation trees and NK fitness-landscape
  Metropolis-Hastings evolution simulators (``trex_tpu.models``).
- Gradient-based search drivers (ASR, landscape-aware, joint topology +
  sequence optimization) under ``trex_tpu.search``.
- Multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map`` over
  ``('tree', 'site')`` axes (``trex_tpu.parallel``).

Design notes (accelerator-first, not a port):

- Tree topologies are struct-of-arrays (``Topology``: per-ancestor child index
  pairs + per-node parent indices), never dense adjacency inside compute. This
  removes the per-node ``where`` gathers of the reference
  (``/root/reference/src/trex/sankoff.py:60``) and makes candidate-tree
  batches a plain leading vmap axis.
- The Sankoff DP table is laid out ``(nodes, states, sites)`` so alignment
  sites are the contiguous, vectorized axis and the min-plus inner product
  is a broadcast + reduce; the site axis is embarrassingly parallel and
  shards cleanly across devices.
- All shapes are static; padding/bucketing utilities (``trex_tpu.padding``)
  keep XLA from recompiling as problem sizes vary.
"""

from trex_tpu.types import (
    PhyloData,
    default_dtype,
    set_default_dtype,
)
from trex_tpu.topology import (
    Topology,
    balanced_topology,
    balanced_adjacency,
    topology_from_adjacency,
    topology_to_adjacency,
    random_topologies,
)

__version__ = "0.1.0"

__all__ = [
    "PhyloData",
    "Topology",
    "balanced_topology",
    "balanced_adjacency",
    "topology_from_adjacency",
    "topology_to_adjacency",
    "random_topologies",
    "default_dtype",
    "set_default_dtype",
    "__version__",
]
