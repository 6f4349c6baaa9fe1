"""jaxtyping shape annotations for the engine's array vocabulary.

Documentation-grade aliases covering the reference's type vocabulary
(``/root/reference/src/trex/types.py``, ``src/trex/utils/types.py``) plus the
accelerator layouts this engine actually uses. Pure annotations — nothing here
affects runtime.
"""

from __future__ import annotations

from jaxtyping import Array, Bool, Float, Int

# --- sequences ---------------------------------------------------------------
EvoSequence = Int[Array, "sites"]
"""One integer-encoded sequence."""
BatchEvoSequence = Int[Array, "batch sites"]
"""A batch of integer sequences (e.g. the leaves of one tree)."""
OneHotSequence = Float[Array, "sites states"]
SoftSequences = Float[Array, "nodes sites states"]
"""Soft (probabilistic) per-node state distributions."""

# --- trees -------------------------------------------------------------------
AdjacencyMatrix = Float[Array, "nodes nodes"]
"""Dense adjacency, A[child, parent] = 1 (API boundaries only)."""
ChildIndexPairs = Int[Array, "ancestors 2"]
"""Topology.children — the engine's internal tree form."""
ParentVector = Int[Array, "nodes"]
"""Topology.parents — root maps to itself."""
TreeLogits = Float[Array, "nodes_minus_1 ancestors"]
"""Learnable parent-assignment logits for the soft topology."""

# --- Sankoff DP (layout: sites on the vector axis) ---------------------------
CostMatrix = Float[Array, "states states"]
DPTable = Float[Array, "nodes states sites"]
"""Engine DP layout (the reference's is (sites, nodes, states))."""
BacktrackTable = Int[Array, "ancestors 2 states sites"]
"""Argmin child states per (ancestor, child slot, parent state, site)."""
FitchSets = Int[Array, "nodes sites"]
"""Fitch state sets as int32 bitmasks."""

# --- scalars / masks ---------------------------------------------------------
TotalCost = Float[Array, ""]
SiteMask = Bool[Array, "sites"]
NodeMask = Bool[Array, "nodes"]
