"""Core types and dtype policy for trex_tpu.

Mirrors the *contract* of the reference's type layer
(``/root/reference/src/trex/types.py``, ``src/trex/utils/types.py``) without
copying it: a process-global default float dtype knob plus the pytree
containers the engine passes across API boundaries.

Conventions inherited from the reference (the "numerics contract",
SURVEY.md §2):

- Node ordering: leaves ``0..n_leaves-1``, ancestors ``n_leaves..n_all-1``,
  root at index ``n_all - 1``; ``n_all = 2 * n_leaves - 1``
  (``sankoff.py:45-46``, ``ground_truth.py:147-151``).
- Adjacency convention (at API boundaries only): ``A[child, parent] = 1``;
  a column is a node's children set (``utils/types.py:30-35``).
- DP sentinel cost for impossible states is ``1e5`` (``sankoff.py:152``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Sentinel cost for impossible leaf states in the Sankoff DP. Matches the
# reference's table initialization (``/root/reference/src/trex/sankoff.py:152``)
# so parsimony scores bit-match.
BIG_COST = 1e5

_DEFAULT_DTYPE = jnp.float32


def default_dtype() -> jnp.dtype:
    """Return the process-global default float dtype (float32 unless changed)."""
    return _DEFAULT_DTYPE


def set_default_dtype(dtype: jnp.dtype) -> None:
    """Set the process-global default float dtype.

    Counterpart of the reference's knob (``/root/reference/src/trex/types.py:40``).
    ``float32`` is the accuracy default; ``bfloat16`` trades precision for
    bandwidth (use for the soft-cost/gradient path, not the exact DP).
    """
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = jnp.dtype(dtype)


class PhyloData(NamedTuple):
    """A generated phylogenetic dataset (JAX pytree).

    Same field contract as the reference's ``PhylogeneticTree``
    (``/root/reference/src/trex/utils/types.py:80-92``) so its tests port as
    golden oracles.
    """

    masked_sequences: jax.Array
    """(n_all, L) sequences with ancestor rows zeroed; leaves observed."""
    all_sequences: jax.Array
    """(n_all, L) full ground-truth sequences including ancestors."""
    adjacency: jax.Array
    """(n_all, n_all) dense adjacency, A[child, parent] = 1."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CostModel:
    """Substitution cost model for parsimony scoring.

    ``matrix`` is the (Q, Q) per-substitution cost; the reference always uses
    Hamming cost ``ones - eye`` (``tests/test_convergence.py:51-54``), but any
    non-negative matrix is supported.
    """

    matrix: jax.Array

    @property
    def n_states(self) -> int:
        return self.matrix.shape[-1]

    @staticmethod
    def hamming(n_states: int, dtype: jnp.dtype | None = None) -> "CostModel":
        dtype = dtype or default_dtype()
        m = jnp.ones((n_states, n_states), dtype=dtype) - jnp.eye(n_states, dtype=dtype)
        return CostModel(matrix=m)

    @staticmethod
    def transition_transversion(
        transition_cost: float = 1.0,
        transversion_cost: float = 2.0,
        dtype: jnp.dtype | None = None,
    ) -> "CostModel":
        """DNA weighted-parsimony costs over the ACGT alphabet.

        Transitions (A<->G, C<->T — within purines/pyrimidines) are cheaper
        than transversions, the standard weighting for real sequence data.
        Uses the engine's ACGT state order (``trex_tpu.io.DNA``).
        """
        dtype = dtype or default_dtype()
        m = jnp.full((4, 4), transversion_cost, dtype=dtype)
        m = m.at[jnp.arange(4), jnp.arange(4)].set(0.0)
        for a, b in ((0, 2), (1, 3)):  # A<->G, C<->T
            m = m.at[a, b].set(transition_cost).at[b, a].set(transition_cost)
        return CostModel(matrix=m)
