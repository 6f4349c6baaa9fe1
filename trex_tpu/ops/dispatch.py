"""Backend dispatch: the one place that chooses kernel or lax.

On a GPU the Fitch row-walk kernels (``ops.fitch_pallas``, Pallas through
Triton) are compiled for the card; everywhere else the lax formulations
run. Interpret mode is for tests only: nothing here ever selects it.
Hamming substitution costs (the reference's universal choice) take the
Fitch bitset path; other costs take the lax min-plus Sankoff.
"""

from __future__ import annotations

import jax
import numpy as np

from trex_tpu.topology import Topology


def _platform() -> str:
    return jax.default_backend()


def use_kernel(n_states: int = 4) -> bool:
    """Whether the Fitch row-walk kernels (``ops.fitch_pallas``) run.

    Decided from the platform and the shape: the kernels exist for the
    GPU only, and their state sets are int32 bitmasks, so the alphabet
    must fit in 32 bits (the stepwise insertion path keeps an event flag
    at bit 30, so its callers already hold Q <= 30).
    """
    return _platform() == "gpu" and n_states <= 32


def _is_hamming(cost_matrix) -> bool:
    try:
        c = np.asarray(cost_matrix)
    except jax.errors.TracerArrayConversionError:
        return False
    q = c.shape[-1]
    return bool(np.array_equal(c, np.ones((q, q)) - np.eye(q)))


def batched_fitch_scores(
    topologies: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
    n_states: int = 4,
) -> jax.Array:
    """(B,) unit-cost Fitch scores: the GPU kernel or the vmapped lax scan.

    Traceable (usable inside ``shard_map``); the choice is static.
    """
    if use_kernel(n_states):
        from trex_tpu.ops.fitch_pallas import batched_fitch_score_pallas

        return batched_fitch_score_pallas(
            topologies, leaf_sequences,
            site_weights=site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    from trex_tpu.ops.fitch import fitch_score

    return jax.vmap(
        lambda t: fitch_score(
            t, leaf_sequences, site_mask=site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    )(topologies)


def batched_scores_fastest(
    topologies: Topology,
    cost_matrix: jax.Array,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None = None,
    *,
    sequences_are_masks: bool = False,
) -> jax.Array:
    """Score a candidate batch with the fastest available backend.

    Selection: Hamming cost + n_states <= 32 -> Fitch bitsets (GPU kernel
    on a GPU, lax elsewhere); other costs -> lax min-plus Sankoff.
    ``sequences_are_masks``: leaves are int32 state-set bitmasks (IUPAC
    ambiguity / gaps), not integer states.

    Do NOT wrap this dispatcher in ``jax.jit``: fast-path selection inspects
    the concrete cost matrix (a traced matrix conservatively falls back to
    the general min-plus path). The selected implementations are jitted.
    """
    q = cost_matrix.shape[-1]
    if _is_hamming(cost_matrix) and q <= 32:
        return batched_fitch_scores(
            topologies, leaf_sequences, site_weights,
            sequences_are_masks=sequences_are_masks, n_states=q,
        )
    from trex_tpu.ops.sankoff import sankoff_score

    return jax.vmap(
        lambda t: sankoff_score(
            t, cost_matrix, leaf_sequences, site_mask=site_weights,
            sequences_are_masks=sequences_are_masks,
        )
    )(topologies)
