"""Memory-bounded mapping (counterpart of ``utils/memory.py:15-28``)."""

from __future__ import annotations

from typing import Callable

import jax


def auto_prune_chunk(
    n_prune: int, per_prune_bytes: int, budget_bytes: int = 2 << 30
) -> int | None:
    """Chunk size bounding an analytic scan's peak working set.

    The SPR/likelihood scans materialize ``n_prune`` pruned-variant DP
    tensors at once (``ops.spr_scan`` / ``ops.likelihood_scan``); above
    ``budget_bytes`` they must run in ``lax.map`` chunks. Returns None
    when the full scan fits (no chunk loop), else the largest chunk
    within budget (>= 1). The 2 GB default is carried over from the
    previous accelerator and not yet derived for the H100.
    """
    if n_prune * per_prune_bytes <= budget_bytes:
        return None
    return max(1, int(budget_bytes // per_prune_bytes))


def chunked_map(fn: Callable, xs, batch_size: int | None = None):
    """Map ``fn`` over the leading axis in fixed-size chunks.

    ``jax.lax.map`` with ``batch_size`` — vectorizes within a chunk, loops
    across chunks, bounding peak memory at chunk granularity. Use for wide
    per-site computations that would not fit if fully vmapped.
    """
    return jax.lax.map(fn, xs, batch_size=batch_size)
