"""Multi-host runtime initialization.

The reference is single-process (SURVEY.md §2); this is the multi-host entry
point the north star requires. On GPU and CPU clusters nothing tells JAX of
the cluster: pass ``coordinator_address`` (e.g. ``localhost:<port>``),
``num_processes`` and ``process_id`` explicitly (as the tests do); a
managed cluster environment that JAX detects needs none of them.
"""

from __future__ import annotations

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int = 300,
) -> bool:
    """Initialize the multi-host JAX runtime (idempotent, fail-fast).

    Returns True when a multi-process runtime was initialized, False when the
    process is already single-host-only (no coordinator configured and no
    cluster environment detected). Raises on timeout so hung pods fail fast
    rather than deadlocking in the first collective.
    """
    if jax.process_count() > 1:
        return True  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=initialization_timeout,
        )
        return jax.process_count() > 1
    except (ValueError, RuntimeError):
        if coordinator_address is not None:
            raise
        return False
