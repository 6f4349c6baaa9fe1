"""Device mesh construction for the ('tree', 'site') sharding layout.

The engine's two parallel axes (SURVEY.md §5):

- ``tree``: candidate-tree / restart batch — pure data parallelism; per-tree
  scores and topology gradients merge with ``psum``.
- ``site``: alignment sites — embarrassingly parallel in parsimony (the DP has
  no cross-site coupling; the score is a site-sum), so site shards compute
  partial scores merged with one ``psum``. This is the "sequence parallelism"
  of this domain.

On one host of four GPUs joined all to all by NVLink, every card reaches
every other at the same rate, so the mesh follows the algorithm alone
(``make_mesh`` gives 2 x 2 for four devices). Across hosts, lay ``tree``
over the slower inter-host dimension so the per-step psum of site partials
stays on NVLink.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TREE_AXIS = "tree"
SITE_AXIS = "site"


def make_mesh(
    devices: list[jax.Device] | None = None,
    tree_parallelism: int | None = None,
) -> Mesh:
    """Build a 2-D ('tree', 'site') mesh over the given devices.

    Args:
        devices: defaults to all addressable devices.
        tree_parallelism: size of the tree axis. Defaults to the largest
            power-of-two divisor <= sqrt(n_devices) heuristic — balanced
            meshes unless the caller knows better.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tree_parallelism is None:
        tree_parallelism = 1
        while (
            tree_parallelism * 2 <= n // (tree_parallelism * 2)
            and n % (tree_parallelism * 2) == 0
        ):
            tree_parallelism *= 2
    if n % tree_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by tree={tree_parallelism}")
    grid = np.asarray(devices).reshape(tree_parallelism, n // tree_parallelism)
    return Mesh(grid, (TREE_AXIS, SITE_AXIS))
