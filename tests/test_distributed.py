"""True multi-process distributed execution (2 processes x 2 CPU devices).

Spawns two worker processes that ``jax.distributed.initialize`` against a
local coordinator, build one global ('tree', 'site') mesh spanning both, and
run sharded batch scoring; every process verifies its addressable score
shards against the single-device oracle. This exercises the actual
multi-host code path (process-spanning mesh + collectives), which the
in-process 8-device tests cannot.
"""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    proc = int(sys.argv[1])
    jax.distributed.initialize(
        "localhost:{port}", num_processes=2, process_id=proc,
        initialization_timeout=60,
    )
    assert jax.process_count() == 2
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from trex_tpu.ops.sankoff import batched_sankoff_score
    from trex_tpu.parallel.mesh import make_mesh
    from trex_tpu.parallel.sharded import sharded_batch_scores
    from trex_tpu.topology import random_topologies
    from trex_tpu.types import CostModel

    mesh = make_mesh(jax.devices(), tree_parallelism=2)
    topos = random_topologies(jax.random.PRNGKey(0), 8, 8)
    leaf = jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, 4)
    cost = CostModel.hamming(4).matrix

    def shard(x, spec):
        arr = np.asarray(x)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
        )

    topos_g = jax.tree_util.tree_map(lambda x: shard(x, P("tree")), topos)
    leaf_g = shard(leaf, P(None, "site"))
    scores = sharded_batch_scores(mesh, topos_g, cost, leaf_g)

    expected = np.asarray(batched_sankoff_score(topos, cost, leaf))
    for s in scores.addressable_shards:
        idx = s.index[0]
        np.testing.assert_allclose(np.asarray(s.data), expected[idx], atol=1e-5)
    print(f"proc{{proc}} verified", flush=True)
    """
)


@pytest.mark.skipif(os.name != "posix", reason="posix subprocess test")
def test_two_process_sharded_scoring(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo, port=12831))
    # CPU only: two processes must never contend for one GPU.
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outputs.append(out)
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-2000:]}"
        assert f"proc{i} verified" in out
