"""Backend choice (``ops.dispatch``): kernels on a GPU, lax elsewhere.

The platform is monkeypatched; the kernels themselves are swapped for
their interpret-mode runs (or a recorder), since no GPU is present here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.ops import dispatch
from trex_tpu.ops import fitch_pallas
from trex_tpu.ops.fitch import batched_fitch_score
from trex_tpu.ops.sankoff import batched_sankoff_score
from trex_tpu.topology import random_topologies
from trex_tpu.types import CostModel


@pytest.fixture
def platform(monkeypatch):
    """Set the platform dispatch sees; returns the setter."""

    def set_platform(name):
        monkeypatch.setattr(dispatch, "_platform", lambda: name)
        jax.clear_caches()  # traced choices are baked into jitted callers

    yield set_platform
    jax.clear_caches()


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the GPU kernels in interpret mode, counting calls."""
    calls = {"fitch": 0, "insertion": 0}
    fitch = fitch_pallas.batched_fitch_score_pallas
    insertion = fitch_pallas.insertion_delta_pallas

    def fitch_counted(*args, **kw):
        calls["fitch"] += 1
        return fitch(*args, interpret=True, **kw)

    def insertion_counted(*args, **kw):
        calls["insertion"] += 1
        return insertion(*args, interpret=True, **kw)

    monkeypatch.setattr(fitch_pallas, "batched_fitch_score_pallas",
                        fitch_counted)
    monkeypatch.setattr(fitch_pallas, "insertion_delta_pallas",
                        insertion_counted)
    return calls


@pytest.mark.parametrize(
    "name,n_states,expected",
    [
        ("gpu", 2, True),
        ("gpu", 4, True),
        ("gpu", 20, True),
        ("gpu", 32, True),
        ("gpu", 33, False),
        ("cpu", 4, False),
        ("rocm", 4, False),
        ("METAL", 4, False),
    ],
)
def test_use_kernel(platform, name, n_states, expected):
    platform(name)
    assert dispatch.use_kernel(n_states) is expected


def test_protein_alphabet_route(platform, interpret_kernels):
    """Q=20 takes the kernel on a GPU and matches lax exactly."""
    platform("gpu")
    topos, leaf = _batch(seed=11, q=20)
    got = dispatch.batched_scores_fastest(
        topos, CostModel.hamming(20).matrix, leaf
    )
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(batched_fitch_score(topos, leaf))
    )
    assert interpret_kernels["fitch"] == 1


def test_real_platform_here_is_lax():
    assert dispatch._platform() == "cpu"
    assert not dispatch.use_kernel()


def _batch(seed=0, n_leaves=10, length=70, batch=5, q=4):
    topos = random_topologies(jax.random.PRNGKey(seed), n_leaves, batch)
    leaf = jax.random.randint(
        jax.random.PRNGKey(seed + 1), (n_leaves, length), 0, q
    )
    return topos, leaf


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_hamming_scores_route_and_agree(platform, interpret_kernels, name):
    platform(name)
    topos, leaf = _batch()
    cost = CostModel.hamming(4).matrix
    got = dispatch.batched_scores_fastest(topos, cost, leaf)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(batched_fitch_score(topos, leaf))
    )
    assert interpret_kernels["fitch"] == (1 if name == "gpu" else 0)


def test_general_cost_never_takes_the_kernel(platform, interpret_kernels):
    platform("gpu")
    topos, leaf = _batch(seed=3)
    cost = CostModel.transition_transversion(1.0, 2.0).matrix
    got = dispatch.batched_scores_fastest(topos, cost, leaf)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(batched_sankoff_score(topos, cost, leaf))
    )
    assert interpret_kernels["fitch"] == 0


def test_traced_cost_takes_minplus(platform, interpret_kernels):
    platform("gpu")
    topos, leaf = _batch(seed=5)
    cost = CostModel.hamming(4).matrix

    @jax.jit
    def scores(c):
        return dispatch.batched_scores_fastest(topos, c, leaf)

    np.testing.assert_array_equal(
        np.asarray(scores(cost)),
        np.asarray(batched_sankoff_score(topos, cost, leaf)),
    )
    assert interpret_kernels["fitch"] == 0


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_weighted_masks_through_dispatch(platform, interpret_kernels, name):
    platform(name)
    topos, leaf = _batch(seed=7, length=33)
    masks = np.asarray(1 << np.asarray(leaf), np.int32)
    masks[2, :4] = 0b1111
    weights = jnp.asarray(np.arange(33) % 3, jnp.float32)
    got = dispatch.batched_fitch_scores(
        topos, jnp.asarray(masks), weights, sequences_are_masks=True
    )
    from trex_tpu.ops.fitch import fitch_score

    want = jax.vmap(
        lambda t: fitch_score(
            t, jnp.asarray(masks), site_mask=weights,
            sequences_are_masks=True,
        )
    )(topos)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_stepwise_takes_the_insertion_kernel_on_gpu(
    platform, interpret_kernels
):
    """The device stepwise loop calls the insertion kernel on a GPU and
    builds the same tree as the lax path."""
    from trex_tpu.search.stepwise import stepwise_addition

    rng = np.random.default_rng(3)
    seqs = rng.integers(0, 4, (9, 40)).astype(np.int32)
    platform("cpu")
    lax_topo, lax_score = stepwise_addition(seqs, 4, seed=1)
    assert interpret_kernels["insertion"] == 0
    platform("gpu")
    topo, score = stepwise_addition(seqs, 4, seed=1)
    assert interpret_kernels["insertion"] >= 1
    assert score == lax_score
    np.testing.assert_array_equal(
        np.asarray(topo.children), np.asarray(lax_topo.children)
    )


def test_sharded_scores_take_the_kernel_per_shard(platform, interpret_kernels):
    from trex_tpu.parallel.mesh import make_mesh
    from trex_tpu.parallel.sharded import sharded_batch_scores

    platform("gpu")
    topos, leaf = _batch(seed=9, length=64, batch=4)
    mesh = make_mesh(jax.devices()[:4], tree_parallelism=2)
    cost = CostModel.hamming(4).matrix
    got = sharded_batch_scores(mesh, topos, cost, leaf)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(batched_fitch_score(topos, leaf))
    )
    assert interpret_kernels["fitch"] >= 1
