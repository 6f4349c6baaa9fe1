"""Ambiguity / missing-data support (state-set bitmask leaves).

The reference has no ambiguity handling at all (its generators emit pure
integer states); real alignments carry IUPAC codes and gaps. Correctness
contract: parsimony with a state-set leaf equals the MINIMUM score over all
per-site resolutions of the ambiguity — exactly what Fitch/Sankoff compute
when the leaf is initialized with cost 0 on every allowed state.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trex_tpu.io import DNA, IUPAC_DNA_MASKS, parse_fasta_masks
from trex_tpu.ops.dispatch import batched_scores_fastest
from trex_tpu.ops.fitch import fitch_reconstruct, fitch_score
from trex_tpu.ops.sankoff import sankoff_reconstruct, sankoff_score
from trex_tpu.ops import fitch_pallas
from trex_tpu.topology import random_topologies

Q = 4
HAMMING = jnp.ones((Q, Q)) - jnp.eye(Q)


def _random_case(seed: int, n_leaves: int = 6, length: int = 12):
    rng = np.random.default_rng(seed)
    topo = jax.tree.map(
        lambda a: a[0], random_topologies(jax.random.key(seed), n_leaves, 1)
    )
    seqs = rng.integers(0, Q, size=(n_leaves, length)).astype(np.int32)
    return topo, seqs


def _ambiguate(seed: int, seqs: np.ndarray, per_site: int = 2) -> np.ndarray:
    """Singleton masks, then widen ``per_site`` random cells per column."""
    rng = np.random.default_rng(seed)
    masks = (1 << seqs).astype(np.int32)
    for col in range(seqs.shape[1]):
        for row in rng.choice(seqs.shape[0], size=per_site, replace=False):
            extra = rng.integers(1, 1 << Q)  # any nonempty set
            masks[row, col] |= extra
    return masks


def _min_over_resolutions(topo, masks: np.ndarray) -> float:
    """Brute-force oracle: per site, min score over all allowed-state combos."""
    n_leaves, length = masks.shape
    total = 0.0
    for col in range(length):
        options = [
            [s for s in range(Q) if masks[row, col] >> s & 1]
            for row in range(n_leaves)
        ]
        best = np.inf
        for combo in itertools.product(*options):
            column = jnp.asarray(combo, jnp.int32)[:, None]
            best = min(best, float(fitch_score(topo, column)))
        total += best
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_singleton_masks_match_integer_states(seed):
    topo, seqs = _random_case(seed)
    masks = jnp.asarray((1 << seqs).astype(np.int32))
    expected = fitch_score(topo, jnp.asarray(seqs))
    assert fitch_score(topo, masks, sequences_are_masks=True) == expected
    assert (
        sankoff_score(topo, HAMMING, masks, sequences_are_masks=True) == expected
    )


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_ambiguity_is_min_over_resolutions(seed):
    topo, seqs = _random_case(seed)
    masks = _ambiguate(seed, seqs)
    oracle = _min_over_resolutions(topo, masks)
    got = float(fitch_score(topo, jnp.asarray(masks), sequences_are_masks=True))
    assert got == oracle
    via_sankoff = float(
        sankoff_score(topo, HAMMING, jnp.asarray(masks), sequences_are_masks=True)
    )
    assert via_sankoff == oracle


def test_fully_ambiguous_leaf_contributes_zero():
    topo, seqs = _random_case(7)
    masks = (1 << seqs).astype(np.int32)
    masks[2, :] = (1 << Q) - 1  # leaf 2 entirely missing
    got = float(fitch_score(topo, jnp.asarray(masks), sequences_are_masks=True))
    assert got == _min_over_resolutions(topo, masks)
    # Missing taxon never increases the score of the rest.
    full = float(fitch_score(topo, jnp.asarray(seqs)))
    assert got <= full


@pytest.mark.parametrize("site_block", [32, 64])
def test_pallas_interpret_matches_lax_with_masks(site_block):
    topos = random_topologies(jax.random.key(11), 8, 5)
    rng = np.random.default_rng(11)
    seqs = rng.integers(0, Q, size=(8, 40)).astype(np.int32)
    masks = jnp.asarray(_ambiguate(11, seqs, per_site=3))
    expected = jnp.stack(
        [
            fitch_score(
                jax.tree.map(lambda a, i=i: a[i], topos),
                masks,
                sequences_are_masks=True,
            )
            for i in range(5)
        ]
    )
    got = fitch_pallas._fitch_scores(
        topos,
        masks,
        None,
        sequences_are_masks=True,
        site_block=site_block,
        table_budget=fitch_pallas.TABLE_BUDGET_BYTES,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))
    via_dispatch = batched_scores_fastest(
        topos, HAMMING, masks, sequences_are_masks=True
    )
    np.testing.assert_array_equal(np.asarray(via_dispatch), np.asarray(expected))


def test_reconstruct_resolves_ambiguous_leaves():
    topo, seqs = _random_case(13)
    masks = jnp.asarray(_ambiguate(13, seqs))
    states, score = fitch_reconstruct(
        topo, masks, n_states=Q, sequences_are_masks=True
    )
    states = np.asarray(states)
    # Every chosen leaf state is allowed by its mask.
    chosen_bits = 1 << states[: masks.shape[0]]
    assert ((chosen_bits & np.asarray(masks)) != 0).all()
    # Realized edge changes equal the score (the reference's own oracle).
    parents = np.asarray(topo.parents)
    realized = sum(
        (states[child] != states[parents[child]]).sum()
        for child in range(len(parents) - 1)
    )
    assert realized == float(score)

    s_states, _, s_score = sankoff_reconstruct(
        topo, HAMMING, masks, sequences_are_masks=True
    )
    s_states = np.asarray(s_states)
    assert float(s_score) == float(score)
    assert ((1 << s_states[: masks.shape[0]] & np.asarray(masks)) != 0).all()
    s_realized = sum(
        (s_states[child] != s_states[parents[child]]).sum()
        for child in range(len(parents) - 1)
    )
    assert s_realized == float(s_score)


def test_parse_fasta_masks_iupac():
    text = ">a\nACGT-\n>b\nRYnWm\n"
    names, masks = parse_fasta_masks(text, DNA)
    assert names == ["a", "b"]
    np.testing.assert_array_equal(
        masks[0], [0b0001, 0b0010, 0b0100, 0b1000, 0b1111]
    )
    np.testing.assert_array_equal(
        masks[1],
        [
            IUPAC_DNA_MASKS["R"],
            IUPAC_DNA_MASKS["Y"],
            IUPAC_DNA_MASKS["N"],
            IUPAC_DNA_MASKS["W"],
            IUPAC_DNA_MASKS["M"],
        ],
    )


def test_parse_fasta_masks_protein_and_errors():
    names, masks = parse_fasta_masks(">p\nAR-X\n", "ARNDCQEGHILKMFPSTWYV")
    full = (1 << 20) - 1
    np.testing.assert_array_equal(masks[0], [1, 2, full, full])
    with pytest.raises(ValueError, match="not in the alphabet"):
        parse_fasta_masks(">bad\nAZ\n", DNA)
