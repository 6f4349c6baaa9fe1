"""Fitch row-walk kernels for the GPU (Pallas, Triton route).

Two hot paths walk a tree's ancestors one dependent step at a time over
(node, site) tables of int32 state-set bitmasks:

- candidate scoring (``batched_fitch_score_pallas``): the Fitch up pass,
  leaves -> root, counting union events per site;
- stepwise insertion (``insertion_delta_pallas``): the down pass of the
  pruned variant, root -> leaves, then the per-edge join penalty
  delta(t, v) of the SPR identity (``ops/spr_scan.py``).

In lax both are sequential scans whose carry is the whole (n_all, L)
table, read and written with dynamic row indices every step; XLA pays
for that carry per step. Here both share one shape:

- one program per (tree, site block) — per site block for insertion —
  so programs are independent and run in any order;
- the ancestor loop runs inside the program, and the program loads its
  own child ids;
- node rows live in a per-program table that is an extra output (the
  Triton route has no scratch memory), padded to a power of two rows.
  That output is allocated in HBM: B * n_anc_pad * padded_L * 4 bytes for
  candidate scoring (1.07 GB at 1024 taxa x 1024 sites x 256 trees, so
  ``batched_fitch_score_pallas`` splits larger batches to keep it under
  ``TABLE_BUDGET_BYTES``), and n_pad * padded_L * 4 bytes for insertion
  (32 MiB at 2048 taxa x 4096 sites). How much of it the card serves
  from L2 is not measured;
- each program writes its own partial (per-site event counts, or per-node
  partial deltas) and a second XLA reduction sums them.

Sites are independent and every row load and store inside the walk has
the same (block,) shape, so each site is read and written by the same
thread and the walk needs no barrier. The zero fill and the final
row-chunk reads use other shapes; a block barrier separates those phases
on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from trex_tpu.ops.spr_scan import _combine0
from trex_tpu.topology import Topology
from trex_tpu.utils.chunking import auto_prune_chunk

# Site block (int32 words per program), a power of two as the Triton
# route requires; chosen by the block sweep in
# ``benchmarks/fitch_kernel_probe.py`` on an H100. Insertion runs one
# program per site block only, so its smaller block also spreads 4096
# sites over 256 programs, more than the card's 132 SMs.
FITCH_SITE_BLOCK = 128
INSERTION_SITE_BLOCK = 16
_ROW_CHUNK = 16  # rows per vectorized zero-fill / reduction step
# Bound on one scoring call's node tables in HBM; larger batches run in
# chunks of trees. Carried over like the scans' 2 GB budget
# (``utils.chunking``), not yet derived for the H100.
TABLE_BUDGET_BYTES = 2 << 30


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def site_block_for(length: int, requested: int) -> int:
    """Power-of-two site block: ``requested``, shrunk to the alignment."""
    if requested & (requested - 1) or requested < 1:
        raise ValueError(f"site block must be a power of two, got {requested}")
    return min(requested, next_pow2(length))


def _warps(site_block: int) -> int:
    # One site per thread; at least one and at most eight warps.
    return max(1, min(8, site_block // 32))


def _compiler_params(site_block: int):
    # num_stages=1: the loops carry dependences through memory, so no
    # software pipelining of loads across iterations.
    return plgpu.CompilerParams(num_warps=_warps(site_block), num_stages=1)


def _barrier(interpret: bool) -> None:
    if not interpret:
        plgpu.debug_barrier()


# --------------------------------------------------------------------------
# Candidate scoring: Fitch up pass, one program per (tree, site block).
# --------------------------------------------------------------------------


def _fitch_kernel(
    children_ref,  # (n_anc_pad, 2) int32 — this tree's child pairs
    leaf_ref,  # (n_leaf_pad, Lb) int32 leaf bitmasks of this site block
    counts_ref,  # out (Lb,) int32 per-site union events
    sets_ref,  # out (n_anc_pad, Lb) int32 ancestor sets (program table)
    *,
    n_leaves: int,
    n_anc: int,
):
    def row(c):
        # Leaves come from the shared leaf block, ancestors from the
        # program's own table; the other load is masked off.
        is_leaf = jnp.full(leaf_ref.shape[-1:], c < n_leaves)
        leaf = plgpu.load(
            leaf_ref.at[jnp.minimum(c, n_leaves - 1)], mask=is_leaf, other=0
        )
        anc = plgpu.load(
            sets_ref.at[jnp.maximum(c - n_leaves, 0)],
            mask=jnp.logical_not(is_leaf), other=0,
        )
        return leaf | anc

    def visit(a, counts):
        d1 = row(children_ref[a, 0])
        d2 = row(children_ref[a, 1])
        inter = d1 & d2
        empty = inter == 0
        sets_ref[a] = jnp.where(empty, d1 | d2, inter)
        return counts + empty.astype(jnp.int32)

    counts_ref[...] = jax.lax.fori_loop(
        0, n_anc, visit, jnp.zeros(counts_ref.shape, jnp.int32)
    )


def batched_fitch_score_pallas(
    topologies: Topology,
    leaf_sequences: jax.Array,
    *,
    site_weights: jax.Array | None = None,
    sequences_are_masks: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """(B,) unit-cost parsimony scores of a candidate batch via fused Fitch.

    Equal to ``jax.vmap(ops.fitch.fitch_score)`` (and so to Hamming
    Sankoff). Sites pad to a ``FITCH_SITE_BLOCK`` multiple with state 0 on
    every leaf and weight 0, which adds no events. ``site_weights`` (L,)
    scale each site's events (compressed patterns, bootstrap). Needs
    n_states <= 32. The node tables take B * n_anc_pad * padded_L * 4
    bytes of HBM; above ``TABLE_BUDGET_BYTES`` the batch runs in chunks.
    """
    return _fitch_scores(
        topologies, leaf_sequences, site_weights,
        sequences_are_masks=sequences_are_masks,
        site_block=FITCH_SITE_BLOCK,
        table_budget=TABLE_BUDGET_BYTES,
        interpret=interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "sequences_are_masks", "site_block", "table_budget", "interpret"
    ),
)
def _fitch_scores(
    topologies: Topology,
    leaf_sequences: jax.Array,
    site_weights: jax.Array | None,
    *,
    sequences_are_masks: bool,
    site_block: int,
    table_budget: int,
    interpret: bool,
) -> jax.Array:
    batch, n_anc, _ = topologies.children.shape
    n_leaves = n_anc + 1
    length = leaf_sequences.shape[-1]
    site_block = site_block_for(length, site_block)
    padded_len = -(-length // site_block) * site_block
    n_blocks = padded_len // site_block
    n_anc_pad = next_pow2(n_anc)
    n_leaf_pad = next_pow2(n_leaves)

    seqs = leaf_sequences.astype(jnp.int32)
    masks = seqs if sequences_are_masks else jnp.left_shift(jnp.int32(1), seqs)
    masks = jnp.pad(
        masks,
        ((0, n_leaf_pad - n_leaves), (0, padded_len - length)),
        constant_values=1,
    )
    children = jnp.pad(
        topologies.children.astype(jnp.int32),
        ((0, 0), (0, n_anc_pad - n_anc), (0, 0)),
    )

    def score(chunk_children):
        trees = chunk_children.shape[0]
        counts, _ = pl.pallas_call(
            functools.partial(_fitch_kernel, n_leaves=n_leaves, n_anc=n_anc),
            grid=(trees, n_blocks),
            in_specs=[
                pl.BlockSpec((None, n_anc_pad, 2), lambda b, j: (b, 0, 0)),
                pl.BlockSpec((n_leaf_pad, site_block), lambda b, j: (0, j)),
            ],
            out_specs=[
                pl.BlockSpec((None, site_block), lambda b, j: (b, j)),
                pl.BlockSpec(
                    (None, None, n_anc_pad, site_block),
                    lambda b, j: (b, j, 0, 0),
                ),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((trees, padded_len), jnp.int32),
                jax.ShapeDtypeStruct(
                    (trees, n_blocks, n_anc_pad, site_block), jnp.int32
                ),
            ],
            backend="triton",
            compiler_params=_compiler_params(site_block),
            interpret=interpret,
            name="fitch_score",
        )(chunk_children, masks)
        return counts

    chunk = auto_prune_chunk(batch, n_anc_pad * padded_len * 4, table_budget)
    if chunk is None:
        counts = score(children)
    else:
        # Padding trees have all-zero children (leaf 0 twice): valid reads,
        # sliced off below.
        n_chunks = -(-batch // chunk)
        children = jnp.pad(
            children, ((0, n_chunks * chunk - batch), (0, 0), (0, 0))
        )
        counts = jax.lax.map(
            score, children.reshape(n_chunks, chunk, n_anc_pad, 2)
        ).reshape(n_chunks * chunk, padded_len)[:batch]
    if site_weights is None:
        weights = jnp.ones((length,), jnp.float32)
    else:
        weights = jnp.asarray(site_weights, jnp.float32)
    weights = jnp.pad(weights, (0, padded_len - length))
    return jnp.sum(counts.astype(jnp.float32) * weights[None, :], axis=-1)


# --------------------------------------------------------------------------
# Stepwise insertion: down pass + join penalties, one program per site block.
# --------------------------------------------------------------------------


def _insertion_kernel(
    children_ref,  # (n_anc_pad, 2) int32 children of the pruned variant
    tnode_ref,  # (1,) int32 inserted leaf t
    up_ref,  # (n_pad, Lb) int32 flagless up sets of this site block
    w_ref,  # (Lb,) f32 site weights
    delta_ref,  # out (n_pad,) f32 partial delta of this site block
    down_ref,  # out (n_pad, Lb) int32 down contexts (program table)
    *,
    n_leaves: int,
    n_anc: int,
    interpret: bool,
):
    n_pad, lb = down_ref.shape
    zeros = jnp.zeros((_ROW_CHUNK, lb), jnp.int32)

    def clear(r, carry):
        down_ref[pl.ds(r * _ROW_CHUNK, _ROW_CHUNK), :] = zeros
        return carry

    jax.lax.fori_loop(0, n_pad // _ROW_CHUNK, clear, None)
    _barrier(interpret)

    def step(i, carry):
        a = n_anc - 1 - i  # root -> leaves
        c1 = children_ref[a, 0]
        c2 = children_ref[a, 1]
        d = down_ref[n_leaves + a]
        is_pass = c1 == c2
        ctx1 = jnp.where(is_pass, d, _combine0(d, up_ref[c2]))
        ctx2 = _combine0(d, up_ref[c1])
        down_ref[c1] = ctx1
        # A pass-through row has c1 == c2: write ctx1 again, not ctx2.
        down_ref[c2] = jnp.where(is_pass, ctx1, ctx2)
        return carry

    jax.lax.fori_loop(0, n_anc, step, None)
    _barrier(interpret)

    tset = up_ref[tnode_ref[0]][None, :]
    w = w_ref[...][None, :]

    def reduce(r, carry):
        rows = pl.ds(r * _ROW_CHUNK, _ROW_CHUNK)
        ctx = _combine0(up_ref[rows, :], down_ref[rows, :])
        empty = ((tset & ctx) == 0).astype(jnp.float32)
        delta_ref[rows] = jnp.sum(empty * w, axis=1)
        return carry

    jax.lax.fori_loop(0, n_pad // _ROW_CHUNK, reduce, None)


def insertion_delta_pallas(
    var_children: jax.Array,
    up_states: jax.Array,
    t_node: jax.Array,
    weights: jax.Array,
    *,
    n_leaves: int,
    interpret: bool = False,
) -> jax.Array:
    """(n_all,) join penalties delta(t, v) of inserting leaf ``t_node``.

    Args:
        var_children: (n_anc, 2) int32 children of the PRUNED variant
            (t's parent row already a pass-through pair).
        up_states: (n_all, L) int32 flagless Fitch up sets of the variant
            (leaf rows = masks; stale rows above the stepwise frontier are
            fine — their contexts only reach invalid positions).
        t_node: scalar int32 inserted leaf.
        weights: (L,) f32 site weights.

    Returns (n_all,) f32: delta[v] = weighted count of sites where t's set
    does not intersect the combined up/down context of the edge above v.
    Total candidate score = L(T minus t) + delta[v] (spr_scan identity).
    Per-site terms do not depend on the blocking, so integer weights give
    the same bits at every site block. The down-context table takes
    n_pad * padded_L * 4 bytes of HBM.
    """
    return _insertion_delta(
        var_children, up_states, t_node, weights,
        n_leaves=n_leaves, site_block=INSERTION_SITE_BLOCK,
        interpret=interpret,
    )


@functools.partial(
    jax.jit, static_argnames=("n_leaves", "site_block", "interpret")
)
def _insertion_delta(
    var_children: jax.Array,
    up_states: jax.Array,
    t_node: jax.Array,
    weights: jax.Array,
    *,
    n_leaves: int,
    site_block: int,
    interpret: bool,
) -> jax.Array:
    n_all, length = up_states.shape
    n_anc = n_leaves - 1
    site_block = site_block_for(length, site_block)
    padded_len = -(-length // site_block) * site_block
    n_blocks = padded_len // site_block
    n_pad = max(next_pow2(n_all), _ROW_CHUNK)
    n_anc_pad = next_pow2(n_anc)

    # Zero-set padding: combine0 treats 0 as "no information", the weight
    # is 0, and padded rows are never a child, so neither reaches delta.
    up = jnp.pad(
        up_states.astype(jnp.int32),
        ((0, n_pad - n_all), (0, padded_len - length)),
    )
    w = jnp.pad(weights.astype(jnp.float32), (0, padded_len - length))
    children = jnp.pad(
        var_children.astype(jnp.int32), ((0, n_anc_pad - n_anc), (0, 0))
    )
    partial, _ = pl.pallas_call(
        functools.partial(
            _insertion_kernel, n_leaves=n_leaves, n_anc=n_anc,
            interpret=interpret,
        ),
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec((n_anc_pad, 2), lambda j: (0, 0)),
            pl.BlockSpec((1,), lambda j: (0,)),
            pl.BlockSpec((n_pad, site_block), lambda j: (0, j)),
            pl.BlockSpec((site_block,), lambda j: (j,)),
        ],
        out_specs=[
            pl.BlockSpec((None, n_pad), lambda j: (j, 0)),
            pl.BlockSpec((n_pad, site_block), lambda j: (0, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_blocks, n_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_pad, padded_len), jnp.int32),
        ],
        backend="triton",
        compiler_params=_compiler_params(site_block),
        interpret=interpret,
        name="insertion_delta",
    )(children, jnp.reshape(t_node, (1,)).astype(jnp.int32), up, w)
    return jnp.sum(partial, axis=0)[:n_all]
