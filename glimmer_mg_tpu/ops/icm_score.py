"""Vectorized ICM scoring on the device (JAX/XLA formulation).

The reference scores one base at a time with a data-dependent tree walk
(``ICM_t::Full_Window_Prob``, reference src/ICM/icm.cc:557-610;
``Partial_Window_Prob`` icm.cc:807-842; ``Score_String`` icm.cc:864).
Here the walk is reformulated:

  * The 11-base context window of every position is packed into one int32
    (2 bits per base, window position w at bits 2w..2w+1). The walk step
    ``child = 4*node + base[ctx_pos[node]] + 1`` then needs only ONE gather
    (``mip[node]``) plus shifts/ands on the packed integer — the per-step
    context lookup is pure arithmetic.
  * The walk is unrolled ``model_depth`` (<= 7) times with masks instead of
    breaks; partial windows (first model_len-1 bases of a string) fall out
    of the same code path via a per-base position threshold, so one kernel
    scores entire sequences with no ragged control flow.

All functions are shape-polymorphic over leading batch dims via vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_contexts(base_idx: jnp.ndarray, model_len: int) -> jnp.ndarray:
    """Packed 2-bit context windows.

    ``ctx[i]`` holds bases at string positions ``i-(model_len-1) .. i-1`` in
    bits ``0..2*(model_len-1)-1`` (window position w at bits 2w..2w+1).
    Out-of-range positions are zeros; callers mask them via the threshold.
    """
    w = model_len - 1
    s = base_idx.astype(jnp.int32)
    n = s.shape[-1]
    padded = jnp.concatenate([jnp.zeros(s.shape[:-1] + (w,), jnp.int32), s], axis=-1)
    ctx = jnp.zeros_like(s)
    for k in range(w):
        # window position k of ctx[i] = s[i - w + k] = padded[i + k]
        ctx = ctx | (jax.lax.dynamic_slice_in_dim(padded, k, n, axis=-1) << (2 * k))
    return ctx


def _tree_walk(
    mip_flat: jnp.ndarray,  # (... * P*N,) int32 — mut_info_pos per (frame, node)
    num_nodes: int,
    depth: int,
    base_off: jnp.ndarray,  # per-base flat table offset (frame*N, + bank offset)
    ctx: jnp.ndarray,  # per-base packed context, int32
    thresh: jnp.ndarray,  # per-base minimum usable window position, int32
) -> jnp.ndarray:
    """Masked unrolled walk; returns final node index per base."""
    node = jnp.zeros_like(ctx)
    done = jnp.zeros(ctx.shape, dtype=bool)
    for _ in range(depth):
        pos = mip_flat[base_off + node]
        avail = pos >= thresh
        b = (ctx >> (2 * jnp.maximum(pos, 0))) & 3
        child = 4 * node + b + 1
        node = jnp.where(done | ~avail, node, child)
        done = done | ~avail
    # Landed on a pruned node (mip == -2): back up to the parent
    # (icm.cc:590-595 / 834-835).
    pos = mip_flat[base_off + node]
    node = jnp.where(pos == -2, (node - 1) // 4, node)
    return node


@functools.partial(jax.jit, static_argnames=("model_len", "depth", "cycle"))
def per_base_logprob(
    mip: jnp.ndarray,  # (P, N) int — mut_info_pos
    probs: jnp.ndarray,  # (P, N, 4) f32 — log-probs
    base_idx: jnp.ndarray,  # (L,) int — encoded sequence
    frame0,  # scalar int — frame of base 0
    model_len: int,
    depth: int,
    cycle: bool = True,
) -> jnp.ndarray:
    """Per-base log-probs of a sequence under one ICM.

    ``cycle=True`` matches Score_String/Cumulative_Score (frame advances per
    base); ``cycle=False`` matches Frame_Score (fixed frame).
    """
    periodicity, num_nodes = mip.shape[0], mip.shape[1]
    n = base_idx.shape[0]
    mip_flat = mip.reshape(-1).astype(jnp.int32)
    probs_flat = probs.reshape(-1)

    ctx = pack_contexts(base_idx, model_len)
    i = jnp.arange(n, dtype=jnp.int32)
    thresh = jnp.maximum(0, (model_len - 1) - i)
    if cycle:
        frame = (frame0 + i) % periodicity
    else:
        frame = jnp.full((n,), frame0, dtype=jnp.int32) % periodicity

    node = _tree_walk(mip_flat, num_nodes, depth, frame * num_nodes, ctx, thresh)
    last = base_idx.astype(jnp.int32)
    return probs_flat[(frame * num_nodes + node) * 4 + last]


def score_string(mip, probs, base_idx, frame0, model_len, depth):
    """Total log-prob (f32 accumulation on device)."""
    return jnp.sum(
        per_base_logprob(mip, probs, base_idx, frame0, model_len, depth, cycle=True)
    )


def cumulative_score(mip, probs, base_idx, frame0, model_len, depth):
    return jnp.cumsum(
        per_base_logprob(mip, probs, base_idx, frame0, model_len, depth, cycle=True)
    )


# ---------------------------------------------------------------------------
# ICM bank scoring (the Phymm classification hot path)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("model_len", "depth"))
def bank_score_reads(
    bank_mip: jnp.ndarray,  # (M, P, N) int
    bank_probs: jnp.ndarray,  # (M, P, N, 4) f32
    reads: jnp.ndarray,  # (B, L) int8/int32 padded base indices
    lengths: jnp.ndarray,  # (B,) int32 true lengths
    model_len: int,
    depth: int,
) -> jnp.ndarray:
    """Score every read against every ICM in a bank: (B, M) total log-probs.

    Equivalent to Phymm's per-ICM ``simple-score -N`` loop over the read set
    (reference scripts/scoreReadsGlim.pl:450), restructured as a dense
    read-by-model matrix. Frame 0 at base 0, cycling — the
    convention used when scoring whole reads.
    """
    b, l = reads.shape
    mask = jnp.arange(l)[None, :] < lengths[:, None]
    reads32 = reads.astype(jnp.int32)

    def one_model(carry, model):
        mip, probs = model
        per_read = jax.vmap(
            lambda r: per_base_logprob(mip, probs, r, 0, model_len, depth, cycle=True)
        )(reads32)
        return carry, jnp.sum(jnp.where(mask, per_read, 0.0), axis=-1)

    # scan over the model axis: compile cost is one model body regardless of
    # bank size (vmap over models made compile time scale with the bank).
    _, scores = jax.lax.scan(one_model, 0, (bank_mip, bank_probs))
    return scores.T


# ---------------------------------------------------------------------------
# glimmer-mg 6-frame per-base precompute (the per-read prediction hot path)
# ---------------------------------------------------------------------------


def _banked_logprob(mip_flat, probs_flat, num_nodes, periodicity, goff, seq,
                    frame0: int, model_len: int, depth: int):
    """Fixed-frame per-base log-probs of one sequence under one bank entry.

    ``goff`` is the model's flat offset (g * periodicity * num_nodes) into
    the stacked bank tables; gathers are exact f32 table reads, so results
    are bitwise equal to the scalar walk (Frame_Score, icm.cc:485).
    """
    n = seq.shape[0]
    ctx = pack_contexts(seq, model_len)
    i = jnp.arange(n, dtype=jnp.int32)
    thresh = jnp.maximum(0, (model_len - 1) - i)
    f = frame0 % periodicity
    base_off = goff + f * num_nodes
    node = _tree_walk(mip_flat, num_nodes, depth, base_off, ctx, thresh)
    last = seq.astype(jnp.int32)
    return probs_flat[(base_off + node) * 4 + last]


@functools.partial(
    jax.jit, static_argnames=("model_len", "depth", "gene_periodicity")
)
def mg_six_frame_batch(
    gene_mip,  # (G, P, N) int — stacked gene ICM bank
    gene_probs,  # (G, P, N, 4) f32
    indep_mip,  # (G, 3, 21) int — per-model null ICMs (Build_Indep_WO_Stops)
    indep_probs,  # (G, 3, 21, 4) f32
    reads,  # (B, L) int32 padded base indices
    lengths,  # (B,) int32
    group,  # (B,) int32 — bank index of each read's model pair
    model_len: int = 12,
    depth: int = 7,
    gene_periodicity: int = 3,
):
    """Batched Score_All_Frames (reference glimmer-mg.cc:1468) table reads.

    Returns (gene (B, 6, L) f32, indep (B, 6, L) f32) per-base log-probs:
    rows 0..2 are fixed frames 0..2 over the REVERSED read (positions
    0..len-1 hold the reversed read; tail padding does not perturb them
    because contexts only look backward), rows 3..5 are frames 0..2 over
    the COMPLEMENTED read. The host computes the f64 gene-minus-null LLR
    and the row reversals — bitwise identical to the per-read host mirror
    (models.icm.per_base_logprob_vec).
    """
    g, p, n_nodes = gene_mip.shape
    gm_flat = gene_mip.reshape(-1).astype(jnp.int32)
    gp_flat = gene_probs.reshape(-1)
    im_flat = indep_mip.reshape(-1).astype(jnp.int32)
    ip_flat = indep_probs.reshape(-1)
    n2 = indep_mip.shape[2]

    b, l = reads.shape
    reads32 = reads.astype(jnp.int32)
    i = jnp.arange(l, dtype=jnp.int32)
    ridx = lengths[:, None] - 1 - i[None, :]
    rev = jnp.where(
        ridx >= 0, jnp.take_along_axis(reads32, jnp.maximum(ridx, 0), axis=1), 0
    )
    comp = jnp.where(i[None, :] < lengths[:, None], 3 - reads32, 0)

    def one(seq_rev, seq_comp, gi):
        goff_g = gi * p * n_nodes
        goff_i = gi * 3 * n2
        gout, iout = [], []
        for seq in (seq_rev, seq_comp):
            for f in range(3):
                gout.append(
                    _banked_logprob(gm_flat, gp_flat, n_nodes, gene_periodicity,
                                    goff_g, seq, f, model_len, depth)
                )
                iout.append(
                    _banked_logprob(im_flat, ip_flat, n2, 3, goff_i, seq, f, 3, 2)
                )
        return jnp.stack(gout), jnp.stack(iout)

    return jax.vmap(one)(rev, comp, group.astype(jnp.int32))


def stack_bank(icms) -> tuple[np.ndarray, np.ndarray]:
    """Stack a list of ICM dataclasses into bank tensors, padding num_nodes."""
    n = max(m.num_nodes for m in icms)
    p = icms[0].periodicity
    mip = np.full((len(icms), p, n), -1, dtype=np.int16)
    probs = np.zeros((len(icms), p, n, 4), dtype=np.float32)
    for i, m in enumerate(icms):
        mip[i, :, : m.num_nodes] = m.mip
        probs[i, :, : m.num_nodes] = m.probs
    return mip, probs
