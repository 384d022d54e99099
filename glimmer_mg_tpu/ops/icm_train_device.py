"""On-device (JAX) ICM bank training — the device path for per-cluster retraining.

Jittable reformulation of the trainer in models/icm_train.py (reference
``ICM_Training_t``, src/ICM/icm.cc:1010-1462): every tree level is a batched
histogram reduction (scatter-add over packed context keys), followed by
vectorized mutual-information position selection and chi-square deleted
interpolation. Trains a whole bank of ICMs at once — one per cluster, with a
soft/hard read->cluster assignment matrix — which is exactly the inner loop
of Scimm-style EM clustering (SURVEY §2.4: per-cluster count reduction ->
interpolation -> rescore).

Under pjit with reads sharded along a ``data`` mesh axis, the scatter-adds
become per-shard partial histograms combined by psum (XLA inserts the
collective); the resulting bank is replicated or model-sharded for scoring.

Numerical notes: counts are exact integers (int32); probability math follows
the same f32-store/f64-compute pattern as the host trainer but runs in f32
on the device (training decisions are count-dominated; the host trainer
remains the bit-exact oracle).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.icm import num_tree_nodes

MUT_INFO_BIAS = 0.03
MUT_INFO_EPSILON = 1e-4
PSEUDO_COUNT = 0.001
SAMPLE_SIZE_BOUND = 400

CHI2_VAL = jnp.asarray(
    np.array([2.37, 4.11, 6.25, 7.81, 9.35, 11.3, 12.8], np.float32)
)
CHI2_SIG = jnp.asarray(
    np.array([0.50, 0.75, 0.90, 0.95, 0.975, 0.99, 0.995], np.float32)
)


def _window_fields(reads, lengths, model_len, periodicity):
    """Per-position packed context, final base, frame, validity. reads (B,L)."""
    b, l = reads.shape
    w = model_len - 1
    s = reads.astype(jnp.int32)
    padded = jnp.concatenate([jnp.zeros((b, w), jnp.int32), s], axis=1)
    ctx = jnp.zeros((b, l), jnp.int32)
    for k in range(w):
        ctx = ctx | (jax.lax.dynamic_slice_in_dim(padded, k, l, axis=1) << (2 * k))
    i = jnp.arange(l)
    valid = (i[None, :] >= w) & (i[None, :] < lengths[:, None])
    frame = (i + 1) % periodicity  # (model_len + start) % p for this layout
    return ctx, s, jnp.broadcast_to(frame[None, :], (b, l)), valid


def _mutual_info(counts):
    """counts (..., W, 16) -> MI (..., W); float32 on device."""
    pair = counts.astype(jnp.float32).reshape(counts.shape[:-1] + (4, 4))
    total = pair.sum((-1, -2))
    left = pair.sum(-1)
    right = pair.sum(-2)
    safe_t = jnp.where(total == 0, 1.0, total)
    p = pair / safe_t[..., None, None]
    lp = left / safe_t[..., None]
    rp = right / safe_t[..., None]
    denom = lp[..., :, None] * rp[..., None, :]
    ok = (pair != 0) & (left[..., :, None] != 0) & (right[..., None, :] != 0)
    term = jnp.where(ok, p * jnp.log(jnp.where(ok, p / jnp.where(denom == 0, 1, denom), 1.0)), 0.0)
    mi = term.reshape(counts.shape[:-1] + (16,)).sum(-1)
    return jnp.where(total == 0, 0.0, mi)


def _select_positions(mi, sums, stop_check):
    """Sequential best-position scan with right bias (icm.cc:1125-1148)."""
    w = mi.shape[-1]
    best = mi[..., 0]
    max_pos = jnp.zeros(best.shape, jnp.int32)
    for i in range(1, w):
        nxt = mi[..., i]
        ge = nxt >= best
        close = (~ge) & (nxt >= best / (1.0 + MUT_INFO_BIAS))
        best = jnp.where(ge, nxt, best)
        max_pos = jnp.where(ge | close, i, max_pos)
    if stop_check:
        stop = (best <= MUT_INFO_EPSILON) & (sums < SAMPLE_SIZE_BOUND)
        max_pos = jnp.where(stop, -1, max_pos)
    return max_pos


def _interpolate(ct4, parent_prob):
    """Chi-square deleted interpolation (icm.cc:1260-1330), f32."""
    ct = ct4.astype(jnp.float32)
    total = ct.sum(-1)
    prob = (ct + PSEUDO_COUNT * parent_prob) / (total + PSEUDO_COUNT)[..., None]

    expected = total[..., None] * parent_prob
    chi2 = jnp.where(expected > 0, (ct - expected) ** 2 / jnp.where(expected > 0, expected, 1), 0.0).sum(-1)
    idx = jnp.searchsorted(CHI2_VAL, chi2)
    n = CHI2_VAL.shape[0]
    i = jnp.clip(idx, 1, n - 1)
    lam_mid = CHI2_SIG[i - 1] + (
        (chi2 - CHI2_VAL[i - 1]) / (CHI2_VAL[i] - CHI2_VAL[i - 1])
    ) * (CHI2_SIG[i] - CHI2_SIG[i - 1])
    lam = jnp.where(idx == 0, 0.0, jnp.where(idx == n, 1.0, lam_mid))
    lam = jnp.minimum(lam * total / SAMPLE_SIZE_BOUND, 1.0)
    interp = prob * lam[..., None] + (1.0 - lam)[..., None] * parent_prob
    return jnp.where((total < SAMPLE_SIZE_BOUND)[..., None], interp, prob)


@functools.partial(
    jax.jit,
    static_argnames=("n_models", "model_len", "depth", "periodicity", "data_axis"),
)
def train_icm_bank(
    reads,  # (B, L) int32 base indices (padded)
    lengths,  # (B,) int32
    assign,  # (B, n_models) float32 weights (one-hot for hard EM)
    n_models: int,
    model_len: int = 12,
    depth: int = 7,
    periodicity: int = 3,
    data_axis: str | None = None,
):
    """Train ``n_models`` ICMs from weighted reads; returns (mip, probs) bank.

    ``data_axis``: name of a mesh axis to psum count histograms over (when
    called inside shard_map); None under plain jit/pjit where XLA handles
    the reduction via sharding propagation.
    """
    p = periodicity
    w = model_len - 1
    n_nodes = num_tree_nodes(depth)
    b, l = reads.shape

    ctx, last, frame, valid = _window_fields(reads, lengths, model_len, p)
    # hard assignment index per read (EM uses one-hot); -1 rows contribute 0
    model_of = jnp.argmax(assign, axis=1)
    weight = assign[jnp.arange(b), model_of] > 0
    valid = valid & weight[:, None]

    mip = jnp.zeros((n_models, p, n_nodes), jnp.int32)
    probs = jnp.zeros((n_models, p, n_nodes, 4), jnp.float32)

    flat_model = jnp.broadcast_to(model_of[:, None], (b, l)).reshape(-1)
    flat_frame = frame.reshape(-1)
    flat_ctx = ctx.reshape(-1)
    flat_last = last.reshape(-1)
    flat_valid = valid.reshape(-1)

    def level_counts(node_local, nodes_on_level, level_valid):
        """(n_models, p, nodes_on_level, W, 16) int32 histogram."""
        size = n_models * p * nodes_on_level * w * 16
        base = ((flat_model * p + flat_frame) * nodes_on_level + node_local) * (w * 16)
        counts = jnp.zeros((size,), jnp.int32)
        for j in range(w):
            pair = 4 * ((flat_ctx >> (2 * j)) & 3) + flat_last
            key = base + j * 16 + pair
            key = jnp.where(level_valid, key, size)  # dump invalid in a sink
            counts = counts.at[key].add(1, mode="drop")
        counts = counts.reshape(n_models, p, nodes_on_level, w, 16)
        if data_axis is not None:
            counts = jax.lax.psum(counts, axis_name=data_axis)
        return counts

    # ---- root ----
    root_counts = level_counts(jnp.zeros_like(flat_ctx), 1, flat_valid)[:, :, 0]
    sums = root_counts[..., 0, :].sum(-1)
    final_ct = root_counts[..., 0, :].reshape(n_models, p, 4, 4).sum(-2)
    probs = probs.at[:, :, 0, :].set(
        (final_ct.astype(jnp.float32) + np.float32(PSEUDO_COUNT / 4))
        / (sums[..., None].astype(jnp.float32) + np.float32(PSEUDO_COUNT))
    )
    mi = _mutual_info(root_counts)
    mip = mip.at[:, :, 0].set(_select_positions(mi, sums, stop_check=False))

    # ---- levels ----
    first_node = 1
    nodes_on_level = 4
    for level in range(1, depth + 1):
        node = jnp.zeros_like(flat_ctx)
        ok = flat_valid
        for _ in range(level):
            pos = mip[flat_model, flat_frame, node]
            ok = ok & (pos >= 0)
            bb = (flat_ctx >> (2 * jnp.maximum(pos, 0))) & 3
            node = jnp.where(ok, 4 * node + bb + 1, node)
        local = jnp.clip(node - first_node, 0, nodes_on_level - 1)
        counts = level_counts(local, nodes_on_level, ok)

        lvl_nodes = first_node + jnp.arange(nodes_on_level)
        parents = (lvl_nodes - 1) // 4
        parent_alive = mip[:, :, parents] >= 0
        sums = counts[..., 0, :].sum(-1)
        final_ct = counts[..., 0, :].reshape(n_models, p, nodes_on_level, 4, 4).sum(-2)
        mi = _mutual_info(counts)
        max_pos = _select_positions(mi, sums, stop_check=True)
        new_mip = jnp.where(parent_alive, max_pos, -2)
        mip = mip.at[:, :, lvl_nodes].set(new_mip)
        new_probs = _interpolate(final_ct, probs[:, :, parents, :])
        probs = probs.at[:, :, lvl_nodes, :].set(
            jnp.where(parent_alive[..., None], new_probs, 0.0)
        )
        first_node += nodes_on_level
        nodes_on_level *= 4

    logged = jnp.where(probs > 0, jnp.log(jnp.where(probs > 0, probs, 1.0)), -jnp.finfo(jnp.float32).max)
    return mip, logged.astype(jnp.float32)
