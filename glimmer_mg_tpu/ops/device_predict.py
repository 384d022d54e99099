"""Chip-resident per-read gene prediction (ORF scan + event DP on device).

This module closes SURVEY §7.4/§7.5 (the on-device ORF/start scan and the
on-device event-graph DP): the COMPLETE error-free prediction path — 6-frame
ICM LLR precompute, ORF enumeration, start scoring (ICM + prior + start
codon + gene length + RBS mixture), per-ORF event construction, the
event-graph dynamic program with bounded-overlap re-linking, and traceback —
runs inside one jitted device computation, vmapped over a read batch. Only
gene calls (~a few tens of bytes per read) cross the host link, so the
reads/s metric scales with chips instead of host cores.

Reference anchors (behavioral spec — the architecture here is array-based,
nothing like the reference's pointer machines):
  Find_Orfs / Do_*_Stop_Codon        glimmer_base.cc:461-780
  Score_Orfs_Errors / Score_Orf_Starts  glimmer-mg.cc:1605-1860
  Add_Events_Fwd / Add_Events_Rev    glimmer_base.cc:43-263
  Add_PWM_Score                      glimmer_base.cc:267-295
  PWM_Meta_Score_Fwd/Rev_Start       glimmer-mg.cc:1900-2060
  Process_Events + helpers           glimmer_base.cc:1530-1896
  Trace_Back                         glimmer3.cc:1631-1759

Scope (gated by callers): error-free classes/user-ICM mode (no indels or
substitution branching, no quality vectors), linear reads,
allow_truncated_orfs=True, default start codons. Everything else stays on
the byte-exact host engines.

Numerics: the reference carries event scores in C doubles and compares DP
candidates in float32; here LLR accumulations and event scores use f64
(via ``jax.enable_x64``) with the same f32 candidate casts. Per-ORF
cumulative scores are computed as differences of whole-read f64 prefix
sums rather than fresh per-ORF sums, and transcendentals (log) are XLA's,
so scores can differ from the host engine in the last ulps; acceptance is
coordinate-identical .predict output (verified on the 999 sample reads and
on fuzz batches in tests/test_device_predict.py), with the byte-exact host
path remaining the default output mode.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

BIG = np.int32(1 << 29)
F32 = np.float32

# Padded event/gene capacities. Overflow is detected per read and reported
# so callers can fall back to the host engine for that read.
MAX_EVENTS = 160
MAX_GENES = 48

# Quality -> base-call probability table for Pass_Stop_Penalty
# (glimmer-mg.cc:961: p = 1 - 10^(-q/10)). Built with PYTHON pow so the
# entries match the host engine's floats bitwise. Index 255 is the
# sentinel for "no quality file" rows and holds the default 0.999.
_CP_TAB = np.array(
    [1.0 - 10.0 ** (-q / 10.0) for q in range(255)] + [0.999],
    dtype=np.float64,
)


# ---------------------------------------------------------------------------
# Bank construction (host side): stack every per-model table the device
# path needs. Groups mirror the six-frame precompute's grouping (one entry
# per distinct Models bundle in the chunk).
# ---------------------------------------------------------------------------


def _codon_tables(patterns):
    """(65,)-entry can/must/which tables over pure 2-bit codons.

    Index = 16*b0 + 4*b1 + b2 (b0 = first base); index 64 = the partial-
    codon sentinel (always false / -1). Exactness: dna.can_be/must_be are
    the reference's Codon_t semantics; a filtered read has pure bases, so
    per-codon table lookup == the streaming register test.
    """
    from ..models import dna

    masks_of = np.array([1, 2, 4, 8], dtype=np.int32)
    codes = np.arange(64)
    b0, b1, b2 = codes // 16, (codes // 4) % 4, codes % 4
    cod12 = (
        (masks_of[b0] << 8) | (masks_of[b1] << 4) | masks_of[b2]
    ).astype(np.int32)

    def can(pats):
        out = np.zeros(65, dtype=bool)
        out[:64] = dna.can_be(cod12, pats)
        return out

    def must(pats):
        out = np.zeros(65, dtype=bool)
        out[:64] = dna.must_be(cod12, pats)
        return out

    def which(pats):
        w = np.full(65, -1, dtype=np.int8)
        for pi in range(len(pats) - 1, -1, -1):
            w[:64][dna.can_be(cod12, pats[pi : pi + 1])] = pi
        return w

    return {
        "fwd_start": can(patterns.fwd_start),
        "rev_start": can(patterns.rev_start),
        "fwd_stop": must(patterns.fwd_stop),
        "rev_stop": must(patterns.rev_stop),
        "which_fwd": which(patterns.fwd_start),
        "which_rev": which(patterns.rev_start),
    }


@dataclasses.dataclass
class DeviceBank:
    """Stacked per-group model tables (numpy, host-built)."""

    # ICM bank (shared with ops.icm_score.mg_six_frame_batch)
    gene_mip: np.ndarray
    gene_probs: np.ndarray
    indep_mip: np.ndarray
    indep_probs: np.ndarray
    model_len: int
    depth: int
    periodicity: int
    # codon tables (G, 65)
    fwd_start: np.ndarray
    rev_start: np.ndarray
    fwd_stop: np.ndarray
    rev_stop: np.ndarray
    which_fwd: np.ndarray
    which_rev: np.ndarray
    # feature tables
    prior: np.ndarray  # (G,) f32
    start_lo: np.ndarray  # (G, S) f32
    len_score: np.ndarray  # (G, 3, T) f64: rows = (full, 5'or3'-trunc, both)
    adj_or: np.ndarray  # (G, 4) f32: ff, fr, rf, rr
    adj_dist: np.ndarray  # (G, 3, D) f32: ff, fr, rf (padded; saturate=last)
    adj_dist_len: np.ndarray  # (G, 3) int32 true lengths
    ignore_score_len: np.ndarray  # (G,) int32
    # RBS mixture (PWM_Meta) or user log-odds PWM
    pwm_cols: np.ndarray  # (G, C, W, 4) f64 raw-prob mixture columns
    pwm_n: np.ndarray  # (G,) int32 — 0 = no PWM for this group
    pwm_user: np.ndarray  # (G, W, 4) f64 log-odds (user -b PWM) or zeros
    pwm_is_user: np.ndarray  # (G,) bool
    gc_lp: np.ndarray  # (G, 4) f64 background logs
    # scalars (uniform across the chunk; enforced by the builder)
    min_gene_len: int
    max_olap: int
    event_threshold: float
    start_threshold: float
    ribosome_window: int
    pwm_w: int


def build_bank(models_list, max_read_len: int) -> DeviceBank:
    """Stack a chunk's Models bundles into device tables.

    Raises ValueError when the bundles cannot share one kernel instance
    (mixed scalars/model shapes) — callers fall back to the host engine.
    """
    from ..ops import icm_score

    m0 = models_list[0]
    for m in models_list:
        if (
            m.min_gene_len != m0.min_gene_len
            or m.max_olap_bases != m0.max_olap_bases
            or m.event_threshold != m0.event_threshold
            or m.start_threshold != m0.start_threshold
            or m.ribosome_window_size != m0.ribosome_window_size
            or m.gene_icm.model_len != m0.gene_icm.model_len
            or m.gene_icm.periodicity != m0.gene_icm.periodicity
            # use_first_start_codon is a glimmer3 whole-genome knob; the
            # per-read mg engine never reads it (Score_Orfs_Errors has no
            # first-start branch, glimmer-mg.cc:1605), so it does not
            # affect device eligibility.
            or m.circular
            # in mg mode allow_truncated_orfs=False occurs ONLY with
            # circular=True (engine/glimmer_mg.py:1243,1430), so the
            # circular exclusion covers it; keep the guard for direct API
            # callers constructing such Models by hand
            or not m.allow_truncated_orfs
        ):
            raise ValueError("device path needs uniform scalar models")
    if m0.min_gene_len <= m0.max_olap_bases + 3:
        # the DP's bounded disqualify/requalify walks rely on the
        # best_pred graph being acyclic, which holds when every
        # closer->opener hop (>= min_gene_len backward) outweighs any
        # re-link hop (<= max_olap + 3 forward); tiny min_gene_len
        # configurations stay on the host engine
        raise ValueError("device path needs min_gene_len > max_olap + 3")

    gmip, gprobs = icm_score.stack_bank([m.gene_icm for m in models_list])
    imip, iprobs = icm_score.stack_bank([m.indep_model for m in models_list])

    g = len(models_list)
    ct = [_codon_tables(m.patterns) for m in models_list]
    n_start = max(len(m.logodds_start.log_odds) for m in models_list)
    start_lo = np.zeros((g, n_start), dtype=np.float32)

    t_len = max_read_len // 3 + 3
    len_score = np.zeros((g, 3, t_len), dtype=np.float64)
    adj_tabs = []
    prior = np.zeros(g, dtype=np.float32)
    adj_or = np.zeros((g, 4), dtype=np.float32)
    isl = np.zeros(g, dtype=np.int32)

    pwm_lists = []
    user_pwms = []
    for gi, m in enumerate(models_list):
        prior[gi] = m.logodds_prior
        start_lo[gi, : len(m.logodds_start.log_odds)] = m.logodds_start.log_odds
        ld = m.logodds_length
        # The classes-mode LengthDist is built per (classes, read-length)
        # cache entry with a single fragment distribution, so score() is a
        # pure function of (length, trunc flags); pre-evaluate it densely.
        # Length 0 is unreachable (min candidate j gives >= 1 AA) — the
        # default dist's merge blend would divide by zero there.
        for L in range(1, t_len):
            len_score[gi, 0, L] = ld.score(L, False, False, max_read_len // 3)
            len_score[gi, 1, L] = ld.score(L, True, False, max_read_len // 3)
            len_score[gi, 2, L] = ld.score(L, True, True, max_read_len // 3)
        len_score[gi, :, 0] = len_score[gi, :, 1]
        ad = m.logodds_adj_dist
        adj_or[gi] = [m.logodds_adj_or.ff, m.logodds_adj_or.fr,
                      m.logodds_adj_or.rf, m.logodds_adj_or.rr]
        adj_tabs.append((ad.ff, ad.fr, ad.rf, ad.max_overlap))
        isl[gi] = min(int(m.ignore_score_len), int(BIG))
        meta = getattr(m, "_meta_pwms", None)
        if meta:
            pwm_lists.append([p.cols for p in meta])
            user_pwms.append(None)
        elif m.user_rbs and not m.logodds_pwm.is_empty():
            pwm_lists.append(None)
            user_pwms.append(m.logodds_pwm.cols)
        else:
            pwm_lists.append([])
            user_pwms.append(None)

    for ff, fr, rf, mo in adj_tabs:
        if mo not in (0, m0.max_olap_bases):
            raise ValueError("adj-dist max_overlap mismatch")

    d_max = max(max(len(t[0]), len(t[1]), len(t[2])) for t in adj_tabs)
    adj_dist = np.zeros((g, 3, d_max), dtype=np.float32)
    adj_dist_len = np.zeros((g, 3), dtype=np.int32)
    for gi, (ff, fr, rf, _mo) in enumerate(adj_tabs):
        for k, t in enumerate((ff, fr, rf)):
            adj_dist[gi, k, : len(t)] = t
            adj_dist[gi, k, len(t):] = t[-1]  # saturate pads at .back()
            adj_dist_len[gi, k] = len(t)

    widths = set()
    cmax = 1
    for gi in range(g):
        if pwm_lists[gi]:
            widths.update(p.shape[0] for p in pwm_lists[gi])
            cmax = max(cmax, len(pwm_lists[gi]))
        if user_pwms[gi] is not None:
            widths.add(user_pwms[gi].shape[0])
    if len(widths) > 1:
        raise ValueError("mixed PWM widths in one chunk")
    w = widths.pop() if widths else 0

    pwm_cols = np.zeros((g, cmax, max(w, 1), 4), dtype=np.float64)
    pwm_n = np.zeros(g, dtype=np.int32)
    pwm_user = np.zeros((g, max(w, 1), 4), dtype=np.float64)
    pwm_is_user = np.zeros(g, dtype=bool)
    gc_lp = np.zeros((g, 4), dtype=np.float64)
    for gi, m in enumerate(models_list):
        gc = m.indep_gc_frac
        gc_log = np.log(0.5 * np.float64(gc))
        at_log = np.log(0.5 * (1.0 - np.float64(gc)))
        gc_lp[gi] = [at_log, gc_log, gc_log, at_log]
        if pwm_lists[gi]:
            for ci, cols in enumerate(pwm_lists[gi]):
                pwm_cols[gi, ci] = cols
            pwm_n[gi] = len(pwm_lists[gi])
        elif user_pwms[gi] is not None:
            pwm_user[gi] = user_pwms[gi]
            pwm_is_user[gi] = True

    return DeviceBank(
        gene_mip=gmip, gene_probs=gprobs, indep_mip=imip, indep_probs=iprobs,
        model_len=m0.gene_icm.model_len, depth=max(
            m.gene_icm.model_depth for m in models_list),
        periodicity=m0.gene_icm.periodicity,
        fwd_start=np.stack([c["fwd_start"] for c in ct]),
        rev_start=np.stack([c["rev_start"] for c in ct]),
        fwd_stop=np.stack([c["fwd_stop"] for c in ct]),
        rev_stop=np.stack([c["rev_stop"] for c in ct]),
        which_fwd=np.stack([c["which_fwd"] for c in ct]),
        which_rev=np.stack([c["which_rev"] for c in ct]),
        prior=prior, start_lo=start_lo, len_score=len_score,
        adj_or=adj_or, adj_dist=adj_dist, adj_dist_len=adj_dist_len,
        ignore_score_len=isl,
        pwm_cols=pwm_cols, pwm_n=pwm_n, pwm_user=pwm_user,
        pwm_is_user=pwm_is_user, gc_lp=gc_lp,
        min_gene_len=m0.min_gene_len, max_olap=m0.max_olap_bases,
        event_threshold=m0.event_threshold,
        start_threshold=m0.start_threshold,
        ribosome_window=m0.ribosome_window_size,
        pwm_w=w,
    )


# ---------------------------------------------------------------------------
# Per-read device computation. Everything below is jnp code over one padded
# read (vmapped by predict_batch); Lp (padded length, multiple of 3) is
# static, n is traced.
# ---------------------------------------------------------------------------


def _cls3_cummax(vals):
    """Running max within each i%3 class (frame-strided scan) along the
    LAST axis; works for (L,) and batched (B, L)."""
    import jax

    shp = vals.shape
    v = vals.reshape(*shp[:-1], -1, 3)
    return jax.lax.associative_scan(
        _maximum, v, axis=v.ndim - 2
    ).reshape(shp)


def _cls3_revcummin(vals):
    import jax

    shp = vals.shape
    v = vals.reshape(*shp[:-1], -1, 3)
    return jax.lax.associative_scan(
        _minimum, v, axis=v.ndim - 2, reverse=True
    ).reshape(shp)


def _cls3_cumsum(vals):
    """Inclusive cumsum within each i%3 class along the last axis."""
    import jax.numpy as jnp

    shp = vals.shape
    v = vals.reshape(*shp[:-1], -1, 3)
    return jnp.cumsum(v, axis=v.ndim - 2).reshape(shp)


def _pick_first(a, b):
    """Associative nearest-valid combiner over (value, valid) pairs.

    In a reverse associative_scan (flip-scan-flip), the FIRST argument
    accumulates the farther suffix; the nearer element (b) must win when
    valid so out[i] is the value at the nearest valid position >= i."""
    import jax.numpy as jnp

    av, af = a
    bv, bf = b
    return jnp.where(bf, bv, av), af | bf


def _cls3_revfill(vals, valid):
    """out[q] = vals at the NEAREST VALID position >= q in q's i%3 class
    (inclusive); any_valid flag alongside. The segmented slot->member
    broadcast: per-slot fields placed at their closing-stop positions
    propagate back over the whole ORF run in one log-depth scan instead
    of one XLA gather per field."""
    import jax

    shp = vals.shape
    v = vals.reshape(*shp[:-1], -1, 3)
    f = valid.reshape(*shp[:-1], -1, 3)
    ov, of = jax.lax.associative_scan(
        _pick_first, (v, f), axis=v.ndim - 2, reverse=True
    )
    return ov.reshape(shp), of.reshape(shp)


def _cls3_fwdfill(vals, valid):
    """out[q] = vals at the nearest valid position <= q (same class)."""
    import jax

    def pick_last(a, b):
        import jax.numpy as jnp

        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    shp = vals.shape
    v = vals.reshape(*shp[:-1], -1, 3)
    f = valid.reshape(*shp[:-1], -1, 3)
    ov, of = jax.lax.associative_scan(
        pick_last, (v, f), axis=v.ndim - 2
    )
    return ov.reshape(shp), of.reshape(shp)


def _maximum(a, b):
    import jax.numpy as jnp

    return jnp.maximum(a, b)


def _minimum(a, b):
    import jax.numpy as jnp

    return jnp.minimum(a, b)


def _shift_right(arr, k, fill):
    """arr shifted right by k along the LAST axis (arr[..., i-k])."""
    import jax.numpy as jnp

    pad = jnp.full(arr.shape[:-1] + (k,), fill, arr.dtype)
    return jnp.concatenate([pad, arr[..., :-k]], axis=-1)


def _shift_left(arr, k, fill):
    import jax.numpy as jnp

    pad = jnp.full(arr.shape[:-1] + (k,), fill, arr.dtype)
    return jnp.concatenate([arr[..., k:], pad], axis=-1)


def _gather_guard(arr, idx, fill):
    """arr[..., idx] along the last axis with out-of-range idx -> fill.

    1-D: plain fancy index. Batched (B, L) with idx (B, K): lowered via
    take_along_axis (a same-shape gather) rather than a vmapped per-row
    fancy index, which lowers to XLA's general batched gather."""
    import jax.numpy as jnp

    L = arr.shape[-1]
    ok = (idx >= 0) & (idx < L)
    idx_c = jnp.clip(idx, 0, L - 1)
    if arr.ndim == 1:
        return jnp.where(ok, arr[idx_c], fill)
    return jnp.where(ok, jnp.take_along_axis(arr, idx_c, axis=-1), fill)


def _gather2(arr2, row, idx, fill):
    """arr2[..., row, idx] elementwise with out-of-range idx -> fill.
    arr2: (3, L) or (B, 3, L); row/idx: (K,) or (B, K)."""
    import jax.numpy as jnp

    L = arr2.shape[-1]
    ok = (idx >= 0) & (idx < L)
    idx_c = jnp.clip(idx, 0, L - 1)
    if arr2.ndim == 2:
        return jnp.where(ok, arr2[row, idx_c], fill)
    flat = arr2.reshape(arr2.shape[0], -1)
    return jnp.where(
        ok, jnp.take_along_axis(flat, row * L + idx_c, axis=-1), fill
    )


def _read_tables(seq, n, gi, bank):
    """Per-position codon-class tables and scan arrays, BATCHED.

    seq: (B, Lp) i32, n/gi: (B,). Returns a dict of (B, Lp) arrays
    mirroring the host's boolean codon arrays (engine.orfs.scan_codons)
    and stop-index arrays (MgSequenceState._save_prev_stops), plus the
    frame-strided next/prev-start/stop scans the ORF assembler queries.
    The whole frontend is written batched (no vmap): vmapped per-row
    fancy indexing would lower to XLA's general batched gathers instead
    of same-shape take_along_axis.
    """
    import jax.numpy as jnp

    B, Lp = seq.shape
    i = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    n2 = n[:, None]
    valid = i < n2

    s0 = _shift_right(seq, 2, 0)
    s1 = _shift_right(seq, 1, 0)
    cod6 = jnp.where((i >= 2) & valid, s0 * 16 + s1 * 4 + seq, 64)

    t = {}
    t["cod6"] = cod6

    # codon classification via ONE shared one-hot over the 65-entry codon
    # axis: shared-mask reductions instead of one gather per table (not
    # yet measured against plain gathers on a GPU)
    ohc = cod6[:, :, None] == jnp.arange(65, dtype=jnp.int32)[None, None, :]

    def ctab(key, dt):
        tab = bank[key][gi]                      # (B, 65), one-shot
        acc = jnp.sum(
            jnp.where(ohc, tab[:, None, :].astype(jnp.int32), 0), axis=2
        )
        return acc.astype(dt) if dt is not bool else acc > 0

    t["is_fwd_start"] = ctab("fwd_start", bool)
    t["is_rev_start"] = ctab("rev_start", bool)
    t["is_fwd_stop"] = ctab("fwd_stop", bool)
    t["is_rev_stop"] = ctab("rev_stop", bool)
    t["which_fwd"] = ctab("which_fwd", jnp.int32)
    t["which_rev"] = ctab("which_rev", jnp.int32)

    nBIG = jnp.int32(BIG)
    t["pstop_f"] = _cls3_cummax(jnp.where(t["is_fwd_stop"], i, -nBIG))
    t["nstop_f"] = _cls3_revcummin(jnp.where(t["is_fwd_stop"], i, nBIG))
    t["pstop_r"] = _cls3_cummax(jnp.where(t["is_rev_stop"], i, -nBIG))
    t["nstop_r"] = _cls3_revcummin(jnp.where(t["is_rev_stop"], i, nBIG))
    t["nstart_f"] = _cls3_revcummin(jnp.where(t["is_fwd_start"], i, nBIG))
    t["pstart_r"] = _cls3_cummax(jnp.where(t["is_rev_start"], i, -nBIG))
    # nsq[q]: next q' >= q (same class) whose codon LAST base q'+2 is a fwd
    # start — the scorer's start-candidate positions (start first base).
    hit2f = _shift_left(t["is_fwd_start"], 2, False)
    t["nsq_f"] = _cls3_revcummin(jnp.where(hit2f, i, nBIG))
    t["psu_r"] = _cls3_cummax(jnp.where(t["is_rev_start"], i, -nBIG))

    # Save_Prev_Stops mirrors (MgSequenceState): per-position previous fwd
    # stop / next rev stop register values (glimmer-mg.cc:675).
    cls = i % 3
    init_f = jnp.where(cls == 0, 0, jnp.where(cls == 1, 1, -1))
    t["fwd_prev"] = jnp.maximum(init_f, t["pstop_f"])
    f_r = (n2 - 1 - i) % 3
    init_r = jnp.where(f_r == 0, n2 - 1, jnp.where(f_r == 1, n2 - 2, n2))
    hit_r = _shift_left(t["is_rev_stop"], 2, False)
    rn_cand = _cls3_revcummin(jnp.where(hit_r, i, nBIG))
    t["rev_next"] = jnp.minimum(init_r, rn_cand)
    return t


def _fps(t, n, x):
    """fwd_prev_stop(x) with the host's out-of-range passthrough.
    Batched: t arrays (B, Lp), n (B,), x (B, K)."""
    import jax.numpy as jnp

    inside = (x >= 0) & (x < n[:, None])
    return jnp.where(inside, _gather_guard(t["fwd_prev"], x, 0), x)


def _rns(t, n, x):
    import jax.numpy as jnp

    inside = (x >= 0) & (x < n[:, None])
    return jnp.where(inside, _gather_guard(t["rev_next"], x, 0), x)


def _fwd_orf_slots(t, n, Lp, min_gene_len, indel_orfs=False,
                   min_indel_orf_len=15):
    """Forward-ORF candidate slots: Lp real (by stop last-base subscript)
    + 3 virtual truncated stops at subscripts n..n+2.

    Mirrors Do_Fwd_Stop_Codon / Handle_First_Forward_Stop
    (glimmer_base.cc:461-506, 946-974; host engine.orfs.find_orfs) and the
    scorer's segment bounds (MgScorer.score_orf_starts, glimmer-mg.cc:1693).
    """
    import jax.numpy as jnp

    B = n.shape[0]
    nBIG = jnp.int32(BIG)
    n2 = n[:, None]
    k3 = jnp.arange(3, dtype=jnp.int32)[None, :]
    stop_m = t["is_fwd_stop"]
    pos = jnp.arange(Lp, dtype=jnp.int32)[None, :]

    # real rows are position-indexed (values only consumed at stop
    # positions); virtual rows are the 3 trailing columns — everything is
    # shifts, class fill scans, and 3-column selects (no wide gathers)
    iS_r = jnp.broadcast_to(pos, (B, Lp))
    iS_v = n2 + k3
    cv = iS_v % 3

    pst3 = _shift_right(t["pstop_f"], 3, -nBIG)
    ip_r = pst3
    ip_v = _sel3(t["pstop_f"][:, Lp - 3:], cv)  # last stop in the class
    has_prev_r = ip_r > -nBIG // 2
    has_prev_v = ip_v > -nBIG // 2

    # first fwd start after the previous stop: forward-fill of
    # nstart_f[p+3] placed at stop positions, read at s-3 / class end
    H = _shift_left(t["nstart_f"], 3, nBIG)
    FFv, FFok = _cls3_fwdfill(jnp.where(stop_m, H, nBIG), stop_m)
    ssp = jnp.where(FFok, FFv, nBIG)
    ss_prev_r = _shift_right(ssp, 3, nBIG)
    ss_prev_v = _sel3(ssp[:, Lp - 3:], cv)
    np_cols = jnp.stack(
        [t["nstart_f"][:, 3], t["nstart_f"][:, 4], t["nstart_f"][:, 2]],
        axis=1)                                   # no-prev: nstart_f[c0]
    ss_np_r = _sel3(np_cols, jnp.broadcast_to(pos % 3, (B, Lp)))
    ss_np_v = _sel3(np_cols, cv)
    s_star_r = jnp.where(has_prev_r, ss_prev_r, ss_np_r)
    s_star_v = jnp.where(has_prev_v, ss_prev_v, ss_np_v)

    def gene_emit(iS, ip, has_prev, s_star, slot_exists):
        gl = jnp.where(s_star < iS, iS - s_star, 0)
        ol = jnp.where(has_prev, iS - ip - 3, (iS - 2) - ((iS - 2) % 3))
        gl = jnp.where((~has_prev) & (gl < min_gene_len), ol, gl)
        keep = gl >= min_gene_len
        if indel_orfs:
            # error modes keep short-gene ORFs whose frame length clears
            # MIN_INDEL_ORF_LEN (engine find_orfs keep_len rule)
            keep = keep | (ol >= min_indel_orf_len)
        return slot_exists & keep

    emit_r = gene_emit(iS_r, ip_r, has_prev_r, s_star_r, stop_m)
    emit_v = gene_emit(iS_v, ip_v, has_prev_v, s_star_v, True)

    # scorer bounds (Cumulative_Frame_Score segment): lo = fps(iS-3)+1
    lo_r = jnp.where(
        pos >= 3, _shift_right(t["fwd_prev"], 3, 0), pos - 3
    ) + 1
    xv = n2 + k3 - 3
    fpv = _gather_guard(t["fwd_prev"], xv, 0)
    lo_v = jnp.where((xv >= 0) & (xv < n2), fpv, xv) + 1

    def cat(a, b):
        return jnp.concatenate(
            [jnp.broadcast_to(a, (B, Lp)), jnp.broadcast_to(b, (B, 3))],
            axis=1)

    iS = cat(iS_r, iS_v)
    emit = cat(emit_r, emit_v)
    lo = cat(lo_r, lo_v)
    hi = iS - 2
    mm = hi - lo
    top_j = jnp.maximum(((mm - 1) // 3) * 3, -3)
    orf_trunc = lo < 3
    t3 = cat(jnp.broadcast_to(pos, (B, Lp)) >= n2, jnp.ones((B, 3), bool))
    key = cat(2 * iS_r + 1, 2 * Lp + 8 + k3 + jnp.zeros((B, 3), jnp.int32))
    return {
        "iS": iS, "emit": emit, "lo": lo, "hi": hi, "mm": mm,
        "top_j": top_j, "orf_trunc": orf_trunc, "t3": t3, "key": key,
        "stop_pos": iS - 1,
    }


def _rev_orf_slots(t, n, Lp, min_gene_len, indel_orfs=False,
                   min_indel_orf_len=15):
    """Reverse-ORF candidate slots: Lp real (closing rev-stop subscript)
    + 3 end-of-sequence slots (frame classes 0..2).

    Mirrors Do_Rev_Stop_Codon / Handle_First_Reverse_Stop / Finish_Orfs
    (glimmer_base.cc:509-539, 978-1000, 783-806; allow_truncated linear).
    """
    import jax.numpy as jnp

    B = n.shape[0]
    nBIG = jnp.int32(BIG)
    n2 = n[:, None]
    k3 = jnp.arange(3, dtype=jnp.int32)[None, :]
    stop_m = t["is_rev_stop"]
    pos = jnp.arange(Lp, dtype=jnp.int32)[None, :]

    # real rows position-indexed (consumed at stop positions), end slots
    # are the 3 trailing columns with STATIC classes 0..2 — all shifts,
    # fill scans, and column selects (see the forward builder's comment)
    c_r = jnp.broadcast_to(pos % 3, (B, Lp))
    slot_exists_r = stop_m

    pst3 = _shift_right(t["pstop_r"], 3, -nBIG)
    ip_r = pst3
    ip_v = t["pstop_r"][:, Lp - 3:]              # class tops, column k
    has_prev_r = ip_r > -nBIG // 2
    has_prev_v = ip_v > -nBIG // 2

    def vstop_of(c):
        return jnp.where(c == 0, -1, jnp.where(c == 1, 0, -2))

    orf_stop_r = jnp.where(has_prev_r, ip_r - 1, vstop_of(c_r))
    orf_stop_v = jnp.where(has_prev_v, ip_v - 1, vstop_of(k3))

    # last rev start inside the segment
    ls_r = _shift_right(t["pstart_r"], 3, -nBIG)       # pstart_r[iC-3]
    ls_v = _gather_guard(
        t["pstart_r"], jnp.broadcast_to(n2 - 3, (B, 3)), -nBIG)

    def gene_emit(ls, ip, has_prev, orf_stop, orf_len, slot_exists):
        ls_ok = (ls > jnp.where(has_prev, ip, -nBIG)) & (ls > -nBIG // 2)
        gl = jnp.where(ls_ok, (ls - 1) - orf_stop, 0)
        return gl, ls_ok

    gl_r, _ok = gene_emit(ls_r, ip_r, has_prev_r, orf_stop_r, None, None)
    keep_r = gl_r >= min_gene_len
    gl_v, _okv = gene_emit(ls_v, ip_v, has_prev_v, orf_stop_v, None, None)
    end_orf_len = n2 - orf_stop_v - 2
    end_orf_len = end_orf_len - end_orf_len % 3
    gl_v = jnp.where(gl_v < min_gene_len, end_orf_len, gl_v)
    keep_v = gl_v >= min_gene_len
    if indel_orfs:
        ol_r = jnp.broadcast_to(pos, (B, Lp)) - orf_stop_r - 4
        keep_r = keep_r | (ol_r >= min_indel_orf_len)
        keep_v = keep_v | (end_orf_len >= min_indel_orf_len)
    emit_r = slot_exists_r & keep_r
    emit_v = keep_v

    # hi = rev_next[end_point - 1] + 1: the has-prev branch reads the
    # register at prev_stop+1 (forward-fill of rev_next[p+1] placed at
    # stops), the no-prev branch reads fixed columns {1,2,0} per class
    Hn = _shift_left(t["rev_next"], 1, 0)
    FFn, FFnok = _cls3_fwdfill(jnp.where(stop_m, Hn, 0), stop_m)
    rn_cols = jnp.stack(
        [t["rev_next"][:, 1], t["rev_next"][:, 2], t["rev_next"][:, 0]],
        axis=1)                                    # x = vstop+2 in {1,2,0}

    def hi_of(x_ep, ff_val, has_prev, c):
        rnv = jnp.where(has_prev, ff_val, _sel3(rn_cols, c))
        inside = (x_ep >= 0) & (x_ep < n2)
        return jnp.where(inside, rnv, x_ep) + 1

    x_r = orf_stop_r + 2
    ff_r = _shift_right(jnp.where(FFnok, FFn, 0), 3, 0)
    hi_r = hi_of(x_r, ff_r, has_prev_r, c_r)
    x_v = orf_stop_v + 2
    ff_v = jnp.where(FFnok, FFn, 0)[:, Lp - 3:]    # class-end fill, col k
    hi_v = hi_of(x_v, ff_v, has_prev_v, k3)

    def cat(a, b):
        return jnp.concatenate(
            [jnp.broadcast_to(a, (B, Lp)), jnp.broadcast_to(b, (B, 3))],
            axis=1)

    idx = jnp.arange(Lp + 3, dtype=jnp.int32)[None, :]
    real = idx < Lp
    iC = cat(jnp.broadcast_to(pos, (B, Lp)), n2 + k3)
    c = cat(c_r, k3)
    orf_stop = cat(orf_stop_r, orf_stop_v)
    emit = cat(emit_r, emit_v)
    hi = cat(hi_r, hi_v)
    lo = orf_stop + 3
    mm = hi - lo
    top_j = jnp.maximum(((mm - 1) // 3) * 3, -3)
    orf_trunc = (n2 - (hi - 1)) < 3
    t3 = orf_stop < 1
    key = jnp.where(real, 2 * iC, 2 * Lp + 4 + (idx - Lp))
    return {
        "iC": iC, "emit": emit, "lo": lo, "hi": hi, "mm": mm,
        "top_j": top_j, "orf_trunc": orf_trunc, "t3": t3, "key": key,
        "stop_pos": orf_stop, "c": c,
    }


# ---------------------------------------------------------------------------
# Start scoring: LLR prefix sums, RBS scorers, event candidates
# ---------------------------------------------------------------------------


def _frame_prefix_sums(gene6, ind6, n, Lp):
    """Per-frame f64 LLR prefix sums in read coordinates.

    gene6/ind6 are the six-frame kernel outputs (rows 0-2: fixed frames
    over the REVERSED read, rows 3-5: over the COMPLEMENTED read,
    ops.icm_score.mg_six_frame_batch). Returns (Sf (3, Lp), Sr (3, Lp))
    where Sf[c] are inclusive prefix sums of the per-base values every
    forward ORF in stop-class c reads (Cumulative_Frame_Score's cycling
    f = (1+t)%3 selection, glimmer-mg.cc:561), and Sr[c] the reverse-frame
    analogue; ORF cumulative start scores are O(1) differences of these.
    """
    import jax.numpy as jnp

    B = gene6.shape[0]
    p = jnp.arange(Lp, dtype=jnp.int32)
    valid = p[None, :] < n[:, None]
    # x[n-1-p] as flip + per-row roll. The roll amount is per row, so it
    # is expressed as ONE same-width take_along_axis on the flattened
    # (B, 3*Lp) block rather than a generic per-element reversal gather.
    roll_idx = (p[None, :] - (n[:, None] - Lp)) % Lp        # (B, Lp)
    flat_idx = (jnp.tile(roll_idx, (1, 3))
                + (jnp.arange(3 * Lp, dtype=jnp.int32)[None, :] // Lp) * Lp)

    def rev3(x):
        fl = jnp.flip(x, axis=-1).reshape(B, 3 * Lp)
        return jnp.take_along_axis(fl, flat_idx, axis=1).reshape(B, 3, Lp)

    # flip/roll commutes with the elementwise f64 subtraction, so ONE
    # rolled gather on the difference replaces two (the roll gather is the
    # frontend's single most expensive op: ~16 ms at (1024, 3*513))
    diff_f = gene6[:, :3].astype(jnp.float64) - ind6[:, :3].astype(
        jnp.float64)
    fs_f = jnp.where(valid[:, None, :], rev3(diff_f), 0.0)
    fs_r = jnp.where(
        valid[:, None, :],
        gene6[:, 3:].astype(jnp.float64) - ind6[:, 3:].astype(jnp.float64),
        0.0,
    )
    c = jnp.arange(3, dtype=jnp.int32)[:, None]

    def rowsel(x, rows):
        # x (B, 3, Lp); rows (3, Lp) in {0,1,2} shared across lanes
        r = rows[None, :, :]
        return jnp.where(
            r == 0, x[:, 0:1, :],
            jnp.where(r == 1, x[:, 1:2, :], x[:, 2:3, :])
        )

    rowf = (c + 1 - p[None, :]) % 3
    Sf = jnp.cumsum(rowsel(fs_f, rowf), axis=2)
    rowr = (p[None, :] - c) % 3
    Sr = jnp.cumsum(rowsel(fs_r, rowr), axis=2)
    return Sf, Sr


def _pwm_arrays(seq, n, gi, bank, pwm_w: int):
    """Whole-read RBS window tables (one entry per window position).

    Mixture mode mirrors MetaPwmScorer._precompute (PWM_Meta_Score_*,
    glimmer-mg.cc:1900-2060): mixf[p0] = mean over class PWMs of the
    window probability product, gcf[p0] = GC-background log sum; the
    per-start scorers then take log(mix) - gc over the separation window.
    User mode mirrors PwmScorer (log-odds column sums).
    """
    import jax.numpy as jnp

    if pwm_w == 0:
        return None
    B, Lp = seq.shape
    comp = 3 - seq
    cols = bank["pwm_cols"][gi]  # (B, C, W, 4) f64
    nm = bank["pwm_n"][gi]       # (B,)
    ucols = bank["pwm_user"][gi]  # (B, W, 4) f64
    gclp = bank["gc_lp"][gi]  # (B, 4) f64

    C = cols.shape[1]

    def sel4_2d(tab, b):
        # tab (B, 4); b (B, Lp) -> (B, Lp)
        out = jnp.broadcast_to(tab[:, 0:1], b.shape).astype(tab.dtype)
        for k in range(1, 4):
            out = jnp.where(b == k, tab[:, k:k + 1], out)
        return out

    def sel4_3d(tab, b):
        # tab (B, C, 4); b (B, Lp) -> (B, C, Lp)
        b3 = b[:, None, :]
        out = jnp.broadcast_to(tab[:, :, 0:1], (B, C, b.shape[1])).astype(
            tab.dtype)
        for k in range(1, 4):
            out = jnp.where(b3 == k, tab[:, :, k:k + 1], out)
        return out

    prod_f = jnp.ones((B, C, Lp), dtype=jnp.float64)
    prod_r = jnp.ones((B, C, Lp), dtype=jnp.float64)
    gcf = jnp.zeros((B, Lp), dtype=jnp.float64)
    gcr = jnp.zeros((B, Lp), dtype=jnp.float64)
    uf = jnp.zeros((B, Lp), dtype=jnp.float64)
    ur = jnp.zeros((B, Lp), dtype=jnp.float64)
    for j in range(pwm_w):
        sj = _shift_left(seq, j, 0)
        cj = _shift_left(comp, pwm_w - 1 - j, 0)
        prod_f = prod_f * sel4_3d(cols[:, :, j, :], sj)
        prod_r = prod_r * sel4_3d(cols[:, :, j, :], cj)
        gcf = gcf + sel4_2d(gclp, sj)
        gcr = gcr + sel4_2d(gclp, cj)
        uf = uf + sel4_2d(ucols[:, j, :], sj)
        ur = ur + sel4_2d(ucols[:, j, :], cj)
    cmask = (jnp.arange(C)[None, :] < nm[:, None])[:, :, None]
    denom = jnp.maximum(nm, 1).astype(jnp.float64)[:, None]
    mixf = jnp.sum(jnp.where(cmask, prod_f, 0.0), axis=1) / denom
    mixr = jnp.sum(jnp.where(cmask, prod_r, 0.0), axis=1) / denom
    is_user = bank["pwm_is_user"][gi][:, None]  # (B, 1)
    has_mix = (nm > 0)[:, None]
    # one log pass per strand; the separation scan below is then pure
    # shift-compare (the per-candidate scorers become two gathers)
    sc_f = jnp.where(is_user, uf, jnp.log(mixf) - gcf)
    sc_r = jnp.where(is_user, ur, jnp.log(mixr) - gcr)
    return {
        "sc_f": sc_f, "sc_r": sc_r,
        "is_user": is_user, "has_mix": has_mix,
    }


def _pwm_window_tables(pw, n, Lp: int, ws: int, W: int):
    """Per-position (score, sep) of the best RBS window for every possible
    start position, with the reference's strict-> first-max rule (smallest
    separation wins ties). Indexed by 0-based (pos - 1); every candidate
    start then needs only two gathers."""
    import jax.numpy as jnp

    if pw is None:
        return None
    any_mode = pw["is_user"] | pw["has_mix"]  # (B, 1)
    p0 = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    n2 = n[:, None]

    shp = pw["sc_f"].shape
    best_f = jnp.full(shp, -jnp.inf, dtype=pw["sc_f"].dtype)
    sep_f = jnp.zeros(shp, dtype=jnp.int32)
    best_r = jnp.full(shp, -jnp.inf, dtype=pw["sc_f"].dtype)
    sep_r = jnp.zeros(shp, dtype=jnp.int32)
    for s in range(ws - W + 1):
        # fwd: window start = pos - W - 1 - s = p0 - W - s
        scf = _shift_right(pw["sc_f"], min(W + s, Lp), -np.inf)
        okf = (p0 - W - s >= 0) & any_mode
        tkf = okf & (scf > best_f)
        best_f = jnp.where(tkf, scf, best_f)
        sep_f = jnp.where(tkf, s, sep_f)
        # rev: window key k = pos + s = p0 + 1 + s; valid while
        # hi = pos - 1 + W + s < n
        scr = _shift_left(pw["sc_r"], min(s + 1, Lp), -np.inf)
        okr = (p0 + W + s < n2) & any_mode
        tkr = okr & (scr > best_r)
        best_r = jnp.where(tkr, scr, best_r)
        sep_r = jnp.where(tkr, s, sep_r)

    def fix(best, sep, user_zero):
        none = ~jnp.isfinite(best)
        best = jnp.where(none & user_zero, 0.0, best)
        sep = jnp.where(none, 0, sep)
        return best, sep

    best_f, sep_f = fix(best_f, sep_f, pw["is_user"])
    best_r, sep_r = fix(best_r, sep_r, pw["is_user"])
    return {"bf": best_f, "sf": sep_f, "br": best_r, "sr": sep_r}


def _pwm_fwd(pwt, pos):
    """(pwm_score, sep) of forward starts at 1-based positions ``pos`` —
    gathers from the per-position window tables."""
    import jax.numpy as jnp

    if pwt is None:
        z = jnp.zeros_like(pos, dtype=jnp.float64)
        return z, jnp.zeros_like(pos)
    return (
        _gather_guard(pwt["bf"], pos - 1, 0.0),
        _gather_guard(pwt["sf"], pos - 1, 0),
    )


def _pwm_rev(pwt, pos):
    import jax.numpy as jnp

    if pwt is None:
        z = jnp.zeros_like(pos, dtype=jnp.float64)
        return z, jnp.zeros_like(pos)
    return (
        _gather_guard(pwt["br"], pos - 1, 0.0),
        _gather_guard(pwt["sr"], pos - 1, 0),
    )


def _add_pwm(score, pwm, sep):
    """Add_Events' separation-weighted RBS boost (glimmer_base.cc:267-295)."""
    import jax.numpy as jnp

    LO_SEP, HI_SEP, HI_TAIL = 4, 10, 6
    coeff = jnp.where(
        sep < LO_SEP,
        sep.astype(jnp.float64) / LO_SEP,
        jnp.where(
            sep <= HI_SEP,
            1.0,
            jnp.where(
                sep < HI_SEP + HI_TAIL,
                (HI_SEP + HI_TAIL - sep).astype(jnp.float64) / HI_TAIL,
                0.0,
            ),
        ),
    )
    add = (pwm >= 0.0) & (coeff > 0.0)
    return jnp.where(add, score + coeff * pwm, score)


# ---------------------------------------------------------------------------
# Event candidate construction (Add_Events semantics, array form)
# ---------------------------------------------------------------------------

# Event type codes — match engine.events (INITIAL=0 .. TERMINAL=5)
E_FWD_START, E_FWD_STOP, E_REV_START, E_REV_STOP = 1, 2, 3, 4


def _start_candidates_fwd(t, fw, n, Lp, gi, bank, Sf, pw, consts, seq=None,
                          quals=None):
    """Forward-strand start-event candidates.

    Two families: one per read position q (the start codon's first base;
    every position belongs to exactly one forward stop-class chain) and
    one 'truncated first start' per forward-ORF slot (the unconditional
    top-of-ORF start of Score_Orf_Starts when the ORF is 5'-truncated,
    glimmer-mg.cc:1769-1800). Returns per-candidate event fields plus the
    per-ORF aggregates (best raw score, any-event) for the gates, plus the
    substitution-extension families when consts["subs"] (the
    Score_Orf_Starts error recursion lands exactly on the PREVIOUS slot's
    segment, glimmer-mg.cc:1769; see COMPONENTS.md r5 design note).
    """
    import jax.numpy as jnp

    min_gene_len, ws, W = consts["min_gene_len"], consts["ws"], consts["W"]
    min_j = max(min(3, min_gene_len - 3), min_gene_len - 3)
    ev_thresh = consts["event_threshold"]

    B = n.shape[0]
    n2 = n[:, None]
    q = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    c = (q + 2) % 3  # stop-subscript class of this position's chain
    i_next = _shift_left(t["nstop_f"], 5, BIG)  # nstop_f[q+5]
    ivirt = n2 + (q + 2 - n2) % 3
    iS = jnp.minimum(i_next, ivirt)
    slot = jnp.where(iS >= n2, Lp + (iS - n2), iS)
    stop_m = t["is_fwd_stop"]
    vcls = (q + 2 - n2) % 3  # virtual-slot index of q's chain

    # slot -> member broadcast: per-slot values, placed at their closing
    # stop's position (member q reads its run's stop at q+5) and
    # reverse-filled along the class chain; the virtual tail is a 3-way
    # select. One log-depth scan per field vs a ~5.4 ms gather.
    def prop(F):
        Gv = _shift_left(F[:, :Lp], 5, jnp.zeros((), F.dtype))
        Vv = _shift_left(stop_m, 5, False)
        rf, anyv = _cls3_revfill(Gv, Vv)
        return jnp.where(anyv, rf, _sel3(F[:, Lp:], vcls))

    is_real = iS < n2
    emit = prop(fw["emit"])
    taa = lambda a: jnp.take_along_axis(a, slot, axis=1)

    # member-local slot fields (no propagation needed): the scorer bounds
    # reduce to shifted per-position registers on the member's own chain
    hi = iS - 2
    j3 = jnp.arange(3, dtype=jnp.int32)[None, :]
    xv3 = n2 + j3 - 3                                   # (B, 3)
    fp3 = _gather_guard(t["fwd_prev"], xv3, 0)
    fp3 = jnp.where(xv3 >= 0, fp3, xv3)                 # _fps passthrough
    fp_virt = _sel3(fp3, vcls)
    lo = jnp.where(
        is_real, _shift_left(t["fwd_prev"], 2, 0), fp_virt
    ) + 1
    mm = hi - lo
    top_j = jnp.maximum(((mm - 1) // 3) * 3, -3)
    t3 = ~is_real

    j = hi - 3 - q
    hit2 = _shift_left(t["is_fwd_start"], 2, False)
    which2 = _shift_left(t["which_fwd"], 2, -1)
    std_valid = (
        emit & (q >= lo) & (j >= min_j) & (j <= top_j) & hit2
    )
    which = which2

    def raw_of(jv, hiv, cv):
        a = _gather2(Sf, cv, hiv - 1, 0.0)
        b = _gather2(Sf, cv, hiv - 1 - jv, 0.0)
        return a - b

    isl = bank["ignore_score_len"][gi][:, None]
    prior = bank["prior"][gi].astype(jnp.float64)[:, None]
    len_tab = bank["len_score"][gi]        # (B, 3, LN)
    LN = len_tab.shape[2]
    start_lo3 = bank["start_lo"][gi]       # (B, 3)

    # raw = Sf[c, iS-3] - Sf[c, q+2]: both ends are class-diagonal reads
    # R[x] = Sf[x%3, x], so the b-end is a shift and the a-end is R at the
    # closing stop (the same revfill placement), virtual tail tiny
    x = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    xm3 = x % 3
    R = jnp.where(
        xm3 == 0, Sf[:, 0, :], jnp.where(xm3 == 1, Sf[:, 1, :], Sf[:, 2, :])
    )
    A_pos = _shift_right(R, 3, 0.0)             # A[p] = Sf[p%3, p-3]
    av_idx = n2 + jnp.arange(3, dtype=jnp.int32)[None, :] - 3  # (B,3)
    a_virt = _gather2(
        Sf, (n2 + jnp.arange(3)[None, :]) % 3, av_idx, 0.0
    )                                            # (B,3)
    A_ext = jnp.concatenate([A_pos, a_virt], axis=1)
    a = prop(A_ext)
    b = _shift_left(R, 2, 0.0)                   # Sf[c, q+2]
    raw_nb = a - b                               # pre-boost (subs reuse it)
    sj = j + 2
    boost = sj > isl
    raw = jnp.where(boost, jnp.maximum(0.0, raw_nb), raw_nb)

    pos = jnp.broadcast_to(q + 3, (B, Lp))  # 1-based event position (kk + 2)
    pwm, sep = (pw["bf"], pw["sf"]) if pw is not None else (
        jnp.zeros((B, Lp), jnp.float64), jnp.zeros((B, Lp), jnp.int32))
    score = raw + prior
    score = _add_pwm(score, pwm, sep)
    start_sel = _sel3(start_lo3, jnp.clip(which, 0, 2)).astype(jnp.float64)
    score = jnp.where(which >= 0, score + start_sel, score)
    len_row = jnp.where(t3, 1, 0)  # std entries: t5 = False
    len_idx = jnp.clip(j // 3 + 1, 0, LN - 1)
    score = score + _gather2(len_tab, len_row, len_idx, 0.0)
    std_pass = std_valid & (score > ev_thresh)

    # --- truncated first-start entries on a (B, 6) domain: 5'-truncation
    # (lo < 3) is only possible for the FIRST ORF of each class chain
    # (real stop subscripts are >= 2, so later ORFs have lo >= 3) plus the
    # 3 virtual end slots — all tr work shrinks to 6 tiny columns ---
    first_stop = t["nstop_f"][:, :3]             # first stop per class
    has_first = first_stop < BIG // 2
    slot6 = jnp.concatenate(
        [jnp.where(has_first, first_stop, -1),
         Lp + jnp.zeros((B, 3), jnp.int32)
         + jnp.arange(3, dtype=jnp.int32)[None, :]], axis=1)  # (B, 6)
    valid6 = jnp.concatenate(
        [has_first, jnp.ones((B, 3), bool)], axis=1)
    slot6c = jnp.clip(slot6, 0, Lp + 2)
    g6 = lambda a: jnp.take_along_axis(a, slot6c, axis=1)

    s_emit = g6(fw["emit"]) & valid6
    s_hi, s_mm, s_top = g6(fw["hi"]), g6(fw["mm"]), g6(fw["top_j"])
    s_trunc, s_t3 = g6(fw["orf_trunc"]), g6(fw["t3"])
    iS6 = g6(fw["iS"])
    tr_valid = s_emit & s_trunc & (s_mm >= 1) & (s_top >= min_j)
    q_t = s_hi - 3 - s_top
    cS = iS6 % 3
    raw_t_nb = raw_of(s_top, s_hi, cS)           # pre-boost (subs reuse it)
    boost_t = (s_top + 2) > isl
    raw_t = jnp.where(boost_t, jnp.maximum(0.0, raw_t_nb), raw_t_nb)
    pos_t = q_t + 3
    pwm_t, sep_t = _pwm_fwd(pw, pos_t - 2)
    score_t = raw_t + prior
    score_t = _add_pwm(score_t, pwm_t, sep_t)
    len_idx_t = jnp.clip(s_top // 3 + 1, 0, LN - 1)
    score_t = score_t + _gather2(len_tab, jnp.where(s_t3, 2, 1), len_idx_t,
                                 0.0)
    tr_pass = tr_valid & (score_t > ev_thresh)

    # --- dedup at the shared position (truncated entry iterates first;
    # the std entry replaces it only with a strictly greater score) ---
    std_at_qt = _gather_guard(std_pass, q_t, False)
    std_score_qt = _gather_guard(score, q_t, -np.inf)
    tr_final = tr_pass & ~(std_at_qt & (std_score_qt > score_t))
    # kill without a scatter: compare q against each of the 6 candidate
    # truncated-start positions
    kill_slot = tr_pass & (std_score_qt <= score_t)
    kill = jnp.zeros((B, Lp), bool)
    for k in range(6):
        kill = kill | ((q == q_t[:, k:k + 1]) & kill_slot[:, k:k + 1])
    std_final = std_pass & ~kill

    # --- per-ORF aggregates over the start_list (host score_orfs_errors:
    # best raw > threshold / any event), scatter-free: each ORF's start
    # candidates are one contiguous class-strided run (q with q+5 past the
    # ORF's previous stop), so existence tests are class-prefix-sum
    # differences at the run boundaries: a cumsum + 2 gathers in place of
    # an XLA scatter. ---
    n_slots = Lp + 3
    thresh = consts["start_threshold"]
    xn3 = n2 + jnp.arange(3, dtype=jnp.int32)[None, :]  # virtual iS (B,3)

    def seg_exists(ind):
        # per-slot existence over the run, scan/shift form: count in
        # (prev_stop-5, s-5] = F[s-5] - F[p-5]; the prev-stop term rides a
        # class forward-fill of F[x-5] placed at stop positions
        F = _cls3_cumsum(ind.astype(jnp.int32))
        Fh = _shift_right(F, 5, 0)                  # F[x-5] at position x
        FFv, FFok = _cls3_fwdfill(jnp.where(stop_m, Fh, 0), stop_m)
        Fp = _shift_right(jnp.where(FFok, FFv, 0), 3, 0)
        ex_real = (Fh - Fp) > 0                     # valid at stop positions
        endF = F[:, Lp - 3:]                        # class k in column k
        endFF = jnp.where(FFok, FFv, 0)[:, Lp - 3:]
        ex_virt = (_sel3(endF, (xn3 + 1) % 3)
                   - _sel3(endFF, xn3 % 3)) > 0     # (B, 3)
        return jnp.concatenate([ex_real, ex_virt], axis=1)

    ex_raw = seg_exists(std_valid & (raw > thresh))
    any_ev = seg_exists(std_final)
    # fold the 6 tr columns back into the slot-domain aggregates
    sNS = jnp.arange(n_slots, dtype=jnp.int32)[None, :]
    tr_raw6 = tr_valid & (raw_t > thresh)
    for k in range(6):
        hit = sNS == slot6[:, k:k + 1]
        ex_raw = ex_raw | (hit & tr_raw6[:, k:k + 1])
        any_ev = any_ev | (hit & tr_final[:, k:k + 1])

    std = {
        "valid": std_final, "pos": pos, "score": score, "slot": slot,
        "trunc": jnp.zeros((B, Lp), dtype=bool),
        "sub": jnp.broadcast_to((c + 1) % 3, (B, Lp)),
    }
    tr = {
        "valid": tr_final, "pos": pos_t, "score": score_t,
        "slot": slot6c,
        "trunc": jnp.ones((B, 6), dtype=bool), "sub": (cS + 1) % 3,
    }

    if not consts.get("subs"):
        return std, tr, ex_raw, any_ev, None

    # ---- substitution extension (Score_Orf_Starts error branch,
    # glimmer-mg.cc:1769): the recursion's segment IS the previous slot's
    # run, so sub-extended candidates of ORF s2 reuse this chain's std
    # scan with per-position suffix terms read from the NEXT slot ----
    Z64 = jnp.zeros((), jnp.float64)
    lowest_j = min(3, min_gene_len - 3)
    # next-stop / next-slot reads on the position domain (at x = s1)
    posI = jnp.broadcast_to(q, (B, Lp))
    rfp, okp = _cls3_revfill(jnp.where(stop_m, posI, 0), stop_m)
    ns2 = _shift_left(jnp.where(okp, rfp, 0), 3, 0)
    has_next = _shift_left(okp, 3, False)
    vclsx = (q - n2) % 3                      # virtual slot j of x's class
    ns2_eff = jnp.where(has_next, ns2, n2 + vclsx)
    mm2 = ns2_eff - q - 3                     # suffix_j at x = s1

    def nxt(F):
        Zf = jnp.zeros((), F.dtype)
        G, ok = _cls3_revfill(jnp.where(stop_m, F[:, :Lp], Zf), stop_m)
        Gv = _shift_left(jnp.where(ok, G, Zf), 3, Zf)
        okv = _shift_left(ok, 3, False)
        return jnp.where(okv, Gv, _sel3(F[:, Lp:], vclsx))

    emit2 = nxt(fw["emit"])
    a2 = nxt(A_ext)                           # Sf[c, hi(s2)-1] at x = s1
    t32 = ~has_next                           # s2 virtual <=> t3(s2)
    mid_a = _shift_right(seq == 0, 1, False)
    last_a = seq == 0
    if consts.get("qual"):
        # Pass_Stop_Penalty with a quality file (glimmer-mg.cc:961): the
        # mutated stop is seq[x-2..x], so codon_p reads the per-base
        # probability table at x-2 / x-1 / x. Multiplication order mirrors
        # the host's running p_stop product.
        cp = jnp.asarray(_CP_TAB)[quals.astype(jnp.int32)]
        cp1 = _shift_right(cp, 1, 0.5)
        cp0 = _shift_right(cp, 2, 0.5)
        fa_of = lambda is_x, c: jnp.where(is_x, 2.0 / 3.0 * c + 1.0 / 3.0, c)
        pp = (cp0 * fa_of(mid_a, cp1)) * fa_of(last_a, cp)
        # clip keeps the penalty finite at the extremes (q=0 -> pp=0 would
        # be +inf where the host raises; q>=~73 under an f32 carry rounds
        # pp to 1.0 -> -inf); every legitimate f64 value is unchanged
        fi = jnp.finfo(pp.dtype)
        pp = jnp.clip(pp, fi.tiny, 1.0 - fi.epsneg)
        pen_pos = jnp.log(1.0 - pp) - jnp.log(pp)
    else:
        # default qualities: 4 constants (python-float log, bit-matching
        # the host) selected by the stop codon's mid/last base being 'a'
        import math as _math

        _dp = 0.999
        _fa = 2.0 / 3.0 * _dp + 1.0 / 3.0

        def _pen(mid_a_c, last_a_c):
            pp = _dp * (_fa if mid_a_c else _dp) * (_fa if last_a_c else _dp)
            return _math.log(1.0 - pp) - _math.log(pp)

        pen_pos = jnp.where(
            mid_a,
            jnp.where(last_a, _pen(True, True), _pen(True, False)),
            jnp.where(last_a, _pen(False, True), _pen(False, False)),
        )
    suf_pos = pen_pos + (a2 - R)              # penalty + score[-1] of seg(s2)

    def prop0(Fpos):
        Zf = jnp.zeros((), Fpos.dtype)
        rf, ok = _cls3_revfill(_shift_left(Fpos, 5, Zf),
                               _shift_left(stop_m, 5, False))
        return jnp.where(ok, rf, Zf)

    sj_q = prop0(mm2)
    suf_q = prop0(suf_pos)
    em2_q = prop0(emit2)
    t32_q = prop0(t32)
    min_j_sub = jnp.maximum(lowest_j, min_gene_len - 3 - sj_q)
    jf = j + 2 + sj_q
    sub_valid = (is_real & em2_q & (q >= lo) & (j >= min_j_sub)
                 & (j <= top_j) & hit2 & (1 + jf >= min_gene_len))
    raw_tot = raw_nb + suf_q
    raw_tot = jnp.where(jf > isl, jnp.maximum(0.0, raw_tot), raw_tot)
    score_sub = raw_tot + prior
    score_sub = _add_pwm(score_sub, pwm, sep)
    score_sub = jnp.where(which >= 0, score_sub + start_sel, score_sub)
    score_sub = score_sub + _gather2(
        len_tab, jnp.where(t32_q, 1, 0),
        jnp.clip((j + sj_q) // 3 + 1, 0, LN - 1), 0.0)
    sub_pass = sub_valid & (score_sub > ev_thresh)

    # truncated sub entries: segment-2 truncation = first run per class;
    # 3 tiny columns at s1 = first_stop, attributed to its next slot s2
    g3t = lambda a: jnp.take_along_axis(
        a, jnp.clip(first_stop, 0, Lp - 1), axis=1)
    sjs6 = g3t(mm2)
    sufs6 = g3t(suf_pos)
    em26 = g3t(emit2)
    t326 = g3t(t32)
    s2slot6 = g3t(jnp.where(has_next, ns2, Lp + vclsx))
    q_t3 = q_t[:, :3]
    minj6 = jnp.maximum(lowest_j, min_gene_len - 3 - sjs6)
    jf6 = s_top[:, :3] + 2 + sjs6
    subtr_valid = (has_first & em26 & s_trunc[:, :3] & (s_mm[:, :3] >= 1)
                   & (s_top[:, :3] >= minj6) & (1 + jf6 >= min_gene_len))
    raw6 = raw_t_nb[:, :3] + sufs6
    raw6 = jnp.where(jf6 > isl, jnp.maximum(0.0, raw6), raw6)
    score6 = raw6 + prior
    score6 = _add_pwm(score6, pwm_t[:, :3], sep_t[:, :3])
    score6 = score6 + _gather2(
        len_tab, jnp.where(t326, 2, 1),
        jnp.clip((s_top[:, :3] + sjs6) // 3 + 1, 0, LN - 1), 0.0)
    subtr_pass = subtr_valid & (score6 > ev_thresh)

    sub_at = _gather_guard(sub_pass, q_t3, False)
    sub_sc = _gather_guard(score_sub, q_t3, -np.inf)
    subtr_final = subtr_pass & ~(sub_at & (sub_sc > score6))
    for k in range(3):
        sub_pass = sub_pass & ~(
            (q == q_t3[:, k:k + 1]) & subtr_pass[:, k:k + 1]
            & (sub_sc[:, k:k + 1] <= score6[:, k:k + 1]))
    sub_final = sub_pass

    # per-slot aggregates of the sub set: count over run(s1), read at s2
    # via its previous stop
    def prev_slot_read(Fpos):
        Zf = jnp.zeros((), Fpos.dtype)
        FFv, FFok = _cls3_fwdfill(jnp.where(stop_m, Fpos, Zf), stop_m)
        vals = jnp.where(FFok, FFv, Zf)
        real_part = _shift_right(vals, 3, Zf)
        virt = _sel3(vals[:, Lp - 3:], xn3 % 3)
        return jnp.concatenate([real_part, virt], axis=1)

    ex_sub = prev_slot_read(
        seg_exists(sub_valid & (raw_tot > thresh))[:, :Lp].astype(jnp.int32)
    ) > 0
    any_sub = prev_slot_read(
        seg_exists(sub_final)[:, :Lp].astype(jnp.int32)) > 0
    subtr_raw6 = subtr_valid & (raw6 > thresh)
    for k in range(3):
        hit = sNS == s2slot6[:, k:k + 1]
        hitk = hit & has_first[:, k:k + 1]
        ex_sub = ex_sub | (hitk & subtr_raw6[:, k:k + 1])
        any_sub = any_sub | (hitk & subtr_final[:, k:k + 1])

    err_pos_stop = prev_slot_read(posI) - 1   # s1 - 1 per slot s2

    subx = {
        "fam_std": {
            "valid": sub_final, "pos": pos, "score": score_sub,
            "trunc": jnp.zeros((B, Lp), dtype=bool),
            "sub": std["sub"],
            "err_pos": jnp.broadcast_to(iS - 1, (B, Lp)),
        },
        "fam_tr": {
            "valid": subtr_final, "pos": q_t3 + 3, "score": score6,
            "trunc": jnp.ones((B, 3), dtype=bool),
            "sub": (cS[:, :3] + 1) % 3,
            "err_pos": jnp.where(has_first, first_stop - 1, -1),
        },
        "any_sub": any_sub,
        "ex_sub": ex_sub,
        "to_member": lambda F: prop(jnp.concatenate(
            [nxt(F), jnp.zeros((B, 3), F.dtype)], axis=1)),
        "s2slot6": jnp.clip(s2slot6, 0, n_slots - 1),
        "s2slot6_valid": has_first,
        "err_pos_stop": err_pos_stop,
    }
    ex_all = ex_raw | ex_sub
    any_all = any_ev | any_sub
    # keep the clean-set indicator for the per-error-set stop events/ids
    subx["any_clean"] = any_ev
    return std, tr, ex_all, any_all, subx


def _start_candidates_rev(t, rv, n, Lp, gi, bank, Sr, pw, consts, seq=None,
                          quals=None):
    """Reverse-strand start-event candidates (mirror of the forward case;
    candidate index u = the genome codon's LAST base of a reverse start)."""
    import jax.numpy as jnp

    min_gene_len, ws, W = consts["min_gene_len"], consts["ws"], consts["W"]
    min_j = max(min(3, min_gene_len - 3), min_gene_len - 3)
    ev_thresh = consts["event_threshold"]

    B = n.shape[0]
    n2 = n[:, None]
    u = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    c = u % 3
    i_close = _shift_left(t["nstop_r"], 3, BIG)  # nstop_r[u+3]
    is_real = i_close < BIG // 2
    slot = jnp.where(is_real, i_close, Lp + c)
    stop_m = t["is_rev_stop"]

    taa = lambda a: jnp.take_along_axis(a, slot, axis=1)

    # slot -> member broadcast (rev placement: member u reads its closing
    # stop at u+3); virtual tail selects by the STATIC class c
    def prop(F):
        Gv = _shift_left(F[:, :Lp], 3, jnp.zeros((), F.dtype))
        Vv = _shift_left(stop_m, 3, False)
        rf, anyv = _cls3_revfill(Gv, Vv)
        return jnp.where(anyv, rf, _sel3(F[:, Lp:], c))

    emit = prop(rv["emit"])

    # member-local slot fields: the rev ORF's prev stop IS pstop_r[u]
    # (nearest stop <= u in u's class), and its right boundary follows
    # from i_close and the rev_next register init values
    ip_m = t["pstop_r"]
    has_prev = ip_m > -jnp.int32(BIG) // 2
    vstop = jnp.where(c == 0, -1, jnp.where(c == 1, 0, -2))
    orf_stop = jnp.where(has_prev, ip_m - 1, vstop)
    lo = orf_stop + 3
    x_ep = lo - 1
    f_r = (n2 - 1 - x_ep) % 3
    init_r = jnp.where(f_r == 0, n2 - 1, jnp.where(f_r == 1, n2 - 2, n2))
    rn = jnp.minimum(init_r, jnp.where(is_real, i_close - 2, BIG))
    inside = (x_ep >= 0) & (x_ep < n2)
    hi = jnp.where(inside, rn, x_ep) + 1
    mm = hi - lo
    top_j = jnp.maximum(((mm - 1) // 3) * 3, -3)
    t3 = orf_stop < 1

    j = u - lo - 1
    std_valid = (
        emit & t["is_rev_start"] & (j >= min_j) & (j <= top_j)
        & (u <= hi - 2)
    )
    which = t["which_rev"]

    def raw_of(jv, lov, cv):
        a = _gather2(Sr, cv, lov - 2 + jv, 0.0)
        b = jnp.where(lov >= 2, _gather2(Sr, cv, lov - 2, 0.0), 0.0)
        return a - b

    isl = bank["ignore_score_len"][gi][:, None]
    prior = bank["prior"][gi].astype(jnp.float64)[:, None]
    len_tab = bank["len_score"][gi]        # (B, 3, LN)
    LN = len_tab.shape[2]
    start_lo3 = bank["start_lo"][gi]       # (B, 3)

    # raw = Sr[c, u-3] - (lo>=2 ? Sr[c, lo-2] : 0): the a-end is the class
    # diagonal Rr shifted; the b-end is Rr at the member's previous stop
    # (forward-fill), with per-class constants when there is none
    xm3 = u % 3
    Rr = jnp.where(
        xm3 == 0, Sr[:, 0, :], jnp.where(xm3 == 1, Sr[:, 1, :], Sr[:, 2, :])
    )
    a = _shift_right(Rr, 3, 0.0)
    FF2v, FF2ok = _cls3_fwdfill(jnp.where(stop_m, Rr, 0.0), stop_m)
    b_np = jnp.stack(
        [Sr[:, 0, 0], Sr[:, 1, 1], jnp.zeros((B,), Sr.dtype)], axis=1
    )
    b = jnp.where(FF2ok, FF2v, _sel3(b_np, c))
    raw_nb = a - b                               # pre-boost (subs reuse it)
    boost = (j + 2) > isl
    raw = jnp.where(boost, jnp.maximum(0.0, raw_nb), raw_nb)

    pos = jnp.broadcast_to(u + 1, (B, Lp))  # REV_START event position = kk
    pwm, sep = (pw["br"], pw["sr"]) if pw is not None else (
        jnp.zeros((B, Lp), jnp.float64), jnp.zeros((B, Lp), jnp.int32))
    score = raw + prior
    score = _add_pwm(score, pwm, sep)
    start_sel = _sel3(start_lo3, jnp.clip(which, 0, 2)).astype(jnp.float64)
    score = jnp.where(which >= 0, score + start_sel, score)
    len_row = jnp.where(t3, 1, 0)
    len_idx = jnp.clip(j // 3 + 1, 0, LN - 1)
    score = score + _gather2(len_tab, len_row, len_idx, 0.0)
    std_pass = std_valid & (score > ev_thresh)

    # --- truncated entries on a (B, 6) domain: 3'-truncation is only
    # possible for the LAST ORF of each class chain (a later stop would
    # pull hi-1 at least 3 below n) plus the 3 end slots ---
    last_stop = t["pstop_r"][:, Lp - 3:]         # last stop per class
    has_last = last_stop > -jnp.int32(BIG) // 2
    slot6 = jnp.concatenate(
        [jnp.where(has_last, last_stop, -1),
         Lp + jnp.zeros((B, 3), jnp.int32)
         + jnp.arange(3, dtype=jnp.int32)[None, :]], axis=1)  # (B, 6)
    valid6 = jnp.concatenate([has_last, jnp.ones((B, 3), bool)], axis=1)
    slot6c = jnp.clip(slot6, 0, Lp + 2)
    g6 = lambda a: jnp.take_along_axis(a, slot6c, axis=1)

    s_emit = g6(rv["emit"]) & valid6
    s_lo, s_hi = g6(rv["lo"]), g6(rv["hi"])
    s_mm, s_top = g6(rv["mm"]), g6(rv["top_j"])
    s_trunc, s_t3 = g6(rv["orf_trunc"]), g6(rv["t3"])
    tr_valid = s_emit & s_trunc & (s_mm >= 1) & (s_top >= min_j)
    u_t = s_lo + s_top + 1
    cS = (s_lo + 1) % 3  # the ORF's stop-subscript class (lo == cu+2 mod 3)
    raw_t_nb = raw_of(s_top, s_lo, cS)           # pre-boost (subs reuse it)
    boost_t = (s_top + 2) > isl
    raw_t = jnp.where(boost_t, jnp.maximum(0.0, raw_t_nb), raw_t_nb)
    pos_t = u_t + 1
    pwm_t, sep_t = _pwm_rev(pw, pos_t)
    score_t = raw_t + prior
    score_t = _add_pwm(score_t, pwm_t, sep_t)
    len_idx_t = jnp.clip(s_top // 3 + 1, 0, LN - 1)
    score_t = score_t + _gather2(len_tab, jnp.where(s_t3, 2, 1), len_idx_t,
                                 0.0)
    tr_pass = tr_valid & (score_t > ev_thresh)

    std_at_ut = _gather_guard(std_pass, u_t, False)
    std_score_ut = _gather_guard(score, u_t, -np.inf)
    tr_final = tr_pass & ~(std_at_ut & (std_score_ut > score_t))
    kill_slot = tr_pass & (std_score_ut <= score_t)
    kill = jnp.zeros((B, Lp), bool)
    for k in range(6):
        kill = kill | ((u == u_t[:, k:k + 1]) & kill_slot[:, k:k + 1])
    std_final = std_pass & ~kill

    # scatter-free aggregates (see the forward-strand comment): rev run
    # for slot s is the class-strided (prev_stop-3, s-3], all classes
    # static, so the virtual columns read the class-end scans directly
    n_slots = Lp + 3
    thresh = consts["start_threshold"]

    def seg_exists(ind):
        F = _cls3_cumsum(ind.astype(jnp.int32))
        Fh = _shift_right(F, 3, 0)                  # F[x-3] at position x
        FFv, FFok = _cls3_fwdfill(jnp.where(stop_m, Fh, 0), stop_m)
        Fp = _shift_right(jnp.where(FFok, FFv, 0), 3, 0)
        ex_real = (Fh - Fp) > 0
        ex_virt = (F[:, Lp - 3:]
                   - jnp.where(FFok, FFv, 0)[:, Lp - 3:]) > 0
        return jnp.concatenate([ex_real, ex_virt], axis=1)

    ex_raw = seg_exists(std_valid & (raw > thresh))
    any_ev = seg_exists(std_final)
    sNS = jnp.arange(n_slots, dtype=jnp.int32)[None, :]
    tr_raw6 = tr_valid & (raw_t > thresh)
    for k in range(6):
        hit = sNS == slot6[:, k:k + 1]
        ex_raw = ex_raw | (hit & tr_raw6[:, k:k + 1])
        any_ev = any_ev | (hit & tr_final[:, k:k + 1])

    std = {
        "valid": std_final, "pos": pos, "score": score, "slot": slot,
        "trunc": jnp.zeros((B, Lp), dtype=bool),
        "sub": jnp.broadcast_to(3 + (c + 1) % 3, (B, Lp)),
    }
    # end-slot frame class: real slots use iC%3 (== the class-top column
    # index), end slots their f
    cslot6 = jnp.where(slot6c < Lp, slot6c % 3, slot6c - Lp)
    tr = {
        "valid": tr_final, "pos": pos_t, "score": score_t,
        "slot": slot6c,
        "trunc": jnp.ones((B, 6), dtype=bool),
        "sub": 3 + (cslot6 + 1) % 3,
    }

    if not consts.get("subs"):
        return std, tr, ex_raw, any_ev, None

    # ---- substitution extension, reverse strand: ORF s2 extends RIGHT
    # past its closing stop s into the NEXT slot's run; every member value
    # of s2 is a class forward-fill read at the member's previous stop ----
    lowest_j = min(3, min_gene_len - 3)

    def prevread(Fpos):
        Zf = jnp.zeros((), Fpos.dtype)
        FFx, FFxok = _cls3_fwdfill(jnp.where(stop_m, Fpos, Zf), stop_m)
        return jnp.where(FFxok, FFx, Zf)

    emit2_u = prevread(rv["emit"][:, :Lp].astype(jnp.int32)) > 0
    sj_u = prevread(rv["mm"][:, :Lp])
    t32_u = prevread(rv["t3"][:, :Lp].astype(jnp.int32)) > 0
    b_slot_pos = _shift_right(b, 3, 0.0)       # b(s2) at position s
    total_pos = a - b_slot_pos                 # score[-1] of seg(s2) at s
    mid_t = _shift_right(seq == 3, 1, False)
    last_t = _shift_right(seq == 3, 2, False)
    if consts.get("qual"):
        # reverse strand: the mutated stop spans seq[x-2..x] with
        # codon_p[0] at x, [1] at x-1 (mid), [2] at x-2 (last) —
        # stop_i = [hi+1, hi, hi-1] in the host engine
        cp = jnp.asarray(_CP_TAB)[quals.astype(jnp.int32)]
        cp1 = _shift_right(cp, 1, 0.5)
        cp0 = _shift_right(cp, 2, 0.5)
        fa_of = lambda is_x, c: jnp.where(is_x, 2.0 / 3.0 * c + 1.0 / 3.0, c)
        pp = (cp * fa_of(mid_t, cp1)) * fa_of(last_t, cp0)
        fi = jnp.finfo(pp.dtype)
        pp = jnp.clip(pp, fi.tiny, 1.0 - fi.epsneg)
        pen_pos = jnp.log(1.0 - pp) - jnp.log(pp)
    else:
        import math as _math

        _dp = 0.999
        _fa = 2.0 / 3.0 * _dp + 1.0 / 3.0

        def _pen(mid_t_c, last_t_c):
            pp = _dp * (_fa if mid_t_c else _dp) * (_fa if last_t_c else _dp)
            return _math.log(1.0 - pp) - _math.log(pp)

        pen_pos = jnp.where(
            mid_t,
            jnp.where(last_t, _pen(True, True), _pen(True, False)),
            jnp.where(last_t, _pen(False, True), _pen(False, False)),
        )
    suf_pos = pen_pos + total_pos
    suf_u = prevread(suf_pos)

    min_j_sub = jnp.maximum(lowest_j, min_gene_len - 3 - sj_u)
    jf = j + 2 + sj_u
    sub_valid = (has_prev & emit2_u & t["is_rev_start"] & (j >= min_j_sub)
                 & (j <= top_j) & (u <= hi - 2) & (1 + jf >= min_gene_len))
    raw_tot = raw_nb + suf_u
    raw_tot = jnp.where(jf > isl, jnp.maximum(0.0, raw_tot), raw_tot)
    score_sub = raw_tot + prior
    score_sub = _add_pwm(score_sub, pwm, sep)
    score_sub = jnp.where(which >= 0, score_sub + start_sel, score_sub)
    score_sub = score_sub + _gather2(
        len_tab, jnp.where(t32_u, 1, 0),
        jnp.clip((j + sj_u) // 3 + 1, 0, LN - 1), 0.0)
    sub_pass = sub_valid & (score_sub > ev_thresh)

    # truncated sub entries: segment-2 = a rev-truncated run = exactly the
    # 6 tr columns (last-stop + end slots as s3); s2 is each one's
    # PREVIOUS slot
    pp3 = _gather_guard(
        t["pstop_r"], jnp.clip(last_stop, 0, Lp - 1) - 3, -jnp.int32(BIG))
    pp3ok = has_last & (pp3 > -jnp.int32(BIG) // 2)
    s2slot6 = jnp.concatenate(
        [jnp.where(pp3ok, pp3, 0), jnp.where(has_last, last_stop, 0)],
        axis=1)                                 # (B, 6)
    s2ok6 = jnp.concatenate([pp3ok, has_last], axis=1)
    g6s = lambda arr: jnp.take_along_axis(arr, s2slot6, axis=1)
    emit26 = g6s(rv["emit"]) & s2ok6
    sjs6 = g6s(rv["mm"])
    t326 = g6s(rv["t3"])
    suf6 = _gather_guard(suf_pos, s2slot6, 0.0)
    minj6 = jnp.maximum(lowest_j, min_gene_len - 3 - sjs6)
    jf6 = s_top + 2 + sjs6
    subtr_valid = (s2ok6 & emit26 & s_trunc & (s_mm >= 1)
                   & (s_top >= minj6) & (1 + jf6 >= min_gene_len))
    raw6 = raw_t_nb + suf6
    raw6 = jnp.where(jf6 > isl, jnp.maximum(0.0, raw6), raw6)
    score6 = raw6 + prior
    score6 = _add_pwm(score6, pwm_t, sep_t)
    score6 = score6 + _gather2(
        len_tab, jnp.where(t326, 2, 1),
        jnp.clip((s_top + sjs6) // 3 + 1, 0, LN - 1), 0.0)
    subtr_pass = subtr_valid & (score6 > ev_thresh)

    sub_at = _gather_guard(sub_pass, u_t, False)
    sub_sc = _gather_guard(score_sub, u_t, -np.inf)
    subtr_final = subtr_pass & ~(sub_at & (sub_sc > score6))
    for k in range(6):
        sub_pass = sub_pass & ~(
            (u == u_t[:, k:k + 1]) & subtr_pass[:, k:k + 1]
            & (sub_sc[:, k:k + 1] <= score6[:, k:k + 1]))
    sub_final = sub_pass

    # per-slot sub aggregates: count over run(s3), read at slot s2 via the
    # NEXT-slot relation (revfill + shift), virtual s3 via the class cols
    def nxt_r(F):
        Zf = jnp.zeros((), F.dtype)
        G, ok = _cls3_revfill(jnp.where(stop_m, F[:, :Lp], Zf), stop_m)
        Gv = _shift_left(jnp.where(ok, G, Zf), 3, Zf)
        okv = _shift_left(ok, 3, False)
        return jnp.where(okv, Gv, _sel3(F[:, Lp:], jnp.broadcast_to(
            c, (B, Lp))))

    def slotify(pos_arr):
        return jnp.concatenate(
            [pos_arr, jnp.zeros((B, 3), pos_arr.dtype)], axis=1)

    ex_sub = slotify(nxt_r(seg_exists(
        sub_valid & (raw_tot > thresh)).astype(jnp.int32)) > 0)
    any_sub = slotify(nxt_r(seg_exists(sub_final).astype(jnp.int32)) > 0)
    subtr_raw6 = subtr_valid & (raw6 > thresh)
    for k in range(6):
        hit = (sNS == s2slot6[:, k:k + 1]) & s2ok6[:, k:k + 1]
        ex_sub = ex_sub | (hit & subtr_raw6[:, k:k + 1])
        any_sub = any_sub | (hit & subtr_final[:, k:k + 1])

    err_pos_stop = sNS + 1                      # rev sub error at s + 1

    subx = {
        "fam_std": {
            "valid": sub_final, "pos": pos, "score": score_sub,
            "trunc": jnp.zeros((B, Lp), dtype=bool),
            "sub": std["sub"],
            "err_pos": ip_m + 1,
        },
        "fam_tr": {
            "valid": subtr_final, "pos": pos_t, "score": score6,
            "trunc": jnp.ones((B, 6), dtype=bool),
            "sub": tr["sub"],
            "err_pos": jnp.where(s2ok6, s2slot6 + 1, -1),
        },
        "any_sub": any_sub,
        "ex_sub": ex_sub,
        "to_member": lambda F: prevread(F[:, :Lp]),
        "s2slot6": jnp.clip(s2slot6, 0, n_slots - 1),
        "s2slot6_valid": s2ok6,
        "err_pos_stop": jnp.broadcast_to(err_pos_stop, (B, n_slots)),
        "any_clean": any_ev,
    }
    ex_all = ex_raw | ex_sub
    any_all = any_ev | any_sub
    return std, tr, ex_all, any_all, subx


# ---------------------------------------------------------------------------
# Event assembly + the DP (Process_Events, array form)
# ---------------------------------------------------------------------------


def _assign_ids(fw, rv, evprod_f, evprod_r, Lp, sub_f=None, sub_r=None):
    """Event-set ids: rank of each (ORF, error-set) in the reference's
    processing order (ids appear in the .predict orfNNNNN column).

    ``add_events_*`` assigns one id per error set present, in order of
    each set's first-appearing event position: on the forward strand the
    sub-extended set lives LEFT of the clean segment (discovered first),
    on the reverse strand RIGHT of it (discovered last) — hence the
    offset order below (engine/events.py:131-139)."""
    import jax.numpy as jnp

    B = evprod_f.shape[0]
    nk = 4 * Lp + 32
    rows = jnp.arange(B)[:, None]
    kf = fw["key"] * 2
    kr = rv["key"] * 2
    keyarr = jnp.zeros((B, nk), dtype=jnp.int32)
    if sub_f is None:
        keyarr = keyarr.at[rows, kf].add(evprod_f.astype(jnp.int32))
        keyarr = keyarr.at[rows, kr].add(evprod_r.astype(jnp.int32))
        ranks = jnp.cumsum(keyarr, axis=1)
        return (jnp.take_along_axis(ranks, kf, axis=1),
                jnp.take_along_axis(ranks, kr, axis=1), None, None)
    keyarr = keyarr.at[rows, kf].add(sub_f.astype(jnp.int32))
    keyarr = keyarr.at[rows, kf + 1].add(evprod_f.astype(jnp.int32))
    keyarr = keyarr.at[rows, kr].add(evprod_r.astype(jnp.int32))
    keyarr = keyarr.at[rows, kr + 1].add(sub_r.astype(jnp.int32))
    ranks = jnp.cumsum(keyarr, axis=1)
    return (jnp.take_along_axis(ranks, kf + 1, axis=1),
            jnp.take_along_axis(ranks, kr, axis=1),
            jnp.take_along_axis(ranks, kf, axis=1),
            jnp.take_along_axis(ranks, kr + 1, axis=1))


def _assemble_events(fam, Lp):
    """Sort candidate families into the padded per-read event tensor.

    ``fam``: list of dicts with valid/pos/score/sub/typ/id/trunc arrays.
    Stable order: position, then family enumeration order (empirically
    equivalent to the reference's introsort order — the host engine run
    with a stable position sort is coordinate-identical on the sample;
    see tests/test_device_predict.py).
    """
    import jax.numpy as jnp

    def cat(key):
        return jnp.concatenate([f[key] for f in fam], axis=-1)

    valid = cat("valid")
    pos = cat("pos").astype(jnp.int32)
    if "tiekey" in fam[0]:
        # equal-position order = the reference's event INSERTION order
        # (ORF processing rank + within-ORF phase; carried per family as
        # `tiekey`): two stable sorts — secondary key first, then pos
        tk = cat("tiekey").astype(jnp.int32)
        p1 = jnp.argsort(jnp.where(valid, tk, jnp.int32(2**30)),
                         axis=-1, stable=True)
        pos_p = jnp.take_along_axis(pos, p1, axis=-1)
        valid_p = jnp.take_along_axis(valid, p1, axis=-1)
        p2 = jnp.argsort(jnp.where(valid_p, pos_p, jnp.int32(2**30)),
                         axis=-1, stable=True)
        order = jnp.take_along_axis(p1, p2, axis=-1)[..., :MAX_EVENTS]
    else:
        # rank (family-enumeration order) == concatenation order, so a
        # STABLE sort on pos alone yields pos-then-rank order for any read
        # length — no packed key, no overflow past ~1.4 kb (r4 advisor).
        sort_key = jnp.where(valid, pos, jnp.int32(2**30))
        order = jnp.argsort(sort_key, axis=-1, stable=True)[..., :MAX_EVENTS]
    g = lambda a: jnp.take_along_axis(a, order, axis=-1)

    ev = {
        "pos": g(pos),
        "typ": jnp.where(g(valid), g(cat("typ").astype(jnp.int32)), 0),
        "sub": g(cat("sub").astype(jnp.int32)),
        "id": g(cat("id").astype(jnp.int32)),
        "score": g(cat("score")),
        "trunc": g(cat("trunc")),
    }
    if "err_pos" in fam[0]:
        ev["err_pos"] = g(cat("err_pos").astype(jnp.int32))
        ev["err_typ"] = g(cat("err_typ").astype(jnp.int32))
    n_events = jnp.sum(valid.astype(jnp.int32), axis=-1)
    return ev, n_events


def _adj_pair(bank, gi, max_olap, t1, succ_is_fstart, dist):
    """(AdjOr, AdjDist) f32 pieces for predecessor type(s) t1 and
    successor FWD_START-ness (gene.cc:733-770, 798-925; unsigned-index
    wrap -> .back() saturation mirrored)."""
    import jax.numpy as jnp

    ao = bank["adj_or"][gi]  # [ff, fr, rf, rr] f32
    is_c2 = t1 == E_FWD_STOP
    is_c3 = t1 == E_REV_START
    or_s = jnp.where(
        is_c2,
        jnp.where(succ_is_fstart, ao[0], ao[1]),
        jnp.where(is_c3, jnp.where(succ_is_fstart, ao[2], ao[3]), F32(0.0)),
    )
    ti = jnp.where(
        is_c2,
        jnp.where(succ_is_fstart, 0, 1),
        jnp.where(succ_is_fstart, 2, 0),  # REV_START->REV_STOP reuses ff
    )
    tab = bank["adj_dist"][gi]  # (3, D) f32
    dl = bank["adj_dist_len"][gi][ti]
    idx = dist + max_olap
    ok = (idx >= 0) & (idx < dl)
    val = jnp.where(
        ok,
        tab[ti, jnp.clip(idx, 0, tab.shape[1] - 1)],
        tab[ti, jnp.clip(dl - 1, 0, tab.shape[1] - 1)],
    )
    di_s = jnp.where(is_c2 | is_c3, val, F32(0.0))
    return or_s, di_s


def _event_dp(ev, gi, bank, consts, ne=None):
    """The event-graph DP: Process_Events + Process_*_Event semantics over
    index-ordered event arrays. Frame chains are implicit (events of frame
    f in processing order = ascending index), best_event[f] is an index,
    and the bounded-overlap re-linking is applied as vectorized masked
    updates (proven order-independent within one closure: re-link targets
    are openers, propagation targets are closers, and the sets are
    disjoint). f32 candidate comparisons mirror the reference's
    `float this_score, max_score` declarations."""
    import jax
    import jax.numpy as jnp

    E = ev["pos"].shape[0]
    pos, typ, sub, eid = ev["pos"], ev["typ"], ev["sub"], ev["id"]
    max_olap = consts["max_olap"]
    je = jnp.arange(E, dtype=jnp.int32)

    def adj_to(e_idx, pred_typ, pred_pos):
        """Candidate adjacency pieces: pred (vector) -> event e (scalar)."""
        succ_fs = typ[e_idx] == E_FWD_START
        dist = pos[e_idx] - pred_pos - 3
        return _adj_pair(bank, gi, max_olap, pred_typ, succ_fs, dist)

    def opener_best(e, score, bp, disq, best, processed):
        """Best-predecessor scan for FWD_START/REV_STOP events: returns
        (max f32 candidate, winner index)."""
        or_s, di_s = adj_to(e, typ, pos)
        cand_f32 = (
            score + or_s.astype(jnp.float64) + di_s.astype(jnp.float64)
        ).astype(jnp.float32)

        best_of_sub = best[sub]
        between = (
            processed
            & ((typ == E_FWD_STOP) | (typ == E_REV_START))
            & (score > 0.0)
            & (je > best_of_sub)
        )
        rank_btw = (sub + 1) * (2 * E) + (E - je)

        # best_event extras per frame: the FWD_STOP best itself, or the
        # maximal REV_START suffix run ending at the best (1609-1703).
        extra = jnp.zeros(E, dtype=bool)
        extra_init_score = jnp.full(6, -jnp.inf, dtype=jnp.float32)
        for i in range(6):
            bei = best[i]
            has = bei >= 0
            btyp = jnp.where(has, typ[jnp.clip(bei, 0)], -1)
            k_mask = processed & (sub == i) & (je <= bei)
            m_i = jnp.max(
                jnp.where(k_mask & (typ != E_REV_START), je, -1)
            )
            fr_extra = jnp.where(
                btyp == E_FWD_STOP,
                je == bei,
                jnp.where(
                    btyp == E_REV_START, k_mask & (je > m_i), False
                ),
            )
            extra = extra | fr_extra
            extra_init_score = extra_init_score.at[i].set(
                jnp.where(has, -jnp.inf, jnp.float32(0.0))
            )
        rank_ext = (sub + 1) * (2 * E) + E + (E - je)

        cand_mask = between | extra
        rank = jnp.where(between, rank_btw, rank_ext)

        b0 = best[0]
        init_score = jnp.where(
            b0 >= 0, cand_f32[jnp.clip(b0, 0)], jnp.float32(0.0)
        )
        init_idx = b0  # -1 when INITIAL

        scores_all = jnp.concatenate(
            [jnp.where(cand_mask, cand_f32, -jnp.inf),
             init_score[None], extra_init_score]
        )
        ranks_all = jnp.concatenate(
            [rank, jnp.zeros(1, jnp.int32),
             (jnp.arange(6, dtype=jnp.int32) + 1) * (2 * E) + E]
        )
        idx_all = jnp.concatenate(
            [je, init_idx[None], jnp.full(6, -1, jnp.int32)]
        )
        m = jnp.max(scores_all)
        winner_rank = jnp.min(jnp.where(scores_all == m, ranks_all, BIG))
        w = jnp.argmax((scores_all == m) & (ranks_all == winner_rank))
        return m, idx_all[w]

    def walk_set(disq, bp, q0, cutoff, value):
        # Disqualify/Requalify chain walk (glimmer_base.cc:437-458,
        # 2463-2480). Bounded at E iterations: the best_pred graph is
        # acyclic (forward re-link hops are < max_olap, closer->opener
        # hops are >= min_gene_len backward), so a correct walk visits
        # < E nodes; the bound keeps a semantics bug from becoming a hang.
        def cond(c):
            q, _d, it = c
            return (q >= 0) & (_gather_guard(pos, q, -BIG) >= cutoff) & (
                it < E
            )

        def body(c):
            q, d, it = c
            d = d.at[jnp.clip(q, 0)].set(value)
            return bp[jnp.clip(q, 0)], d, it + 1

        _q, disq, _it = jax.lax.while_loop(
            cond, body, (q0, disq, jnp.int32(0))
        )
        return disq

    def step(e, st):
        """One merged body for every event type (under vmap a lax.switch
        evaluates all branches anyway; merging shares the scans and runs
        TWO chain walks per step instead of four)."""
        score, bp, disq, best = st
        te = typ[e]
        active = te != 0
        is_open = (te == E_FWD_START) | (te == E_REV_STOP)
        is_fs = te == E_FWD_STOP
        is_rs = te == E_REV_START
        processed = je < e

        m_open, w_open = opener_best(e, score, bp, disq, best, processed)

        # closer scans: FWD_STOP takes its best same-id start; REV_START
        # locates its REV_STOP (largest same-frame non-REV_START with its id)
        cand_id = processed & (sub == sub[e]) & (eid == eid[e])
        m_fs = jnp.max(jnp.where(cand_id, score, -jnp.inf))
        w_fs = jnp.max(jnp.where(cand_id & (score == m_fs), je, -1))
        p_rs = jnp.max(jnp.where(cand_id & (typ != E_REV_START), je, -1))

        new_e_score = jnp.where(
            is_open, score[e] + m_open.astype(score.dtype),
            jnp.where(
                is_fs, m_fs,
                jnp.where(is_rs, score[e] + score[jnp.clip(p_rs, 0)],
                          score[e]),
            ),
        )
        new_e_bp = jnp.where(
            is_open, w_open,
            jnp.where(is_fs, w_fs, jnp.where(is_rs, p_rs, bp[e])),
        )
        score = score.at[e].set(jnp.where(active, new_e_score, score[e]))
        bp = bp.at[e].set(jnp.where(active, new_e_bp, bp[e]))

        # ---- closure (Process_Fwd_Stop_Rev_Start tail), masked by `do` ----
        f = sub[e]
        be = best[f]
        be_s = jnp.where(be >= 0, score[jnp.clip(be, 0)], 0.0)
        do = (is_fs | is_rs) & (be_s < score[e])
        p_disq = jnp.where(is_rs, p_rs, -1)
        cutoff = 3 + pos[e] - max_olap
        q0 = jnp.where(do & (p_disq >= 0), bp[jnp.clip(p_disq, 0)], -1)
        disq = walk_set(disq, bp, q0, cutoff, True)
        best = best.at[f].set(jnp.where(do, e, be))

        window = processed & (3 + pos[e] - pos <= max_olap)
        opener_m = (typ == E_FWD_START) | (typ == E_REV_STOP)
        bpj = bp
        bpj_c = jnp.clip(bpj, 0)
        needed = jnp.where(bpj >= 0, score[bpj_c], 0.0)
        cand = do & window & ~disq & opener_m & (needed < score[e])

        # old adjacency: (p.best_pred -> p); INITIAL pred -> 0
        succ_fs = typ == E_FWD_START
        bp_typ = jnp.where(bpj >= 0, typ[bpj_c], 0)
        oo, od = _adj_pair(
            bank, gi, max_olap, bp_typ, succ_fs, pos - pos[bpj_c] - 3
        )
        old_adj = jnp.where(bpj >= 0, oo + od, jnp.float32(0.0))
        no_, nd = _adj_pair(
            bank, gi, max_olap,
            jnp.full(E, typ[e], jnp.int32), succ_fs, pos - pos[e] - 3
        )
        new_adj = no_ + nd
        diff = (score[e] - needed) + (new_adj - old_adj).astype(score.dtype)
        upd = cand & (diff > 0.0)
        prop = (
            processed
            & (bpj >= 0)
            & upd[bpj_c]
            & (sub == sub[bpj_c])
            & (je > bpj)
        )
        delta = jnp.where(upd, diff, 0.0) + jnp.where(prop, diff[bpj_c], 0.0)
        score = score + delta
        bp = jnp.where(upd, e, bp)

        q0b = jnp.where(do & (p_disq >= 0), bp[jnp.clip(p_disq, 0)], -1)
        disq = walk_set(disq, bp, q0b, cutoff, False)
        return score, bp, disq, best

    init = (
        ev["score"],
        jnp.full(E, -2, jnp.int32),
        jnp.zeros(E, dtype=bool),
        jnp.full(6, -1, jnp.int32),
    )
    # dynamic bound: only the read's real events run (under vmap the loop
    # executes max-over-batch steps, typically far below MAX_EVENTS)
    hi = E if ne is None else ne
    score, bp, disq, best = jax.lax.fori_loop(0, hi, step, init)
    return score, bp, best


def _traceback(ev, score, bp, best, ne=None):
    """Set_Final_Event + Trace_Back (glimmer_base.cc:2536, glimmer3.cc:1631):
    emit raw gene records (id, stop_position, gene_len, sign, score, trunc)
    in traceback order; the host reverses and formats coordinates."""
    import jax
    import jax.numpy as jnp

    E = ev["pos"].shape[0]
    pos, typ, eid, trunc = ev["pos"], ev["typ"], ev["id"], ev["trunc"]

    s6 = jnp.where(best >= 0, score[jnp.clip(best, 0)], 0.0)
    fe = best[0]
    fs = s6[0]
    for i in range(1, 6):
        take = s6[i] >= fs
        fe = jnp.where(take, best[i], fe)
        fs = jnp.where(take, s6[i], fs)

    def body(_k, st):
        (p, cur_stop, rev_start_pos, prev_score, rev_trunc,
         g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt) = st
        active = p >= 0
        pc = jnp.clip(p, 0)
        tp = jnp.where(active, typ[pc], 0)

        emit_f = tp == E_FWD_START
        emit_r = tp == E_REV_STOP
        emit = emit_f | emit_r
        bpp = bp[pc]
        sc_f = score[pc] - jnp.where(bpp >= 0, score[jnp.clip(bpp, 0)], 0.0)
        rec_id = eid[pc]
        rec_stop = jnp.where(emit_f, cur_stop, pos[pc] - 2)
        rec_len = jnp.where(
            emit_f, 2 + cur_stop - pos[pc], rev_start_pos - pos[pc]
        )
        rec_sign = jnp.where(emit_f, 1, -1)
        rec_trunc = jnp.where(emit_f, trunc[pc], rev_trunc)
        rec_score = jnp.where(emit_f, sc_f, prev_score - score[pc])

        slot = jnp.clip(cnt, 0, MAX_GENES - 1)
        g_id = jnp.where(emit, g_id.at[slot].set(rec_id), g_id)
        g_stop = jnp.where(emit, g_stop.at[slot].set(rec_stop), g_stop)
        g_len = jnp.where(emit, g_len.at[slot].set(rec_len), g_len)
        g_sign = jnp.where(emit, g_sign.at[slot].set(rec_sign), g_sign)
        g_trunc = jnp.where(emit, g_trunc.at[slot].set(rec_trunc), g_trunc)
        g_score = jnp.where(emit, g_score.at[slot].set(rec_score), g_score)
        cnt = cnt + emit.astype(jnp.int32)

        cur_stop = jnp.where(tp == E_FWD_STOP, pos[pc] - 2,
                             jnp.where(emit_r, pos[pc] - 2, cur_stop))
        rev_start_pos = jnp.where(tp == E_REV_START, pos[pc], rev_start_pos)
        prev_score = jnp.where(tp == E_REV_START, score[pc], prev_score)
        rev_trunc = jnp.where(tp == E_REV_START, trunc[pc], rev_trunc)

        p = jnp.where(active, bp[pc], p)
        return (p, cur_stop, rev_start_pos, prev_score, rev_trunc,
                g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt)

    z = jnp.zeros(MAX_GENES, jnp.int32)
    st = (fe, jnp.int32(0), jnp.int32(0), jnp.float64(0.0),
          jnp.zeros((), bool),
          z, z, z, z, jnp.zeros(MAX_GENES, bool),
          jnp.zeros(MAX_GENES, jnp.float64), jnp.int32(0))
    st = jax.lax.fori_loop(0, E if ne is None else ne, body, st)
    (_p, _cs, _rs, _ps, _rt,
     g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt) = st
    return g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt


# ---------------------------------------------------------------------------
# Batched event DP (no vmap)
#
# Identical math to _event_dp/_traceback, rewritten over (B, E) arrays.
# Under vmap, per-lane fancy-index gathers (`score[bp]`, `best[sub]`,
# chain-walk hops) lower to XLA's general batched gathers; this form keeps
# every indexed read a same-shape take_along_axis or a one-hot reduction.
# Whether the one-hot forms still pay on a GPU, where gathers are native
# loads, is not measured yet (ROADMAP Speed 4). Rules used here:
#   - (B,E)<-(B,E) gathers: jnp.take_along_axis (the only fast gather form)
#   - per-lane single-index gathers: one-hot masked reductions
#   - tiny tables ((B,6) best, (B,3) lens): explicit k-way selects
#   - adjacency tables: padded to width E so distance lookups become three
#     same-shape take_along_axis calls + a 3-way select
#   - per-lane scatters: one-hot jnp.where, shared-index scatters:
#     a.at[:, e].set (dynamic-update-slice)
# ---------------------------------------------------------------------------


def _oh_at(a, idx):
    """Batched ``a[clip(idx, 0)]``: per-lane single-index gather via a
    one-hot masked sum (a: (B, E) or (1, E)-broadcastable, idx: (B,))."""
    import jax.numpy as jnp

    E = a.shape[-1]
    je2 = jnp.arange(E, dtype=jnp.int32)[None, :]
    oh = je2 == jnp.clip(idx, 0, E - 1)[:, None]
    return jnp.sum(
        jnp.where(oh, a, jnp.zeros((), a.dtype)), axis=1
    ).astype(a.dtype)


def _sel3(cols, ti):
    """cols: (B, 3); ti: (B, E) in {0,1,2} -> (B, E)."""
    import jax.numpy as jnp

    return jnp.where(
        ti == 0, cols[:, 0:1], jnp.where(ti == 1, cols[:, 1:2], cols[:, 2:3])
    )


def _sel6(cols, ti):
    """cols: (B, 6); ti: (B, E) in {0..5} -> (B, E)."""
    import jax.numpy as jnp

    out = jnp.broadcast_to(cols[:, 0:1], ti.shape)
    for k in range(1, 6):
        out = jnp.where(ti == k, cols[:, k:k + 1], out)
    return out


def _prefetch_adj(bank, groups, E: int):
    """Per-lane adjacency tables, gathered by group ONCE per batch (the
    per-group gather is a slow XLA form — it must stay out of the DP loop).

    Returns dict with ao (B,4) f32, dl (B,3) i32, tab0/1/2 (B,D) f32,
    satv (B,3) f32 = tab[t, dl[t]-1] (the reference's `.back()` saturation
    value, gene.cc:798-925), and D."""
    import jax.numpy as jnp

    ao = bank["adj_or"][groups]            # (B, 4)
    ad = bank["adj_dist"][groups]          # (B, 3, D)
    dl = bank["adj_dist_len"][groups]      # (B, 3)
    D = ad.shape[2]
    jd = jnp.arange(D, dtype=jnp.int32)[None, :]
    sat_cols = []
    for t in range(3):
        ohl = jd == jnp.clip(dl[:, t] - 1, 0, D - 1)[:, None]
        sat_cols.append(jnp.sum(jnp.where(ohl, ad[:, t], 0.0), axis=1))
    satv = jnp.stack(sat_cols, axis=1).astype(jnp.float32)  # (B, 3)
    return dict(ao=ao, dl=dl, tab0=ad[:, 0], tab1=ad[:, 1], tab2=ad[:, 2],
                satv=satv, D=D)


def _adj_ti(t1, succ_fs):
    """AdjDist table index for pred type t1 -> successor (gene.cc:798-925);
    REV_START->REV_STOP reuses ff."""
    import jax.numpy as jnp

    is_c2 = t1 == E_FWD_STOP
    return jnp.where(
        is_c2,
        jnp.where(succ_fs, 0, 1),
        jnp.where(succ_fs, 2, 0),
    )


def _adj_or_b(adj, t1, succ_fs):
    """AdjOr piece: pure selects over the per-lane (B, 4) log-odds."""
    import jax.numpy as jnp

    ao = adj["ao"]
    is_c2 = t1 == E_FWD_STOP
    is_c3 = t1 == E_REV_START
    return jnp.where(
        is_c2,
        jnp.where(succ_fs, ao[:, 0:1], ao[:, 1:2]),
        jnp.where(is_c3, jnp.where(succ_fs, ao[:, 2:3], ao[:, 3:4]),
                  F32(0.0)),
    )


def _adj_dist_exact(adj, max_olap, ti, dist):
    """Exact AdjDist lookup on a NARROW (B, W) tile via one-hot over the
    table width D (no gather HLO inside the DP loop). Out-of-table
    indices saturate to tab[dl-1], the reference's unsigned-wrap `.back()`
    quirk (gene.cc:798-925)."""
    import jax.numpy as jnp

    D = adj["D"]
    dl = _sel3(adj["dl"], ti)
    idx = dist + max_olap
    ok = (idx >= 0) & (idx < dl)
    idx_eff = jnp.where(ok, jnp.clip(idx, 0, D - 1),
                        jnp.clip(dl - 1, 0, D - 1))
    ohd = idx_eff[:, :, None] == jnp.arange(D, dtype=jnp.int32)[None, None, :]
    v0 = jnp.sum(jnp.where(ohd, adj["tab0"][:, None, :], 0.0), axis=2)
    v1 = jnp.sum(jnp.where(ohd, adj["tab1"][:, None, :], 0.0), axis=2)
    v2 = jnp.sum(jnp.where(ohd, adj["tab2"][:, None, :], 0.0), axis=2)
    return jnp.where(ti == 0, v0, jnp.where(ti == 1, v1, v2)).astype(
        jnp.float32)


# Re-link/adjacency row window: per DP step, arbitrary-index work is
# restricted to the last WINDOW_ROWS events before e. Correct because both
# the re-link window (3 + pos[e] - pos <= max_olap) and the in-table
# adjacency range (idx < dl <= 2*max_olap+4  =>  pos[e] - pos <=
# max_olap + 6) only reach events within ~max_olap bases behind e, and
# events are position-sorted. Reads whose event density puts an in-range
# event OUTSIDE the row window are flagged (wovf) and served by the host
# engine, like MAX_EVENTS overflow.
WINDOW_ROWS = 48


def _event_dp_batched(ev, adj, consts, ne):
    """Batched _event_dp: identical semantics over (B, E) arrays.

    ev arrays: (B, E); ne: (B,). The loop runs to max(ne); lanes whose
    events are exhausted see typ == 0 padding rows (inactive), exactly as
    the per-lane fori bound made them no-ops.

    All per-element indexed reads are expressed as one-hot masked
    contractions (never XLA gather HLOs), and everything quadratic is
    restricted to the WINDOW_ROWS trailing events (see above). Returns
    (score, bp, best, wovf) where wovf flags reads needing the host
    fallback."""
    import jax
    import jax.numpy as jnp

    B, E = ev["pos"].shape
    W = min(WINDOW_ROWS, E)
    pos, typ, sub, eid = ev["pos"], ev["typ"], ev["sub"], ev["id"]
    has_err = "err_pos" in ev
    errp = ev.get("err_pos")
    max_olap = consts["max_olap"]
    je2 = jnp.arange(E, dtype=jnp.int32)[None, :]
    jwr = jnp.arange(W, dtype=jnp.int32)
    dsl = lambda a, lo: jax.lax.dynamic_slice_in_dim(a, lo, W, axis=1)
    dus = lambda a, u, lo: jax.lax.dynamic_update_slice_in_dim(a, u, lo,
                                                               axis=1)

    def opener_best(e, score, best, processed, wlo, typ_w, pos_w, proc_w):
        te_c = typ[:, e][:, None]
        pos_e = pos[:, e][:, None]
        succ_fs = te_c == E_FWD_START
        # adjacency to e: saturated value everywhere, exact on the window
        ti_full = _adj_ti(typ, succ_fs)
        di_s = _sel3(adj["satv"], ti_full)
        or_s = _adj_or_b(adj, typ, succ_fs)
        ti_w = _adj_ti(typ_w, succ_fs)
        di_w = _adj_dist_exact(adj, max_olap, ti_w, pos_e - pos_w - 3)
        di_s = dus(di_s, di_w, wlo)
        cand_f32 = (
            score + or_s.astype(jnp.float64) + di_s.astype(jnp.float64)
        ).astype(jnp.float32)

        best_of_sub = _sel6(best, sub)
        between = (
            processed
            & ((typ == E_FWD_STOP) | (typ == E_REV_START))
            & (score > 0.0)
            & (je2 > best_of_sub)
        )
        rank_btw = (sub + 1) * (2 * E) + (E - je2)

        extra = jnp.zeros((B, E), dtype=bool)
        ei_cols = []
        for i in range(6):
            bei = best[:, i]
            has = bei >= 0
            btyp = jnp.where(has, _oh_at(typ, bei), jnp.int32(-1))
            k_mask = processed & (sub == i) & (je2 <= bei[:, None])
            m_i = jnp.max(
                jnp.where(k_mask & (typ != E_REV_START), je2, -1), axis=1
            )
            fr_extra = jnp.where(
                (btyp == E_FWD_STOP)[:, None],
                je2 == bei[:, None],
                jnp.where(
                    (btyp == E_REV_START)[:, None],
                    k_mask & (je2 > m_i[:, None]),
                    False,
                ),
            )
            extra = extra | fr_extra
            ei_cols.append(
                jnp.where(has, -jnp.inf, jnp.float32(0.0)).astype(jnp.float32)
            )
        extra_init_score = jnp.stack(ei_cols, axis=1)  # (B, 6)
        rank_ext = (sub + 1) * (2 * E) + E + (E - je2)

        cand_mask = between | extra
        rank = jnp.where(between, rank_btw, rank_ext)

        b0 = best[:, 0]
        init_score = jnp.where(
            b0 >= 0, _oh_at(cand_f32, b0), jnp.float32(0.0)
        )
        init_idx = b0  # -1 when INITIAL

        scores_all = jnp.concatenate(
            [jnp.where(cand_mask, cand_f32, -jnp.inf),
             init_score[:, None], extra_init_score], axis=1
        )
        ranks_all = jnp.concatenate(
            [jnp.broadcast_to(rank, (B, E)),
             jnp.zeros((B, 1), jnp.int32),
             jnp.broadcast_to(
                 (jnp.arange(6, dtype=jnp.int32)[None, :] + 1) * (2 * E) + E,
                 (B, 6))], axis=1
        )
        idx_all = jnp.concatenate(
            [jnp.broadcast_to(je2, (B, E)), init_idx[:, None],
             jnp.full((B, 6), -1, jnp.int32)], axis=1
        )
        m = jnp.max(scores_all, axis=1)
        winner_rank = jnp.min(
            jnp.where(scores_all == m[:, None], ranks_all, BIG), axis=1
        )
        wsel = (scores_all == m[:, None]) & (ranks_all == winner_rank[:, None])
        w = jnp.argmax(wsel, axis=1).astype(jnp.int32)
        j_all = jnp.arange(E + 7, dtype=jnp.int32)[None, :]
        widx = jnp.sum(
            jnp.where(j_all == w[:, None], idx_all, 0), axis=1
        ).astype(jnp.int32)
        return m, widx

    def walk_set(disq, bp, q0, cutoff, value):
        # Disqualify/Requalify chain walk, all lanes advanced jointly with
        # per-lane active masks; same E-iteration safety bound.
        def cond(c):
            q, _d, it = c
            pos_q = jnp.where(q >= 0, _oh_at(pos, q), -BIG)
            return jnp.any((q >= 0) & (pos_q >= cutoff)) & (it < E)

        def body(c):
            q, d, it = c
            pos_q = jnp.where(q >= 0, _oh_at(pos, q), -BIG)
            act = (q >= 0) & (pos_q >= cutoff)
            ohq = (je2 == jnp.clip(q, 0, E - 1)[:, None]) & act[:, None]
            d = jnp.where(ohq, value, d)
            q = jnp.where(act, _oh_at(bp, q), q)
            return q, d, it + 1

        _q, disq, _it = jax.lax.while_loop(
            cond, body, (q0, disq, jnp.int32(0))
        )
        return disq

    def step(e, st):
        score, bp, disq, best, wovf = st
        te = typ[:, e]
        pos_e_v = pos[:, e]
        sub_e = sub[:, e]
        eid_e = eid[:, e]
        score_e = score[:, e]
        active = te != 0
        is_open = (te == E_FWD_START) | (te == E_REV_STOP)
        is_fs = te == E_FWD_STOP
        is_rs = te == E_REV_START
        processed = je2 < e  # (1, E) shared across lanes

        wlo = jnp.maximum(e - W, 0)
        typ_w = dsl(typ, wlo)
        pos_w = dsl(pos, wlo)
        sub_w = dsl(sub, wlo)
        jw = wlo + jwr[None, :]           # (1, W) absolute row indices
        proc_w = jw < e

        # row-window sufficiency: any processed event OUTSIDE the window
        # rows but within adjacency/base range flags the read for host
        # fallback (conservative: correctness never depends on W)
        out_rng = (processed & (je2 < wlo)
                   & (pos_e_v[:, None] - pos <= max_olap + 6))
        wovf = wovf | (active & jnp.any(out_rng, axis=1))

        m_open, w_open = opener_best(e, score, best, processed, wlo,
                                     typ_w, pos_w, proc_w)

        cand_id = processed & (sub == sub_e[:, None]) & (eid == eid_e[:, None])
        m_fs = jnp.max(jnp.where(cand_id, score, -jnp.inf), axis=1)
        w_fs = jnp.max(
            jnp.where(cand_id & (score == m_fs[:, None]), je2, -1), axis=1
        ).astype(jnp.int32)
        p_rs = jnp.max(
            jnp.where(cand_id & (typ != E_REV_START), je2, -1), axis=1
        ).astype(jnp.int32)
        score_at_prs = _oh_at(score, p_rs)

        new_e_score = jnp.where(
            is_open, score_e + m_open.astype(score.dtype),
            jnp.where(
                is_fs, m_fs,
                jnp.where(is_rs, score_e + score_at_prs, score_e),
            ),
        )
        new_e_bp = jnp.where(
            is_open, w_open,
            jnp.where(is_fs, w_fs, jnp.where(is_rs, p_rs, bp[:, e])),
        )
        score = score.at[:, e].set(jnp.where(active, new_e_score, score_e))
        bp = bp.at[:, e].set(jnp.where(active, new_e_bp, bp[:, e]))
        score_e = score[:, e]

        # ---- closure (Process_Fwd_Stop_Rev_Start tail), masked by `do` ----
        f = sub_e
        be = jnp.sum(
            jnp.where(jnp.arange(6)[None, :] == f[:, None], best, 0), axis=1
        ).astype(jnp.int32)
        be_s = jnp.where(be >= 0, _oh_at(score, be),
                         jnp.zeros((), score.dtype))
        do = (is_fs | is_rs) & (be_s < score_e)
        p_disq = jnp.where(is_rs, p_rs, -1)
        cutoff = 3 + pos_e_v - max_olap
        bp_at_pd = _oh_at(bp, p_disq)
        q0 = jnp.where(do & (p_disq >= 0), bp_at_pd, -1)
        disq = walk_set(disq, bp, q0, cutoff, True)
        oh6 = jnp.arange(6)[None, :] == f[:, None]
        best = jnp.where(oh6 & do[:, None], e, best).astype(jnp.int32)

        # ---- bounded-overlap re-link, on the row window only ----
        bp_w = dsl(bp, wlo)
        disq_w = dsl(disq, wlo)
        valid_bpw = bp_w >= 0
        ohw = (jnp.clip(bp_w, 0, E - 1)[:, :, None] == je2[:, None, :])
        zS = jnp.zeros((), score.dtype)

        def gath_w(a, dt):
            return jnp.sum(
                jnp.where(ohw, a[:, None, :], jnp.zeros((), dt)), axis=2
            ).astype(dt)

        needed_w = jnp.where(valid_bpw, gath_w(score, score.dtype), zS)
        bptyp_w = jnp.where(valid_bpw, gath_w(typ, typ.dtype), 0)
        bppos_w = gath_w(pos, pos.dtype)
        window_w = proc_w & (3 + pos_e_v[:, None] - pos_w <= max_olap)
        opener_w = (typ_w == E_FWD_START) | (typ_w == E_REV_STOP)
        cand_w = (do[:, None] & window_w & ~disq_w & opener_w
                  & (needed_w < score_e[:, None]))
        if has_err:
            # the reference suppresses re-links whose error positions
            # overlap the other event's span (glimmer_base.cc:1726-1896)
            errp_e = errp[:, e][:, None]
            errp_w = dsl(errp, wlo)
            ov = (((errp_e >= 0) & (pos_w - 2 <= errp_e))
                  | ((errp_w >= 0) & (errp_w <= pos_e_v[:, None])))
            cand_w = cand_w & ~ov

        succ_fs_w = typ_w == E_FWD_START
        oo_w = _adj_or_b(adj, bptyp_w, succ_fs_w)
        od_w = _adj_dist_exact(adj, max_olap, _adj_ti(bptyp_w, succ_fs_w),
                               pos_w - bppos_w - 3)
        old_adj_w = jnp.where(valid_bpw, oo_w + od_w, F32(0.0))
        no_w = _adj_or_b(adj, te[:, None], succ_fs_w)
        nd_w = _adj_dist_exact(adj, max_olap, _adj_ti(te[:, None], succ_fs_w),
                               pos_w - pos_e_v[:, None] - 3)
        new_adj_w = no_w + nd_w
        diff_w = ((score_e[:, None] - needed_w)
                  + (new_adj_w - old_adj_w).astype(score.dtype))
        upd_w = cand_w & (diff_w > 0.0)

        # successor propagation over the full array: a successor's pred is
        # in the window iff its bp lands in [wlo, wlo+W)
        rel = bp - wlo
        inw = (bp >= 0) & (rel >= 0) & (rel < W)
        ohrel = ((jnp.clip(rel, 0, W - 1)[:, :, None]
                  == jwr[None, None, :]) & inw[:, :, None])
        upd_at = jnp.any(ohrel & upd_w[:, None, :], axis=2)
        sub_at = jnp.sum(
            jnp.where(ohrel, sub_w[:, None, :], 0), axis=2
        ).astype(jnp.int32)
        diff_at = jnp.sum(
            jnp.where(ohrel, diff_w[:, None, :], zS), axis=2
        ).astype(score.dtype)
        prop = processed & upd_at & (sub == sub_at) & (je2 > bp)
        score = score + jnp.where(prop, diff_at, zS)
        sw = dsl(score, wlo)
        score = dus(score, sw + jnp.where(upd_w, diff_w, zS), wlo)
        bw = dsl(bp, wlo)
        bp = dus(bp, jnp.where(upd_w, e, bw).astype(jnp.int32), wlo)

        bp_at_pd2 = _oh_at(bp, p_disq)
        q0b = jnp.where(do & (p_disq >= 0), bp_at_pd2, -1)
        disq = walk_set(disq, bp, q0b, cutoff, False)
        return score, bp, disq, best, wovf

    init = (
        ev["score"],
        jnp.full((B, E), -2, jnp.int32),
        jnp.zeros((B, E), dtype=bool),
        jnp.full((B, 6), -1, jnp.int32),
        jnp.zeros((B,), dtype=bool),
    )
    hi = jnp.max(jnp.minimum(ne, E)) if ne is not None else E
    score, bp, disq, best, wovf = jax.lax.fori_loop(0, hi, step, init)
    return score, bp, best, wovf


def _traceback_batched(ev, score, bp, best, ne):
    """Batched _traceback: Set_Final_Event + Trace_Back over (B, E)."""
    import jax
    import jax.numpy as jnp

    B, E = ev["pos"].shape
    pos, typ, eid, trunc = ev["pos"], ev["typ"], ev["id"], ev["trunc"]
    je2 = jnp.arange(E, dtype=jnp.int32)[None, :]
    jg = jnp.arange(MAX_GENES, dtype=jnp.int32)[None, :]

    s6 = jnp.where(best >= 0, 0.0, 0.0).astype(score.dtype)
    cols = []
    for i in range(6):
        cols.append(jnp.where(
            best[:, i] >= 0, _oh_at(score, best[:, i]),
            jnp.zeros((), score.dtype)))
    s6 = jnp.stack(cols, axis=1)  # (B, 6)
    fe = best[:, 0]
    fs = s6[:, 0]
    for i in range(1, 6):
        take = s6[:, i] >= fs
        fe = jnp.where(take, best[:, i], fe)
        fs = jnp.where(take, s6[:, i], fs)

    has_err = "err_pos" in ev
    epos = ev.get("err_pos")
    etyp = ev.get("err_typ")

    def body(_k, st):
        (p, cur_stop, rev_start_pos, prev_score, rev_trunc,
         rev_epos, rev_etyp,
         g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos, g_etyp,
         cnt) = st
        active = p >= 0
        pc = jnp.clip(p, 0, E - 1)
        ohp = je2 == pc[:, None]

        def get(a, dt):
            return jnp.sum(
                jnp.where(ohp, a, jnp.zeros((), dt)), axis=1
            ).astype(dt)

        typ_p = get(typ, typ.dtype)
        bpp = get(bp, bp.dtype)
        score_p = get(score, score.dtype)
        eid_p = get(eid, eid.dtype)
        pos_p = get(pos, pos.dtype)
        trunc_p = get(trunc.astype(jnp.int32), jnp.int32).astype(bool)
        if has_err:
            epos_p = get(epos, jnp.int32)
            etyp_p = get(etyp, jnp.int32)
        tp = jnp.where(active, typ_p, 0)

        emit_f = tp == E_FWD_START
        emit_r = tp == E_REV_STOP
        emit = emit_f | emit_r
        score_bpp = jnp.where(
            bpp >= 0, _oh_at(score, bpp), jnp.zeros((), score.dtype)
        )
        sc_f = score_p - score_bpp
        rec_id = eid_p
        rec_stop = jnp.where(emit_f, cur_stop, pos_p - 2)
        rec_len = jnp.where(
            emit_f, 2 + cur_stop - pos_p, rev_start_pos - pos_p
        )
        rec_sign = jnp.where(emit_f, jnp.int32(1), jnp.int32(-1))
        rec_trunc = jnp.where(emit_f, trunc_p, rev_trunc)
        rec_score = jnp.where(emit_f, sc_f, prev_score - score_p)

        slot = jnp.clip(cnt, 0, MAX_GENES - 1)
        ohs = (jg == slot[:, None]) & emit[:, None]
        g_id = jnp.where(ohs, rec_id[:, None], g_id)
        g_stop = jnp.where(ohs, rec_stop[:, None], g_stop)
        g_len = jnp.where(ohs, rec_len[:, None], g_len)
        g_sign = jnp.where(ohs, rec_sign[:, None], g_sign)
        g_trunc = jnp.where(ohs, rec_trunc[:, None], g_trunc)
        g_score = jnp.where(ohs, rec_score[:, None], g_score)
        if has_err:
            # fwd genes carry the FWD_START event's errors; rev genes the
            # ones latched at REV_START (trace_back, glimmer3.cc:1631)
            rec_ep = jnp.where(emit_f, epos_p, rev_epos)
            rec_et = jnp.where(emit_f, etyp_p, rev_etyp)
            g_epos = jnp.where(ohs, rec_ep[:, None], g_epos)
            g_etyp = jnp.where(ohs, rec_et[:, None], g_etyp)
        cnt = cnt + emit.astype(jnp.int32)

        cur_stop = jnp.where(tp == E_FWD_STOP, pos_p - 2,
                             jnp.where(emit_r, pos_p - 2, cur_stop))
        rev_start_pos = jnp.where(tp == E_REV_START, pos_p, rev_start_pos)
        prev_score = jnp.where(tp == E_REV_START, score_p, prev_score)
        rev_trunc = jnp.where(tp == E_REV_START, trunc_p, rev_trunc)
        if has_err:
            rev_epos = jnp.where(tp == E_REV_START, epos_p, rev_epos)
            rev_etyp = jnp.where(tp == E_REV_START, etyp_p, rev_etyp)

        p = jnp.where(active, bpp, p)
        return (p, cur_stop, rev_start_pos, prev_score, rev_trunc,
                rev_epos, rev_etyp,
                g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos,
                g_etyp, cnt)

    zi = jnp.zeros((B,), jnp.int32)
    zg = jnp.zeros((B, MAX_GENES), jnp.int32)
    st = (fe, zi, zi, jnp.zeros((B,), jnp.float64), jnp.zeros((B,), bool),
          jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32),
          zg, zg, zg, zg, jnp.zeros((B, MAX_GENES), bool),
          jnp.zeros((B, MAX_GENES), jnp.float64),
          jnp.full((B, MAX_GENES), -1, jnp.int32),
          jnp.full((B, MAX_GENES), -1, jnp.int32), zi)
    hi = jnp.max(jnp.minimum(ne, E)) if ne is not None else E
    st = jax.lax.fori_loop(0, hi, body, st)
    (_p, _cs, _rs, _ps, _rt, _re1, _re2,
     g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos, g_etyp,
     cnt) = st
    return (g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos, g_etyp,
            cnt)


# ---------------------------------------------------------------------------
# Top level: one read end-to-end, batch wrapper, host finish
# ---------------------------------------------------------------------------


def _frontend_one(seq, n, gi, gene6, ind6, bank, Lp: int, consts,
                  quals=None):
    """BATCHED candidate construction: ORF slots, start scoring, event
    assembly — everything before the event DP. seq (B, Lp), n/gi (B,),
    gene6/ind6 (B, 6, Lp). Returns (ev of (B, E) arrays, n_events (B,))."""
    import jax.numpy as jnp

    B = seq.shape[0]
    t = _read_tables(seq, n, gi, bank)
    fw = _fwd_orf_slots(t, n, Lp, consts["min_gene_len"],
                        indel_orfs=bool(consts.get("subs")))
    rv = _rev_orf_slots(t, n, Lp, consts["min_gene_len"],
                        indel_orfs=bool(consts.get("subs")))
    Sf, Sr = _frame_prefix_sums(gene6, ind6, n, Lp)
    pw = _pwm_window_tables(
        _pwm_arrays(seq, n, gi, bank, consts["W"]),
        n, Lp, consts["ws"], consts["W"],
    ) if consts["W"] else None

    subs = bool(consts.get("subs"))
    std_f, tr_f, braw_f, anyev_f, subx_f = _start_candidates_fwd(
        t, fw, n, Lp, gi, bank, Sf, pw, consts, seq, quals=quals
    )
    std_r, tr_r, braw_r, anyev_r, subx_r = _start_candidates_rev(
        t, rv, n, Lp, gi, bank, Sr, pw, consts, seq, quals=quals
    )
    # braw_* are already the boolean "any start's raw beats the
    # start_threshold" existence tests (scatter-free segment form)
    evprod_f = fw["emit"] & braw_f & anyev_f
    evprod_r = rv["emit"] & braw_r & anyev_r
    if subs:
        sub_ind_f = evprod_f & subx_f["any_sub"]
        sub_ind_r = evprod_r & subx_r["any_sub"]
        clean_ind_f = evprod_f & subx_f["any_clean"]
        clean_ind_r = evprod_r & subx_r["any_clean"]
        id_f, id_r, id_sf, id_sr = _assign_ids(
            fw, rv, clean_ind_f, clean_ind_r, Lp, sub_ind_f, sub_ind_r)
    else:
        id_f, id_r, _u1, _u2 = _assign_ids(fw, rv, evprod_f, evprod_r, Lp)

    n_slots = Lp + 3
    idx_slots = jnp.arange(n_slots, dtype=jnp.int32)[None, :]
    cslot_r = jnp.where(idx_slots < Lp, idx_slots % 3, idx_slots - Lp)
    zsc = jnp.zeros((B, n_slots), dtype=jnp.float64)
    taa = lambda a, i: jnp.take_along_axis(a, i, axis=1)

    # slot -> member propagation of the per-ORF gate + id (the gather-free
    # slot broadcast; see _start_candidates_fwd)
    q = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    stop_f = t["is_fwd_stop"]
    stop_r = t["is_rev_stop"]
    vcls_f = (q + 2 - n[:, None]) % 3
    cr = jnp.broadcast_to(q % 3, (B, Lp))

    def prop_mk(stop_mask, shift, vsel):
        def prop(F):
            rf, anyv = _cls3_revfill(
                _shift_left(F[:, :Lp], shift, jnp.zeros((), F.dtype)),
                _shift_left(stop_mask, shift, False))
            return jnp.where(anyv, rf, _sel3(F[:, Lp:], vsel))
        return prop

    prop_f = prop_mk(stop_f, 5, vcls_f)
    prop_r = prop_mk(stop_r, 3, cr)

    stop_f_valid = evprod_f if not subs else clean_ind_f
    stop_r_valid = evprod_r if not subs else clean_ind_r
    # within-ORF insertion phases for the equal-position tie order (fwd
    # inserts starts then stops, rev stops then starts; stop pairs by
    # _error_key i.e. clean before sub)
    kf4 = fw["key"] * 4
    kr4 = rv["key"] * 4
    fams_f = [
        dict(std_f, valid=std_f["valid"] & prop_f(evprod_f),
             typ=jnp.full((B, Lp), E_FWD_START, jnp.int32),
             id=prop_f(id_f), tiekey=prop_f(kf4) + 1),
        dict(tr_f, valid=tr_f["valid"] & taa(evprod_f, tr_f["slot"]),
             typ=jnp.full((B, 6), E_FWD_START, jnp.int32),
             id=taa(id_f, tr_f["slot"]), tiekey=taa(kf4, tr_f["slot"]) + 1),
    ]
    if subs:
        fams_f.append(dict(
            subx_f["fam_std"],
            valid=subx_f["fam_std"]["valid"] & subx_f["to_member"](evprod_f),
            typ=jnp.full((B, Lp), E_FWD_START, jnp.int32),
            id=subx_f["to_member"](id_sf), err_typ=2,
            tiekey=subx_f["to_member"](kf4) + 1))
        fams_f.append(dict(
            subx_f["fam_tr"],
            valid=(subx_f["fam_tr"]["valid"] & subx_f["s2slot6_valid"]
                   & taa(evprod_f, subx_f["s2slot6"])),
            typ=jnp.full((B, 3), E_FWD_START, jnp.int32),
            id=taa(id_sf, subx_f["s2slot6"]), err_typ=2,
            tiekey=taa(kf4, subx_f["s2slot6"]) + 1))
    fams_f.append(
        dict(valid=stop_f_valid, pos=fw["stop_pos"] + 2,
             score=zsc, sub=jnp.broadcast_to((fw["iS"] % 3 + 1) % 3,
                                             (B, n_slots)),
             typ=jnp.full((B, n_slots), E_FWD_STOP, jnp.int32), id=id_f,
             trunc=jnp.zeros((B, n_slots), bool), tiekey=kf4 + 2))
    if subs:
        fams_f.append(
            dict(valid=sub_ind_f, pos=fw["stop_pos"] + 2,
                 score=zsc, sub=jnp.broadcast_to((fw["iS"] % 3 + 1) % 3,
                                                 (B, n_slots)),
                 typ=jnp.full((B, n_slots), E_FWD_STOP, jnp.int32),
                 id=id_sf, trunc=jnp.zeros((B, n_slots), bool),
                 err_pos=subx_f["err_pos_stop"], err_typ=2,
                 tiekey=kf4 + 3))

    # rev sub events belong to the PREVIOUS slot (processed first in the
    # reference's ORF order), so at equal positions they must enumerate
    # BEFORE the clean families (ties decide best[f]/re-link side effects)
    fams_r = []
    if subs:
        fams_r.append(dict(
            subx_r["fam_std"],
            valid=subx_r["fam_std"]["valid"] & subx_r["to_member"](evprod_r),
            typ=jnp.full((B, Lp), E_REV_START, jnp.int32),
            id=subx_r["to_member"](id_sr), err_typ=2,
            tiekey=subx_r["to_member"](kr4) + 2))
        fams_r.append(dict(
            subx_r["fam_tr"],
            valid=(subx_r["fam_tr"]["valid"] & subx_r["s2slot6_valid"]
                   & taa(evprod_r, subx_r["s2slot6"])),
            typ=jnp.full((B, 6), E_REV_START, jnp.int32),
            id=taa(id_sr, subx_r["s2slot6"]), err_typ=2,
            tiekey=taa(kr4, subx_r["s2slot6"]) + 2))
    fams_r.extend([
        dict(std_r, valid=std_r["valid"] & prop_r(evprod_r),
             typ=jnp.full((B, Lp), E_REV_START, jnp.int32),
             id=prop_r(id_r), tiekey=prop_r(kr4) + 2),
        dict(tr_r, valid=tr_r["valid"] & taa(evprod_r, tr_r["slot"]),
             typ=jnp.full((B, 6), E_REV_START, jnp.int32),
             id=taa(id_r, tr_r["slot"]), tiekey=taa(kr4, tr_r["slot"]) + 2),
    ])
    fams_r.append(
        dict(valid=stop_r_valid, pos=rv["stop_pos"] + 2,
             score=zsc, sub=jnp.broadcast_to(3 + (cslot_r + 1) % 3,
                                             (B, n_slots)),
             typ=jnp.full((B, n_slots), E_REV_STOP, jnp.int32), id=id_r,
             trunc=jnp.zeros((B, n_slots), bool), tiekey=kr4 + 0))
    if subs:
        fams_r.append(
            dict(valid=sub_ind_r, pos=rv["stop_pos"] + 2,
                 score=zsc, sub=jnp.broadcast_to(3 + (cslot_r + 1) % 3,
                                                 (B, n_slots)),
                 typ=jnp.full((B, n_slots), E_REV_STOP, jnp.int32),
                 id=id_sr, trunc=jnp.zeros((B, n_slots), bool),
                 err_pos=subx_r["err_pos_stop"], err_typ=2,
                 tiekey=kr4 + 1))

    fams = fams_f + fams_r
    for f in fams:
        f.pop("slot", None)
        if not subs:
            f.pop("tiekey", None)
        else:
            w = f["pos"].shape[1]
            if "err_pos" not in f:
                f["err_pos"] = jnp.full((B, w), -1, jnp.int32)
            et = f.pop("err_typ", -1)
            f["err_typ"] = (jnp.full((B, w), et, jnp.int32)
                            if isinstance(et, int) else et)
    ev, n_events = _assemble_events(fams, Lp)
    return ev, n_events


def _predict_one(seq, n, gi, gene6, ind6, bank, Lp: int, consts):
    """Legacy per-lane path (GLIMMER_MG_TPU_DP_BATCHED=0): wraps the
    batched frontend on a size-1 batch, then the per-lane event DP."""
    import jax
    import jax.numpy as jnp

    ne_cap = consts.get("ne_cap", MAX_EVENTS)
    ev_b, n_events_b = _frontend_one(
        seq[None], n[None], gi[None], gene6[None], ind6[None], bank, Lp,
        consts)
    ev = jax.tree.map(lambda a: a[0], ev_b)
    n_events = n_events_b[0]
    ne = jnp.minimum(n_events, ne_cap)
    score, bp, best = _event_dp(ev, gi, bank, consts, ne)
    g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt = _traceback(
        ev, score, bp, best, ne
    )
    return g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt, n_events


# LRU-bounded: one compiled executable per (batch, length-bucket, consts)
# combination — long-lived processes over many length buckets must not
# accumulate executables without bound (r4 advisor, low).
from collections import OrderedDict as _OrderedDict

_JIT_CACHE: _OrderedDict = _OrderedDict()
_JIT_CACHE_CAP = 32


def _bank_jnp(bank: DeviceBank):
    import jax.numpy as jnp

    fields = (
        "fwd_start rev_start fwd_stop rev_stop which_fwd which_rev prior "
        "start_lo len_score adj_or adj_dist adj_dist_len ignore_score_len "
        "pwm_cols pwm_n pwm_user pwm_is_user gc_lp"
    ).split()
    return {f: jnp.asarray(getattr(bank, f)) for f in fields}


def use_f64_default() -> bool:
    """DP score precision: f64 (reference-matching C doubles, native on
    the GPU) unless GLIMMER_MG_TPU_DEVICE_DP_F32=1 selects the f32 carry
    (measured coordinate-identical on the sample + fuzz sets; see
    tests/test_device_predict.py::test_f32_dp_parity)."""
    import os

    return os.environ.get("GLIMMER_MG_TPU_DEVICE_DP_F32") != "1"


def predict_batch_device(bank: DeviceBank, reads, lengths, groups,
                         gene6, ind6, cache_key=None, f64=None,
                         subs=False, quals=None, lower=False):
    """Run the chip-resident prediction for a padded read batch.

    reads (B, L) int32, lengths (B,), groups (B,) — the same batching as
    the six-frame precompute; gene6/ind6 (B, 6, L) f32 are that kernel's
    outputs (device arrays; they never leave the chip). Returns host
    numpy arrays of raw gene records + per-read event counts.

    quals: optional (B, L) uint8 quality values (rows without a quality
    file filled with the 255 sentinel); only read in subs mode, where it
    switches Pass_Stop_Penalty to the per-position quality form.

    lower: return the program lowered for these arguments
    (``jax.stages.Lowered``) instead of running it.
    """
    import contextlib

    import jax
    import jax.numpy as jnp

    if f64 is None:
        f64 = use_f64_default()
    b, L0 = reads.shape
    Lp = L0 + (-L0) % 3
    batched_env = os.environ.get("GLIMMER_MG_TPU_DP_BATCHED", "1") == "1"
    consts = dict(
        min_gene_len=bank.min_gene_len, max_olap=bank.max_olap,
        event_threshold=bank.event_threshold,
        start_threshold=bank.start_threshold,
        ws=bank.ribosome_window, W=bank.pwm_w, f64=f64,
        # the legacy per-lane DP never learned the error machinery;
        # callers fall back to the host engine for subs there
        subs=bool(subs) and batched_env,
        qual=bool(subs) and batched_env and quals is not None,
    )

    # without x64, every jnp.float64 in the trace becomes f32 — exactly
    # the intended precision switch (suppress the per-call-site warnings)
    import warnings

    with jax.enable_x64() if f64 else contextlib.nullcontext(), \
            warnings.catch_warnings():
        if not f64:
            warnings.filterwarnings(
                "ignore", message=".*dtype float64.*", category=UserWarning
            )
        # the jit takes the bank as an ARGUMENT pytree, so the compiled
        # program is reused across chunks/runs with any bank of the same
        # shapes (keying on bank identity forced a retrace per generator
        # run — ~3 s of pure tracing per bench repetition)
        key = (b, L0, Lp, tuple(sorted(consts.items())), f64)
        fn = _JIT_CACHE.get(key)
        if fn is not None:
            _JIT_CACHE.move_to_end(key)
        else:
            batched = batched_env
            pad_amt = Lp - L0

            if batched:

                def run(bj, reads, lengths, groups, gene6, ind6, quals):
                    # length padding INSIDE the jit: one dispatch per
                    # chunk instead of one per eager op
                    reads = jnp.pad(reads.astype(jnp.int32),
                                    ((0, 0), (0, pad_amt)))
                    gene6 = jnp.pad(gene6, ((0, 0), (0, 0), (0, pad_amt)))
                    ind6 = jnp.pad(ind6, ((0, 0), (0, 0), (0, pad_amt)))
                    q = None
                    if consts["qual"]:
                        q = jnp.pad(quals, ((0, 0), (0, pad_amt)),
                                    constant_values=np.uint8(255))
                    ev, n_events = _frontend_one(
                        reads, lengths, groups, gene6, ind6, bj, Lp, consts,
                        quals=q)
                    ne_cap = consts.get("ne_cap", MAX_EVENTS)
                    ne = jnp.minimum(n_events, ne_cap)
                    adjb = _prefetch_adj(bj, groups, MAX_EVENTS)
                    score, bp_arr, best, wovf = _event_dp_batched(
                        ev, adjb, consts, ne)
                    outs = _traceback_batched(ev, score, bp_arr, best, ne)
                    # reads whose event density exceeded the re-link row
                    # window fold into the overflow fallback channel
                    n_flag = jnp.where(
                        wovf, jnp.int32(MAX_EVENTS + 1), n_events
                    )
                    return (*outs, n_flag)

            else:

                def run(bj, reads, lengths, groups, gene6, ind6, quals):
                    # legacy per-lane path: no error machinery, quals unused
                    reads = jnp.pad(reads.astype(jnp.int32),
                                    ((0, 0), (0, pad_amt)))
                    gene6 = jnp.pad(gene6, ((0, 0), (0, 0), (0, pad_amt)))
                    ind6 = jnp.pad(ind6, ((0, 0), (0, 0), (0, pad_amt)))

                    def one(seq, n, gi, g6, i6):
                        return _predict_one(seq, n, gi, g6, i6, bj, Lp,
                                            consts)

                    return jax.vmap(
                        one, in_axes=(0, 0, 0, 0, 0)
                    )(reads, lengths, groups, gene6, ind6)

            fn = jax.jit(run)
            _JIT_CACHE[key] = fn
            while len(_JIT_CACHE) > _JIT_CACHE_CAP:
                _JIT_CACHE.popitem(last=False)

        bj = getattr(bank, "_jnp_cache", None)
        if bj is None:
            bj = _bank_jnp(bank)
            bank._jnp_cache = bj
        # host numpy here: the jit dispatch transfers it with the other
        # arguments instead of an extra eager dispatch
        qarr = (np.asarray(quals, np.uint8) if consts["qual"]
                else np.zeros((1, 1), np.uint8))
        args = (bj, jnp.asarray(reads), jnp.asarray(lengths, jnp.int32),
                jnp.asarray(groups, jnp.int32), jnp.asarray(gene6),
                jnp.asarray(ind6), qarr)
        if lower:
            return fn.lower(*args)
        out = fn(*args)
        return [np.asarray(x) for x in jax.device_get(out)]


def finish_genes(outs, n_reads: int):
    """Host-side tail of Trace_Back: reverse traceback order and fix up
    final 1-based coordinates (glimmer3.cc:1692-1759). Returns
    (list[list[TracedGene]], overflow mask)."""
    from ..engine.events import TracedGene
    from ..engine.glimmer_mg import Error

    if len(outs) == 10:
        (g_id, g_stop, g_len, g_sign, g_trunc, g_score, g_epos, g_etyp,
         cnt, n_events) = outs
    else:
        g_id, g_stop, g_len, g_sign, g_trunc, g_score, cnt, n_events = outs
        g_epos = g_etyp = None
    overflow = (n_events > MAX_EVENTS) | (cnt > MAX_GENES)
    results = []
    for r in range(n_reads):
        genes = []
        for k in range(int(cnt[r])):
            sp = int(g_stop[r, k])
            fabs = 1 + ((sp + 2) % 3) if sp >= 0 else 3 - ((-sp) % 3)
            sign = int(g_sign[r, k])
            frame = fabs if sign > 0 else -fabs
            trunc = bool(g_trunc[r, k])
            if frame > 0:
                stop = sp + 2
                start = stop - int(g_len[r, k]) - 2
                if trunc:
                    start -= 3
            else:
                stop = sp
                start = stop + int(g_len[r, k]) + 2
                if trunc:
                    start += 3
            errors = ()
            if g_etyp is not None and int(g_etyp[r, k]) >= 0:
                errors = (Error(int(g_epos[r, k]), int(g_etyp[r, k])),)
            genes.append(TracedGene(
                id=int(g_id[r, k]), start=start, stop=stop, frame=frame,
                score=float(g_score[r, k]), errors=errors, truncated=trunc,
            ))
        results.append(genes[::-1])
    return results, overflow
