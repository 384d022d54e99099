"""glimmer-mg metagenomics prediction engine (per-read, error-tolerant).

Reference: src/Glimmer/glimmer-mg.cc. Differences from the glimmer3 engine:

  * whole-read 6-frame per-base LLR precompute (``Score_All_Frames``,
    glimmer-mg.cc:1468) + previous/next stop index arrays
    (``Save_Prev_Stops``, 675) — ORF scoring then reads cached values
    (``Cumulative_Frame_Score``, 561), so window contexts cross ORF
    boundaries (unlike glimmer3, which rescores each ORF in isolation);
  * sequencing-error tolerance: substitution pass-through of stop codons
    (``Pass_Stop_Penalty``, 961) and frame-shift branching at low-quality
    bases (``Score_Indels``, 1513), recursively enumerating error sets
    (``Score_Orf_Starts``, 1693) with 454 homopolymer quality synthesis
    (``Set_Quality_454``, 1865);
  * .predict rows carry I:/D:/S: error coordinates (``Trace_Back``, 1909).

The per-base LLR precompute is exactly 6 fixed-frame ICM walks over the
read (ops/icm_score.mg_six_frame_batch) for both the gene and null ICMs.
``run_glimmer_mg`` / ``run_glimmer_mg_classes`` process reads in chunks.
On a GPU backend each eligible chunk runs device-resident
(:func:`_device_dp_chunk`: six-frame walk, ORF scan, event DP and
traceback in ops.device_predict; only gene records come back). On a CPU
backend the per-read event semantics run in the native C++ engine
(glimmer_mg_tpu.native), batched over the chunk and threaded, with its own
tree walk or with device-computed LLRs (``device_precompute``); this
module's Python implementation is the parity oracle and the fallback
(GLIMMER_MG_TPU_NATIVE=0). GLIMMER_MG_TPU_DEVICE_DP=0/1 forces the route.
"""

from __future__ import annotations

import collections
import itertools
import os
from collections import OrderedDict

import numpy as np

from ..models import dna, icm as icm_mod
from . import events as ev_mod
from . import orfs as orf_mod
from .glimmer3 import Models, PwmScorer, Start

INT_MAX = 2**31 - 1

INDEL_SUFFIX_SCORE_THRESHOLD = -12.0
INDEL_QUALITY_THRESHOLD = 18
INDEL_MAX = 2
MIN_INDEL_ORF_LEN = 15


class Error:
    """Error_t (gene.hh:138): pos 1-based; type 0=ins, 1=del, 2=sub."""

    __slots__ = ("pos", "type")

    def __init__(self, pos, type):
        self.pos = pos
        self.type = type

    def __eq__(self, o):
        return (self.pos, self.type) == (o.pos, o.type)

    def __hash__(self):
        return hash((self.pos, self.type))

    def __repr__(self):
        return f"Err({self.pos},{'ids'[self.type]})"


def set_quality_454(seq: str) -> list[int]:
    """Synthesize 454-style qualities from homopolymer runs (mg.cc:1865)."""
    run_q = [31 - 5 * q for q in range(6)]  # {31,26,21,16,11,6}
    n = len(seq)
    qv = [0] * n
    run = 0
    last = None
    for i, ch in enumerate(seq):
        if ch != last:
            if i > 0:
                qv[i - 1] = run_q[run] if run < len(run_q) else run_q[-1]
            run = 1
        else:
            qv[i - 1] = 31
            run += 1
        last = ch
    if n:
        qv[n - 1] = run_q[run] if run < len(run_q) else run_q[-1]
    return qv


def clean_quality_454(seq: str, quals: list[int]) -> list[int]:
    """Clean_Quality_454 (mg.cc:519): floor at 1; in homopolymers only the
    final base keeps its low quality."""
    qv = [max(1, q) for q in quals]
    if len(qv) != len(seq):
        raise ValueError("sequence length does not match quality values length")
    for i in range(1, len(seq)):
        if seq[i] == seq[i - 1]:
            qv[i - 1] = max(qv[i - 1], INDEL_QUALITY_THRESHOLD + 1)
    return qv


def host_frame_scores(models: Models, seq_idx: np.ndarray) -> np.ndarray:
    """Score_All_Frames (mg.cc:1468) on host via the numpy walk mirror —
    the parity oracle for the device batch path."""
    n = len(seq_idx)
    frame_scores = np.zeros((6, n), dtype=np.float64)
    # forward frames from the reversed sequence…
    rev = seq_idx[::-1]
    for f in range(3):
        g = icm_mod.per_base_logprob_vec(models.gene_icm, rev, f, cycle=False)
        nn = icm_mod.per_base_logprob_vec(models.indep_model, rev, f, cycle=False)
        frame_scores[f] = g.astype(np.float64)[::-1] - nn.astype(np.float64)[::-1]
    # …reverse frames from the complemented (unreversed) sequence.
    comp = dna.COMPLEMENT_INDEX[seq_idx]
    for f in range(3):
        g = icm_mod.per_base_logprob_vec(models.gene_icm, comp, f, cycle=False)
        nn = icm_mod.per_base_logprob_vec(models.indep_model, comp, f, cycle=False)
        frame_scores[3 + f] = g.astype(np.float64) - nn.astype(np.float64)
    return frame_scores


def _bucket(x: int, step: int = 256) -> int:
    return max(step, -(-x // step) * step)


def device_frame_scores(jobs) -> list[np.ndarray] | None:
    """Batched Score_All_Frames on device for ``jobs`` = [(models, seq_idx)].

    Groups jobs by model pair into a stacked bank, pads reads/batch/bank to
    bucketed shapes (so jit caches stay warm), runs ONE device call, and
    forms the f64 LLRs on host. Returns None when the jobs cannot share one
    kernel instance (mixed model_len/periodicity) — callers fall back to
    ``host_frame_scores``.
    """
    fut = device_frame_scores_dispatch(jobs)
    return device_frame_scores_finish(fut)


def device_frame_scores_dispatch(jobs):
    """Async half of :func:`device_frame_scores`: enqueue the device
    computation and return an opaque future.

    JAX dispatch is asynchronous, so the walk for chunk k+1 runs on the
    chip while the host's event-DP engine processes chunk k (the
    double-buffered streaming loop in :func:`run_glimmer_mg_classes`,
    mirroring the reference's chunked main loop glimmer-mg.cc:327-452 but
    with the 6-frame precompute off the critical path).  Returns None when
    the job set cannot share one kernel instance.
    """
    from ..ops import icm_score

    if not jobs:
        return []
    model_ids: dict[int, int] = {}
    gene_list, indep_list = [], []
    group = np.zeros(len(jobs), dtype=np.int32)
    for r, (models, _seq) in enumerate(jobs):
        key = id(models)
        gi = model_ids.get(key)
        if gi is None:
            gi = len(gene_list)
            model_ids[key] = gi
            gene_list.append(models.gene_icm)
            indep_list.append(models.indep_model)
        group[r] = gi

    model_len = gene_list[0].model_len
    periodicity = gene_list[0].periodicity
    if any(m.model_len != model_len or m.periodicity != periodicity
           for m in gene_list):
        return None
    depth = max(m.model_depth for m in gene_list)

    gmip, gprobs = icm_score.stack_bank(gene_list)
    imip, iprobs = icm_score.stack_bank(indep_list)
    # pad the bank to a power of two so recompiles stay rare
    g_pad = 1 << (len(gene_list) - 1).bit_length()
    if g_pad > len(gene_list):
        pad = g_pad - len(gene_list)
        gmip = np.concatenate([gmip, np.repeat(gmip[:1], pad, 0)])
        gprobs = np.concatenate([gprobs, np.repeat(gprobs[:1], pad, 0)])
        imip = np.concatenate([imip, np.repeat(imip[:1], pad, 0)])
        iprobs = np.concatenate([iprobs, np.repeat(iprobs[:1], pad, 0)])

    lengths = np.array([len(s) for _, s in jobs], dtype=np.int32)
    l_pad = _bucket(int(lengths.max(initial=1)))
    b_pad = _bucket(len(jobs), 64)
    reads = np.zeros((b_pad, l_pad), dtype=np.int32)
    for r, (_m, seq) in enumerate(jobs):
        reads[r, : len(seq)] = seq
    lens = np.zeros(b_pad, dtype=np.int32)
    lens[: len(jobs)] = lengths
    grp = np.zeros(b_pad, dtype=np.int32)
    grp[: len(jobs)] = group

    gene, ind = icm_score.mg_six_frame_batch(
        gmip, gprobs, imip, iprobs, reads, lens, grp,
        model_len=model_len, depth=depth, gene_periodicity=periodicity,
    )
    read_lens = [len(s) for _m, s in jobs]
    return (gene, ind, read_lens)


def device_frame_scores_finish(fut) -> list[np.ndarray] | None:
    """Blocking half of :func:`device_frame_scores`: fetch the device
    arrays and form the f64 gene-minus-null LLRs per read."""
    import jax

    if fut is None or fut == []:
        return fut
    gene, ind, read_lens = fut
    gene, ind = jax.device_get((gene, ind))

    out = []
    for r, n in enumerate(read_lens):
        fs = np.empty((6, n), dtype=np.float64)
        for f in range(3):
            fs[f] = (
                gene[r, f, :n].astype(np.float64)
                - ind[r, f, :n].astype(np.float64)
            )[::-1]
            fs[3 + f] = gene[r, 3 + f, :n].astype(np.float64) - ind[
                r, 3 + f, :n
            ].astype(np.float64)
        out.append(fs)
    return out


def _use_device_precompute(device_precompute) -> bool:
    if _use_device_dp():
        # chip-resident mode runs its own six-frame call inside
        # _device_dp_chunk; no per-base LLRs are shipped to the host
        return False
    if device_precompute is not None:
        return bool(device_precompute)
    if os.environ.get("GLIMMER_MG_TPU_HOST_PRECOMPUTE") == "1":
        return False
    if os.environ.get("GLIMMER_MG_TPU_DEVICE_PRECOMPUTE") == "1":
        return True
    # Default: the native engine runs its own C++ walk, which saves
    # shipping the two (B, 6, L) f32 LLR tables to the host;
    # without the native engine the batched device walk beats the
    # per-read numpy walk. Whether shipping pays on a GPU host is not
    # measured yet.
    from .. import native as native_mod

    return not native_mod.available()


def _native_models_for(models):
    """Cached native marshaling of a Models bundle (None if unavailable)."""
    from .. import native as native_mod

    nm = getattr(models, "_native_marshal", None)
    if nm is None:
        nm = native_mod.NativeModels(models)
        models._native_marshal = nm
    return nm


def _native_predict(pending_jobs, fs_list, allow_indels, allow_subs):
    """Run a chunk through the native C++ engine.

    pending_jobs: [(seq_idx, models, quals, have_qual)] with models != None.
    fs_list: per-job (6, n) f64 LLR arrays from the device precompute, or
    None to let the native engine run its own tree walk.
    Returns list[list[TracedGene]] or None when the native path can't serve
    these jobs (engine missing, circular mode).
    """
    from .. import native as native_mod

    if not native_mod.available():
        return None
    jobs = []
    try:
        for ji, (seq_idx, models, quals, have_qual) in enumerate(pending_jobs):
            fs = fs_list[ji] if fs_list is not None else None
            jobs.append(
                (seq_idx, quals, have_qual, fs, _native_models_for(models))
            )
    except native_mod.NativeUnavailable:
        return None
    return native_mod.predict_batch(
        jobs, allow_indels=allow_indels, allow_subs=allow_subs
    )


_SERIAL = itertools.count()


def _stable_tag(obj, kind: str):
    """Process-unique, never-reused identity for process-wide cache keys.

    ``id()`` can be reused after the object is garbage-collected, so a
    module-global cache keyed on it can silently serve a stale bank built
    from a dead object's tables (r4 advisor, medium). The serial is
    stamped on the object once and never reissued.
    """
    tag = getattr(obj, "_gmg_cache_serial", None)
    if tag is None:
        tag = (kind, next(_SERIAL))
        try:
            object.__setattr__(obj, "_gmg_cache_serial", tag)
        except Exception:
            pass  # unsettable object: fresh tag per call (cache miss, safe)
    return tag


def _lru_put(cache, key, val, cap: int) -> None:
    """Insert into an OrderedDict LRU bounded at ``cap`` entries."""
    cache[key] = val
    cache.move_to_end(key)
    while len(cache) > cap:
        cache.popitem(last=False)


def _use_native() -> bool:
    return os.environ.get("GLIMMER_MG_TPU_NATIVE") != "0"


_ENGINE_CHOICE_LOGGED = [False]

#: Where the reads of device-eligible chunks went: ``chunks_device`` /
#: ``reads_device`` ran device-resident, ``reads_overflow`` of those were
#: re-run on the host engine (event or window capacity), ``chunks_host``
#: were refused by the device path (indel mode, circular, mixed scalars)
#: and ran entirely on the host. Callers may reset it between runs.
DEVICE_DP_COUNTS: collections.Counter = collections.Counter()


def _use_device_dp() -> bool:
    """Chip-resident prediction (on-device ORF scan + event DP): the whole
    per-read path runs on the accelerator and only gene calls cross the
    link (ops.device_predict; SURVEY §7.4/§7.5).

    GLIMMER_MG_TPU_DEVICE_DP=1/0 forces it. Otherwise eligible chunks run
    device-resident on a GPU backend and in the host engines on a CPU
    backend. The choice is logged once (GLIMMER_MG_TPU_VERBOSE=1)."""
    env = os.environ.get("GLIMMER_MG_TPU_DEVICE_DP")
    if env is not None:
        return env == "1"
    import jax

    from ..utils import observe

    backend = jax.default_backend()
    choice = backend == "gpu"
    if not _ENGINE_CHOICE_LOGGED[0]:
        _ENGINE_CHOICE_LOGGED[0] = True
        observe.vlog(
            1,
            f"engine auto-select: {'device-resident' if choice else 'host'}"
            f" (jax backend {backend!r})")
    return choice


# LRU-bounded: banks are large (numpy tables + _jnp_cache device arrays)
# and long-lived processes can see many (models, length-bucket) pairs.
_DEVICE_BANK_CACHE: OrderedDict = OrderedDict()
_DEVICE_BANK_CAP = 8


def _device_dp_chunk(pending_jobs, allow_indels, allow_subs):
    """Run a chunk through the chip-resident path.

    pending_jobs: [(seq_idx, models, quals, have_qual)] with models set.
    Returns list[list[TracedGene]] or None when ineligible (indel mode,
    circular, non-uniform model scalars) — callers fall back. Substitution
    mode, with or without quality files, runs on the device (the
    sub-extension families in ops.device_predict).
    """
    if allow_indels:
        return None
    if allow_subs and os.environ.get("GLIMMER_MG_TPU_DP_BATCHED", "1") != "1":
        return None  # the legacy per-lane DP has no error machinery
    from ..ops import device_predict as dpk

    any_qual = False
    for seq_idx, models, quals, have_qual in pending_jobs:
        if models.circular:
            return None
        if not models.allow_truncated_orfs:
            return None
        if quals is not None or have_qual:
            # quality values feed exactly two things in the host engine:
            # the indel branch (indel mode — host fallback above) and
            # Pass_Stop_Penalty (subs mode — the device computes the
            # per-position quality penalty from an uploaded table).
            # Error-free mode never reads them, so quality-file
            # reads stay device-eligible there with no upload at all.
            any_qual = allow_subs

    model_ids: dict[int, int] = {}
    models_list = []
    group = np.zeros(len(pending_jobs), dtype=np.int32)
    for r, (_s, models, _q, _hq) in enumerate(pending_jobs):
        gi = model_ids.get(id(models))
        if gi is None:
            gi = len(models_list)
            model_ids[id(models)] = gi
            models_list.append(models)
        group[r] = gi

    lengths = np.array([len(s) for s, *_ in pending_jobs], dtype=np.int32)
    l_pad = _bucket(int(lengths.max(initial=1)))
    b_pad = _bucket(len(pending_jobs), 64)

    # subs mode + quality file: upload per-base qualities (uint8, sentinel
    # 255 = "no quality file row" -> the default 0.999 penalty table entry)
    q_pad = None
    if any_qual:
        q_pad = np.full((b_pad, l_pad), 255, np.uint8)
        for r, (_s, _m, quals, have_qual) in enumerate(pending_jobs):
            if have_qual and quals is not None:
                # negative (Solexa-scale) values floor at 0 instead of
                # wrapping through the uint8 cast to a high quality
                qv = np.clip(np.asarray(quals[:l_pad], np.int64), 0, 254)
                q_pad[r, : len(qv)] = qv.astype(np.uint8)

    # content-stable tags (the classes-mode model cache key) keep the bank
    # cache warm across generator invocations; raw id() keys changed
    # every run and forced bank rebuilds
    tags = tuple(
        getattr(m, "_cache_tag", None) or _stable_tag(m, "m")
        for m in models_list
    )
    bank_key = (tags, l_pad)
    bank = _DEVICE_BANK_CACHE.get(bank_key)
    if bank is not None:
        _DEVICE_BANK_CACHE.move_to_end(bank_key)
    else:
        # pad the group axis to a fixed bucket (8, then powers of two) with
        # copies of the first model: chunks holding different numbers of
        # model groups then share one compiled walk and DP instead of
        # compiling per group count (no read points at a pad group)
        g_pad = max(8, 1 << (len(models_list) - 1).bit_length())
        padded = models_list + [models_list[0]] * (g_pad - len(models_list))
        try:
            bank = dpk.build_bank(padded, max_read_len=l_pad)
        except ValueError:
            return None
        _lru_put(_DEVICE_BANK_CACHE, bank_key, bank, _DEVICE_BANK_CAP)

    # six-frame f32 LLR tables stay on device; DP consumes them in place
    from ..ops import icm_score

    reads = np.zeros((b_pad, l_pad), dtype=np.int32)
    for r, (seq_idx, *_rest) in enumerate(pending_jobs):
        reads[r, : len(seq_idx)] = seq_idx
    lens = np.zeros(b_pad, dtype=np.int32)
    lens[: len(pending_jobs)] = np.minimum(lengths, l_pad)
    grp = np.zeros(b_pad, dtype=np.int32)
    grp[: len(pending_jobs)] = group

    gene6, ind6 = icm_score.mg_six_frame_batch(
        bank.gene_mip, bank.gene_probs, bank.indep_mip, bank.indep_probs,
        reads, lens, grp, model_len=bank.model_len, depth=bank.depth,
        gene_periodicity=bank.periodicity,
    )
    outs = dpk.predict_batch_device(
        bank, reads, lens, grp, gene6, ind6, cache_key=bank_key,
        subs=allow_subs, quals=q_pad,
    )
    genes, overflow = dpk.finish_genes(outs, len(pending_jobs))
    DEVICE_DP_COUNTS["chunks_device"] += 1
    DEVICE_DP_COUNTS["reads_device"] += len(pending_jobs)
    DEVICE_DP_COUNTS["reads_overflow"] += int(overflow[: len(pending_jobs)].sum())

    for r, (seq_idx, models, quals, have_qual) in enumerate(pending_jobs):
        if overflow[r]:
            # forward the error mode: dropping allow_subs here would give
            # overflowing reads error-free predictions in subs mode
            genes[r] = _predict_read_with_models(
                models, seq_idx, quals, allow_subs=allow_subs,
                have_qual_file=have_qual
            )
    return genes


def _overlap_engine() -> bool:
    """Pipeline the native engine call behind the main thread (chunk k runs
    in the engine while the main thread parameterizes chunk k+1).

    Only a win when a core is free to absorb the extra thread: on a 2-core
    host the engine threads and the prep thread oversubscribe the cores,
    while on >=4-core hosts the serial prep phase otherwise leaves the
    engine idle.  GLIMMER_MG_TPU_OVERLAP=0/1 overrides."""
    env = os.environ.get("GLIMMER_MG_TPU_OVERLAP")
    if env is not None:
        return env != "0"
    return (os.cpu_count() or 1) >= 4


_ENGINE_POOL = None


def _engine_pool():
    """Single-worker pool running engine chunks behind the main thread.

    One worker keeps chunk ordering FIFO and serializes the lazy marshaling
    caches.  Module-level so abandoned generators don't leak pools; the
    worker only ever runs bounded chunk jobs, so interpreter exit (which
    joins executor threads) cannot hang on it."""
    global _ENGINE_POOL
    if _ENGINE_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _ENGINE_POOL = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gmg-engine"
        )
    return _ENGINE_POOL


class MgSequenceState:
    """Per-read precomputed state: 6-frame LLRs + stop indexes."""

    def __init__(self, models: Models, seq_idx: np.ndarray, frame_scores=None):
        self.m = models
        self.seq = seq_idx
        n = len(seq_idx)
        self.n = n
        if frame_scores is None:
            frame_scores = host_frame_scores(models, seq_idx)
        self.frame_scores = frame_scores

        self._save_prev_stops()

    def _save_prev_stops(self):
        """Save_Prev_Stops (mg.cc:675): per-position previous fwd stop / next
        rev stop in the position's frame (0-based codon-boundary indexes).
        Vectorized as per-frame running max/min scans."""
        n = self.n
        masks = np.array([1, 2, 4, 8], dtype=np.uint8)[self.seq]
        cod = dna.codon12_stream(masks)
        fwd_stop = dna.must_be(cod, self.m.patterns.fwd_stop)

        self.fwd_prev = np.empty(n, dtype=np.int64)
        init_f = (0, 1, -1)
        for f in range(3):
            idx = np.arange(f, n, 3)
            if len(idx) == 0:
                continue
            hit = (idx >= 2) & fwd_stop[idx]
            vals = np.where(hit, idx, np.int64(-(10**9)))
            run = np.maximum.accumulate(
                np.concatenate(([np.int64(init_f[f])], vals))
            )[1:]
            self.fwd_prev[idx] = run

        # reverse: stops detected scanning right-to-left over revcomp codons;
        # a rev stop with 0-based first base i is flagged by rev_stop[i+2]
        # in the forward codon stream.
        rev_stop = dna.must_be(cod, self.m.patterns.rev_stop)
        self.rev_next = np.empty(n, dtype=np.int64)
        init_r = (n - 1, n - 2, n)
        for f in range(3):
            # i with (n-1-i) % 3 == f, scanned right-to-left
            idx = np.arange(n - 1 - f, -1, -3)
            if len(idx) == 0:
                continue
            hit = (idx <= n - 3) & rev_stop[np.minimum(idx + 2, n - 1)]
            vals = np.where(hit, idx, np.int64(10**9))
            run = np.minimum.accumulate(
                np.concatenate(([np.int64(init_r[f])], vals))
            )[1:]
            self.rev_next[idx] = run

    def fwd_prev_stop(self, end_point: int) -> int:
        if 0 <= end_point < self.n:
            return int(self.fwd_prev[end_point])
        return end_point

    def rev_next_stop(self, end_point: int) -> int:
        if 0 <= end_point < self.n:
            return int(self.rev_next[end_point])
        return end_point

    def cumulative_frame_score(self, frame: int, lo: int, hi: int) -> np.ndarray:
        """Cumulative_Frame_Score (mg.cc:561): cumsum of cached LLRs, frame
        cycling starting at 1 (the '0,2,1 codon order' quirk)."""
        length = hi - lo
        if length <= 0:
            return np.zeros(max(0, length), dtype=np.float64)
        if frame > 0:
            si = np.arange(hi - 1, lo - 1, -1)
            f = (1 + np.arange(length)) % 3
            vals = self.frame_scores[f, si]
        else:
            si = np.arange(lo - 1, hi - 1)
            f = 3 + (1 + np.arange(length)) % 3
            vals = self.frame_scores[f, si]
        return np.cumsum(vals)


_F64_TINY = float(np.finfo(np.float64).tiny)
_F64_EPSNEG = float(np.finfo(np.float64).epsneg)


def pass_stop_penalty(models, seq_str, quals, frame, lo, hi) -> float:
    """Pass_Stop_Penalty (mg.cc:961)."""
    import math

    default_p = 0.999
    if frame > 0:
        stop_i = [lo - 3, lo - 2, lo - 1]
    else:
        stop_i = [hi + 1, hi, hi - 1]
    if quals is not None:
        # negative qualities floor at 0, as in the device upload
        codon_p = [1.0 - 10.0 ** (-float(max(quals[s], 0)) / 10.0)
                   for s in stop_i]
    else:
        codon_p = [default_p] * 3
    p_stop = codon_p[0]
    mid = seq_str[stop_i[1]]
    if (frame > 0 and mid == "a") or (frame < 0 and mid == "t"):
        p_stop *= 2.0 / 3.0 * codon_p[1] + 1.0 / 3.0
    else:
        p_stop *= codon_p[1]
    last = seq_str[stop_i[2]]
    if (frame > 0 and last == "a") or (frame < 0 and last == "t"):
        p_stop *= 2.0 / 3.0 * codon_p[2] + 1.0 / 3.0
    else:
        p_stop *= codon_p[2]
    # the device path's clamp: finite at the phred extremes (q=0 gives
    # p_stop=0); every other value passes unchanged
    p_stop = min(max(p_stop, _F64_TINY), 1.0 - _F64_EPSNEG)
    return math.log(1.0 - p_stop) - math.log(p_stop)


class MgScorer:
    """Score_Orfs_Errors / Score_Orf_Starts / Score_Indels."""

    def __init__(self, models: Models, seq_str: str, seq_idx, state, quals,
                 allow_indels=False, allow_subs=False, have_qual_file=False):
        self.m = models
        self.seq_str = seq_str
        self.seq = seq_idx
        self.state = state
        self.quals = quals
        self.allow_indels = allow_indels
        self.allow_subs = allow_subs
        self.have_qual_file = have_qual_file
        masks_of = np.array([1, 2, 4, 8], dtype=np.int32)
        self.masks = masks_of[seq_idx]
        self.comp_masks = masks_of[dna.COMPLEMENT_INDEX[seq_idx]]

    def score_orf_starts(self, orf, start_list, end_point, suffix_score,
                         suffix_j, errors):
        """mg.cc:1693."""
        m = self.m
        st = self.state
        n = st.n
        frame = orf.frame

        if frame > 0:
            hi = end_point
            lo = st.fwd_prev_stop(end_point - 1) + 1
            length = hi - lo
            orf_is_truncated = lo < 3 and m.allow_truncated_orfs
            k = lo - 1
            if length >= 0:
                # reversed buffer masks: buff[j] = seq[hi-1-j]
                bidx = np.arange(hi - 1, hi - 1 - length, -1)
                bm = self.masks[bidx] if length > 0 else np.zeros(0, np.int32)
                bq = (
                    [self.quals[i] for i in bidx]
                    if self.quals is not None
                    else None
                )
            else:
                bm, bq = np.zeros(0, np.int32), None
        else:
            lo = end_point
            hi = st.rev_next_stop(end_point - 1) + 1
            length = hi - lo
            orf_is_truncated = (n - (hi - 1)) < 3 and m.allow_truncated_orfs
            k = hi + 1
            if lo - 1 < n:
                bidx = np.arange(lo - 1, lo - 1 + length)
                bm = self.comp_masks[bidx] if length > 0 else np.zeros(0, np.int32)
                bq = (
                    [self.quals[i] for i in bidx]
                    if self.quals is not None
                    else None
                )
            else:
                bm, bq = np.zeros(0, np.int32), None

        score = st.cumulative_frame_score(frame, lo, hi)

        # -- substitution branch: mutate previous stop codon (mg.cc:1769) --
        if self.allow_subs and len(errors) < 1:
            if frame > 0:
                error_end_point = lo - 3
                error_pos = lo - 2
            else:
                error_end_point = hi + 3
                error_pos = hi + 2
            if error_end_point >= 0 and error_end_point - 2 < n:
                error_suffix_j = suffix_j + length
                error_suffix_score = suffix_score + pass_stop_penalty(
                    m, self.seq_str, self.quals if self.have_qual_file else None,
                    frame, lo, hi,
                )
                if len(score):
                    error_suffix_score += float(score[-1])
                self.score_orf_starts(
                    orf, start_list, error_end_point, error_suffix_score,
                    error_suffix_j, errors + [Error(error_pos, 2)],
                )

        # -- start scanning (with indel branching) --
        mm = len(score)
        if mm:
            cod = np.zeros(mm, dtype=np.int32)
            cod |= bm
            cod[: mm - 1] |= bm[1:] << 4
            cod[: mm - 2] |= bm[2:] << 8
            can_any = dna.can_be(cod, m.patterns.fwd_start)
            whichs = np.full(mm, -1, dtype=np.int64)
            for pi in range(len(m.patterns.fwd_start) - 1, -1, -1):
                hit = dna.can_be(cod, m.patterns.fwd_start[pi : pi + 1])
                whichs[hit] = pi
        # Sparse rewrite of the reference's dense descending-j scan
        # (glimmer-mg.cc:1769-1860): only positions that can actually fire —
        # possible starts (j % 3 == 0, Can_Be, length bound) and low-quality
        # indel-branch bases — are visited, in the exact original order
        # (indel branch before the start at equal j; the truncated-ORF
        # "first position counts even without a start codon" rule tracked
        # via first_pos exactly as the dense loop does).
        lowest_j = min(3, m.min_gene_len - 3)
        first_pos = 0
        dir_ = 1 if frame > 0 else -1

        if mm:
            min_j = max(lowest_j, m.min_gene_len - 3 - suffix_j)
            top_j = ((mm - 1) // 3) * 3
            start_j = np.arange(top_j, min_j - 1, -3, dtype=np.int64)
            can_pos = (
                np.nonzero(can_any[start_j])[0] if len(start_j)
                else np.zeros(0, dtype=np.int64)
            )
        else:
            top_j = -1
            start_j = np.zeros(0, dtype=np.int64)
            can_pos = np.zeros(0, dtype=np.int64)

        if (self.allow_indels and bq is not None and len(errors) < INDEL_MAX
                and mm):
            bq_arr = np.asarray(bq, dtype=np.int64)
            ij = np.nonzero(bq_arr <= INDEL_QUALITY_THRESHOLD)[0]
            ij = ij[ij >= lowest_j][::-1]  # descending j
        else:
            bq_arr = None
            ij = np.zeros(0, dtype=np.int64)

        si = 0  # next unconsidered index into start_j (descending)
        ci = 0  # pointer into can_pos
        ii = 0  # pointer into ij
        n_start = len(start_j)
        n_can = len(can_pos)
        n_ij = len(ij)
        while True:
            ns = -1
            if si < n_start:
                if first_pos == 0 and orf_is_truncated:
                    ns = int(start_j[si])
                else:
                    while ci < n_can and can_pos[ci] < si:
                        ci += 1
                    if ci < n_can:
                        ns = int(start_j[can_pos[ci]])
            ni = int(ij[ii]) if ii < n_ij else -1
            if ns < 0 and ni < 0:
                break
            if ni >= 0 and ni >= ns:  # indel branch fires before the start
                j = ni
                ii += 1
                kk = k + dir_ * (mm - 1 - j)
                self._score_indels(
                    orf, start_list, errors, suffix_score, suffix_j, score,
                    int(bq_arr[j]), kk, j,
                )
                continue
            j = ns
            si = (top_j - j) // 3 + 1  # index of j in start_j, advanced past
            kk = k + dir_ * (mm - 1 - j)
            which = int(whichs[j])
            next_s = float(score[j - 1])
            first_flag = first_pos == 0
            base = Start(
                j + 2 + suffix_j, kk, next_s + suffix_score, first_flag,
                which, which < 0, tuple(errors),
            )
            if which >= 0 and first_pos == 0 and orf_is_truncated:
                start_list.append(
                    Start(base.j, kk, base.score, first_flag, -1, True,
                          tuple(errors))
                )
                base.first = False
            start_list.append(base)
            if first_pos == 0:
                first_pos = kk

    def _score_indels(self, orf, start_list, errors, suffix_score, suffix_j,
                      score, q, k, j):
        """Score_Indels (mg.cc:1513)."""
        import math

        frame = orf.frame
        prob_err = 10.0 ** (-float(q) / 10.0)
        penalty = math.log(prob_err / 2.0) - math.log(1.0 - prob_err)

        if frame > 0:
            branches = [
                # (llr index, new end point, error)
                (j, k + (j % 3), Error(k + 3, 1)),  # deletion
                (j - 1, k - (2 - (j % 3)), Error(k + 2, 0)),  # insertion
            ]
        else:
            branches = [
                (j, k - (j % 3), Error(k - 1, 1)),
                (j - 1, k + 2 - (j % 3), Error(k - 2, 0)),
            ]
        for sidx, end_point, err in branches:
            ess = suffix_score + float(score[sidx]) + penalty
            if ess > INDEL_SUFFIX_SCORE_THRESHOLD:
                esj = suffix_j + j + 2 - (j % 3)
                self.score_orf_starts(
                    orf, start_list, end_point, ess, esj, errors + [err]
                )


def score_orfs_errors(models, scorer, orf_list, engine, pwm_scorer):
    """Score_Orfs_Errors (mg.cc:1605)."""
    m = models
    for orf in orf_list:
        frame = orf.frame
        start_list: list[Start] = []
        if frame > 0:
            end_point = orf.stop_position - 1
        else:
            end_point = orf.stop_position + 3
        scorer.score_orf_starts(orf, start_list, end_point, 0.0, 0, [])

        for s in start_list:
            if s.j > m.ignore_score_len:
                s.score = max(0.0, s.score)

        if not start_list:
            continue
        from ..utils.stdsort import std_sort

        std_sort(start_list, lambda a, b: a.pos < b.pos)  # std::sort w/ Start_Cmp
        first_j = start_list[0].j if frame > 0 else start_list[-1].j
        if first_j + 1 < m.min_gene_len:
            continue
        best_score = max(s.score for s in start_list)
        if best_score > m.start_threshold:
            if frame > 0:
                engine.add_events_fwd(orf, start_list, pwm_scorer)
            else:
                engine.add_events_rev(orf, start_list, pwm_scorer)


def predict_read(models: Models, seq: str, quals=None, *, allow_indels=False,
                 allow_subs=False, have_qual_file=False, frame_scores=None):
    """Full per-read pipeline; returns traced genes (with errors)."""
    return _predict_read_with_models(
        models, seq, quals, allow_indels=allow_indels, allow_subs=allow_subs,
        have_qual_file=have_qual_file, frame_scores=frame_scores,
        use_meta_pwms=False,
    )


class MetaPwmScorer:
    """RBS scoring against a mixture of class PWMs with per-position
    memoization (PWM_Meta_Score_Fwd/Rev_Start, glimmer-mg.cc:1900-2060)."""

    def __init__(self, models: Models, seq_idx: np.ndarray, pwms):
        import math

        self.m = models
        self.seq = seq_idx
        self.n = len(seq_idx)
        self.pwms = pwms  # raw-probability PWMs
        self.cache: dict[int, tuple] = {}
        gc = models.indep_gc_frac
        gc_log = math.log(0.5 * gc)
        at_log = math.log(0.5 * (1.0 - gc))
        self.nt_lp = np.array([at_log, gc_log, gc_log, at_log])
        self._precompute()

    def _precompute(self) -> None:
        """Vectorize the per-window mixture probabilities over the whole read.

        ``mix_fwd[lo]`` = mean over class PWMs of prod_j cols[j, seq[lo+j]]
        (the value whose libm log the scalar scorer takes); ``gc_fwd[lo]`` =
        the GC-background log-prob sum. The chained elementwise multiplies /
        adds reproduce np.prod / .sum() over the 6-wide window bitwise
        (sequential order below the pairwise-reduction blocksize), and the
        log itself stays scalar math.log in fwd/rev_start, so scores are
        bit-identical to the reference's per-window loop
        (PWM_Meta_Score_Fwd/Rev_Start, glimmer-mg.cc:1900-2060)."""
        self.mix_fwd = self.gc_fwd = self.mix_rev = self.gc_rev = None
        if not self.pwms:
            return
        width = self.pwms[0].width
        n = self.n
        nw = n - width + 1
        if nw <= 0:
            return
        s = self.seq.astype(np.int64)
        comp = dna.COMPLEMENT_INDEX[self.seq].astype(np.int64)

        acc = np.zeros(nw, dtype=np.float64)
        for p in self.pwms:
            prod = np.ones(nw, dtype=np.float64)
            for j in range(width):
                prod = prod * p.cols[j, s[j : j + nw]]
            acc = acc + prod
        self.mix_fwd = acc / len(self.pwms)
        g = np.zeros(nw, dtype=np.float64)
        for j in range(width):
            g = g + self.nt_lp[s[j : j + nw]]
        self.gc_fwd = g

        # rev window "ending" at hi (hi in [width-1, n-1]): window[j] =
        # comp(seq[hi - j]); stored at index hi - (width - 1).
        acc = np.zeros(nw, dtype=np.float64)
        for p in self.pwms:
            prod = np.ones(nw, dtype=np.float64)
            for j in range(width):
                prod = prod * p.cols[j, comp[width - 1 - j : n - j]]
            acc = acc + prod
        self.mix_rev = acc / len(self.pwms)
        g = np.zeros(nw, dtype=np.float64)
        for j in range(width):
            g = g + self.nt_lp[comp[width - 1 - j : n - j]]
        self.gc_rev = g

    def fwd_start(self, pos: int):
        import math

        if not self.pwms:
            return 0.0, 0
        key = pos - 1
        if key in self.cache:
            return self.cache[key]
        n = self.pwms[0].width
        bottom = pos - self.m.ribosome_window_size - 1
        score = -np.inf
        best_sep = sep = 0
        lo = pos - n - 1
        while lo >= 0 and lo >= bottom:
            sc = math.log(self.mix_fwd[lo]) - self.gc_fwd[lo]
            if sc > score:
                score = sc
                best_sep = sep
            lo -= 1
            sep += 1
        out = (score, best_sep)
        self.cache[key] = out
        return out

    def rev_start(self, pos: int):
        import math

        if not self.pwms:
            return 0.0, 0
        key = self.n + pos - 1
        if key in self.cache:
            return self.cache[key]
        n = self.pwms[0].width
        top = pos - 1 + self.m.ribosome_window_size
        score = -np.inf
        best_sep = sep = 0
        hi = pos - 1 + n
        while hi < self.n and hi <= top:
            sc = math.log(self.mix_rev[hi - (n - 1)]) - self.gc_rev[hi - (n - 1)]
            if sc > score:
                score = sc
                best_sep = sep
            hi += 1
            sep += 1
        out = (score, best_sep)
        self.cache[key] = out
        return out


def classes_emission_order(genome_data, classifications: dict) -> list[str]:
    """Reference emission order of classified reads (glimmer-mg.cc:361):
    reads grouped by gene-ICM file, groups in __gnu_cxx::hash_map iteration
    order over the ICM paths, reads within a group in the
    `classifications` hash_map order (Read_Meta_ICMs, glimmer-mg.cc:1001);
    unclassified reads are never emitted. Duplicate prefixes: the last
    read wins (Read_Indexes) and is emitted once.

    A pure function of the class map — any process can compute it, so
    read-sharded multi-process prediction can take contiguous slices whose
    concatenated outputs are byte-equal to the single-process run
    (reference combine_seq merge semantics, phymm_par.py:283-399).
    """
    from ..utils.gnuhash import GnuHashMap, gnu_hash_order

    icm_groups = GnuHashMap()
    for prefix in gnu_hash_order(list(classifications.keys())):
        cl = classifications.get(prefix)
        if not cl:
            continue
        f = genome_data.classes_icm_file(cl)
        if f in icm_groups:
            icm_groups[f].append(prefix)
        else:
            icm_groups.insert(f, [prefix])
    return [p for _f, prefixes in icm_groups.items() for p in prefixes]


def run_glimmer_mg_classes(
    sequences,  # list of (header, seq)
    genome_data,  # io.genome_data.GenomeData
    classifications: dict,  # header prefix -> [class strings]
    *,
    qualities: dict | None = None,
    user_icm: icm_mod.ICM | None = None,
    features_path=None,
    user_rbs_pwm=None,
    logodds_fudge: float | None = None,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    allow_indels: bool = False,
    allow_subs: bool = False,
    circular: bool = False,
    user_stop_codons=None,
    device_precompute=None,
):
    """glimmer-mg classification mode (-c): per-read model parameterization.

    Mirrors Update_Meta_* (glimmer-mg.cc:2050-2359): per-read the class
    length/start/adjacency distributions are averaged (log-space for
    lengths), the null ICM is rebuilt from mean class GC, stop codons come
    from the top class's translation table, the RBS is a mixture of class
    PWMs, and the gene ICM is the best (double) class ICM.
    """
    import math

    from ..io import features_file
    from ..io.genome_data import STOP_CODONS_BY_CODE
    from .glimmer3 import set_ignore_score_len, gc_fraction
    from ..utils.mathutils import log_add

    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")

    fudge_f32 = np.float32(1.0 if logodds_fudge is None else logodds_fudge)

    parsed = None
    if features_path is not None:
        parsed = features_file.parse_features(
            features_path,
            min_gene_len=min_gene_len,
            max_olap_bases=max_olap_bases,
            sequence_aa_lengths=[len(s) // 3 for _, s in sequences],
            logodds_fudge=logodds_fudge,
        )

    icm_cache: dict[str, icm_mod.ICM] = {}
    model_cache: dict[tuple, Models] = {}

    sequences = list(sequences)
    if user_icm is not None:
        user_gc = gc_fraction([s for _, s in sequences])
        iter_sequences = sequences
    else:
        by_prefix = {}
        for h, s in sequences:
            by_prefix[h.split()[0]] = (h, s)
        iter_sequences = [
            by_prefix[p]
            for p in classes_emission_order(genome_data, classifications)
            if p in by_prefix
        ]

    use_device = _use_device_precompute(device_precompute)
    # Evaluate once per run: _dispatch/_consume must agree on the engine
    # pipelining mode even if GLIMMER_MG_TPU_OVERLAP changes mid-flight.
    overlap = _overlap_engine()
    chunk_size = int(os.environ.get("GLIMMER_MG_TPU_CHUNK", "2048"))
    pending: list = []  # (header, seq_idx or None, models, quals, have_qual)
    inflight: list = []  # at most one (chunk, engine-future) in flight

    def _run_chunk(chunk, fut):
        """Worker-side half of a chunk: finish the device precompute (if
        any) and run the native engine.  Runs on the single engine worker
        thread; the C call releases the GIL, so the main thread keeps
        building chunk k+1's models while chunk k is predicted."""
        jobs = [(s, m, q, hq) for _h, s, m, q, hq in chunk if m is not None]
        if _use_device_dp() and jobs:
            dd = _device_dp_chunk(jobs, allow_indels, allow_subs)
            if dd is not None:
                return None, dd
            DEVICE_DP_COUNTS["chunks_host"] += 1
        fs_list = device_frame_scores_finish(fut) if fut is not None else None
        native_results = None
        if _use_native() and jobs:
            native_results = _native_predict(
                jobs, fs_list, allow_indels, allow_subs,
            )
        return fs_list, native_results

    def _dispatch():
        """Enqueue the current chunk's device precompute (async) and hand
        the chunk to the engine worker; both the chip walk and the C++
        engine of chunk k then overlap with the host prep of chunk k+1."""
        chunk = list(pending)
        pending.clear()
        jobs = [(m, s) for _h, s, m, _q, _hq in chunk if m is not None]
        fut = (
            device_frame_scores_dispatch(jobs) if (use_device and jobs) else None
        )
        if overlap:
            inflight.append(
                (chunk, _engine_pool().submit(_run_chunk, chunk, fut))
            )
        else:
            inflight.append((chunk, fut))

    def _consume():
        chunk, efut = inflight.pop(0)
        if overlap:
            fs_list, native_results = efut.result()
        else:
            fs_list, native_results = _run_chunk(chunk, efut)
        ji = 0
        for header, seq_idx, models, quals, have_qual in chunk:
            if models is None:
                yield header, []
                continue
            if native_results is not None:
                yield header, native_results[ji]
                ji += 1
                continue
            fs = None
            if fs_list is not None:
                fs = fs_list[ji]
            ji += 1
            yield header, _predict_read_with_models(
                models, seq_idx, quals,
                allow_indels=allow_indels, allow_subs=allow_subs,
                have_qual_file=have_qual, frame_scores=fs,
            )

    def _flush(final=False):
        _dispatch()
        # keep one chunk in flight: consume the PREVIOUS chunk while the
        # device computes the one just dispatched (double buffering)
        while len(inflight) > (0 if final else 1):
            yield from _consume()

    for header, seq in iter_sequences:
        prefix = header.split()[0]
        classes = classifications.get(prefix)
        if classes is None or not classes:
            pending.append((header, None, None, None, False))
            if len(pending) >= chunk_size:
                yield from _flush()
            continue
        n = len(seq)

        cache_key = (tuple(classes), n if parsed is None or not parsed.user_length else 0)
        models = model_cache.get(cache_key)
        if models is None:
            # gene ICM
            if user_icm is not None:
                gene_icm = user_icm
            else:
                icm_file = genome_data.classes_icm_file(classes)
                gene_icm = icm_cache.get(icm_file)
                if gene_icm is None:
                    gene_icm = icm_mod.read_icm_cached(icm_file)
                    icm_cache[icm_file] = gene_icm

            # stop codons from top class's translation table
            # (Update_Meta_Stop, skipped when -z/-Z set User_Stop)
            if user_stop_codons is not None:
                stop_codons = user_stop_codons
            else:
                code = genome_data.transl_table(classes[0])
                stop_codons = STOP_CODONS_BY_CODE.get(code, dna.DEFAULT_STOP_CODONS)
            patterns = orf_mod.CodonPatterns.make(None, stop_codons)

            # null ICM GC (Update_Meta_Null_ICM) or user GC
            if user_icm is not None:
                gc = user_gc
            else:
                gc = 0.0
                for c in classes:
                    gc += genome_data.gc(c)
                gc /= np.float32(len(classes))
            indep = icm_mod.build_indep_wo_stops(gc, patterns.stop_codons)

            models = Models(
                gene_icm=gene_icm,
                indep_model=indep,
                patterns=patterns,
                indep_gc_frac=gc,
                min_gene_len=min_gene_len,
                max_olap_bases=max_olap_bases,
                allow_truncated_orfs=not circular,
                circular=circular,
            )
            models.ignore_score_len = set_ignore_score_len(gc, patterns.stop_codons)
            num = np.float32(len(classes))

            # length + prior (Update_Meta_Length)
            if parsed is not None and parsed.user_length:
                models.logodds_prior = parsed.logodds_prior
                models.logodds_length = parsed.logodds_length
            else:
                try:
                    from ..native import get_lib

                    native_lib = get_lib() if _use_native() else None
                except Exception:
                    native_lib = None
                prior = fudge_f32
                mixed_gene = None
                mixed_non = None
                for c in classes:
                    gene_l, non_l, cls_prior = genome_data.lengths(c, min_gene_len)
                    prior = np.float32(prior + cls_prior / num)
                    if mixed_gene is None:
                        mixed_gene = np.full(len(gene_l), -np.inf)
                        mixed_non = np.full(len(non_l), -np.inf)
                    if native_lib is not None:
                        # exact C++ mirror of the log_add loops below
                        g64 = np.ascontiguousarray(gene_l, dtype=np.float64)
                        n64 = np.ascontiguousarray(non_l, dtype=np.float64)
                        native_lib.gmg_log_add_acc(
                            mixed_gene.ctypes.data, g64.ctypes.data, len(g64)
                        )
                        native_lib.gmg_log_add_acc(
                            mixed_non.ctypes.data, n64.ctypes.data, len(n64)
                        )
                        continue
                    for l in range(len(gene_l)):
                        mixed_gene[l] = log_add(mixed_gene[l], gene_l[l])
                    for l in range(len(non_l)):
                        mixed_non[l] = log_add(mixed_non[l], non_l[l])
                mixed_gene -= math.log(float(num))
                mixed_non -= math.log(float(num))
                models.logodds_prior = prior
                models.logodds_length = features_file._length_make_log_odds(
                    mixed_gene, mixed_non, [n // 3], min_gene_len
                )

            # starts (Update_Meta_Start)
            if parsed is not None and parsed.user_start:
                models.logodds_start = parsed.logodds_start
            else:
                sg = np.zeros(3, dtype=np.float32)
                sn = np.zeros(3, dtype=np.float32)
                for c in classes:
                    g, nn = genome_data.starts(c)
                    sg = (sg + g / num).astype(np.float32)
                    sn = (sn + nn / num).astype(np.float32)
                models.logodds_start.make_log_odds(sg, sn)

            # adjacency (Update_Meta_Adj)
            if parsed is not None and parsed.user_adj:
                models.logodds_adj_or = parsed.logodds_adj_or
                models.logodds_adj_dist = parsed.logodds_adj_dist
            else:
                aog = np.zeros(4, dtype=np.float32)
                aon = np.zeros(4, dtype=np.float32)
                mixed_ad: dict = {}
                for c in classes:
                    g, nn = genome_data.adj_orients(c)
                    aog = (aog + g / num).astype(np.float32)
                    aon = (aon + nn / num).astype(np.float32)
                    ad = genome_data.adj_dists(c, max_olap_bases)
                    for key, d in ad.items():
                        if key not in mixed_ad:
                            mixed_ad[key] = np.zeros(len(d), dtype=np.float32)
                        mixed_ad[key] = (mixed_ad[key] + d / num).astype(np.float32)
                models.logodds_adj_or.make_log_odds(aog, aon)
                models.logodds_adj_dist.max_overlap = max_olap_bases
                for key in ("ff", "fr", "rf"):
                    models.logodds_adj_dist.make_log_odds(
                        key, mixed_ad.get((key, "genes")), mixed_ad.get((key, "non"))
                    )

            # RBS mixture (Update_Meta_RBS) or user PWM
            if user_rbs_pwm is not None:
                models.logodds_pwm = user_rbs_pwm.make_log_odds_wrt_gc(gc)
                models.user_rbs = True
                models._meta_pwms = None
            else:
                models._meta_pwms = [genome_data.rbs_pwm(c) for c in classes]

            # content-stable identity for the device-path caches (scoped
            # by the GenomeData instance: same class names over different
            # DBs must not collide)
            models._cache_tag = (
                ("cls", _stable_tag(genome_data, "gd")) + cache_key
            )
            model_cache[cache_key] = models

        quals = None
        have_qual = False
        if qualities is not None:
            quals = qualities.get(prefix)
            have_qual = quals is not None

        pending.append((header, dna.encode(seq), models, quals, have_qual))
        if len(pending) >= chunk_size:
            yield from _flush()
    yield from _flush(final=True)


def _predict_read_with_models(models, seq, quals=None, *, allow_indels=False,
                              allow_subs=False, have_qual_file=False,
                              frame_scores=None, use_meta_pwms=True):
    """predict_read but honoring models._meta_pwms for RBS scoring."""
    seq_idx = dna.encode(seq) if isinstance(seq, (str, bytes)) else seq
    seq_str = dna.decode(seq_idx)
    n = len(seq_idx)
    masks = np.array([1, 2, 4, 8], dtype=np.uint8)[seq_idx]

    if allow_indels:
        if not have_qual_file or quals is None:
            quals = set_quality_454(seq_str)
        else:
            quals = clean_quality_454(seq_str, quals)

    orf_list = orf_mod.find_orfs(
        masks, models.patterns,
        min_gene_len=models.min_gene_len,
        allow_truncated=models.allow_truncated_orfs,
        allow_indel_orfs=allow_indels or allow_subs,
        min_indel_orf_len=MIN_INDEL_ORF_LEN,
        circular=models.circular,
    )
    state = MgSequenceState(models, seq_idx, frame_scores=frame_scores)
    scorer = MgScorer(models, seq_str, seq_idx, state, quals,
                      allow_indels=allow_indels, allow_subs=allow_subs,
                      have_qual_file=have_qual_file)
    engine = ev_mod.EventEngine(models, n)
    meta_pwms = getattr(models, "_meta_pwms", None) if use_meta_pwms else None
    if meta_pwms is not None:
        pwm_scorer = MetaPwmScorer(models, seq_idx, meta_pwms)
    else:
        pwm_scorer = PwmScorer(models, seq_idx)
    score_orfs_errors(models, scorer, orf_list, engine, pwm_scorer)
    engine.process_events()
    final = engine.set_final_event()
    return ev_mod.trace_back(final, n)


def run_glimmer_mg(
    sequences,  # list of (header, seq)
    gene_icm: icm_mod.ICM,
    *,
    qualities: dict | None = None,  # header-prefix -> [int]
    features_path=None,
    rbs_pwm=None,
    gc_frac: float | None = None,
    logodds_fudge: float | None = None,
    min_gene_len: int = 75,
    max_olap_bases: int = 50,
    allow_indels: bool = False,
    allow_subs: bool = False,
    circular: bool = False,
    start_codons=None,
    stop_codons=None,
    device_precompute=None,
):
    """glimmer-mg with a user ICM (-m mode). Yields (header, [TracedGene])."""
    from .glimmer3 import gc_fraction, set_ignore_score_len
    from ..io import features_file

    if allow_indels and allow_subs:
        raise ValueError("cannot use indels and subs simultaneously")

    patterns = orf_mod.CodonPatterns.make(start_codons, stop_codons)
    if gc_frac is None:
        gc_frac = gc_fraction([s for _, s in sequences])
    indep = icm_mod.build_indep_wo_stops(gc_frac, patterns.stop_codons)
    models = Models(
        gene_icm=gene_icm,
        indep_model=indep,
        patterns=patterns,
        indep_gc_frac=gc_frac,
        min_gene_len=min_gene_len,
        max_olap_bases=max_olap_bases,
        allow_truncated_orfs=not circular,
        circular=circular,
    )
    models.logodds_prior = np.float32(-1.0)
    if logodds_fudge is not None:
        models.logodds_prior = np.float32(
            models.logodds_prior + np.float32(logodds_fudge)
        )
    models.ignore_score_len = set_ignore_score_len(gc_frac, patterns.stop_codons)

    if features_path is not None:
        parsed = features_file.parse_features(
            features_path,
            min_gene_len=min_gene_len,
            max_olap_bases=max_olap_bases,
            sequence_aa_lengths=[len(s) // 3 for _, s in sequences],
            logodds_fudge=logodds_fudge,
        )
        if parsed.logodds_prior is not None:
            models.logodds_prior = parsed.logodds_prior
        if parsed.logodds_length is not None:
            models.logodds_length = parsed.logodds_length
        if parsed.logodds_start is not None:
            models.logodds_start = parsed.logodds_start
        if parsed.logodds_adj_or is not None:
            models.logodds_adj_or = parsed.logodds_adj_or
            models.logodds_adj_dist = parsed.logodds_adj_dist

    if rbs_pwm is not None:
        models.logodds_pwm = rbs_pwm.make_log_odds_wrt_gc(gc_frac)
        models.user_rbs = True

    use_device = _use_device_precompute(device_precompute)
    chunk_size = int(os.environ.get("GLIMMER_MG_TPU_CHUNK", "2048"))
    pending: list = []

    def _flush():
        jobs = [(models, s) for _h, s, _q, _hq in pending]
        native_results = None
        fs_list = None
        if _use_device_dp() and jobs:
            native_results = _device_dp_chunk(
                [(s, models, q, hq) for _h, s, q, hq in pending],
                allow_indels, allow_subs,
            )
            if native_results is None:
                DEVICE_DP_COUNTS["chunks_host"] += 1
        if native_results is None:
            fs_list = (
                device_frame_scores(jobs) if (use_device and jobs) else None
            )
        if native_results is None and _use_native() and jobs:
            native_results = _native_predict(
                [(s, models, q, hq) for _h, s, q, hq in pending],
                fs_list, allow_indels, allow_subs,
            )
        for ji, (header, seq_idx, quals, have_qual) in enumerate(pending):
            if native_results is not None:
                yield header, native_results[ji]
                continue
            fs = fs_list[ji] if fs_list is not None else None
            yield header, predict_read(
                models, seq_idx, quals,
                allow_indels=allow_indels, allow_subs=allow_subs,
                have_qual_file=have_qual, frame_scores=fs,
            )
        pending.clear()

    for header, seq in sequences:
        quals = None
        have_qual = False
        if qualities is not None:
            quals = qualities.get(header.split()[0])
            have_qual = quals is not None
        pending.append((header, dna.encode(seq), quals, have_qual))
        if len(pending) >= chunk_size:
            yield from _flush()
    yield from _flush()


def format_predict_mg(results) -> str:
    """glimmer-mg .predict rows with I:/D:/S: error lists (mg.cc:2023)."""
    out = []
    for header, genes in results:
        out.append(f">{header}\n")
        for g in genes:
            ins = sorted(e.pos for e in g.errors if e.type == 0)
            dels = sorted(e.pos for e in g.errors if e.type == 1)
            subs = sorted(e.pos for e in g.errors if e.type == 2)
            out.append(
                "orf%05d %8d %8d %+3d %8.2f I:%s D:%s S:%s\n"
                % (
                    g.id, g.start, g.stop, g.frame, g.score,
                    ",".join(map(str, ins)), ",".join(map(str, dels)),
                    ",".join(map(str, subs)),
                )
            )
    return "".join(out)
