#!/usr/bin/env python3
"""Smoke test of the metagenome main path on one GPU, at full model width.

Drives the three stages users run, through the functions they call, on
seeded data (no reference tree, no network), in one process:

  compile            every jitted step at full width, with
                     ``compiled.memory_analysis()``
  classify           a 256-model depth-7 bank x 4,096 reads through
                     ``PhymmBank.score_reads`` against the host numpy walk
  predict            ``run_glimmer_mg_classes`` device-resident (error-free)
  predict-subs       the same in -S mode
  predict-subs-qual  the same in -S mode with quality files
  predict-f32        the f32 DP carry (GLIMMER_MG_TPU_DEVICE_DP_F32=1)
  scimm              ``scimm_cluster(use_device=True)`` against the host
                     trainer, plus one timed EM step

Tolerances (each phase fails hard when it misses its bound):

  * six-frame walk: table reads are exact, so it is bitwise equal to the
    host walk (tolerance 0);
  * prediction: .predict text (ids, coordinates, frames, error records and
    the printed %8.2f scores) identical to the native engine's, with no
    eligible chunk served by the host; with the f32 DP carry the printed
    scores may differ by 0.01 (f32 sums land on the other side of a
    rounding boundary), every other field stays identical;
  * classification: |gpu - host| <= 1e-5 * |host| per (read, model),
    since f32 sums run in another order than the host's f64 sum; the best
    model agrees wherever the top-two margin exceeds that bound;
  * Scimm: >= 99% of reads get the host trainer's cluster (the device
    trainer selects tree positions from f32 mutual information, so
    near-tie nodes may differ).

None of these paths has a matrix product, so TF32 cannot apply.

``--chips 4`` runs only the multi-card paths and what they are compared
with: classification of the same bank on a (4,1) and a (2,2) mesh, and one
Scimm EM step on a (4,1) mesh, each against the one-card result.

Exits non-zero unless JAX's first device is a GPU. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python3 chip_smoke.py [--chips 1|4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    n_models=256,        # Phymm-scale classification bank
    bank_genes=16,       # genes per seeded bank genome (~15 kb)
    bank_group=64,       # models trained per jitted train_icm_bank call
    classify_reads=4096,
    classify_batch=512,
    host_check_reads=64,
    predict_reads=8192,  # 4 chunks of the default 2,048 reads
    read_len=500,
    scimm_reads=2048,
    scimm_clusters=8,
)

CLASSIFY_RTOL = 1e-5
SCIMM_MIN_AGREE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


class Spy:
    """Record the arguments of the last call to ``module.name``."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = self.kwargs = None

    def __enter__(self):
        def wrapped(*a, **k):
            self.args, self.kwargs = a, k
            return self.orig(*a, **k)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def memory_line(name: str, compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return f"  {name}: memory_analysis unavailable"
    gib = 1 << 30
    return (f"  {name}: args {m.argument_size_in_bytes / gib:.3f} GiB, "
            f"outputs {m.output_size_in_bytes / gib:.3f} GiB, "
            f"temps {m.temp_size_in_bytes / gib:.3f} GiB, "
            f"code {m.generated_code_size_in_bytes / 1e6:.1f} MB")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# set-up: seeded data, the native engine, the bank genomes
# ---------------------------------------------------------------------------


def setup(cfg):
    from glimmer_mg_tpu import bench_db, native
    from glimmer_mg_tpu.io.genome_data import GenomeData

    st = {}
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit("native engine unavailable: no parity baseline")
    st["native_build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    db = os.path.join(HERE, ".cache", "smoke_db")
    classes, genomes = bench_db.build_bench_db(db)
    st["db_build_s"] = time.perf_counter() - t0
    gd = GenomeData(os.path.join(db, "genomeData"))

    t0 = time.perf_counter()
    reads, sources = bench_db.sample_reads(
        genomes, cfg["predict_reads"], cfg["read_len"], seed=3)
    cls_map = bench_db.top2_classes(reads, sources, classes)
    sub_reads, quals = bench_db.add_substitutions(reads, seed=5)
    bank_genomes = bench_db.bank_genomes(cfg["n_models"],
                                         n_genes=cfg["bank_genes"])
    st["data_s"] = time.perf_counter() - t0
    return dict(gd=gd, classes=classes, genomes=genomes, reads=reads,
                sources=sources, cls_map=cls_map, sub_reads=sub_reads,
                quals=quals, bank_genomes=bank_genomes, setup=st)


def train_bank(cfg, ctx):
    from glimmer_mg_tpu import bench_db

    t0 = time.perf_counter()
    mip, probs = bench_db.train_bank(ctx["bank_genomes"],
                                     group=cfg["bank_group"])
    ctx["setup"]["bank_train_s"] = time.perf_counter() - t0
    ctx["bank_names"] = [f"bank{k:03d}|chr" for k in range(len(mip))]
    ctx["mip"], ctx["probs"] = mip, probs
    log(f"  bank: {mip.shape[0]} models, mip {mip.nbytes / 1e6:.1f} MB "
        f"+ probs {probs.nbytes / 1e6:.1f} MB on the host")


def predict_modes(ctx):
    """(phase name, reads, run_glimmer_mg_classes kwargs, environment)."""
    return [
        ("predict", ctx["reads"], {}, {}),
        ("predict-subs", ctx["sub_reads"], dict(allow_subs=True), {}),
        ("predict-subs-qual", ctx["sub_reads"],
         dict(allow_subs=True, qualities=ctx["quals"]), {}),
        ("predict-f32", ctx["reads"], {},
         {"GLIMMER_MG_TPU_DEVICE_DP_F32": "1"}),
    ]


# ---------------------------------------------------------------------------
# phase 1: compile every jitted step at full width
# ---------------------------------------------------------------------------


def phase_compile(cfg, ctx):
    from glimmer_mg_tpu import bench_db
    from glimmer_mg_tpu.engine import glimmer_mg as mg
    from glimmer_mg_tpu.ops import device_predict as dpk, icm_score
    from glimmer_mg_tpu.ops import icm_train_device
    from glimmer_mg_tpu.parallel import classify as pclassify

    times = {}
    # bank trainer (also the Scimm EM trainer)
    reads, lengths, assign = next(bench_db.bank_batches(
        ctx["bank_genomes"], group=cfg["bank_group"]))
    t0 = time.perf_counter()
    c = icm_train_device.train_icm_bank.lower(
        reads, lengths, assign, n_models=cfg["bank_group"]).compile()
    times["train_icm_bank"] = time.perf_counter() - t0
    log(memory_line("train_icm_bank", c))
    train_bank(cfg, ctx)

    # classification step at the bank's full width
    rd, ln = pclassify.pad_reads(
        [s for _h, s in ctx["reads"][: cfg["classify_batch"]]],
        length=cfg["read_len"])
    t0 = time.perf_counter()
    c = pclassify.classify_step.lower(ctx["mip"], ctx["probs"], rd, ln,
                                      12, 7).compile()
    times["classify_step"] = time.perf_counter() - t0
    log(memory_line("classify_step", c))

    # device-resident prediction: one chunk per mode compiles the six-frame
    # walk and each DP variant; the spies catch their full-width arguments
    chunk = int(os.environ.get("GLIMMER_MG_TPU_CHUNK", "2048"))
    for name, rds, kw, env in predict_modes(ctx):
        os.environ.update(env)
        try:
            with Spy(icm_score, "mg_six_frame_batch") as s6, \
                    Spy(dpk, "predict_batch_device") as sp:
                t0 = time.perf_counter()
                list(mg.run_glimmer_mg_classes(
                    rds[:chunk], ctx["gd"], ctx["cls_map"], **kw))
                times[f"{name} first chunk"] = time.perf_counter() - t0
            if name == "predict":
                c = icm_score.mg_six_frame_batch.lower(
                    *s6.args, **s6.kwargs).compile()
                log(memory_line("mg_six_frame_batch", c))
                ctx["six_args"] = (s6.args, s6.kwargs)
            c = dpk.predict_batch_device(*sp.args, **sp.kwargs,
                                         lower=True).compile()
            log(memory_line(f"device DP ({name})", c))
        finally:
            for k in env:
                os.environ.pop(k, None)
    for k, v in times.items():
        log(f"  compile {k}: {v:.1f} s")
    ctx["compile_s"] = times


# ---------------------------------------------------------------------------
# phase 2: classification
# ---------------------------------------------------------------------------


def host_bank_scores(mip, probs, seqs):
    """fwd/rev-max f64 scores from the host numpy walk (models.icm)."""
    import numpy as np

    from glimmer_mg_tpu.models import dna, icm as icm_mod

    icms = [icm_mod.ICM(12, 7, 3, mip[m], probs[m])
            for m in range(mip.shape[0])]
    out = np.zeros((len(seqs), len(icms)))
    for r, s in enumerate(seqs):
        enc = dna.encode(s)
        rc = dna.COMPLEMENT_INDEX[enc][::-1]
        for m, icm in enumerate(icms):
            fwd = icm_mod.per_base_logprob_vec(icm, enc, 0)
            rev = icm_mod.per_base_logprob_vec(icm, rc, 0)
            out[r, m] = max(fwd.astype(np.float64).sum(),
                            rev.astype(np.float64).sum())
    return out


def phase_classify(cfg, ctx):
    import numpy as np

    from glimmer_mg_tpu import bench_db
    from glimmer_mg_tpu.parallel import phymm

    genomes = dict(zip(ctx["bank_names"], ctx["bank_genomes"]))
    reads, sources = bench_db.sample_reads(
        genomes, cfg["classify_reads"], cfg["read_len"], seed=17)
    seqs = [s.lower() for _h, s in reads]
    bank = phymm.PhymmBank(ctx["bank_names"], ctx["mip"], ctx["probs"],
                           12, 7)
    bank.score_reads(seqs[: cfg["classify_batch"]],
                     batch=cfg["classify_batch"])  # warm
    t0 = time.perf_counter()
    scores = bank.score_reads(seqs, batch=cfg["classify_batch"])
    dt = time.perf_counter() - t0
    model_mbp = sum(len(s) for s in seqs) * len(ctx["bank_names"]) * 2 / 1e6
    log(f"  {len(seqs)} reads x {len(ctx['bank_names'])} models in "
        f"{dt:.3f} s: {model_mbp / dt:.1f} model*Mbp/s (fwd+rev), "
        f"{len(seqs) / dt:.1f} reads/s")

    n = cfg["host_check_reads"]
    t0 = time.perf_counter()
    want = host_bank_scores(ctx["mip"], ctx["probs"], seqs[:n])
    got = scores[:n].astype(np.float64)
    rel = np.abs(got - want) / np.abs(want)
    log(f"  host walk check ({n} reads x all models, "
        f"{time.perf_counter() - t0:.1f} s): max rel diff {rel.max():.3e}")
    if not (rel <= CLASSIFY_RTOL).all():
        raise AssertionError(f"classification off by {rel.max():.3e}")
    top2 = np.sort(want, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * CLASSIFY_RTOL * np.abs(top2[:, 1])
    same = np.argmax(got, 1) == np.argmax(want, 1)
    if not same[decided].all():
        raise AssertionError("best model differs where the margin decides")
    truth = np.array([ctx["bank_names"].index(s) for s in sources])
    log(f"  best model agrees on {int(decided.sum())}/{n} decided reads; "
        f"source genome is the best model for "
        f"{(np.argmax(scores, 1) == truth).mean():.4f} of all reads")
    ctx["classify_scores"] = scores
    ctx["classify_seqs"] = seqs
    return {"model_mbp_per_s": model_mbp / dt, "seconds": dt}


# ---------------------------------------------------------------------------
# phases 3-6: device-resident prediction against the native engine
# ---------------------------------------------------------------------------


def six_frame_check(ctx):
    """Bitwise: the device six-frame walk of the first captured chunk vs
    the host numpy walk, on 64 reads."""
    import jax
    import numpy as np

    from glimmer_mg_tpu.models import dna, icm as icm_mod
    from glimmer_mg_tpu.ops import icm_score

    args, kw = ctx["six_args"]
    gmip, gprobs, imip, iprobs, reads, lens, grp = args
    gene, ind = jax.device_get(icm_score.mg_six_frame_batch(*args, **kw))
    reads, lens, grp = map(np.asarray, (reads, lens, grp))
    n_checked = 0
    for r in range(min(64, int((lens > 0).sum()))):
        n = int(lens[r])
        g = grp[r]
        gicm = icm_mod.ICM(12, 7, 3, np.asarray(gmip[g]), np.asarray(gprobs[g]))
        iicm = icm_mod.ICM(3, 2, 3, np.asarray(imip[g]), np.asarray(iprobs[g]))
        seq = reads[r, :n]
        for row, s in enumerate((seq[::-1], dna.COMPLEMENT_INDEX[seq])):
            for f in range(3):
                for model, out in ((gicm, gene), (iicm, ind)):
                    want = icm_mod.per_base_logprob_vec(model, s, f,
                                                        cycle=False)
                    if not np.array_equal(out[r, 3 * row + f, :n], want):
                        raise AssertionError(f"six-frame walk differs: read "
                                             f"{r} row {3 * row + f}")
        n_checked += 1
    log(f"  six-frame walk bitwise equal to the host walk on {n_checked} "
        f"reads x 6 frames x (gene, null)")

    def run():
        out = icm_score.mg_six_frame_batch(*args, **kw)
        jax.block_until_ready(out)

    run()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[2]


def compare_predict(a: str, b: str, score_tol: float, name: str) -> int:
    """Every field of two .predict texts equal, except printed scores,
    which may differ by ``score_tol``. Returns how many scores differ."""
    la, lb = a.splitlines(), b.splitlines()
    n_diff = 0
    for x, y in zip(la, lb):
        fx, fy = x.split(), y.split()
        if x.startswith(">") or y.startswith(">"):
            same = x == y
        else:
            same = (len(fx) == len(fy) == 8
                    and fx[:4] + fx[5:] == fy[:4] + fy[5:]
                    and abs(float(fx[4]) - float(fy[4])) <= score_tol + 1e-9)
        if not same:
            log(f"  first difference:\n    device {x}\n    native {y}")
            raise AssertionError(f"{name}: .predict differs from the native "
                                 f"engine")
        n_diff += x != y
    if len(la) != len(lb):
        raise AssertionError(f"{name}: .predict line counts differ")
    return n_diff


def phase_predict(cfg, ctx, name, reads, kw, env):
    from glimmer_mg_tpu.engine import glimmer_mg as mg

    f32 = env.get("GLIMMER_MG_TPU_DEVICE_DP_F32") == "1"

    def run(device: bool):
        os.environ["GLIMMER_MG_TPU_DEVICE_DP"] = "1" if device else "0"
        t0 = time.perf_counter()
        res = list(mg.run_glimmer_mg_classes(reads, ctx["gd"], ctx["cls_map"],
                                             **kw))
        return res, time.perf_counter() - t0

    def timed(device: bool):
        """First run (kept, with its route counts), then the median of 3."""
        mg.DEVICE_DP_COUNTS.clear()
        first = run(device)[0]
        counts = dict(mg.DEVICE_DP_COUNTS)
        ts = sorted(run(device)[1] for _ in range(3))
        if mg.DEVICE_DP_COUNTS.get("chunks_host", 0):
            raise AssertionError("a timed run refused a chunk to the host")
        return first, ts[1], ts, counts

    os.environ.update(env)
    try:
        dev, t_dev, ts_dev, counts = timed(True)
        nat, t_nat, ts_nat, _ = timed(False)
    finally:
        os.environ.pop("GLIMMER_MG_TPU_DEVICE_DP", None)
        for k in env:
            os.environ.pop(k, None)
    n = len(reads)
    log(f"  device-resident: {n} reads, median of 3 warm runs {t_dev:.4f} s "
        f"= {n / t_dev:.1f} reads/s (runs {[round(t, 4) for t in ts_dev]}); "
        f"per run: chunks {counts.get('chunks_device', 0)} on device, "
        f"{counts.get('chunks_host', 0)} refused to the host, "
        f"{counts.get('reads_overflow', 0)} reads overflowed to the host")
    log(f"  native engine (host, {os.cpu_count()} cores): median {t_nat:.4f} s "
        f"= {n / t_nat:.1f} reads/s (runs {[round(t, 4) for t in ts_nat]})")
    if counts.get("chunks_host", 0) or counts.get("reads_device", 0) != n:
        raise AssertionError(f"eligible reads served by the host: {counts}")
    score_tol = 0.01 if f32 else 0.0
    n_score_diff = compare_predict(mg.format_predict_mg(dev),
                                   mg.format_predict_mg(nat), score_tol, name)
    n_genes = sum(len(g) for _h, g in dev)
    n_err = sum(1 for _h, gs in dev for g in gs if g.errors)
    log(f"  .predict matches the native engine: {n_genes} genes, {n_err} "
        f"with error records; {n_score_diff} printed scores differ "
        f"(tolerance {score_tol})")
    chunks = max(1, counts.get("chunks_device", 1))
    return {"reads_per_s": n / t_dev, "native_reads_per_s": n / t_nat,
            "chunk_s": t_dev / chunks,
            "overflow_reads": counts.get("reads_overflow", 0)}


# ---------------------------------------------------------------------------
# phase 7: Scimm EM
# ---------------------------------------------------------------------------


def phase_scimm(cfg, ctx):
    import jax
    import numpy as np

    from glimmer_mg_tpu.parallel import classify as pclassify
    from glimmer_mg_tpu.pipeline import scimm

    n = cfg["scimm_reads"]
    k = cfg["scimm_clusters"]
    seqs = [s for _h, s in ctx["reads"][:n]]
    pos = {c: i for i, c in enumerate(ctx["classes"])}
    init = np.array([pos[c] for c in ctx["sources"][:n]], np.int32) % k
    init[::3] = (init[::3] + 1) % k  # scramble a third of the seeds
    t0 = time.perf_counter()
    a_dev, _icms, _s = scimm.scimm_cluster(seqs, init, k, max_iters=2,
                                           use_device=True)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_host, _icms, _s = scimm.scimm_cluster(seqs, init, k, max_iters=2,
                                            use_device=False)
    t_host = time.perf_counter() - t0
    agree = float((a_dev == a_host).mean())
    log(f"  2 EM iterations: device {t_dev:.2f} s, host trainer "
        f"{t_host:.2f} s; assignments agree on {agree:.4f} of {n} reads")
    if agree < SCIMM_MIN_AGREE:
        raise AssertionError(f"Scimm device EM agrees on only {agree:.4f}")

    # one full EM step (classify -> assign -> retrain), timed warm
    length = cfg["read_len"]
    reads, lengths = pclassify.pad_reads([s.lower() for s in seqs],
                                         length=length)
    mip, probs = ctx["mip"][:k], ctx["probs"][:k]

    def step():
        out = pclassify.em_step(mip, probs, reads, lengths, n_models=k)
        jax.block_until_ready(out)
        return out

    t0 = time.perf_counter()
    step()
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        ts.append(time.perf_counter() - t0)
    log(f"  em_step ({n} reads x {k} clusters): first call {t_first:.2f} s, "
        f"warm median {sorted(ts)[1]:.4f} s")
    return {"em_step_s": sorted(ts)[1], "agree": agree}


# ---------------------------------------------------------------------------
# four cards: sharded classification and one sharded Scimm EM step
# ---------------------------------------------------------------------------


def run_four(cfg, ctx):
    import jax
    import numpy as np

    from glimmer_mg_tpu import bench_db
    from glimmer_mg_tpu.parallel import classify as pclassify, mesh as pmesh
    from glimmer_mg_tpu.parallel import phymm

    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"--chips 4 needs 4 devices, found {len(devs)}")
    train_bank(cfg, ctx)
    genomes = dict(zip(ctx["bank_names"], ctx["bank_genomes"]))
    reads, _src = bench_db.sample_reads(genomes, cfg["classify_reads"],
                                        cfg["read_len"], seed=17)
    seqs = [s.lower() for _h, s in reads]
    bank = phymm.PhymmBank(ctx["bank_names"], ctx["mip"], ctx["probs"], 12, 7)
    batch = cfg["classify_batch"]
    ref = bank.score_reads(seqs, batch=batch)
    t0 = time.perf_counter()
    bank.score_reads(seqs, batch=batch)
    log(f"  classify on 1 card: {time.perf_counter() - t0:.3f} s")
    for shape in ((4, 1), (2, 2)):
        mesh = pmesh.make_mesh(*shape)
        bank.score_reads(seqs[:batch], batch=batch, mesh=mesh)  # warm
        t0 = time.perf_counter()
        got = bank.score_reads(seqs, batch=batch, mesh=mesh)
        dt = time.perf_counter() - t0
        rel = np.abs(got.astype(np.float64) - ref) / np.abs(ref)
        model_mbp = sum(len(s) for s in seqs) * len(bank.paths) * 2 / 1e6
        log(f"  classify mesh {shape}: {dt:.3f} s = "
            f"{model_mbp / dt:.1f} model*Mbp/s; max rel diff vs 1 card "
            f"{rel.max():.3e}; best model equal: "
            f"{bool((np.argmax(got, 1) == np.argmax(ref, 1)).all())}")
        if not (rel <= CLASSIFY_RTOL).all():
            raise AssertionError(f"mesh {shape} classification differs")

    # one Scimm EM step on a (4, 1) mesh vs one card
    k = cfg["scimm_clusters"]
    n = cfg["scimm_reads"]
    rd, ln = pclassify.pad_reads(seqs[:n], length=cfg["read_len"])
    mip, probs = ctx["mip"][:k], ctx["probs"][:k]
    one = jax.device_get(pclassify.em_step(mip, probs, rd, ln, n_models=k))
    mesh = pmesh.make_mesh(4, 1)
    rd_s, ln_s = pmesh.shard_reads(mesh, rd, ln)
    out = pclassify.em_step(mip, probs, rd_s, ln_s, n_models=k)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = pclassify.em_step(mip, probs, rd_s, ln_s, n_models=k)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    used = sorted({d.id for a in out for d in a.sharding.device_set})
    four = jax.device_get(out)
    same = [np.array_equal(x, y) for x, y in zip(one[:3], four[:3])]
    srel = np.abs(four[3] - one[3]).max() / np.abs(one[3]).max()
    log(f"  em_step mesh (4, 1): {dt:.4f} s; devices holding outputs {used}; "
        f"new mip / probs / assignment equal to 1 card: {same}; "
        f"max rel score diff {srel:.3e}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    log(f"  peak bytes in use per device: {peaks}")
    if not all(same) or srel > CLASSIFY_RTOL or len(used) != 4:
        raise AssertionError("sharded EM step differs from one card")
    if devs[0].platform == "gpu" and min(peaks) == 0:
        raise AssertionError("a device held no memory: work did not spread")


# ---------------------------------------------------------------------------


def run_one(cfg, ctx):
    phase("compile", phase_compile, cfg, ctx)
    res = {}
    res["classify"] = phase("classify", phase_classify, cfg, ctx)
    sixframe_s = six_frame_check(ctx)
    for name, reads, kw, env in predict_modes(ctx):
        res[name] = phase(name, phase_predict, cfg, ctx, name, reads, kw, env)
    log(f"  six-frame walk: {sixframe_s * 1e3:.2f} ms per chunk "
        f"= {sixframe_s / res['predict']['chunk_s']:.3f} of a device-resident "
        f"chunk ({res['predict']['chunk_s'] * 1e3:.1f} ms)")
    res["scimm"] = phase("scimm", phase_scimm, cfg, ctx)
    return res


def phase(name, fn, *args):
    log(f"[{name}]")
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        from glimmer_mg_tpu.utils.compile_cache import setup_compile_cache
    except ImportError:
        print("chip_smoke: the glimmer_mg_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    cache = setup_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {devs[0].platform} {devs[0].device_kind} "
        f"x {len(devs)}; compile cache {cache}")

    cfg = dict(FULL)
    t0 = time.perf_counter()
    ctx = setup(cfg)
    for k, v in ctx["setup"].items():
        log(f"  setup {k}: {v:.1f} s")
    log(f"[setup] ok in {time.perf_counter() - t0:.1f} s")
    if args.chips == 4:
        phase("four-cards", run_four, cfg, ctx)
    else:
        run_one(cfg, ctx)
        log(f"  setup bank_train_s: {ctx['setup']['bank_train_s']:.1f} s")
        stats = devs[0].memory_stats() or {}
        log(f"  peak device memory in use: "
            f"{stats.get('peak_bytes_in_use', 0) / (1 << 30):.2f} GiB")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
