"""Chip-resident prediction path (ops.device_predict) parity tests.

The on-device ORF scan + event DP (SURVEY §7.4/§7.5) must produce
coordinate-identical gene calls to the exact host engine in error-free
mode. Scores are f64 with different summation groupings (whole-read
prefix-sum differences vs fresh per-ORF cumsums) and XLA transcendentals,
so they can differ in the last ulps — the tests also assert the PRINTED
(%8.2f) scores agree, which bounds the practical effect.
"""

import os

import numpy as np
import pytest

from glimmer_mg_tpu.engine import glimmer_mg as mg
from glimmer_mg_tpu.engine import orfs as orf_mod
from glimmer_mg_tpu.engine.glimmer3 import Models
from glimmer_mg_tpu.models import dna, icm as icm_mod, icm_train


def _coords(genes):
    return [(g.id, g.start, g.stop, g.frame) for g in genes]


def _rows(genes):
    return [
        "%05d %d %d %+d %8.2f" % (g.id, g.start, g.stop, g.frame, g.score)
        for g in genes
    ]


@pytest.fixture(scope="module")
def trained_models():
    """Two realistic Models bundles (trained gene ICMs, meta PWMs,
    features) with distinct GC, like classes-mode parameterization."""
    from glimmer_mg_tpu.io.genome_data import GenomeData
    from glimmer_mg_tpu.pipeline import train_all

    import tempfile

    rng = np.random.default_rng(5)
    root = tempfile.mkdtemp(prefix="devdp_db_")
    genomes = {}
    for gi, gc in ((0, 0.38), (1, 0.58)):
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

        def gene(ncod):
            cs = []
            while len(cs) < ncod:
                c = "".join(rng.choice(list("ACGT"), 3, p=p))
                if c not in ("TAA", "TAG", "TGA"):
                    cs.append(c)
            return "ATG" + "".join(cs) + rng.choice(["TAA", "TAG", "TGA"])

        parts = []
        for _ in range(60):
            parts.append(
                "".join(rng.choice(list("ACGT"), int(rng.integers(40, 200)), p=p))
            )
            g = gene(int(rng.integers(80, 300)))
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
            parts.append(g)
        genomes[f"s{gi}|chr"] = "".join(parts)
    train_all.train_all(genomes, os.path.join(root, "genomeData"))
    gd = GenomeData(os.path.join(root, "genomeData"))
    return gd, list(genomes), genomes


def _seeded_reads(genomes, n, seed, read_len=500):
    """Seeded reads sampled from the fixture's own genomes (both strands,
    arbitrary offsets relative to genes)."""
    from glimmer_mg_tpu import bench_db

    reads, _src = bench_db.sample_reads(genomes, n, read_len=read_len,
                                        seed=seed)
    return reads


def _fragments(genome, n, seed, max_subs=4, stops=2):
    """Seeded 200-700 bp fragments of one genome with 0..max_subs-1
    sprinkled substitutions and ``stops`` stop codons written over random
    positions (in-frame inside a gene a third of the time), so that -S
    mode has stops to read through."""
    genome = genome.lower()
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        rl = int(rng.integers(200, 700))
        st = int(rng.integers(0, len(genome) - rl))
        s = list(genome[st:st + rl])
        for _ in range(int(rng.integers(0, max_subs))):
            p = int(rng.integers(0, rl))
            s[p] = "acgt"[int(rng.integers(0, 4))]
        for _ in range(stops):
            p = int(rng.integers(0, rl - 3))
            s[p:p + 3] = ("taa", "tag", "tga")[int(rng.integers(0, 3))]
        reads.append((f"r{i}", "".join(s)))
    return reads


def _run_both(reads, gd, cls_map, monkeypatch):
    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    host = list(mg.run_glimmer_mg_classes(reads, gd, cls_map,
                                          device_precompute=False))
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
    dev = list(mg.run_glimmer_mg_classes(reads, gd, cls_map,
                                         device_precompute=False))
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    return host, dev


def test_sample_reads_parity(trained_models, monkeypatch):
    """Coordinate parity on seeded reads of the fixture genomes (classes
    mode)."""
    gd, classes, genomes = trained_models
    recs = _seeded_reads(genomes, 250, seed=1)
    cls_map = {
        h.split()[0]: [classes[i % 2], classes[(i + 1) % 2]]
        for i, (h, _s) in enumerate(recs)
    }
    host, dev = _run_both(recs, gd, cls_map, monkeypatch)
    assert [h for h, _ in host] == [h for h, _ in dev]
    n_genes = 0
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h
        assert _rows(hg) == _rows(dg), h  # printed scores agree too
        n_genes += len(hg)
    assert n_genes > 50  # the comparison actually exercised genes


def test_fuzz_random_reads(trained_models, monkeypatch):
    """Random reads of varied lengths, including degenerate tiny ones."""
    gd, classes, genomes = trained_models
    rng = np.random.default_rng(17)
    reads = []
    cls_map = {}
    for i in range(120):
        n = int(rng.integers(30, 700))
        gc = float(rng.uniform(0.3, 0.7))
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        seq = "".join(rng.choice(list("acgt"), n, p=p))
        rid = f"fz{i}"
        reads.append((rid, seq))
        cls_map[rid] = [classes[int(rng.integers(0, 2))]]
    host, dev = _run_both(reads, gd, cls_map, monkeypatch)
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h


def test_user_icm_mode_parity(trained_models, monkeypatch):
    """run_glimmer_mg (-m user ICM, no classes) through the device path."""
    gd, classes, genomes = trained_models
    icm_file = gd.classes_icm_file([classes[0]])
    gicm = icm_mod.read_icm_cached(icm_file)
    recs = _seeded_reads(genomes, 80, seed=2)

    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    host = list(mg.run_glimmer_mg(recs, gicm, device_precompute=False))
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
    dev = list(mg.run_glimmer_mg(recs, gicm, device_precompute=False))
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h


def test_subs_mode_device_parity_classes(trained_models, monkeypatch):
    """Substitution mode (-S) runs ON DEVICE since r5: classes-mode
    coordinate + error-record parity vs the host engine. Indel mode still
    falls back (checked below)."""
    gd, classes, genomes = trained_models
    recs = _seeded_reads({classes[0]: genomes[classes[0]]}, 25, seed=3)
    cls_map = {h.split()[0]: [classes[0]] for h, _s in recs}

    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    host = list(mg.run_glimmer_mg_classes(
        recs, gd, cls_map, allow_subs=True, device_precompute=False))
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
    dev = list(mg.run_glimmer_mg_classes(
        recs, gd, cls_map, allow_subs=True, device_precompute=False))
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h
        assert [tuple((e.pos, e.type) for e in g.errors) for g in hg] == \
               [tuple((e.pos, e.type) for e in g.errors) for g in dg]

    # indel mode remains a host fallback with identical output
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    host_i = list(mg.run_glimmer_mg_classes(
        recs[:8], gd, cls_map, allow_indels=True, device_precompute=False))
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
    dev_i = list(mg.run_glimmer_mg_classes(
        recs[:8], gd, cls_map, allow_indels=True, device_precompute=False))
    for (h, hg), (_d, dg) in zip(host_i, dev_i):
        assert _coords(hg) == _coords(dg), h


def test_subs_mode_device_parity_fuzz(trained_models, monkeypatch):
    """Error-dense fuzz for the device substitution machinery: fragments
    of a self-trained genome with sprinkled substitutions and stops,
    classes mode; coordinates, error records, and ORF ids must all match
    the host engine."""
    gd, classes, genomes = trained_models
    reads = _fragments(genomes[classes[0]], 80, seed=9)
    cls_map = {h: [classes[0]] for h, _s in reads}

    def run(dev):
        monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
        if dev:
            monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
        else:
            monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "0")
        return [
            (h, [(g.id, g.start, g.stop, g.frame,
                  tuple((e.pos, e.type) for e in g.errors)) for g in gs])
            for h, gs in mg.run_glimmer_mg_classes(
                reads, gd, cls_map, allow_subs=True,
                device_precompute=False)]

    host = run(False)
    dev = run(True)
    n_err = sum(1 for _h, gs in host for g in gs if g[4])
    assert host == dev
    assert n_err >= 5  # the corpus really exercised sub-extended genes


def test_subs_mode_quality_file_device_parity(trained_models, monkeypatch):
    """Quality-file subs mode runs ON DEVICE: Pass_Stop_Penalty switches
    to the per-position quality form (glimmer-mg.cc:961) built from
    uploaded uint8 qualities. A mixed bank (reads with and without a
    quality file) must match the host engine on coordinates, ids, AND
    error records."""
    gd, classes, genomes = trained_models
    reads = _fragments(genomes[classes[0]], 60, seed=31)
    cls_map = {h: [classes[0]] for h, _s in reads}
    rng = np.random.default_rng(31)
    qualities = {}
    for i, (rid, s) in enumerate(reads):
        if i % 3 != 2:  # two thirds carry a quality file entry
            # full plausible phred span incl. extremes (q=1 -> p=0.2,
            # q~87 -> p within an ulp of 1.0)
            qualities[rid] = [int(q) for q in rng.integers(1, 88, len(s))]

    def run(dev):
        monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
        monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1" if dev else "0")
        return [
            (h, [(g.id, g.start, g.stop, g.frame,
                  tuple((e.pos, e.type) for e in g.errors)) for g in gs])
            for h, gs in mg.run_glimmer_mg_classes(
                reads, gd, cls_map, allow_subs=True, qualities=qualities,
                device_precompute=False)]

    host = run(False)
    dev = run(True)
    n_err = sum(1 for _h, gs in host for g in gs if g[4])
    assert host == dev
    assert n_err >= 3  # quality penalties really produced sub genes


def test_quality_file_error_free_stays_on_device(trained_models,
                                                 monkeypatch):
    """Error-free mode never reads quality values (their only consumers
    are the indel branch and Pass_Stop_Penalty), so a quality file must
    not knock reads off the device path — and the output must equal the
    no-quality run."""
    gd, classes, genomes = trained_models
    recs = _seeded_reads(genomes, 40, seed=4)
    rng = np.random.default_rng(41)
    cls_map = {h.split()[0]: [classes[i % 2]]
               for i, (h, _s) in enumerate(recs)}
    qualities = {
        h.split()[0]: [int(q) for q in rng.integers(1, 60, len(s))]
        for h, s in recs
    }

    monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", "0")
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "0")
    host = list(mg.run_glimmer_mg_classes(recs, gd, cls_map,
                                          device_precompute=False))

    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")

    def boom(*_a, **_k):  # any host fallback fails the test
        raise AssertionError("read fell back to the host engine")

    monkeypatch.setattr(mg, "predict_read", boom)
    monkeypatch.setattr(mg, "_predict_read_with_models", boom)
    dev = list(mg.run_glimmer_mg_classes(recs, gd, cls_map,
                                         qualities=qualities,
                                         device_precompute=False))
    assert [h for h, _ in host] == [h for h, _ in dev]
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h


def test_f32_dp_parity(trained_models, monkeypatch):
    """The f32 score-carry mode must also be coordinate-identical to the
    host engine on seeded + fuzz reads."""
    gd, classes, genomes = trained_models
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP_F32", "1")
    rng = np.random.default_rng(23)
    reads = _seeded_reads(genomes, 120, seed=5)
    for i in range(60):
        n = int(rng.integers(60, 600))
        reads.append((f"fz{i}", "".join(rng.choice(list("acgt"), n))))
    cls_map = {
        h.split()[0]: [classes[i % 2]] for i, (h, _s) in enumerate(reads)
    }
    host, dev = _run_both(reads, gd, cls_map, monkeypatch)
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP_F32", raising=False)
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h


def test_event_overflow_falls_back(trained_models, monkeypatch):
    """Reads whose event count exceeds the device tensor capacity must be
    detected per read and served by the host engine with identical
    output. Forced by shrinking MAX_EVENTS."""
    from glimmer_mg_tpu.ops import device_predict as dpk

    gd, classes, genomes = trained_models
    recs = _seeded_reads(genomes, 40, seed=6)
    cls_map = {h.split()[0]: [classes[i % 2]]
               for i, (h, _s) in enumerate(recs)}
    monkeypatch.setattr(dpk, "MAX_EVENTS", 12)
    dpk._JIT_CACHE.clear()
    try:
        host, dev = _run_both(recs, gd, cls_map, monkeypatch)
    finally:
        dpk._JIT_CACHE.clear()
    n_genes = 0
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h
        n_genes += len(hg)
    assert n_genes > 0  # overflow reads really produced genes via fallback


def test_default_engages_without_native(monkeypatch):
    """The default route follows the backend alone: device-resident on a
    GPU backend, the host engines on a CPU backend, with or without the
    native engine."""
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    import glimmer_mg_tpu.native as native_mod
    import jax

    for native_ok in (False, True):
        monkeypatch.setattr(native_mod, "available", lambda: native_ok)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert mg._use_device_dp()
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert not mg._use_device_dp()


def test_engine_autoselect_economics(monkeypatch):
    """No throughput constants: core and device counts do not move the
    choice, GLIMMER_MG_TPU_DEVICE_DP=0/1 forces either route, and a
    backend that fails to initialise raises instead of passing for a
    machine without an accelerator."""
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    assert mg._use_device_dp()  # 1 card vs 64 cores: still the card
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "0")
    assert not mg._use_device_dp()
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1")
    assert mg._use_device_dp()  # env override wins regardless
    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP")

    def broken():
        raise RuntimeError("backend failed to initialise")

    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError):
        mg._use_device_dp()


def _subs_quality_runs(reads, gd, cls_map, qualities, monkeypatch):
    """-S with quality files (classes mode) through the Python host
    engine, the native engine, and the device path; returns the three
    result lists."""
    out = []
    for native, dev in (("0", "0"), ("1", "0"), ("0", "1")):
        monkeypatch.setenv("GLIMMER_MG_TPU_NATIVE", native)
        monkeypatch.setenv("GLIMMER_MG_TPU_DEVICE_DP", dev)
        out.append([
            (h, [(g.id, g.start, g.stop, g.frame, "%8.2f" % g.score,
                  tuple((e.pos, e.type) for e in g.errors)) for g in gs])
            for h, gs in mg.run_glimmer_mg_classes(
                reads, gd, cls_map, allow_subs=True, qualities=qualities,
                device_precompute=False)])
    return out


def test_negative_quality_floors_at_zero(trained_models, monkeypatch):
    """Negative (Solexa-scale) qualities floor at 0 on every engine: the
    device upload no longer wraps them through uint8 into a high
    quality, so device, native and Python engines agree."""
    gd, classes, genomes = trained_models
    reads = _fragments(genomes[classes[0]], 30, seed=61)
    cls_map = {h: [classes[0]] for h, _s in reads}
    rng = np.random.default_rng(61)
    qualities = {rid: [int(q) for q in rng.integers(-5, 40, len(s))]
                 for rid, s in reads}
    py, nat, dev = _subs_quality_runs(reads, gd, cls_map, qualities,
                                      monkeypatch)
    assert py == nat == dev
    floored = {rid: [max(q, 0) for q in qv] for rid, qv in qualities.items()}
    assert _subs_quality_runs(reads, gd, cls_map, floored,
                              monkeypatch)[2] == dev


def test_quality_zero_penalty_is_finite(trained_models, monkeypatch):
    """q=0 makes the stop-pass probability 0; the host engines clamp it
    like the device path (finite penalty) instead of raising log(0)."""
    import math

    gd, classes, genomes = trained_models
    assert math.isfinite(mg.pass_stop_penalty(
        None, "taataa", [0] * 6, 1, 4, 6))
    reads = _fragments(genomes[classes[0]], 30, seed=62)
    cls_map = {h: [classes[0]] for h, _s in reads}
    rng = np.random.default_rng(62)
    qualities = {}
    for rid, s in reads:
        q = rng.integers(5, 40, len(s))
        q[rng.random(len(s)) < 0.2] = 0
        qualities[rid] = [int(v) for v in q]
    py, nat, dev = _subs_quality_runs(reads, gd, cls_map, qualities,
                                      monkeypatch)
    assert py == nat == dev
    assert sum(1 for _h, gs in py for g in gs if g[5]) > 0


def test_long_reads_parity(trained_models, monkeypatch):
    """Reads past the old packed-sort-key bound (~1.4 kb): the event order
    must stay pos-then-family for any padded length (r4 advisor high —
    pos*8192+rank overflowed its bucket above Lp~1360). Gene-dense long
    reads device vs host."""
    gd, classes, genomes = trained_models
    rng = np.random.default_rng(53)
    reads = []
    cls_map = {}

    def gene_like(ncod, gc):
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        cs = []
        while len(cs) < ncod:
            c = "".join(rng.choice(list("acgt"), 3, p=p))
            if c not in ("taa", "tag", "tga"):
                cs.append(c)
        return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))

    for i in range(10):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        target = int(rng.integers(1450, 2100))
        while total < target:
            parts.append("".join(
                rng.choice(list("acgt"), int(rng.integers(20, 80)))))
            g = gene_like(int(rng.integers(40, 150)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            parts.append(g)
            total = sum(len(x) for x in parts)
        rid = f"lr{i}"
        reads.append((rid, "".join(parts)[:target]))
        cls_map[rid] = [classes[i % 2]]
    host, dev = _run_both(reads, gd, cls_map, monkeypatch)
    n_genes = 0
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h
        n_genes += len(hg)
    assert n_genes > 5  # long reads really produced genes (9 measured)


def test_fuzz_overlap_dense(trained_models, monkeypatch):
    """Adversarial re-link stress: reads built from tightly packed /
    overlapping gene-like segments on both strands, so closures fire with
    many openers inside the 50 bp window (the vectorized re-link +
    disqualify/requalify machinery must match the host exactly)."""
    gd, classes, genomes = trained_models
    rng = np.random.default_rng(41)
    reads = []
    cls_map = {}

    def gene_like(ncod, gc):
        # class-GC-matched codons so the trained ICMs actually score them
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        cs = []
        while len(cs) < ncod:
            c = "".join(rng.choice(list("acgt"), 3, p=p))
            if c not in ("taa", "tag", "tga"):
                cs.append(c)
        return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))

    for i in range(60):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        while total < 450:
            g = gene_like(int(rng.integers(30, 80)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            ov = int(rng.integers(0, 45))  # overlap previous segment
            if parts and ov:
                joined = "".join(parts)
                parts = [joined[: max(0, len(joined) - ov)]]
            parts.append(g)
            total = sum(len(p) for p in parts)
        seq = "".join(parts)[:500]
        rid = f"ov{i}"
        reads.append((rid, seq))
        cls_map[rid] = [classes[i % 2]]
    host, dev = _run_both(reads, gd, cls_map, monkeypatch)
    n_genes = 0
    for (h, hg), (_d, dg) in zip(host, dev):
        assert _coords(hg) == _coords(dg), h
        n_genes += len(hg)
    assert n_genes > 15  # dense input really generated genes (26 measured)


def test_first_start_codon_flag_is_eligible(monkeypatch):
    """use_first_start_codon is a glimmer3 whole-genome knob the per-read
    engine ignores; a Models carrying it must still run on the device path
    with identical output (VERDICT r4 task 6)."""
    from glimmer_mg_tpu.ops import device_predict as dpk

    rng = np.random.default_rng(31)
    pat = orf_mod.CodonPatterns.make()
    gc = 0.6
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def gene_like(ncod):
        cs = []
        while len(cs) < ncod:
            c = "".join(rng.choice(list("acgt"), 3, p=p))
            if c not in ("taa", "tag", "tga"):
                cs.append(c)
        return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))

    train = [gene_like(120) for _ in range(8)]
    gicm = icm_train.train_icm(
        [dna.encode(s) for s in train], model_len=12, depth=3)
    indep = icm_mod.build_indep_wo_stops(0.5, pat.stop_codons)
    models = Models(gene_icm=gicm, indep_model=indep, patterns=pat,
                    min_gene_len=75, allow_truncated_orfs=True,
                    use_first_start_codon=True)
    jobs = []
    for i in range(24):
        s = ("".join(rng.choice(list("acgt"), 30)) + gene_like(60)
             + "".join(rng.choice(list("acgt"), 30)))
        jobs.append((dna.encode(s), models, None, False))

    dev = mg._device_dp_chunk(jobs, False, False)
    assert dev is not None  # eligible despite the flag
    n_genes = 0
    for r, (seq_idx, m, _q, _hq) in enumerate(jobs):
        host = mg._predict_read_with_models(m, seq_idx)
        assert _coords(host) == _coords(dev[r]), r
        n_genes += len(host)
    assert n_genes > 5


def test_group_count_shares_one_program(monkeypatch):
    """Chunks holding different numbers of model groups pad the bank to
    one group bucket, so they share one compiled device program instead
    of compiling once per group count."""
    from glimmer_mg_tpu.ops import device_predict as dpk

    rng = np.random.default_rng(71)
    pat = orf_mod.CodonPatterns.make()
    train = ["atg" + "".join(rng.choice(list("acgt"), 300)) + "taa"
             for _ in range(8)]
    gicm = icm_train.train_icm(
        [dna.encode(s) for s in train], model_len=12, depth=3)
    models = [
        Models(gene_icm=gicm,
               indep_model=icm_mod.build_indep_wo_stops(gc, pat.stop_codons),
               patterns=pat, min_gene_len=75, allow_truncated_orfs=True)
        for gc in (0.4, 0.5, 0.6)
    ]
    seqs = [dna.encode("".join(rng.choice(list("acgt"), 200)))
            for _ in range(12)]
    one = [(s, models[0], None, False) for s in seqs]
    three = [(s, models[i % 3], None, False) for i, s in enumerate(seqs)]
    mg._DEVICE_BANK_CACHE.clear()
    dpk._JIT_CACHE.clear()
    assert mg._device_dp_chunk(one, False, False) is not None
    keys = list(dpk._JIT_CACHE)
    assert mg._device_dp_chunk(three, False, False) is not None
    assert list(dpk._JIT_CACHE) == keys  # no second program
    shapes = {b.gene_mip.shape for b in mg._DEVICE_BANK_CACHE.values()}
    assert len(mg._DEVICE_BANK_CACHE) == 2 and len(shapes) == 1
    assert shapes.pop()[0] == 8
    dev = mg._device_dp_chunk(three, False, False)
    for r, (s, m, _q, _hq) in enumerate(three):
        assert _coords(mg._predict_read_with_models(m, s)) == _coords(dev[r])
