"""Seeded benchmark fixtures: genomes, a Phymm-style genomeData DB, reads,
errors and qualities, and a trained classification bank.

The reference's Phymm DB (~50 GB of trained reference-genome models,
docs/notes.tex:80-83) is not shipped, so throughput benchmarks, the GPU
smoke test and the device-vs-host tests run against deterministic
synthetic data made from a seed: gene-dense random genomes self-trained
with this framework's own pipeline (long-orfs -> extract -> build-icm -r ->
glimmer3 -> train_features), the exact bootstrap the reference uses for
novel genomes (g3-iterated.py), reads sampled from those genomes, and a
bank of ICMs trained on the device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

STOPS = ("TAA", "TAG", "TGA")


def make_genome(rng, gc: float, n_genes: int = 50) -> str:
    """A random genome with dense unambiguous genes at the given GC."""
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def gene(n_codons):
        codons = []
        while len(codons) < n_codons:
            c = "".join(rng.choice(list("ACGT"), 3, p=p))
            if c not in STOPS:
                codons.append(c)
        return "ATG" + "".join(codons) + rng.choice(list(STOPS))

    parts = []
    for _ in range(n_genes):
        parts.append(
            "".join(rng.choice(list("ACGT"), int(rng.integers(50, 300)), p=p))
        )
        g = gene(int(rng.integers(100, 400)))
        if rng.random() < 0.4:
            g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
        parts.append(g)
    return "".join(parts)


def build_bench_db(root, n_strains: int = 8, seed: int = 7, n_genes: int = 50):
    """Build (or reuse) a genomeData tree of self-trained synthetic genomes.

    Returns (class_names, genomes dict). Layout matches the Phymm DB the
    reference expects: genomeData/<strain>/<nc>.{gicm,lengths.*,starts,...}.
    """
    from .engine import glimmer3 as g3
    from .models import dna, icm_train
    from .pipeline import extract as ex, long_orfs as lo, train_features as tf

    root = Path(root)
    gd = root / "genomeData"
    gd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    gcs = np.linspace(0.35, 0.65, n_strains)
    genomes = {}
    classes = []
    for gi in range(n_strains):
        cls = f"strain{gi}|chr"
        classes.append(cls)
        genomes[cls] = make_genome(rng, float(gcs[gi]), n_genes=n_genes)

    for cls, seq in genomes.items():
        strain, nc = cls.split("|")
        d = gd / strain
        d.mkdir(exist_ok=True)
        if (d / f"{nc}.gicm").exists():
            continue
        lines, _ = lo.run_long_orfs(seq, entropy_cutoff=1.15)
        train_recs = list(ex.extract(seq, "\n".join(lines), skip_stop=True))
        strings = icm_train.prepare_training_strings(
            [s for _, s in train_recs], reverse=True
        )
        m = icm_train.train_icm([dna.encode(s) for s in strings])
        res = list(g3.run_glimmer3([(nc, seq)], m, logodds_fudge=-12))
        tf.train_genome_data(g3.format_predict(res), {nc: seq}, str(d / nc))
    return classes, genomes


def sample_reads(genomes: dict, n_reads: int, read_len: int = 500,
                 seed: int = 3):
    """Seeded reads sampled from ``genomes`` (class name -> sequence).

    Each read picks a genome uniformly, a start uniformly over the
    genome, and a strand with probability 1/2 (reverse complement on the
    minus strand). Starts ignore gene coordinates, so reads begin and end
    at arbitrary offsets: most cross a gene boundary, some lie inside a
    gene or an intergenic spacer. Returns (reads [(header, seq)],
    sources [class name]).
    """
    rng = np.random.default_rng(seed)
    names = list(genomes)
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    src = rng.integers(0, len(names), n_reads)
    minus = rng.random(n_reads) < 0.5
    reads, sources = [], []
    for i in range(n_reads):
        g = genomes[names[src[i]]]
        st = int(rng.integers(0, len(g) - read_len + 1))
        seq = g[st : st + read_len]
        if minus[i]:
            seq = seq[::-1].translate(comp)
        reads.append((f"r{i}", seq))
        sources.append(names[src[i]])
    return reads, sources


def top2_classes(reads, sources, classes) -> dict:
    """Per-read class calls for classes mode: the read's own strain, then
    its neighbour in the DB's GC order (``build_bench_db`` spaces strain
    GC evenly, so the neighbour is the closest other model, the usual
    Phymm runner-up). Returns header prefix -> [class, class]."""
    pos = {c: k for k, c in enumerate(classes)}
    out = {}
    for (h, _s), c in zip(reads, sources):
        k = pos[c]
        other = k + 1 if k + 1 < len(classes) else k - 1
        out[h.split()[0]] = [c, classes[other]]
    return out


def add_substitutions(reads, rate: float = 0.004, seed: int = 5):
    """Seeded substitution errors plus Illumina-like quality values.

    Every base is substituted with probability ``rate`` (by one of the
    three other bases). Qualities fall from ~38 at the 5' end to ~22 at
    the 3' end with noise, clipped to [2, 41]; substituted bases get a
    low quality in [2, 12], as a base caller flags them. Returns
    (reads [(header, seq)], qualities {header prefix: [int]}).
    """
    rng = np.random.default_rng(seed)
    out, quals = [], {}
    for h, seq in reads:
        n = len(seq)
        arr = np.frombuffer(seq.lower().encode(), np.uint8).copy()
        hit = rng.random(n) < rate
        alphabet = np.frombuffer(b"acgt", np.uint8)
        for p in np.flatnonzero(hit):
            others = alphabet[alphabet != arr[p]]
            arr[p] = others[int(rng.integers(0, len(others)))]
        x = np.arange(n) / max(n - 1, 1)
        q = 38.0 - 16.0 * x * x + rng.normal(0.0, 3.0, n)
        q = np.clip(np.rint(q), 2, 41).astype(np.int64)
        q[hit] = rng.integers(2, 13, int(hit.sum()))
        out.append((h, arr.tobytes().decode()))
        quals[h.split()[0]] = [int(v) for v in q]
    return out, quals


def bank_genomes(n_models: int = 256, seed: int = 11,
                 n_genes: int = 16) -> list[str]:
    """Seeded genomes for a classification bank, GC spread evenly over
    0.30-0.70 (``n_genes`` genes each, ~1 kb per gene)."""
    rng = np.random.default_rng(seed)
    return [make_genome(rng, float(gc), n_genes=n_genes)
            for gc in np.linspace(0.30, 0.70, n_models)]


def bank_batches(genomes, row_len: int = 2000, group: int = 64):
    """Training batches for :func:`train_bank`, ``group`` models each.

    Each genome is cut into ``row_len`` rows; every batch has the same
    shape (short genomes and a short last group are padded with empty
    rows), so one compiled trainer serves them all. Yields
    (reads (group*R, row_len) int32, lengths, assign (group*R, group) f32).
    """
    from .models import dna

    rows_of = [[g[lo : lo + row_len] for lo in range(0, len(g), row_len)]
               for g in genomes]
    n_rows = max(len(r) for r in rows_of)
    for g0 in range(0, len(genomes), group):
        reads = np.zeros((group * n_rows, row_len), np.int32)
        lengths = np.zeros(group * n_rows, np.int32)
        assign = np.zeros((group * n_rows, group), np.float32)
        for k, rows in enumerate(rows_of[g0 : g0 + group]):
            for j, row in enumerate(rows):
                r = k * n_rows + j
                reads[r, : len(row)] = dna.encode(row)
                lengths[r] = len(row)
                assign[r, k] = 1.0
        yield reads, lengths, assign


def train_bank(genomes, row_len: int = 2000, group: int = 64,
               model_len: int = 12, depth: int = 7):
    """Train one full-width ICM per genome on the device, ``group`` at a
    time with the jitted ``icm_train_device.train_icm_bank`` (the Scimm
    EM trainer). Returns host arrays (mip (M, 3, N) int16,
    probs (M, 3, N, 4) f32)."""
    import jax

    from .ops import icm_train_device

    mips, probs = [], []
    for reads, lengths, assign in bank_batches(genomes, row_len, group):
        mip, prob = jax.device_get(icm_train_device.train_icm_bank(
            reads, lengths, assign, n_models=group, model_len=model_len,
            depth=depth))
        mips.append(np.asarray(mip, np.int16))
        probs.append(np.asarray(prob, np.float32))
    n = len(genomes)
    return np.concatenate(mips)[:n], np.concatenate(probs)[:n]
