"""Seeded fixtures in bench_db: reads, errors and qualities, bank data."""

import numpy as np

from glimmer_mg_tpu import bench_db
from glimmer_mg_tpu.models import dna


def _genomes():
    rng = np.random.default_rng(0)
    return {f"g{k}|chr": bench_db.make_genome(rng, gc, n_genes=6)
            for k, gc in enumerate((0.35, 0.5, 0.65))}


def test_sample_reads_seeded_both_strands():
    genomes = _genomes()
    reads, src = bench_db.sample_reads(genomes, 60, read_len=120, seed=4)
    again, src2 = bench_db.sample_reads(genomes, 60, read_len=120, seed=4)
    assert reads == again and src == src2
    assert all(len(s) == 120 for _h, s in reads)
    comp = str.maketrans("ACGT", "TGCA")
    n_minus = 0
    for (_h, s), g in zip(reads, src):
        if s in genomes[g]:
            continue
        assert s[::-1].translate(comp) in genomes[g]
        n_minus += 1
    assert 10 < n_minus < 50
    cls = bench_db.top2_classes(reads, src, list(genomes))
    assert all(v[0] == g and v[1] != g for v, g in zip(cls.values(), src))


def test_substitutions_and_qualities():
    reads, _src = bench_db.sample_reads(_genomes(), 40, read_len=300, seed=1)
    mut, quals = bench_db.add_substitutions(reads, rate=0.01, seed=2)
    n_diff = 0
    for (h, s), (h2, m) in zip(reads, mut):
        q = np.array(quals[h])
        diff = np.array([a != b for a, b in zip(s.lower(), m)])
        assert h == h2 and len(q) == len(m) == len(s)
        assert q.min() >= 2 and q.max() <= 41
        assert (q[diff] <= 12).all()  # errors carry low qualities
        n_diff += int(diff.sum())
    assert 40 < n_diff < 250  # ~1% of 12,000 bases


def test_bank_batches_shapes_and_assignment():
    genomes = [g for g in _genomes().values()]
    batches = list(bench_db.bank_batches(genomes, row_len=1000, group=2))
    assert len(batches) == 2
    shapes = {tuple(b[0].shape) for b in batches}
    assert len(shapes) == 1  # one compiled trainer serves every group
    for k, g in enumerate(genomes):
        reads, lengths, assign = batches[k // 2]
        rows = assign[:, k % 2] > 0
        got = "".join(dna.decode(r[:n]) for r, n in
                      zip(reads[rows], lengths[rows]))
        assert got == g.lower()
    assert batches[1][2][:, 1].sum() == 0  # short last group: empty column
