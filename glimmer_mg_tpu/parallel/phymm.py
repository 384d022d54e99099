"""Phymm-equivalent read classification against a genome ICM bank.

The reference pipeline (scripts/phymm_par.py + scripts/scoreReadsGlim.pl)
fans out processes, each running `simple-score -N <icm>` over all reads
forward and reverse-complement, keeping the per-read max, then merges score
matrices from files. Here the whole bank is a stacked tensor scored on
device in one pass (the XLA gather walk, ops.icm_score), optionally sharded
over a (data, model) mesh; the "merge" is the device argmax/top-k.

File-format parity: emits/reads the reference's rawPhymmOutput_*.txt
(BEGIN_ICM_LIST / BEGIN_READID_LIST / BEGIN_DATA_MATRIX, one row per ICM;
scoreReadsGlim.pl:376-555) and the results.01.phymm_*.txt best-hit table,
so artifacts interoperate with reference tooling and support the pipeline's
--raw/--class resume flags.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..models import icm as icm_mod
from ..ops import icm_score
from . import classify as pclassify


def genome_icm_paths(icm_dir: str) -> list[str]:
    """All whole-genome Phymm ICMs (<dir>/<strain>/<nc>.icm), sorted like
    the reference's `sort { $a cmp $b }` over full paths."""
    return sorted(glob.glob(os.path.join(icm_dir, "*", "*.icm")))


def path_to_genome(path: str) -> str:
    """ICM path -> 'strain|nc' (parse_phymm, glimmer-mg.py:556-559)."""
    parts = path.split("/")
    return "%s|%s" % (parts[-2], parts[-1].split(".")[0])


class PhymmBank:
    """A stacked, device-ready ICM bank."""

    def __init__(self, paths: list[str], mip, probs, model_len: int,
                 depth: int):
        self.paths = paths
        self.mip, self.probs = mip, probs
        self.model_len, self.depth = model_len, depth

    @classmethod
    def from_paths(cls, icm_paths: list[str]) -> "PhymmBank":
        icms = [icm_mod.read_icm(p) for p in icm_paths]
        mip, probs = icm_score.stack_bank(icms)
        return cls(icm_paths, mip, probs, icms[0].model_len,
                   max(m.model_depth for m in icms))

    @classmethod
    def from_genome_data(cls, icm_dir: str) -> "PhymmBank":
        return cls.from_paths(genome_icm_paths(icm_dir))

    def score_reads(self, seqs: list[str], batch: int = 512, progress=None,
                    mesh=None):
        """(n_reads, n_models) fwd/rev-max scores. Pads reads per batch.

        ``progress`` is an optional utils.observe.ProgressLog advanced once
        per read (the reference's *_progress.txt, scoreReadsGlim.pl:417).

        ``mesh``: a (data, model) jax Mesh — the bank shards over the
        ``model`` axis and each read batch over ``data`` (the two
        phymm_par.py fan-out modes at once); bank/batch are padded to the
        axis sizes and the pads sliced off the result.
        """
        from . import mesh as pmesh

        n = len(seqs)
        m = len(self.paths)
        out = np.zeros((n, m), dtype=np.float32)
        length = max((len(s) for s in seqs), default=0)
        mip, probs = self.mip, self.probs
        if mesh is not None:
            dat, mdl = mesh.shape["data"], mesh.shape["model"]
            pad_m = (-m) % mdl
            if pad_m:
                mip = np.concatenate([mip, np.repeat(mip[:1], pad_m, axis=0)])
                probs = np.concatenate(
                    [probs, np.repeat(probs[:1], pad_m, axis=0)]
                )
            mip, probs = pmesh.shard_bank(mesh, mip, probs)

        # every batch has the same row count (a short tail is padded with
        # empty reads), so one compiled step serves the whole read set
        rows = min(batch, n)
        if mesh is not None:
            rows += (-rows) % dat
        for lo in range(0, n, batch):
            chunk = seqs[lo : lo + batch]
            reads, lengths = pclassify.pad_reads(chunk, length=length)
            pad_b = rows - len(chunk)
            if pad_b:
                reads = np.pad(reads, ((0, pad_b), (0, 0)))
                lengths = np.pad(lengths, (0, pad_b))
            if mesh is not None:
                reads, lengths = pmesh.shard_reads(mesh, reads, lengths)
            scores, _ = pclassify.classify_step(
                mip, probs, reads, lengths, self.model_len, self.depth
            )
            # multi-host safe: process_allgather instead of np.asarray
            out[lo : lo + len(chunk)] = pmesh.materialize(scores)[
                : len(chunk), :m]
            if progress is not None:
                progress.advance(len(chunk))
        return out


def write_raw_phymm_output(path, icm_paths, read_ids, scores) -> None:
    """scoreReadsGlim.pl raw matrix: one DATA row per ICM across reads."""
    with open(path, "w") as fh:
        fh.write("BEGIN_ICM_LIST\n")
        for p in icm_paths:
            fh.write(p + "\n")
        fh.write("END_ICM_LIST\nBEGIN_READID_LIST\n")
        for r in read_ids:
            fh.write(r + "\n")
        fh.write("END_READID_LIST\nBEGIN_DATA_MATRIX\n")
        for g in range(len(icm_paths)):
            fh.write(" ".join("%.4f" % s for s in scores[:, g]) + "\n")
        fh.write("END_DATA_MATRIX\n")


def read_raw_phymm_output(path):
    """Returns (icm_paths, read_ids, scores (n_reads, n_models))."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    it = iter(lines)
    assert next(it) == "BEGIN_ICM_LIST"
    icm_paths = []
    for line in it:
        if line.startswith("END_ICM_LIST"):
            break
        icm_paths.append(line)
    assert next(it) == "BEGIN_READID_LIST"
    read_ids = []
    for line in it:
        if line.startswith("END_READID_LIST"):
            break
        read_ids.append(line)
    assert next(it) == "BEGIN_DATA_MATRIX"
    rows = []
    for line in it:
        if line.startswith("END_DATA_MATRIX"):
            break
        rows.append([float(x) for x in line.split()])
    scores = np.array(rows, dtype=np.float64).T  # (reads, models)
    return icm_paths, read_ids, scores


def raw_phymm_name(sequence_file: str) -> str:
    """rawPhymmOutput_<basename with . -> _>.txt (scoreReadsGlim.pl:376)."""
    base = os.path.basename(sequence_file).replace(".", "_")
    return f"rawPhymmOutput_{base}.txt"


def results_name(sequence_file: str) -> str:
    base = os.path.basename(sequence_file).replace(".", "_")
    return f"results.01.phymm_{base}.txt"


#: Taxonomy ranks in results-table column order (scoreReadsGlim.pl:571).
RANKS = ("genus", "family", "order", "class", "phylum")


def load_taxonomy(icm_dir: str) -> dict[str, tuple[str, ...]]:
    """Load the Phymm taxonomy table for a genome DB.

    Mirrors scoreReadsGlim.pl:296-340: the DB root (the directory holding
    the ``.genomeData`` tree, i.e. ``icm_dir/..``) may carry
    ``.taxonomyData/.3_parsedTaxData/distributionOfTaxa.txt`` (plus a
    ``_userAdded`` variant) with lines

        <taxType> \\t <taxValue> \\t <prefix + species> \\t <strainDirName>

    Only the five ranks in :data:`RANKS` are kept. Returns
    strain -> (genus, family, order, class, phylum); missing ranks are "".
    An absent table yields {} (ranks blank, clustering falls back to
    per-strain granularity).
    """
    root = os.path.dirname(os.path.abspath(icm_dir))
    base = os.path.join(root, ".taxonomyData", ".3_parsedTaxData")
    tax: dict[str, dict[str, str]] = {}
    for name in ("distributionOfTaxa.txt", "distributionOfTaxa_userAdded.txt"):
        path = os.path.join(base, name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                if not line[:1].strip():
                    continue
                toks = line.rstrip("\n").split("\t")
                if len(toks) >= 4 and toks[0] in RANKS:
                    tax.setdefault(toks[3], {})[toks[0]] = toks[1]
    return {s: tuple(d.get(r, "") for r in RANKS) for s, d in tax.items()}


def write_results_table(path, read_ids, icm_paths, scores, taxonomy=None) -> None:
    """Best-hit table (results.01.phymm_*.txt). ``taxonomy`` maps strain ->
    (genus, family, order, class, phylum); unknown ranks are left blank."""
    best = np.argmax(scores, axis=1)
    with open(path, "w") as fh:
        fh.write("QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\tCLASS\tPHYLUM\n")
        for i, rid in enumerate(read_ids):
            genome = path_to_genome(icm_paths[best[i]])
            strain = genome.split("|")[0]
            ranks = (taxonomy or {}).get(strain, ("", "", "", "", ""))
            fh.write(
                "%s\t%s\t%.4f\t%s\n"
                % (rid, strain, scores[i, best[i]], "\t".join(ranks))
            )


def classify_file(sequence_file, icm_dir, out_dir=".", taxonomy=None,
                  batch: int = 512, mesh=None):
    """Full classification step: score + write raw matrix + results table.

    ``mesh`` shards the bank/reads over a (data, model) device mesh.
    Returns (icm_paths, read_ids, scores).
    """
    from ..io.fasta import read_fasta

    from ..utils.observe import ProgressLog, vlog

    recs = list(read_fasta(sequence_file))
    read_ids = [h.split()[0] for h, _ in recs]
    if taxonomy is None:
        taxonomy = load_taxonomy(icm_dir)
    bank = PhymmBank.from_genome_data(icm_dir)
    vlog(1, f"[phymm] {len(bank.paths)} ICMs x {len(recs)} reads")
    from .mesh import is_output_process

    base = os.path.basename(sequence_file).replace(".", "_")
    progress = None
    if is_output_process():
        progress = ProgressLog(
            os.path.join(out_dir, f"{base}_progress.txt"), len(recs), every=50
        )
    scores = bank.score_reads([s.lower() for _, s in recs], batch=batch,
                              progress=progress, mesh=mesh)
    # every process gets the full score matrix (score_reads all-gathers in
    # multi-host mode); only one writes the shared artifacts
    if is_output_process():
        write_raw_phymm_output(
            os.path.join(out_dir, raw_phymm_name(sequence_file)),
            bank.paths, read_ids, scores,
        )
        write_results_table(
            os.path.join(out_dir, results_name(sequence_file)),
            read_ids, bank.paths, scores, taxonomy,
        )
    return bank.paths, read_ids, scores
