"""Scimm/PhyScimm-equivalent clustering: classification-seeded iterative EM.

The reference invokes the external Scimm package (a missing large blob;
scimm-0.3.0.tar.gz): physcimm.py initializes clusters from the Phymm
best-hit table at a taxonomic level (dropping clusters below a bp
fraction), then iterates: train an IMM per cluster (build-icm), score every
read against every cluster IMM (simple-score), reassign reads to the argmax
cluster (SURVEY P12; artifacts cluster-<k>.fa / cluster-<k>.icm /
icm-<k>.scores.tmp in sample-run). Exact parity is impossible (Scimm is
stochastic per the reference manual, docs/notes.tex:249-253); this module
reconstructs the algorithm deterministically, with the EM inner loop on
device (ops.icm_train_device + the bank scorer).
"""

from __future__ import annotations

import os

import numpy as np

from ..models import dna, icm as icm_mod, icm_train
from ..ops import icm_score
from ..parallel import classify as pclassify


def init_clusters_from_results(results_file, read_ids, taxonomy=None,
                               taxlevel_index: int = 1, minbp_pct: float = 0.01,
                               read_lengths=None):
    """Seed clusters by grouping reads on a taxonomy rank of their best hit.

    ``taxlevel_index``: 0=genus, 1=family, ... over the results columns.
    Falls back to the strain name when the rank column is blank. Clusters
    holding < minbp_pct of total bp are dropped (their reads go to the
    biggest cluster).
    """
    best = {}
    with open(results_file) as fh:
        header = fh.readline()
        for line in fh:
            toks = line.rstrip("\n").split("\t")
            rid = toks[0]
            rank = ""
            if len(toks) > 3 + taxlevel_index:
                rank = toks[3 + taxlevel_index]
            best[rid] = rank if rank else toks[1]

    groups: dict[str, list[int]] = {}
    for i, rid in enumerate(read_ids):
        groups.setdefault(best.get(rid, ""), []).append(i)

    if read_lengths is None:
        read_lengths = np.ones(len(read_ids))
    total_bp = float(np.sum(read_lengths))
    keep = {k: v for k, v in groups.items()
            if sum(read_lengths[i] for i in v) >= minbp_pct * total_bp}
    if not keep:
        keep = {max(groups, key=lambda k: len(groups[k])): sum(groups.values(), [])}
    biggest = max(keep, key=lambda k: len(keep[k]))
    assign = np.zeros(len(read_ids), dtype=np.int32)
    names = sorted(keep)
    for ci, name in enumerate(names):
        for i in keep[name]:
            assign[i] = ci
    for name, members in groups.items():
        if name not in keep:
            for i in members:
                assign[i] = names.index(biggest)
    return assign, names


def _train_cluster_icms(seqs, assign, n_clusters, min_bp=500):
    """Host trainer per cluster (bit-exact path); tiny clusters get a
    uniform placeholder that scores poorly."""
    icms = []
    for c in range(n_clusters):
        strings = [seqs[i].lower() for i in range(len(seqs)) if assign[i] == c]
        bp = sum(len(s) for s in strings)
        if bp >= min_bp:
            icms.append(icm_train.train_icm([dna.encode(s) for s in strings]))
        else:
            m = icm_mod.ICM.empty()
            m.probs[:] = np.float32(np.log(0.25))
            m.mip[:, 0] = -1
            m.mip[:, 1:] = -2
            icms.append(m)
    return icms


def _bank_to_icms(mip, probs, model_len=12, depth=7) -> list:
    """Device-trained bank tensors -> host ICM objects (for artifacts)."""
    mip = np.asarray(mip)
    probs = np.asarray(probs, dtype=np.float32)
    return [
        icm_mod.ICM(model_len, depth, mip.shape[1], mip[i].astype(np.int16),
                    probs[i])
        for i in range(mip.shape[0])
    ]


def _device_em(reads, lengths, init_assign, n_clusters, max_iters, mesh=None,
               model_len=12, depth=7):
    """EM with per-cluster retraining ON DEVICE (ops.icm_train_device) and
    classification through the XLA walk (parallel.classify). With ``mesh``,
    reads shard over the ``data`` axis — the count histograms become a
    psum, the argmax an all-gather (the sharding dryrun_multichip exercises
    via parallel.classify.em_step)."""
    import jax

    from ..ops import icm_train_device
    from ..parallel import mesh as pmesh

    n_reads = reads.shape[0]
    if mesh is not None:
        # zero-pad to the data-axis size (pad rows have length 0: no counts,
        # no scores) — NamedSharding requires even divisibility
        reads, lengths, n_reads = pmesh.pad_batch(mesh, reads, lengths)
        reads, lengths = pmesh.shard_reads(mesh, reads, lengths)

    assign = np.asarray(init_assign, dtype=np.int32).copy()
    scores = mip = probs = None
    for it in range(max_iters + 1):
        onehot = np.zeros((reads.shape[0], n_clusters), np.float32)
        onehot[np.arange(len(assign)), assign] = 1.0  # pad rows stay zero
        mip, probs = icm_train_device.train_icm_bank(
            jax.numpy.asarray(reads), lengths, onehot, n_models=n_clusters,
            model_len=model_len, depth=depth,
        )
        if it == max_iters:
            break
        scores, _ = pclassify.classify_step(
            mip, probs, reads, lengths, model_len, depth)
        scores = pmesh.materialize(scores)[:n_reads]
        new_assign = np.argmax(scores, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
    return assign, _bank_to_icms(mip, probs, model_len, depth), scores


def scimm_cluster(
    seqs: list[str],
    init_assign: np.ndarray,
    n_clusters: int,
    max_iters: int = 10,
    use_device: bool | None = None,
    mesh=None,
    model_len: int = 12,
    depth: int = 7,
):
    """Iterative EM clustering; returns (assign, cluster_icms, scores).

    ``use_device=None`` auto-selects: the device EM (bank trainer + XLA
    classifier, one jitted dispatch per stage) on a GPU backend, the
    bit-exact host trainer on a CPU backend. ``mesh`` shards reads over the
    ``data`` axis of a (data, model) mesh (device path only)."""
    import jax

    if use_device is None:
        use_device = jax.default_backend() == "gpu"
    assign = np.asarray(init_assign, dtype=np.int32).copy()
    length = max((len(s) for s in seqs), default=3)
    length += (-length) % 3
    reads, lengths = pclassify.pad_reads([s.lower() for s in seqs], length=length)

    if use_device:
        return _device_em(reads, lengths, assign, n_clusters, max_iters, mesh,
                          model_len, depth)

    scores = None
    for it in range(max_iters):
        icms = _train_cluster_icms(seqs, assign, n_clusters)
        mip, probs = icm_score.stack_bank(icms)
        scores, best = pclassify.classify_step(mip, probs, reads, lengths, 12, 7)
        scores = np.asarray(scores)
        new_assign = np.argmax(scores, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
    icms = _train_cluster_icms(seqs, assign, n_clusters)
    return assign, icms, scores


def write_cluster_artifacts(out_dir, read_recs, assign, icms, scores) -> None:
    """cluster-<k>.fa, cluster-<k>.icm, icm-<k>.scores.tmp (the files
    glimmer-mg.py consumes at :127-131 and :343-348)."""
    from ..io.fasta import write_fasta

    n_clusters = len(icms)
    for c in range(n_clusters):
        members = [read_recs[i] for i in range(len(read_recs)) if assign[i] == c]
        write_fasta(os.path.join(out_dir, f"cluster-{c}.fa"), members, width=60)
        icm_mod.write_icm(icms[c], os.path.join(out_dir, f"cluster-{c}.icm"))
        with open(os.path.join(out_dir, f"icm-{c}.scores.tmp"), "w") as fh:
            for i, (h, _) in enumerate(read_recs):
                fh.write("%-20s\t%10.4f\n" % (h.split()[0], scores[i, c]))
