"""Throughput on the GPU, from seeded data, in one process.

Prints one JSON line per metric; the last line is the end-to-end metric.
Every row carries the device (platform, kind, count) and the card's
``nvidia-smi`` name and power limit. Exits non-zero without a GPU.

  icm_bank_scoring        PhymmBank.score_reads of 4,096 seeded 500 bp reads
                          against a 256-model depth-7 bank trained on the
                          device; model*Mbp/s = bases x models x 2 strands
                          / 1e6 / seconds
  glimmer_mg_reads_per_s  run_glimmer_mg_classes device-resident over 8,192
                          seeded reads (top-2 classes each) on the
                          8-strain bench DB; the native host engine's
                          reads/s on the same reads and the parity of the
                          two .predict texts ride in the detail

Times are wall-clock medians of 3 warm runs; compile and data set-up are
reported apart.

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_MODELS = 256
CLASSIFY_READS = 4096
PREDICT_READS = 8192
READ_LEN = 500
RUNS = 3


def device_stamp():
    import jax

    d = jax.devices()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d), "card": card.strip().splitlines()[0]}


def _median_runs(fn):
    fn()  # warm: compile and caches
    ts = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def bench_bank_scoring(stamp):
    from glimmer_mg_tpu import bench_db
    from glimmer_mg_tpu.parallel import phymm

    t0 = time.perf_counter()
    genomes = bench_db.bank_genomes(N_MODELS)
    mip, probs = bench_db.train_bank(genomes)
    setup_s = time.perf_counter() - t0
    names = [f"bank{k:03d}|chr" for k in range(N_MODELS)]
    reads, _src = bench_db.sample_reads(dict(zip(names, genomes)),
                                        CLASSIFY_READS, READ_LEN, seed=17)
    seqs = [s.lower() for _h, s in reads]
    bank = phymm.PhymmBank(names, mip, probs, 12, 7)
    med, ts = _median_runs(lambda: bank.score_reads(seqs))
    model_mbp = sum(len(s) for s in seqs) * N_MODELS * 2 / 1e6
    print(json.dumps({
        "metric": "icm_bank_scoring", "value": model_mbp / med,
        "unit": "model*Mbp/s",
        "detail": dict(stamp, models=N_MODELS, reads=len(seqs),
                       read_len=READ_LEN, median_s=med, runs_s=ts,
                       bank_setup_s=setup_s),
    }), flush=True)


def bench_reads_per_s(stamp):
    from glimmer_mg_tpu import bench_db
    from glimmer_mg_tpu.engine import glimmer_mg as mg
    from glimmer_mg_tpu.io.genome_data import GenomeData

    t0 = time.perf_counter()
    db = os.path.join(HERE, ".cache", "bench_db")
    classes, genomes = bench_db.build_bench_db(db)
    gd = GenomeData(os.path.join(db, "genomeData"))
    reads, sources = bench_db.sample_reads(genomes, PREDICT_READS, READ_LEN)
    cls_map = bench_db.top2_classes(reads, sources, classes)
    setup_s = time.perf_counter() - t0

    out = {}

    def run(device):
        os.environ["GLIMMER_MG_TPU_DEVICE_DP"] = "1" if device else "0"
        out[device] = list(mg.run_glimmer_mg_classes(reads, gd, cls_map))

    mg.DEVICE_DP_COUNTS.clear()
    med, ts = _median_runs(lambda: run(True))
    counts = dict(mg.DEVICE_DP_COUNTS)
    nat_med, nat_ts = _median_runs(lambda: run(False))
    os.environ.pop("GLIMMER_MG_TPU_DEVICE_DP", None)
    parity = mg.format_predict_mg(out[True]) == mg.format_predict_mg(out[False])
    print(json.dumps({
        "metric": "glimmer_mg_reads_per_s", "value": len(reads) / med,
        "unit": "reads/s",
        "detail": dict(stamp, engine="device_resident", reads=len(reads),
                       read_len=READ_LEN, median_s=med, runs_s=ts,
                       parity_with_native=parity,
                       native_reads_per_s=len(reads) / nat_med,
                       native_runs_s=nat_ts, native_threads=os.cpu_count(),
                       route_counts=counts, setup_s=setup_s),
    }), flush=True)


def main():
    sys.path.insert(0, HERE)
    from glimmer_mg_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench: needs a GPU", file=sys.stderr)
        return 1
    stamp = device_stamp()
    bench_bank_scoring(stamp)
    bench_reads_per_s(stamp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
