"""Multi-host (2-process) mesh test: EM across process boundaries.

Launches two real OS processes, each with 4 virtual CPU devices, joined via
parallel.mesh.init_distributed (VERDICT r1 item 4). Proves the
classification all-gather and the training-count psum cross process
boundaries — the single-machine stand-in for a multi-host mesh and the
replacement for the reference's Condor fan-out (phymm_par.py:268-274).
"""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_em():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own 4-device count
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            outs.append(out)
    finally:
        for p in procs:  # kill exact PIDs on timeout, never by pattern
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "MULTIHOST_OK" in out, out[-2000:]


def test_two_process_classify_cli(tmp_path):
    """classify_file end to end across 2 processes, driven through the real
    CLI (--coordinator/--num_procs/--proc_id + --mesh): each process holds a
    read shard; artifacts are written once and equal the single-process run
    (VERDICT r2 item 8; reference Condor fan-out phymm_par.py:268-274)."""
    import numpy as np

    from glimmer_mg_tpu.io.fasta import write_fasta
    from glimmer_mg_tpu.parallel import phymm
    from glimmer_mg_tpu.pipeline import train_all

    # tiny 2-genome DB + 12 reads
    rng = np.random.default_rng(21)
    genomes = {
        f"g{k}|chr{k}": "".join(
            rng.choice(list("ACGT"), 4000,
                       p=[0.2 + 0.25 * k, 0.3 - 0.05 * k,
                          0.3 - 0.05 * k, 0.2 - 0.15 * k])
        )
        for k in range(2)
    }
    icm_dir = tmp_path / "genomeData"
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=1000)
    reads = []
    keys = list(genomes)
    for i in range(12):
        g = genomes[keys[i % 2]]
        lo = int(rng.integers(0, len(g) - 400))
        reads.append((f"read{i}", g[lo : lo + 400]))
    seqs_fa = tmp_path / "reads.fa"
    write_fasta(seqs_fa, reads, width=60)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    out_dirs = [tmp_path / f"proc{i}" for i in range(2)]
    for d in out_dirs:
        d.mkdir()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "glimmer_mg_tpu.cli", "classify",
             str(seqs_fa), str(icm_dir), "-o", str(out_dirs[i]),
             "--platform", "cpu",
             "--mesh", "4,2", "--coordinator", f"127.0.0.1:{port}",
             "--num_procs", "2", "--proc_id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            outs.append(out)
    finally:
        for p in procs:  # kill exact PIDs on timeout, never by pattern
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    # only process 0 writes the shared artifacts
    raw0 = out_dirs[0] / phymm.raw_phymm_name(str(seqs_fa))
    assert raw0.exists()
    assert not (out_dirs[1] / phymm.raw_phymm_name(str(seqs_fa))).exists()

    # and they equal the single-process (unsharded) run byte for byte
    single = tmp_path / "single"
    single.mkdir()
    phymm.classify_file(str(seqs_fa), str(icm_dir), out_dir=str(single))
    assert raw0.read_text() == (
        single / phymm.raw_phymm_name(str(seqs_fa))
    ).read_text()
    assert (out_dirs[0] / phymm.results_name(str(seqs_fa))).read_text() == (
        single / phymm.results_name(str(seqs_fa))
    ).read_text()


def test_two_process_predict_cli(tmp_path):
    """Predict-stage read sharding across 2 OS processes (VERDICT r3
    task 8): each process predicts a contiguous slice of the deterministic
    emission order; concatenated part files are byte-equal to the
    single-process .predict (reference combine_seq merge semantics,
    phymm_par.py:283-399). The wall-clock of the busier shard vs the
    single-process run is the scaling evidence recorded in COMPONENTS.md."""
    import time

    import numpy as np

    from glimmer_mg_tpu.io.fasta import write_fasta
    from glimmer_mg_tpu.pipeline import train_all

    from glimmer_mg_tpu import bench_db

    rng = np.random.default_rng(31)
    genomes = {
        f"g{k}|chr{k}": bench_db.make_genome(rng, 0.4 + 0.15 * k, n_genes=30)
        for k in range(2)
    }
    icm_dir = tmp_path / "genomeData"
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=1000)
    keys = list(genomes)
    reads = []
    class_lines = []
    for i in range(40):
        g = genomes[keys[i % 2]]
        lo = int(rng.integers(0, len(g) - 450))
        reads.append((f"read{i}", g[lo : lo + 450]))
        class_lines.append("read%d\t%s" % (i, keys[i % 2]))
    seqs_fa = tmp_path / "reads.fa"
    write_fasta(seqs_fa, reads, width=60)
    class_file = tmp_path / "reads.class.txt"
    class_file.write_text("\n".join(class_lines) + "\n")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def run(num_procs, proc_id, tag):
        args = [sys.executable, "-m", "glimmer_mg_tpu.cli", "glimmer-mg",
                "-c", str(class_file), "--genome_data", str(icm_dir),
                str(seqs_fa), str(tmp_path / tag)]
        if num_procs > 1:
            args += ["--num_procs", str(num_procs), "--proc_id", str(proc_id)]
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=REPO)

    t0 = time.time()
    procs = [run(2, i, "sh") for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            outs.append(out)
    finally:
        for p in procs:  # kill exact PIDs on timeout, never by pattern
            if p.poll() is None:
                p.kill()
    sharded_s = time.time() - t0
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    t0 = time.time()
    p1 = run(1, 0, "single")
    out, _ = p1.communicate(timeout=280)
    assert p1.returncode == 0, out[-2000:]
    single_s = time.time() - t0

    merged = (tmp_path / "sh.predict.part0").read_text() + (
        tmp_path / "sh.predict.part1"
    ).read_text()
    single = (tmp_path / "single.predict").read_text()
    assert merged == single
    # both shards actually predicted reads
    assert (tmp_path / "sh.predict.part0").read_text().count(">") >= 10
    assert (tmp_path / "sh.predict.part1").read_text().count(">") >= 10
    print("predict shard scaling: single %.1fs, 2-proc wall %.1fs"
          % (single_s, sharded_s))
