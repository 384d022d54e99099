"""One process of the 2-process multi-host EM test (run by test_multihost.py).

Each process owns 4 virtual CPU devices; parallel.mesh.init_distributed joins
them into one 8-device world. The (data, model) mesh then spans process
boundaries, so em_step's classification argmax all-gathers and its training
count histograms psum across processes (gloo on CPU, NCCL on GPUs).
Usage: multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")

from glimmer_mg_tpu.parallel import mesh as pmesh

assert pmesh.init_distributed(f"127.0.0.1:{port}", nproc, pid)

import numpy as np
from jax.experimental import multihost_utils

from glimmer_mg_tpu.models import dna, icm_train
from glimmer_mg_tpu.ops import icm_score
from glimmer_mg_tpu.parallel import classify as pclassify

assert len(jax.devices()) == 4 * nproc, jax.devices()

rng = np.random.default_rng(0)  # same seed -> same host data in every process
seqs = ["".join(rng.choice(list("acgt"), 120)) for _ in range(16)]
icms = [
    icm_train.train_icm(
        [dna.encode("".join(rng.choice(list("acgt"), 300))) for _ in range(5)],
        model_len=12,
        depth=2,
    )
    for _ in range(2)
]
mip, probs = icm_score.stack_bank(icms)
reads, lengths = pclassify.pad_reads(seqs, length=120)

mesh = pmesh.make_mesh(data=2 * nproc, model=2)
reads_s, lengths_s = pmesh.shard_reads(mesh, reads, lengths)
mip_s, probs_s = pmesh.shard_bank(mesh, mip, probs)
with mesh:
    new_mip, new_probs, best, scores = pclassify.em_step(
        mip_s, probs_s, reads_s, lengths_s, n_models=2, model_len=12, depth=2
    )
    jax.block_until_ready((new_mip, new_probs))

# cross-process result vs the single-process oracle computed locally
got = np.asarray(multihost_utils.process_allgather(scores, tiled=True))
want, _ = pclassify.classify_step(mip, probs, reads, lengths, 12, 2)
err = np.abs(got - np.asarray(want)).max()
assert err < 1e-3, err
got_mip = np.asarray(multihost_utils.process_allgather(new_mip, tiled=True))
assert got_mip.shape[0] == 2
print(f"MULTIHOST_OK proc={pid} err={err:.2e}", flush=True)
