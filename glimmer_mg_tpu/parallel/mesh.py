"""Device mesh construction and sharding helpers.

The framework's scale-out axes (SURVEY §2.4):
  * ``model`` — the ICM bank (hundreds of reference genome models) is
    sharded across devices; per-read classification takes a max/argmax
    across the model axis (the reference's ICM-sharded phymm_par mode,
    scripts/phymm_par.py:146-200, whose file-merge is our all-gather).
  * ``data`` — read batches are sharded across devices (the reference's
    read-sharded mode, phymm_par.py:210-261); training-count reductions
    psum over this axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Initialize multi-process mode; the framework's replacement for the
    reference's Condor process fan-out (scripts/phymm_par.py:268-274).

    Call once per process before any JAX computation, with the coordinator
    address, process count and this process's id (nothing auto-detects a
    cluster). After it returns, ``jax.devices()`` is the GLOBAL device
    list, so :func:`make_mesh` builds a cross-process mesh and the
    classification all-gather / EM count psum ride the collective fabric
    (gloo on CPU, NCCL on GPUs). Single-process runs (num_processes
    None/1) are a no-op; returns whether distributed mode was initialized.
    """
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def make_mesh(data: int | None = None, model: int | None = None, devices=None) -> Mesh:
    """Build a (data, model) mesh. Defaults: all devices on the data axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(devices.reshape(data, model), axis_names=("data", "model"))


def shard_reads(mesh: Mesh, reads, lengths):
    """Place padded reads/lengths sharded along the data axis.

    The batch must divide evenly by the data-axis size (NamedSharding
    requirement); use :func:`pad_batch` first for arbitrary read counts.
    """
    rs = NamedSharding(mesh, P("data", None))
    ls = NamedSharding(mesh, P("data"))
    return jax.device_put(reads, rs), jax.device_put(lengths, ls)


def pad_batch(mesh: Mesh, reads, lengths):
    """Zero-pad a read batch to a multiple of the mesh data-axis size.

    Pad rows have length 0, so they contribute nothing to training counts
    or scores. Returns (reads, lengths, n_orig); slice results back to
    ``n_orig`` rows after the sharded computation.
    """
    n = reads.shape[0]
    pad = (-n) % mesh.shape["data"]
    if pad:
        reads = np.pad(np.asarray(reads), ((0, pad), (0, 0)))
        lengths = np.pad(np.asarray(lengths), (0, pad))
    return reads, lengths, n


def materialize(x) -> np.ndarray:
    """Fetch a (possibly multi-host-sharded) array to a host numpy array.

    ``np.asarray`` raises for arrays spanning non-addressable devices; in
    multi-process mode the shards are exchanged with ``process_allgather``
    so every process sees the full array (the reference's file-merge join,
    scripts/phymm_par.py:410-474, as a DCN collective)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def is_output_process() -> bool:
    """True on the process that should write shared file artifacts."""
    return jax.process_index() == 0


def shard_bank(mesh: Mesh, bank_mip, bank_probs):
    """Place an ICM bank sharded along the model axis."""
    ms = NamedSharding(mesh, P("model"))
    return (
        jax.device_put(bank_mip, NamedSharding(mesh, P("model", None, None))),
        jax.device_put(bank_probs, NamedSharding(mesh, P("model", None, None, None))),
    )
