"""Sharded read classification and EM clustering steps.

Device reformulation of the reference's scale-out (SURVEY §2.4):

  * Phymm classification (scripts/scoreReadsGlim.pl:380-560 — every read
    scored against every ICM in the bank, forward and reverse-complement,
    per-read max): a dense (reads x models) score matrix. Reads shard over
    the ``data`` mesh axis, the bank over ``model``; XLA inserts the
    all-gather for the cross-model argmax/top-k.
  * Scimm EM iteration (SURVEY P12): classify -> hard-assign -> retrain
    per-cluster ICMs from count histograms (psum over data shards) ->
    repeat. One call to em_step is one full training step of the framework.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import icm_score, icm_train_device
from ..models import dna

import numpy as np


def revcomp_reads(reads, lengths):
    """Reverse-complement padded reads on device (pad stays at the tail)."""
    b, l = reads.shape
    comp = (3 - reads).astype(reads.dtype)  # a<->t, c<->g in index space
    idx = (lengths[:, None] - 1 - jnp.arange(l)[None, :]) % l
    rc = jnp.take_along_axis(comp, idx, axis=1)
    return jnp.where(jnp.arange(l)[None, :] < lengths[:, None], rc, 0)


@functools.partial(jax.jit, static_argnames=("model_len", "depth"))
def classify_step(bank_mip, bank_probs, reads, lengths, model_len=12, depth=7):
    """Score reads fwd + revcomp against the bank; per-read max over strands.

    Returns (scores (B, M) f32, best (B,) int32). Matches the Phymm driver's
    fwd/rev max (scoreReadsGlim.pl:450-482).
    """
    fwd = icm_score.bank_score_reads(bank_mip, bank_probs, reads, lengths, model_len, depth)
    rc = revcomp_reads(reads, lengths)
    rev = icm_score.bank_score_reads(bank_mip, bank_probs, rc, lengths, model_len, depth)
    scores = jnp.maximum(fwd, rev)
    return scores, jnp.argmax(scores, axis=1).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("n_models", "model_len", "depth", "periodicity")
)
def em_step(
    bank_mip,
    bank_probs,
    reads,
    lengths,
    n_models: int,
    model_len: int = 12,
    depth: int = 7,
    periodicity: int = 3,
):
    """One full Scimm-style EM training step on device.

    classify -> hard assignment -> retrain the whole bank from windowed
    context counts (chi-square deleted interpolation) -> return the new
    bank plus the assignment. Under a (data, model) mesh with reads sharded
    on ``data`` and the bank on ``model``, XLA turns the argmax into an
    all-gather and the count histograms into a psum.
    """
    scores, best = classify_step(bank_mip, bank_probs, reads, lengths, model_len, depth)
    assign = jax.nn.one_hot(best, n_models, dtype=jnp.float32)
    new_mip, new_probs = icm_train_device.train_icm_bank(
        reads.astype(jnp.int32),
        lengths,
        assign,
        n_models=n_models,
        model_len=model_len,
        depth=depth,
        periodicity=periodicity,
    )
    return new_mip, new_probs, best, scores


def pad_reads(seqs, length=None):
    """Encode + pad a list of sequences to a (B, L) int32 batch."""
    enc = [dna.encode(s) for s in seqs]
    lengths = np.array([len(e) for e in enc], dtype=np.int32)
    if length is None:
        length = int(max((len(e) for e in enc), default=0))
    reads = np.zeros((len(enc), length), dtype=np.int32)
    for i, e in enumerate(enc):
        reads[i, : len(e)] = e[:length]
    return reads, lengths
