"""Bank scoring, device trainer, and sharded classification/EM tests."""

import numpy as np
import pytest
import jax

from glimmer_mg_tpu.models import dna, icm as icm_mod, icm_train
from glimmer_mg_tpu.ops import icm_score, icm_train_device
from glimmer_mg_tpu.parallel import classify as pclassify
from glimmer_mg_tpu.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def golden():
    """A full-width (depth-7, model_len 12) ICM trained on the host from a
    seeded bench_db genome."""
    from glimmer_mg_tpu import bench_db

    genome = bench_db.make_genome(np.random.default_rng(21), 0.45, n_genes=30)
    return icm_train.train_icm([dna.encode(genome.lower())])


def test_bank_scoring_matches_host_walk(golden):
    """PhymmBank.score_reads (fwd/rev max over the XLA walk) equals the
    host numpy walk summed in f64, within f32 summation-order error; the
    short last batch is padded to the batch shape."""
    from glimmer_mg_tpu.parallel import phymm

    rng = np.random.default_rng(4)
    icms = [golden] + [
        icm_mod.ICM(12, 7, 3, golden.mip.copy(),
                    (golden.probs - np.float32(0.05 * k)))
        for k in range(1, 3)
    ]
    mip, probs = icm_score.stack_bank(icms)
    bank = phymm.PhymmBank(["a", "b", "c"], mip, probs, 12, 7)
    seqs = ["".join(rng.choice(list("acgt"), int(n)))
            for n in rng.integers(5, 200, 7)]
    got = bank.score_reads(seqs, batch=3)
    want = np.zeros_like(got, dtype=np.float64)
    for r, s in enumerate(seqs):
        enc = dna.encode(s)
        rc = dna.COMPLEMENT_INDEX[enc][::-1]
        for m, icm in enumerate(icms):
            fwd = icm_mod.per_base_logprob_vec(icm, enc, 0).astype(np.float64)
            rev = icm_mod.per_base_logprob_vec(icm, rc, 0).astype(np.float64)
            want[r, m] = max(fwd.sum(), rev.sum())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_revcomp_reads():
    rng = np.random.default_rng(1)
    reads = rng.integers(0, 4, (3, 20), dtype=np.int32)
    lengths = np.array([20, 13, 5], np.int32)
    rc = np.asarray(pclassify.revcomp_reads(reads, lengths))
    for i, l in enumerate(lengths):
        want = dna.COMPLEMENT_INDEX[reads[i, :l]][::-1]
        np.testing.assert_array_equal(rc[i, :l], want)
        assert (rc[i, l:] == 0).all()


def test_device_trainer_matches_host():
    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("acgt"), 400)) for _ in range(30)]
    enc = [dna.encode(s) for s in seqs]
    host = icm_train.train_icm(enc, model_len=12, depth=4)

    reads, lengths = pclassify.pad_reads(seqs)
    assign = np.ones((len(seqs), 1), dtype=np.float32)
    mip, probs = icm_train_device.train_icm_bank(
        reads, lengths, assign, n_models=1, model_len=12, depth=4
    )
    mip = np.asarray(mip)[0]
    probs = np.asarray(probs)[0]
    # trees must agree except where float32 MI rounding flips near-ties
    agree = (mip == host.mip).mean()
    assert agree > 0.995, f"tree agreement {agree}"
    same = mip == host.mip
    alive = (host.mip >= -1) & same
    d = np.abs(probs[alive] - host.probs[alive])
    assert d.max() < 2e-2, d.max()


def test_bank_scale_sharded_classification(golden):
    """Realistic Phymm bank scale (256 models): classification sharded over
    the model axis of the 8-device mesh equals the unsharded scores
    (VERDICT r1 item 6; reference banks are hundreds of ICMs,
    scoreReadsGlim.pl:380-560)."""
    rng = np.random.default_rng(7)
    base = icm_mod.ICM(12, 4, 3, golden.mip[:, : icm_mod.num_tree_nodes(4)].copy(),
                       golden.probs[:, : icm_mod.num_tree_nodes(4)].copy())
    icms = [
        icm_mod.ICM(
            12, 4, 3, base.mip.copy(),
            (base.probs * (1.0 + 0.02 * rng.standard_normal(base.probs.shape)))
            .astype(np.float32),
        )
        for _ in range(256)
    ]
    mip, probs = icm_score.stack_bank(icms)
    reads = rng.integers(0, 4, (16, 300), dtype=np.int32)
    lengths = rng.integers(30, 301, 16).astype(np.int32)

    want, best_want = pclassify.classify_step(mip, probs, reads, lengths, 12, 4)

    mesh = pmesh.make_mesh(data=1, model=8)
    reads_s, lengths_s = pmesh.shard_reads(mesh, reads, lengths)
    mip_s, probs_s = pmesh.shard_bank(mesh, mip, probs)
    with mesh:
        got, best = pclassify.classify_step(mip_s, probs_s, reads_s, lengths_s, 12, 4)
        jax.block_until_ready(got)
    assert got.shape == (16, 256)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(best_want))


def test_sharded_em_step_runs():
    mesh = pmesh.make_mesh(data=4, model=2)
    rng = np.random.default_rng(3)
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
    reads_s, lengths_s = pmesh.shard_reads(mesh, reads, lengths)
    mip_s, probs_s = pmesh.shard_bank(mesh, mip, probs)
    with mesh:
        new_mip, new_probs, best, scores = pclassify.em_step(
            mip_s, probs_s, reads_s, lengths_s, n_models=2, model_len=12, depth=2
        )
        jax.block_until_ready((new_mip, new_probs))
    assert scores.shape == (16, 2)
    assert new_mip.shape == (2, 3, icm_mod.num_tree_nodes(2))
    # classification agrees with single-device scoring
    want, best_want = pclassify.classify_step(mip, probs, reads, lengths, 12, 2)
    np.testing.assert_allclose(np.asarray(scores), np.asarray(want), rtol=1e-5, atol=1e-3)
