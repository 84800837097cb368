"""The port's 1-NN (plain version on the CPU, the CUDA kernel's oracle)
against the JAX package's ``nn1_pallas`` in interpret mode and a numpy
brute force, on the same inputs.

Tolerances: indices equal everywhere, ties to the lowest index.  The port
and the numpy brute force sum the same f32 squares of direct differences
in coordinate order: distances bitwise equal.  The Pallas interpreter runs
on XLA's CPU backend, which contracts multiply-adds into FMAs, so its
distances differ by up to an ulp: 1e-6 relative there."""
import jax  # noqa: F401  (port tests hold both frameworks)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.ops.knn_pallas import nn1_pallas
from deepi2p_tpu_torch.ops.knn import nn1, nn1_plain
from deepi2p_tpu_torch.ops.knn_cuda import (NN1_TILE, NN1_TRACK, NN1Card,
                                             NN1Plan, nn1_cuda, nn1_plan)

# An H100 as the CUDA runtime describes it to nn1_plan: 132 SMs, 227 KB of
# shared memory per block; two resident blocks per SM (238 registers per
# thread), one for a 160 KB database
H100 = NN1Card(sms=132, block_smem=232448, per_sm=2)


def _brute(q, db):
    """numpy f32: (S, N, D) against (S, M, D) -> (d2, first argmin)."""
    d2 = None
    for d in range(q.shape[-1]):
        diff = db[:, None, :, d] - q[:, :, None, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    idx = np.argmin(d2, axis=-1)
    return np.take_along_axis(d2, idx[..., None], -1)[..., 0], idx


def _inputs(seed, B, Q, N, M, D):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B * Q, N, D)) * 5).astype(np.float32)
    db = (rng.normal(size=(B, M, D)) * 5).astype(np.float32)
    # duplicated rows, in one chunk and across the 512-row chunk
    # boundary: tied distances, the lowest index wins
    db[0, min(700, M - 1)] = db[0, 3]
    db[0, 5] = db[0, 3]
    q[0, :3] = db[0, 3]
    q[1, 3] = db[0, 3] + 1e-3
    return q, db


# M: one chunk, a ragged tail, several chunks with a ragged tail
@pytest.mark.parametrize("M", [37, 512, 1100])
@pytest.mark.parametrize("D", [3, 5])
def test_nn1_matches_pallas_and_bruteforce(M, D):
    B, Q, N = 2, 3, 150
    q, db = _inputs(M * 10 + D, B, Q, N, M, D)
    d2_t, idx_t = nn1(torch.from_numpy(q), torch.from_numpy(db))
    assert d2_t.dtype == torch.float32 and idx_t.dtype == torch.int32
    assert tuple(idx_t.shape) == (B * Q, N)
    db_rep = np.repeat(db, Q, axis=0)          # set s against database s//Q
    d2_b, idx_b = _brute(q, db_rep)
    np.testing.assert_array_equal(idx_t.numpy(), idx_b)
    np.testing.assert_array_equal(d2_t.numpy(), d2_b)
    d2_p, idx_p = nn1_pallas(jnp.asarray(q), jnp.asarray(db_rep),
                             interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=1e-6,
                               atol=0)
    assert idx_t[0, 0] == 3 and idx_t[0, 1] == 3


def test_nn1_sentinel_padding_is_never_chosen():
    """The harness pads pseudo clouds to a common M with 1e6 rows."""
    q, db = _inputs(3, 2, 2, 200, 600, 3)
    db[:, 450:] = 1e6
    d2_t, idx_t = nn1_plain(torch.from_numpy(q), torch.from_numpy(db))
    assert int(idx_t.max()) < 450
    d2_p, idx_p = nn1_pallas(jnp.asarray(q),
                             jnp.asarray(np.repeat(db, 2, 0)), interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("chunk", [1, 7, 512, 4096])
def test_nn1_plain_chunking_does_not_change_the_answer(chunk):
    q, db = _inputs(4, 1, 2, 90, 1030, 3)
    ref = _brute(q, np.repeat(db, 2, 0))
    d2, idx = nn1_plain(torch.from_numpy(q), torch.from_numpy(db),
                        chunk=chunk)
    np.testing.assert_array_equal(idx.numpy(), ref[1])
    np.testing.assert_array_equal(d2.numpy(), ref[0])


def test_nn1_nan_distances_sort_last_and_indices_stay_in_range():
    """A NaN distance never beats a number; a query whose distances are
    all NaN gets d2 NaN and index 0 (the Pallas kernel can return an index
    >= M there, which the port never writes)."""
    q = np.zeros((1, 3, 3), np.float32)
    q[0, 1, 0] = np.nan
    q[0, 2] = [5.0, 0.0, 0.0]
    db = np.zeros((1, 700, 3), np.float32)
    db[0, :, 0] = np.arange(700, dtype=np.float32)
    db[0, 0, 1] = np.nan                        # row 0 is NaN
    db[0, 600, 1] = np.nan                      # a NaN row in chunk 2
    d2, idx = nn1_plain(torch.from_numpy(q), torch.from_numpy(db))
    assert idx[0].tolist() == [1, 0, 5]
    assert d2[0, 0] == 1.0 and d2[0, 2] == 0.0
    assert np.isnan(d2[0, 1].item())


def test_nn1_cuda_refuses_cpu_tensors():
    q, db = _inputs(0, 1, 2, 10, 20, 3)
    nn1_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        nn1_cuda(torch.from_numpy(q), torch.from_numpy(db))
    assert nn1_cuda.launches == 0


def test_nn1_plan():
    """The kernel's launch: 16 queries per thread (8 for D > 4), 2048-query
    chunks; at the ICP launch (512 sets of 20480 against 8 clouds of 5120)
    each cloud stays in shared memory (80 KB) and 32 blocks walk its 640
    chunks, 20 each: 256 blocks on the H100's 264 places of two per SM.
    One init group gets one block per chunk; a database of 20000 rows is
    too large for shared memory and streams; 5120 rows of D=8 fit once
    per SM.  The spread follows the card: on half the SMs the ICP
    launch's 5120 chunks go 39 to a block, 17 blocks per cloud."""
    assert NN1_TRACK == 64 and NN1_TILE == 1024   # read from csrc/nn1.cu
    assert nn1_plan(512, 20480, 5120, 3, 8, H100) == NN1Plan(
        qt=16, chunk=2048, chunks=640, blocks=32, resident=True)
    assert nn1_plan(8, 20480, 5120, 3, 1, H100) == NN1Plan(
        16, 2048, 80, 80, True)
    assert nn1_plan(8, 1000, 20000, 3, 1, H100) == NN1Plan(
        16, 2048, 4, 4, False)
    assert nn1_plan(4, 100, 5120, 8, 2, H100._replace(per_sm=1)) == NN1Plan(
        8, 1024, 1, 1, True)
    assert nn1_plan(512, 20480, 5120, 3, 8, H100._replace(sms=66)) == \
        NN1Plan(16, 2048, 640, 17, True)


def test_nn1_ties_across_the_kernels_tiles_and_chunks_match_pallas():
    """Ties the kernel meets at its own boundaries: a row duplicated at 0
    and M-1 (the first and the last tracked tile), at the edge of a
    tracked tile (rows NN1_TRACK-1 and NN1_TRACK) and at the edge of a
    streamed tile (rows NN1_TILE-1 and NN1_TILE), with queries on them
    at the last place of one query chunk and the first of the next.  The
    lowest index wins, as in ``nn1_pallas`` and the numpy brute force."""
    B, Q, N, M, D = 1, 2, 1100, 1100, 3
    q, db = _inputs(11, B, Q, N, M, D)
    T = NN1_TRACK
    db[0, M - 1] = db[0, 0]
    db[0, T] = db[0, T - 1]
    db[0, NN1_TILE] = db[0, NN1_TILE - 1]
    chunk = nn1_plan(B * Q, N, M, D, B, H100).chunk
    flat = q.reshape(B * Q * N, D)
    for k, row in enumerate((0, T - 1, NN1_TILE - 1)):
        flat[chunk - 1 - k] = db[0, row]
        flat[chunk + k] = db[0, row] + np.float32(1e-3)
    d2_t, idx_t = nn1_plain(torch.from_numpy(q), torch.from_numpy(db))
    want = {chunk - 1: 0, chunk: 0, chunk - 2: T - 1, chunk + 1: T - 1,
            chunk - 3: NN1_TILE - 1, chunk + 2: NN1_TILE - 1}
    got = idx_t.numpy().reshape(-1)
    assert {p: int(got[p]) for p in want} == want
    d2_b, idx_b = _brute(q, np.repeat(db, Q, axis=0))
    np.testing.assert_array_equal(idx_t.numpy(), idx_b)
    np.testing.assert_array_equal(d2_t.numpy(), d2_b)
    d2_p, idx_p = nn1_pallas(jnp.asarray(q), jnp.asarray(np.repeat(db, Q, 0)),
                             interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=1e-6,
                               atol=0)
