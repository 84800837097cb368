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
from deepi2p_tpu_torch.ops.knn_cuda import nn1_cuda


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
