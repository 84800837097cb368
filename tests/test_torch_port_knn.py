"""The port's kNN (plain version on the CPU) against the JAX package's
``knn_pallas`` in interpret mode and its XLA ``knn``, on the same inputs."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepi2p_tpu.ops.knn import knn as jax_knn
from deepi2p_tpu.ops.knn_pallas import knn_pallas
from deepi2p_tpu_torch.ops.knn import gather_knn, knn, knn_plain
from deepi2p_tpu_torch.ops.knn_cuda import knn_cuda

CASES = [(M, k, D) for M, k, D in itertools.product((8, 128), (1, 3, 16),
                                                      (3, 6)) if k <= M]


def _inputs(M, D, seed, B=2, N=300):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 1.0, (B, N, D)).astype(np.float32)
    db = rng.uniform(0.0, 1.0, (B, M, D)).astype(np.float32)
    # duplicated database rows: tied distances, lowest index first
    db[0, M - 1] = db[0, 0]
    db[1, M // 2] = db[1, 1]
    q[0, :4] = db[0, 0]            # queries sitting on a duplicated row
    return q, db


@pytest.mark.parametrize("M,k,D", CASES)
def test_knn_matches_pallas_and_xla(M, k, D):
    q, db = _inputs(M, D, seed=M * 100 + k * 10 + D)
    d2_t, idx_t = knn(torch.from_numpy(q), torch.from_numpy(db), k)
    assert idx_t.dtype == torch.int32 and tuple(idx_t.shape) == (2, 300, k)
    d2_p, idx_p = knn_pallas(jnp.asarray(q), jnp.asarray(db), k,
                             interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=0,
                               atol=1e-6)
    # the XLA path forms |x|^2 + |y|^2 - 2 x.y, whose cancellation costs up
    # to ~eps * 4D (< 3e-6 at D=6 in the unit cube): a looser d2 bound
    # there, the same indices
    d2_x, idx_x = jax_knn(jnp.asarray(q), jnp.asarray(db), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_x))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_x), rtol=0,
                               atol=5e-6)


def test_knn_ties_go_to_lowest_index():
    db = np.zeros((1, 8, 3), np.float32)
    db[0, :, 0] = [3, 1, 2, 1, 1, 0, 2, 3]
    q = np.zeros((1, 1, 3), np.float32)
    d2, idx = knn_plain(torch.from_numpy(q), torch.from_numpy(db), 8)
    assert idx[0, 0].tolist() == [5, 1, 3, 4, 2, 6, 0, 7]
    assert d2[0, 0].tolist() == [0, 1, 1, 1, 4, 4, 9, 9]


def test_knn_nan_sorts_last_and_indices_stay_in_range():
    q = np.zeros((1, 2, 3), np.float32)
    db = np.arange(24, dtype=np.float32).reshape(1, 8, 3)
    db[0, 2] = np.nan
    q[0, 1] = np.nan
    _, idx = knn_plain(torch.from_numpy(q), torch.from_numpy(db), 8)
    assert idx[0, 0].tolist() == [0, 1, 3, 4, 5, 6, 7, 2]
    assert idx[0, 1].tolist() == list(range(8))


def test_gather_knn_matches_jax():
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 16, 5)).astype(np.float32)
    idx = rng.integers(0, 16, (2, 7, 3)).astype(np.int32)
    from deepi2p_tpu.ops.knn import gather_knn as jax_gather
    np.testing.assert_array_equal(
        gather_knn(torch.from_numpy(feat), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_gather(jnp.asarray(feat), jnp.asarray(idx))))


def test_knn_cuda_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda(q, q, 1)


def _on_duplicates(M, N, seed, B=2, D=3):
    """Database rows duplicated in pairs, queries sitting on some of them:
    every such query has tied nearest rows."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1.0, 1.0, (B, M, D)).astype(np.float32)
    half = M // 2
    db[:, half:2 * half] = db[:, :half]
    q = rng.uniform(-1.0, 1.0, (B, N, D)).astype(np.float32)
    q[:, :min(N, M)] = db[:, :min(N, M)]
    return q, db


# the main path's kNN widths (M=128 with k=3 and k=16), k = M = 16 and the
# largest database the kernel takes (M=512, k=16), with ties everywhere
@pytest.mark.parametrize("M,k", [(128, 3), (128, 16), (16, 16), (512, 16)])
def test_knn_ties_at_main_path_widths_match_pallas(M, k):
    q, db = _on_duplicates(M, N=300, seed=M + k)
    d2_t, idx_t = knn(torch.from_numpy(q), torch.from_numpy(db), k)
    d2_p, idx_p = knn_pallas(jnp.asarray(q), jnp.asarray(db), k,
                             interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_p), rtol=0,
                               atol=1e-6)
    # a query on a duplicated row: that row and its copy, lowest first
    half = M // 2
    assert idx_t[0, 0, :2].tolist() == [0, half]


def _stable_numpy_knn(q, db, k):
    """numpy's stable argsort of the direct distances (NaN last)."""
    d2 = ((db[:, None, :, :] - q[:, :, None, :]) ** 2).sum(-1,
                                                          dtype=np.float32)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d2, idx, -1), idx.astype(np.int32)


# NaN rows and NaN queries: numpy's stable sort is the oracle here, since
# the Pallas kernel has no answer there (next test)
@pytest.mark.parametrize("M,k", [(128, 16), (16, 16), (128, 3)])
def test_knn_nan_rows_and_queries_sort_last_stably(M, k):
    q, db = _on_duplicates(M, N=64, seed=3 * M + k)
    db[:, ::5] = np.nan
    q[:, ::7] = np.nan
    with np.errstate(invalid="ignore"):
        d2_n, idx_n = _stable_numpy_knn(q, db, k)
    d2_t, idx_t = knn(torch.from_numpy(q), torch.from_numpy(db), k)
    np.testing.assert_array_equal(idx_t.numpy(), idx_n)
    assert int(idx_t.max()) < M and int(idx_t.min()) >= 0
    np.testing.assert_array_equal(np.isnan(d2_t.numpy()), np.isnan(d2_n))
    # a NaN query: every distance NaN, so the first k rows in index order
    assert idx_t[0, 0].tolist() == list(range(k))


def test_knn_nan_where_pallas_has_no_answer():
    """knn_pallas's min over a column with a NaN is NaN and matches no
    row, so it writes index M; the port writes the stable order, NaN
    rows after every number."""
    q, db = _on_duplicates(16, N=8, seed=0)
    db[0, 3] = np.nan
    _, idx_p = knn_pallas(jnp.asarray(q), jnp.asarray(db), 4, interpret=True)
    assert bool((np.asarray(idx_p)[0] == 16).all())
    _, idx_t = knn(torch.from_numpy(q), torch.from_numpy(db), 16)
    assert bool((idx_t[0, :, -1] == 3).all())
    assert int(idx_t.max()) < 16
