"""The port's label-corruption models (``register/noise.py``) against the
JAX package's: the same generator state gives the same flips, bitwise,
and leaves the generator in the same state."""
import numpy as np
import pytest

from deepi2p_tpu.register import noise as jn
from deepi2p_tpu_torch.register import noise as tn

from test_frustum import H, K_np, W, _make_problem


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(4)
    return _make_problem(rng, 0.7, np.array([0.5, 0.0, -1.0], np.float32),
                         n=4096)


CALLS = {
    "flip_iid": lambda m, r, pc, lab, P: m.flip_iid(r, lab, 0.1),
    "flip_sectors": lambda m, r, pc, lab, P: m.flip_sectors(
        r, pc, lab, n_sectors=32, n_flipped=3),
    "flip_border_band": lambda m, r, pc, lab, P: m.flip_border_band(
        r, lab, pc, P, K_np, H, W, band_px=40.0, rate=0.5),
    "drop_insiders": lambda m, r, pc, lab, P: m.drop_insiders(
        r, lab, miss_rate=0.3, fp_rate=0.05),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_noise_bitwise(sample, name):
    pc, labels, P = sample
    outs = []
    for mod in (jn, tn):
        rng = np.random.default_rng(9)
        out = CALLS[name](mod, rng, pc, labels, P)
        outs.append((out, rng.bit_generator.state))
    (a, sa), (b, sb) = outs
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sa == sb
    assert tn.error_rate(labels, b) == jn.error_rate(labels, a) > 0.0
