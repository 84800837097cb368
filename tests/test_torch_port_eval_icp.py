"""The port's harness with ``method="icp"`` against the JAX package's on
the JAX tests' own ICP problem (test_register_extra.py:251-282): the same
success rate, with blind inits and seeded from the frustum solution."""
import os

import jax  # noqa: F401  (port tests hold both frameworks)
import numpy as np
import pytest

from deepi2p_tpu.eval import dump as jdump
from deepi2p_tpu.eval.harness import evaluate_registration as jax_eval
from deepi2p_tpu_torch.eval.harness import evaluate_registration

from test_register_extra import H, K_np, W


def _icp_dumps(out, pdir, rng):
    """test_register_extra.py::test_icp_harness_end_to_end's data: pseudo
    clouds of varying sizes in the camera frame."""
    os.makedirs(out)
    os.makedirs(pdir)
    for i in range(3):
        pc = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
        ry = rng.uniform(-0.1, 0.1)
        c, s = np.cos(ry), np.sin(ry)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        P[:3, 3] = [rng.uniform(-0.5, 0.5), 0.0, rng.uniform(-0.5, 0.5)]
        cam = pc @ P[:3, :3].T + P[:3, 3]
        inside = (cam[:, 2] > 0).astype(np.int64)
        zeros = np.zeros(256, np.int64)
        jdump.save_sample_dump(out, f"{i:06d}_00", pc=pc, coarse_pred=inside,
                               coarse_label=inside, fine_pred=zeros,
                               fine_label=zeros, K=K_np, P=P[:3])
        np.save(os.path.join(pdir, f"{i:06d}_00_pc.npy"),
                cam[:200 + i * 24].T)


@pytest.mark.parametrize("icp_seed", ["none", "frustum"])
def test_icp_harness_on_the_jax_tests_problem(tmp_path, icp_seed):
    """The JAX test's ICP run (3 pairs, 24 inits, 25 iterations, pseudo
    clouds of 200-248 points): the same success rate as the JAX harness,
    blind and seeded from the frustum solution."""
    out, pdir = str(tmp_path / "dump"), str(tmp_path / "pseudo")
    _icp_dumps(out, pdir, np.random.default_rng(6))
    kw = dict(method="icp", H=H, W=W, n_inits=24, max_iter=25,
              pseudo_dir=pdir, batch_size=3, icp_seed=icp_seed)
    s_t = evaluate_registration(out, device="cpu", **kw)
    s_j = jax_eval(out, **kw)
    assert s_t["num_pairs"] == 3
    assert s_t["success_rate"] == s_j["success_rate"]
    assert s_t["success_rate"] >= 1.0 / 3.0
