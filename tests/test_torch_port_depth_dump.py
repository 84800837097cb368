"""``eval.cli depth-dump`` of the port against the JAX package's on the
same images and weights (the JAX one from an orbax save, the port's from
``depth.npz``): the ``_pc.npy`` clouds within 1e-4 relative; then the
port's ``solve --method icp --pseudo-dir`` on them on the CPU."""
import os

import numpy as np

from deepi2p_tpu.eval import cli as jax_eval_cli
from deepi2p_tpu.train import depth_cli as jax_depth_cli
from deepi2p_tpu_torch.eval import cli as eval_cli
from deepi2p_tpu_torch.train import depth_cli
from test_torch_port_depth import jax_init, rel


def test_depth_dump_matches_jax_then_icp(tmp_path):
    """A tiny dump with images -> each package's ``depth-dump`` on the
    same weights (the JAX one from an orbax save, the port's from
    ``depth.npz``) -> the port's ICP solve on the port's clouds."""
    dump_dir, jout, pout = (str(tmp_path / n) for n in ("dump", "j", "p"))
    eval_cli.main(["dump", "--dataset", "synthetic", "--dump-len", "4",
                   "--batch-size", "2", "--synthetic-scene", "street",
                   "--save-images", "--out", dump_dir, "--device", "cpu"])
    imgs = sorted(f for f in os.listdir(dump_dir) if f.endswith("_img.npy"))
    assert len(imgs) == 4
    ex = np.load(os.path.join(dump_dir, imgs[0]))[None]
    _, params = jax_init((16, 32, 64, 128), ex, seed=1)
    jax_depth_cli.save_depth_params(params, str(tmp_path / "orbax"))
    depth_cli.save_depth_params(params, str(tmp_path / "npz"))
    assert jax_eval_cli.main(["depth-dump", "--data-dir", dump_dir,
                              "--depth-checkpoint", str(tmp_path / "orbax"),
                              "--out", jout]) == 4
    assert eval_cli.main(["depth-dump", "--data-dir", dump_dir,
                          "--depth-checkpoint",
                          str(tmp_path / "npz" / "depth.npz"),
                          "--out", pout, "--device", "cpu"]) == 4
    for f in sorted(os.listdir(jout)):
        ref, got = np.load(os.path.join(jout, f)), np.load(
            os.path.join(pout, f))
        assert got.shape == ref.shape and got.shape[0] == 3
        assert rel(got, ref) < 1e-4, f
    summ = eval_cli.main(["solve", "--data-dir", dump_dir, "--method", "icp",
                          "--pseudo-dir", pout, "--img-h", "64",
                          "--img-w", "96", "--n-inits", "8", "--max-iter",
                          "16", "--device", "cpu"])
    assert summ["num_pairs"] == 4
    assert np.isfinite(summ["rte_mean"]) and np.isfinite(summ["rre_mean"])
