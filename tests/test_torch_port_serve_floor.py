"""The floor that ``chip_smoke.py``'s ``serve`` phase holds the card's PnP
to: the JAX package's harness (``method="pnp"``, ``use_labels``, seed 0)
on the serve dump's pairs (``config.kitti`` street scenes, B=8, N=20480,
seed 0; labels of the true pose) solves ``PNP_LABELS_JAX_SUCCESS`` of
them on the CPU."""
import jax.numpy as jnp
import numpy as np

import chip_smoke
from deepi2p_tpu.eval.harness import evaluate_registration as jax_eval
from deepi2p_tpu.ops.projection import generate_labels
from deepi2p_tpu_torch import config
from deepi2p_tpu_torch.data import synthetic_batch
from deepi2p_tpu_torch.eval.dump import save_sample_dump


def test_jax_harness_pnp_success_on_the_serve_labels(tmp_path):
    cfg = config.kitti(synthetic_scene="street",
                       batch_size=chip_smoke.EVAL_BATCH)
    raw = synthetic_batch(cfg, seed=0)
    lab = generate_labels(*(jnp.asarray(raw[k]) for k in ("pc", "P", "K")),
                          cfg.img_H, cfg.img_W,
                          cfg.img_fine_resolution_scale)
    zero = np.zeros(cfg.input_pt_num)
    for b in range(cfg.batch_size):
        save_sample_dump(str(tmp_path), f"{b:06d}_00", pc=raw["pc"][b],
                         coarse_pred=zero,
                         coarse_label=np.asarray(lab.coarse[b]),
                         fine_pred=zero, fine_label=np.asarray(lab.fine[b]),
                         K=raw["K"][b], P=raw["P"][b])
    summ = jax_eval(str(tmp_path), method="pnp", use_labels=True,
                    H=cfg.img_H, W=cfg.img_W, batch_size=cfg.batch_size)
    assert summ["num_pairs"] == cfg.batch_size
    ok = round(summ["success_rate"] * cfg.batch_size)
    assert ok == chip_smoke.PNP_LABELS_JAX_SUCCESS, summ
