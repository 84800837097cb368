"""Tiny sizes at which the CPU tests run the cells (the widths stay)."""
import time

from portbench import run

CONFIG = {"input_pt_num": 512, "node_a_num": 16, "node_b_num": 16,
          "k_ab": 4, "img_H": 64, "img_W": 128}
TRAFFIC = {
    "oxford.register": {"batch": 2, "pool": 2, "calib_pairs": 2,
                        "check_pairs": 4, "profile_batches": 1,
                        "warmup": 1},
    "kitti.train": {"batch": 2, "pool": 3, "profile_batches": 1},
    "kitti.icp": {"batch": 2, "pool": 2, "profile_batches": 1,
                  "max_iter": 5},
}
CELLS = tuple(TRAFFIC)
SEED = 2 ** 31           # over 32 signed bits


def run_tiny(cell, trace=False, seed=SEED, seconds=0.3, **kw):
    """One CPU run of ``cell`` at the tiny sizes: (result, checks)."""
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        overrides={"config": CONFIG,
                                   "traffic": TRAFFIC[cell]},
                        t0=time.monotonic(), **kw)
