"""Single dataclass configuration, field for field the same as the JAX
package's ``deepi2p_tpu.config``.

The port keeps its own copy (it must import on a machine without JAX);
``tests/test_torch_port_parts.py`` holds every field and preset equal to
the JAX package's.  ``compute_dtype`` is the activation dtype of the
forward (bf16 on the card, as on the TPU); the mesh fields are carried
unused until the port has a multi-device path.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Config:
    # --- identification -------------------------------------------------
    dataset: str = "oxford"            # 'kitti' | 'oxford' | 'nuscenes'
    version: str = "tpu-0.1"
    dataroot: str = ""
    checkpoints_dir: str = "checkpoints"
    is_debug: bool = False

    # --- task ------------------------------------------------------------
    is_fine_resolution: bool = True
    is_remove_ground: bool = False

    # --- point cloud / image geometry ------------------------------------
    input_pt_num: int = 20480
    pc_min_range: float = -1.0
    pc_max_range: float = 50.0
    node_a_num: int = 128
    node_b_num: int = 128
    k_ab: int = 16
    k_interp_ab: int = 3
    k_interp_point_a: int = 3
    k_interp_point_b: int = 3

    img_H: int = 384
    img_W: int = 640
    img_scale: float = 0.5
    img_fine_resolution_scale: int = 32
    crop_original_top_rows: int = 0
    crop_original_bottom_rows: int = 0

    # --- dataset specific sampling ---------------------------------------
    accumulation_frame_num: int = 3      # kitti / nuscenes
    accumulation_frame_skip: int = 6     # kitti / nuscenes
    delta_ij_max: int = 40               # kitti
    translation_max: float = 10.0
    test_translation_max: float = 10.0   # oxford
    pc_build_interval: int = 2           # oxford

    # --- pose perturbation amplitudes (camera coordinates) ----------------
    P_tx_amplitude: float = 0.0
    P_ty_amplitude: float = 0.0
    P_tz_amplitude: float = 0.0
    P_Rx_amplitude: float = 0.0
    P_Ry_amplitude: float = 2.0 * math.pi
    P_Rz_amplitude: float = 0.0

    # --- model ------------------------------------------------------------
    normalization: str = "batch"         # 'batch' | 'instance'
    norm_momentum: float = 0.1           # torch convention: ema += m*(batch-ema)
    activation: str = "relu"             # relu|elu|swish|leakyrelu|selu
    node_feature_a: int = 64             # Ca (reference KeypointDetector: Ca=64)
    node_feature_b: int = 256            # Cb
    global_feature: int = 512            # Cg

    # --- training ---------------------------------------------------------
    batch_size: int = 8
    lr: float = 1e-3
    lr_decay_step: int = 10
    lr_decay_scale: float = 0.5
    lr_clip: float = 1e-5
    epochs: int = 101
    coarse_loss_alpha: float = 50.0
    # >1 up-weights the inside-frustum coarse class in the focal loss
    # (deepi2p_tpu extension; 1.0 = exact reference loss).  The frustum
    # solver consumes inside-class recall, not accuracy — false negatives
    # repel the solve (round-3 e2e analysis, BENCH_NOTES.md).
    coarse_inside_weight: float = 1.0
    dataloader_threads: int = 10
    vis_max_batch: int = 4
    seed: int = 0

    # --- synthetic data ---------------------------------------------------
    # "uniform": random box cloud (shape/smoke tests, bench).  "street":
    # points on ground/facade/box surfaces — gives frustum membership a
    # translation-sensitive structure, so end-to-end synthetic training
    # can demonstrate full 4-DoF pose recovery (uniform clouds leave
    # translation nearly unidentifiable from noisy membership).
    synthetic_scene: str = "uniform"
    # Render the synthetic camera image from only the first
    # ``img_render_n`` points of the (already permuted) cloud; 0 renders
    # from all ``input_pt_num`` points (legacy behavior).  Rationale: in
    # the reference the image is a real photo, so its statistics NEVER
    # depend on the lidar point count — but a splat of the full cloud
    # couples the two, and evaluating an N=8192-trained model at
    # N=20480 silently makes the images 2.5x denser than anything it
    # trained on (round-5 n20k transfer analysis).  Pinning this to the
    # training N for every eval N restores the reference's invariant.
    img_render_n: int = 0

    # --- compute ----------------------------------------------------------
    compute_dtype: str = "bfloat16"      # activation dtype of the forward
    remat: bool = False                  # rematerialise MLP activations
    param_dtype: str = "float32"
    mesh_data: int = -1                  # -1 => all devices on the data axis
    mesh_model: int = 1

    # ----------------------------------------------------------------------
    @property
    def H_fine_res(self) -> int:
        return int(round(self.img_H / self.img_fine_resolution_scale))

    @property
    def W_fine_res(self) -> int:
        return int(round(self.img_W / self.img_fine_resolution_scale))

    @property
    def num_fine_classes(self) -> int:
        return self.H_fine_res * self.W_fine_res

    @property
    def fine_out_channels(self) -> int:
        return 2 + self.num_fine_classes if self.is_fine_resolution else 2

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def kitti(**overrides) -> Config:
    """KITTI configuration (reference ``kitti/options.py:6-60``)."""
    cfg = Config(
        dataset="kitti",
        img_H=160, img_W=512, img_scale=0.5,
        crop_original_top_rows=50,
        pc_max_range=80.0,
        accumulation_frame_num=3, accumulation_frame_skip=6,
        delta_ij_max=40, translation_max=10.0,
        P_tx_amplitude=0.0, P_ty_amplitude=0.0, P_tz_amplitude=0.0,
        P_Rx_amplitude=0.0, P_Ry_amplitude=2.0 * math.pi, P_Rz_amplitude=0.0,
        batch_size=8, lr_decay_step=20,
    )
    return cfg.replace(**overrides) if overrides else cfg


def oxford(**overrides) -> Config:
    """Oxford configuration (reference ``oxford/options.py:6-59``)."""
    cfg = Config(
        dataset="oxford",
        img_H=384, img_W=640, img_scale=0.5,
        crop_original_bottom_rows=0,
        pc_max_range=50.0,
        pc_build_interval=2, translation_max=10.0, test_translation_max=10.0,
        P_tx_amplitude=10.0, P_ty_amplitude=5.0, P_tz_amplitude=10.0,
        P_Rx_amplitude=0.0, P_Ry_amplitude=2.0 * math.pi, P_Rz_amplitude=0.0,
        batch_size=8, lr_decay_step=10,
    )
    return cfg.replace(**overrides) if overrides else cfg


def nuscenes(**overrides) -> Config:
    """nuScenes configuration (reference ``nuscenes_t/options.py:6-58``)."""
    cfg = Config(
        dataset="nuscenes",
        img_H=160, img_W=320, img_scale=0.2,
        crop_original_top_rows=100,
        pc_max_range=0.0,  # no range limit in the reference loader
        accumulation_frame_num=3, accumulation_frame_skip=4,
        translation_max=10.0,
        P_tx_amplitude=0.0, P_ty_amplitude=0.0, P_tz_amplitude=0.0,
        # nuScenes rotates about z (up axis in ENU): nuscenes_t/options.py:42
        P_Rx_amplitude=0.0, P_Ry_amplitude=0.0, P_Rz_amplitude=2.0 * math.pi,
        batch_size=12, lr_decay_step=15,
    )
    return cfg.replace(**overrides) if overrides else cfg


def tiny(**overrides) -> Config:
    """A tiny configuration for unit tests and multi-chip dry-runs."""
    cfg = Config(
        dataset="oxford",
        input_pt_num=256, node_a_num=16, node_b_num=16,
        k_ab=4, img_H=64, img_W=96, img_fine_resolution_scale=32,
        batch_size=2, compute_dtype="float32",
    )
    return cfg.replace(**overrides) if overrides else cfg
