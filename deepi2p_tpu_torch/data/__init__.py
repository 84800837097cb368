"""Data path of the port (numpy on the host, torch at the hand-over): the
KITTI, Oxford and nuScenes loaders, synthetic batches, OpenCV-free
augmentation and image decoding, the native sampling core, the threaded
batch loader and the pinned-memory prefetch to the card.  The exports mirror the JAX package's
``deepi2p_tpu.data``."""
from .base import collate, crop_K, scale_K
from .kitti import KittiCalib, KittiLoader
from .loader import BatchLoader, device_prefetch
from .nuscenes import NuScenesLoader, enu2cam
from .oxford import OxfordLoader
from .synthetic import SyntheticDataset, batch_to_torch, synthetic_batch
