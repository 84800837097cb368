"""Offline dataset preparation of the port, counterpart of the JAX
package's ``data/prep`` (reference ``data/kitti/*.py``,
``data/oxford/build_dataset.py``, ``data/nuscenes/make_datasets.py``):
numpy on the host, the port's native core for kNN and voxel averages, its
own PNG reader and JPEG encoder for images; no OpenCV."""
from .kitti_prep import (estimate_normals, prepare_kitti_velodyne,
                         kitti_png_to_npy, kitti_poses_to_npz)
