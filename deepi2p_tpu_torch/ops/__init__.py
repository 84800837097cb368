"""Point-cloud ops of the port; :func:`knn` and :func:`nn1` run their
CUDA kernels on the card and their plain versions on the CPU."""
from .interpolate import interpolate_inverse_dist
from .knn import gather_knn, knn, knn_plain, nn1, nn1_plain, pairwise_dist2
from .projection import generate_labels, project_points
from .segment import (node_count, node_mean_and_count, node_pool_max,
                      scatter_to_points)
