"""Point-cloud ops of the port; :func:`knn` runs the CUDA kNN kernel on
the card and its plain version on the CPU."""
from .interpolate import interpolate_inverse_dist
from .knn import gather_knn, knn, knn_plain, pairwise_dist2
from .segment import (node_count, node_mean_and_count, node_pool_max,
                      scatter_to_points)
