"""Registration of the port: the frustum LM solve (CUDA kernel on the
card, plain version on the CPU), ICP (1-NN kernel on the card) and the
error metrics."""
from .frustum import (frustum_cost, initial_guess, lm_solve_generic,
                      rodrigues, sample_inits, solve_frustum_batch,
                      theta_to_pose)
from .frustum_cuda import lm_solve, lm_solve_cuda, lm_solve_plain
from .icp import icp_batch, icp_point_to_point, icp_random_init
from .metrics import pose_diff, pose_diff_np, registration_summary
