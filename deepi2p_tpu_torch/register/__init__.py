"""Registration of the port: the frustum LM solve (CUDA kernel on the
card, plain version on the CPU) and the error metrics."""
from .frustum import (initial_guess, rodrigues, sample_inits,
                      solve_frustum_batch, theta_to_pose)
from .frustum_cuda import lm_solve, lm_solve_cuda, lm_solve_plain
from .metrics import pose_diff, registration_summary
