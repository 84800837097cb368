"""Evaluation of the port: dumps in the reference's npy contract, pseudo
point clouds for ICP, and the registration harness over a dump
directory (``python -m deepi2p_tpu_torch.eval.cli solve``)."""
