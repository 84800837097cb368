"""Data for the port: synthetic batches (numpy) and their move to torch."""
from .synthetic import synthetic_batch, batch_to_torch
