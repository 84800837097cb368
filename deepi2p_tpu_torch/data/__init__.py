"""Data for the port: synthetic batches and samples (numpy), their move
to torch, and ordered batching."""
from .loader import BatchLoader, collate
from .synthetic import SyntheticDataset, batch_to_torch, synthetic_batch
