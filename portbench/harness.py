"""What the loops share: the run's context, seeds, the program's model
built from the benchmark's weights, the reservoir that samples served
answers for the check, and the reference's numerics."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .traffic.synthetic import derived_seed

# tags of the seeds drawn from --seed (pool batches use 1)
WEIGHTS, BATCH, SAMPLE = 2, 3, 4


@dataclasses.dataclass
class Ctx:
    """One run: the configuration (its file as a dict), the program's
    ``Config`` built from it, the traffic parameters, the seed, the device
    and the spans."""
    cfg: dict
    port: object
    traffic: dict
    seed: int
    device: str
    spans: object


def batch_seed(seed: int, i: int) -> int:
    """The seed of window batch ``i`` (its inits or dropout masks)."""
    return derived_seed(seed, BATCH, i)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def build_model(port_cfg, sd: Dict[str, torch.Tensor], device):
    """The program's detector holding a copy of the benchmark's state
    dict (every key, strictly), in eval mode."""
    from deepi2p_tpu_torch.models.detector import KeypointDetector
    with torch.device("meta"):
        model = KeypointDetector(port_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


class Reservoir:
    """A uniform sample of ``k`` of all items offered, drawn from the
    seed: item ``n`` replaces a random slot with probability k / (n+1)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.n = 0
        self.rng = np.random.default_rng(derived_seed(seed, SAMPLE))
        self.items: List[object] = []

    def slots(self, count: int) -> List[tuple]:
        """(index in the offered batch, slot) of each of the next
        ``count`` items that enters the sample."""
        out = []
        for j in range(count):
            if self.n < self.k:
                out.append((j, self.n))
                self.items.append(None)
            else:
                r = int(self.rng.integers(0, self.n + 1))
                if r < self.k:
                    out.append((j, r))
            self.n += 1
        return out


@contextlib.contextmanager
def reference_numerics():
    """True float32 products (no TF32) while the reference runs."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in the 2-norm, float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def free_device_memory() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
