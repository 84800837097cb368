"""Depth-net trainer of the port, counterpart of the JAX package's
``train/depth_cli.py`` (the auxiliary model of the ICP pipeline, the
reference's external monodepth2 stage,
``evaluation/icp/save_depth_map.py:60-102``):

    python -m deepi2p_tpu_torch.train.depth_cli --steps 2000 \\
        --checkpoints-dir DEPTH_CKPT --scene street [--dense-targets] \\
        [--img-h 160 --img-w 512] [--device cpu]

:class:`~..models.depth.DepthNet` trains on the synthetic renderer's depth
with a fresh scene per step: batch ``i`` is ``synthetic_batch(seed=(seed
<< 40) + 1 + i)`` and the held-out batches ``((seed + 1) << 40) + i``, the
JAX trainer's seeds, from the port's copy of the renderer.  Adam follows
optax's ``adam(cosine_decay_schedule(lr, steps))``: the rate of step
``count`` is the schedule at the count before the step, in f32.  The
weights are seeded by the port (flax's initialisers, not its random
stream).

The checkpoint is ``depth.npz`` in ``--checkpoints-dir``: ``__step__`` and
one array per leaf under the flax key paths (``params['enc0']['Conv_0']
['kernel']``, kernels HWIO), the layout of ``train/checkpoint.py``'s
``export_npz``.  The JAX package saves orbax directories, which
:func:`load_depth_fn` refuses; :func:`save_depth_params` writes this file
from a flax tree as well, in a process that restores one.  The default
device is the card.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Union

import numpy as np
import torch

from .. import config as config_mod
from ..data.synthetic import synthetic_batch
from ..device import resolve_device
from ..models.depth import DepthNet, build_depth_net, depth_loss
from ..models.from_jax import (depth_state_dict_from_flax,
                               flax_from_depth_state_dict)
from .checkpoint import flatten_tree, load_npz
from .engine import adam_update

CHECKPOINT_NAME = "depth.npz"


def cosine_decay_lr(lr: float, steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)(count)`` in f32:
    ``lr * 0.5 * (1 + cos(pi * min(count, steps) / steps))``."""
    f32 = np.float32
    c = f32(min(count, steps))
    decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(steps)))
    return float(f32(lr) * decay)


def depth_batch(cfg, batch_size: int, seed: int, dense: bool, device):
    """(img, depth) of one synthetic batch on ``device``."""
    b = synthetic_batch(cfg, batch_size=batch_size, seed=seed,
                        with_depth=True, dense_depth=dense)
    return (torch.as_tensor(b["img"]).to(device),
            torch.as_tensor(b["depth"]).to(device))


class DepthTrainer:
    """Adam with the cosine schedule on a :class:`DepthNet`, in optax's
    order (``train.engine.adam_update``)."""

    def __init__(self, model: DepthNet, lr: float, steps: int):
        self.model, self.lr, self.steps = model, lr, steps
        self.params = list(model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def loss_and_grads(self, img: torch.Tensor, depth: torch.Tensor):
        """The loss and the gradient of every parameter (no update)."""
        with torch.enable_grad():
            for p in self.params:
                p.grad = None
            loss = depth_loss(self.model(img), depth)
            loss.backward()
        return loss.detach(), [p.grad for p in self.params]

    def step(self, img: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """One step; returns the loss before it (a tensor on the card)."""
        loss, grads = self.loss_and_grads(img, depth)
        adam_update(self.params, grads, self.mu, self.nu, self.count,
                    cosine_decay_lr(self.lr, self.steps, self.count))
        self.count += 1
        return loss


def train_depth(cfg, *, steps: int, batch_size: int, lr: float,
                seed: int = 0, log_every: int = 50, eval_batches: int = 4,
                dense: bool = False, device="cuda"):
    """Train a DepthNet; returns (model, held-out log-L1, per-step
    losses)."""
    dev = resolve_device(device)
    model = build_depth_net(cfg.compute_dtype, seed=seed, device=dev)
    trainer = DepthTrainer(model, lr, steps)
    losses: List[float] = []
    t0 = time.time()
    for i in range(steps):
        img, depth = depth_batch(cfg, batch_size, (seed << 40) + 1 + i,
                                 dense, dev)
        losses.append(float(trainer.step(img, depth)))
        if i % log_every == 0 or i == steps - 1:
            print(f"depth step {i}: log-L1 {losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    errs = []
    with torch.no_grad():
        for i in range(eval_batches):
            img, depth = depth_batch(cfg, batch_size,
                                     ((seed + 1) << 40) + i, dense, dev)
            errs.append(float(depth_loss(model(img), depth)))
    val = float(np.mean(errs))
    print(f"depth val log-L1: {val:.4f}")
    return model, val, losses


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def load_depth_state(model: DepthNet, sd: Dict[str, np.ndarray]) -> None:
    """Copy a DepthNet state_dict (numpy) into ``model``, strictly: every
    parameter filled, shapes equal."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"DepthNet checkpoint: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(sd[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint {sd[name].shape} != "
                                 f"model {tuple(t.shape)}")
            t.copy_(torch.as_tensor(np.asarray(sd[name])))


def save_depth_params(params: Union[DepthNet, Dict], directory: str,
                      step: int = 0) -> str:
    """Write ``directory/depth.npz`` from a DepthNet or a flax ``params``
    tree (numpy); returns its path."""
    tree = (flax_from_depth_state_dict(params.state_dict())
            if isinstance(params, torch.nn.Module)
            else {"params": params.get("params", params)})
    arrays = {k: np.asarray(v, np.float32)
              for k, v in flatten_tree("params", tree["params"]).items()}
    arrays["__step__"] = np.asarray(step, np.int32)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CHECKPOINT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def checkpoint_file(path: str) -> str:
    """The ``.npz`` a ``--depth-checkpoint`` names: the file, or
    ``depth.npz`` in the directory.  An orbax directory is refused."""
    if os.path.isdir(path):
        npz = os.path.join(path, CHECKPOINT_NAME)
        if os.path.isfile(npz):
            return npz
        raise SystemExit(
            f"{path}: no {CHECKPOINT_NAME}; orbax depth checkpoints are the "
            "JAX package's (restore one there and write it for the port "
            "with deepi2p_tpu_torch.train.depth_cli.save_depth_params), "
            "and the port's depth_cli writes depth.npz in its "
            "--checkpoints-dir")
    if not path.endswith(".npz"):
        raise SystemExit(f"{path}: a depth checkpoint is a .npz file or a "
                         f"directory holding {CHECKPOINT_NAME}")
    return path


def load_depth_fn(path: str, cfg, device="cuda"):
    """The DepthNet of ``path`` (see :func:`checkpoint_file`) on
    ``device`` as ``depth_fn(img_hw3) -> depth_hw`` (numpy in, numpy out),
    the callable of ``eval.depth.dump_pseudo_pointclouds``."""
    dev = resolve_device(device)
    params, _, _ = load_npz(checkpoint_file(path))
    model = DepthNet(compute_dtype=cfg.compute_dtype)
    load_depth_state(model, depth_state_dict_from_flax(params))
    model = model.to(dev).eval()

    def depth_fn(img):
        x = torch.as_tensor(np.asarray(img, np.float32)).to(dev)[None]
        with torch.no_grad():
            return model(x)[0].cpu().numpy()
    return depth_fn


def main(argv=None):
    p = argparse.ArgumentParser(description="DeepI2P port depth trainer")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--scene", default="street",
                   choices=["uniform", "street"])
    p.add_argument("--img-h", type=int, default=64,
                   help="training image height: match the geometry of the "
                        "dump the depth maps will be estimated for")
    p.add_argument("--img-w", type=int, default=96)
    p.add_argument("--dense-targets", action="store_true",
                   help="train on dense ray-cast depth (street scenes) "
                        "instead of the sparse splat z-buffer")
    p.add_argument("--checkpoints-dir", default="depth_checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    cfg = config_mod.tiny(synthetic_scene=args.scene,
                          input_pt_num=args.points,
                          img_H=args.img_h, img_W=args.img_w)
    model, val, _ = train_depth(cfg, steps=args.steps,
                                batch_size=args.batch_size, lr=args.lr,
                                seed=args.seed, dense=args.dense_targets,
                                device=args.device)
    path = save_depth_params(model, args.checkpoints_dir, step=args.steps)
    print(f"saved depth checkpoint to {path} (val log-L1 {val:.4f})")
    return val


if __name__ == "__main__":
    main()
