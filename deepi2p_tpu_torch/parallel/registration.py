"""Registration sharded over ranks, counterpart of the JAX package's
``parallel/registration.py``.

The bench path (detector forward -> argmax -> multi-init frustum LM) is
independent across pairs, so each rank of the data axis runs the whole
per-pair pipeline on its slice of the batch, with the kNN and LM kernels
on its own card, and the poses and costs are gathered to every rank
(one all-reduce, ``collectives.gather_cat``): the multi-card form of the
reference's 8-process solver fan-out
(``evaluation/registration_lsq.py:334-343``).

Layout independence: pair ``i`` draws its inits from its own CPU
generator (:func:`pair_generators`, seeded from ``(seed, i)``), so the
inits, and so the solved poses, are the same whether a pair is solved on
one rank or on one of four.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..register.frustum import (initial_guess, sample_inits_per_pair,
                                solve_frustum_batch)
from .collectives import gather_cat
from .mesh import Mesh, shard_batch


def pair_seed(seed: int, i: int) -> int:
    """The seed of pair ``i``'s generator."""
    return int(np.random.SeedSequence([int(seed), int(i)])
               .generate_state(1)[0])


def pair_generators(seed: int, n_pairs: int) -> List[torch.Generator]:
    """One CPU ``torch.Generator`` per pair, seeded from ``(seed, i)``."""
    return [torch.Generator().manual_seed(pair_seed(seed, i))
            for i in range(n_pairs)]


def make_sharded_registration(mesh: Mesh, apply_fn: Callable, *, H: int,
                              W: int, n_inits: int = 64, max_iter: int = 24,
                              solver_stride: int = 1, is_2d: bool = True):
    """The registration step of one rank.

    Args:
      mesh: the rank's layout; pairs are split over its data axis (the
        model axis repeats the data index's work, as the JAX package's
        ``shard_map`` over ``P("data")`` does).
      apply_fn: ``apply_fn(batch) -> coarse_logits (B, N, 2)`` on the
        rank's slice, typically the detector's eval forward.
      is_2d: the 2-D mode ([ry, tx, ty, tz]) or 6-DoF ([aa, t]).
    Returns:
      ``step(batch, generators) -> (P (B, 4, 4), cost (B,))`` for the
      rank's slice of the batch and of the pair generators (from
      :func:`place_for_registration`); the outputs cover the whole batch
      on every rank.  ``step(..., with_inits=True)`` also returns the
      inits, ``theta0`` (B, n_inits, P), gathered the same way.
    """
    def step(batch: Dict, generators: Sequence[torch.Generator],
             with_inits: bool = False):
        with torch.no_grad():
            coarse = apply_fn(batch)
        pred = torch.argmax(coarse, dim=-1)
        pc = batch["pc"].float()
        ang, _ = initial_guess(pc, pred)
        theta0 = sample_inits_per_pair(generators, ang, n_inits,
                                       is_2d=is_2d)
        P, cost = solve_frustum_batch(pc, pred, batch["K"], H=H, W=W,
                                      n_inits=n_inits, max_iter=max_iter,
                                      solver_stride=solver_stride,
                                      is_2d=is_2d, theta0=theta0)
        args = (mesh.data_group, mesh.data_index, mesh.n_data)
        out = tuple(gather_cat(x.contiguous(), *args, dim=0)
                    for x in ((P, cost, theta0) if with_inits
                              else (P, cost)))
        return out

    return step


def place_for_registration(mesh: Mesh, model, batch: Dict,
                           generators: Sequence[torch.Generator]):
    """The rank's share for :func:`make_sharded_registration`: the model
    on the mesh's device (every rank holds all of it), its slice of the
    batch there, and its slice of the pair generators."""
    B = len(generators)
    if B % mesh.n_data:
        raise ValueError(f"{B} pairs do not split over {mesh.n_data} "
                         "data ranks")
    b = B // mesh.n_data
    lo = mesh.data_index * b
    return (model.to(mesh.device), shard_batch(mesh, batch),
            list(generators[lo:lo + b]))
