"""A (data, model) layout of ranks and the training step over it,
counterpart of the JAX package's ``parallel/mesh.py``.

The JAX package names a mesh of devices and lets GSPMD insert the
collectives; here each rank is a process (``torch.distributed``), and the
reductions that make the sharded step compute the single-process step are
explicit:

* ranks: ``rank = d * n_model + m`` (the JAX ``reshape(n // n_model,
  n_model)``), with one process group per model index over the data axis
  and one per data index over the model axis;
* batch: the global batch's leading axis split over the data axis
  (:func:`shard_batch`); every model rank of a data index holds the same
  slice.  A stack of K batches for a K-step call keeps K whole and splits
  B (:func:`shard_stacked_batch`).  :func:`shard_points` also splits the
  point axis of the clouds over the model axis (the JAX dry run's
  ``P("data", "model")``); the engine gathers it at the step's entry,
  where GSPMD inserts its all-gathers;
* batch norm in train mode: the per-channel sums of x and x^2 and the
  count summed over the data axis, with gradients, before the mean and
  the biased variance; every rank then updates the running statistics
  the same way;
* the loss: numerators and denominators summed over the data axis
  (``train/loss.py``'s ``psum``), the head's dropout drawn for the whole
  batch and sliced (``models/layers.py``);
* gradients: each rank differentiates its share of the loss, the
  gradients are summed over the data axis, the replicated parameters'
  gradients are model rank 0's on every model rank, and the same Adam
  runs on every rank, so replicated parameters stay bitwise equal;
* tensor parallelism: the weight and bias of every ``nn.Linear`` whose
  ``out_features >= min_shard_dim`` and divides by ``n_model`` are split on
  the output axis over the model axis, the Adam moments with them
  (:func:`shard_state`); the forward gathers the channels
  (``collectives.ColumnParallel``).

Every collective is an all-reduce (``collectives.py``), so the same code
runs over NCCL on cards and over gloo on the CPU or on a card that several
ranks share.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..config import Config
from ..models.layers import Norm, PNLayer
from ..train.engine import Engine, TrainState
from .collectives import (BatchStats, ColumnParallel, _reduce_, gather_cat,
                          psum_local)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) layout.  ``data_group`` holds
    the ranks of this model index over the data axis, ``model_group`` those
    of this data index over the model axis; both are ``None`` without a
    process group (one rank).  ``member`` is False on a rank beyond
    ``n_data * n_model``, which takes no part."""
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    member: bool = True

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_model: int = 1, n_data: Optional[int] = None,
              device="cpu") -> Mesh:
    """The layout of this process's ranks.  Without an initialised process
    group the world is this one rank.  ``n_data`` defaults to ``world //
    n_model``; the world size must be a multiple of ``n_model``.  Every
    rank of the world calls this (creating a group is collective), also
    one beyond ``n_data * n_model``, which gets ``member=False``."""
    device = torch.device(device)
    if not dist.is_available() or not dist.is_initialized():
        if n_model != 1 or n_data not in (None, 1):
            raise ValueError(f"a (data={n_data}, model={n_model}) layout "
                             "needs a process group; this is one rank")
        return Mesh(1, 1, 0, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks not divisible by model={n_model}")
    n_data = world // n_model if n_data is None else n_data
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(f"(data={n_data}, model={n_model}) needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank < n_data * n_model and rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank < n_data * n_model and rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, device, data_group, model_group,
                member=rank < n_data * n_model)


# the point-axis tensors of a batch, (B, N, C)
POINT_KEYS = ("pc", "intensity", "sn")


class PointShards(dict):
    """A rank's batch whose :data:`POINT_KEYS` hold its model rank's share
    of the point axis (:func:`shard_points`)."""


def _block(v: torch.Tensor, key: str, dim: int, index: int, size: int,
           what: str, ranks: str) -> torch.Tensor:
    """Block ``index`` of ``size`` equal blocks of ``v`` along ``dim``."""
    n = v.shape[dim]
    if n % size:
        raise ValueError(f"{what} of {n} ({key}) does not split over "
                         f"{size} {ranks} ranks")
    return v.narrow(dim, index * (n // size), n // size)


def shard_batch(mesh: Mesh, batch: Dict, dim: int = 0) -> Dict:
    """The rank's slice of the global batch's axis ``dim`` (the batch
    axis), contiguous on the mesh's device."""
    return {k: _block(torch.as_tensor(v), k, dim, mesh.data_index,
                      mesh.n_data, "batch", "data"
                      ).to(mesh.device).contiguous()
            for k, v in batch.items()}


def shard_stacked_batch(mesh: Mesh, batches: Dict) -> Dict:
    """A (K, B, ...) stack of K batches laid out for a K-step call: K
    whole on every rank, the rank's slice of B."""
    return shard_batch(mesh, batches, dim=1)


def shard_points(mesh: Mesh, batch: Dict) -> PointShards:
    """:func:`shard_batch`, with the point axis (axis 1) of the
    :data:`POINT_KEYS` also split over the model ranks."""
    out = shard_batch(mesh, batch)
    for k in POINT_KEYS:
        out[k] = _block(out[k], k, 1, mesh.model_index, mesh.n_model,
                        "point axis", "model").contiguous()
    return PointShards(out)


def _split_layers(model: nn.Module, n_model: int, min_shard_dim: int
                  ) -> List[PNLayer]:
    """The layers whose Linear is split over ``n_model`` ranks; a wide
    Linear outside a :class:`PNLayer` (none in the detector) raises."""
    def wide(lin):
        return (lin.out_features >= min_shard_dim
                and lin.out_features % n_model == 0)
    layers = [m for m in model.modules()
              if isinstance(m, PNLayer) and wide(m.conv)]
    inside = {id(m.conv) for m in model.modules() if isinstance(m, PNLayer)}
    if any(isinstance(m, nn.Linear) and wide(m) and id(m) not in inside
           for m in model.modules()):
        raise ValueError("a wide nn.Linear outside a PNLayer cannot be "
                         "split")
    return layers


def shard_state(mesh: Mesh, state: TrainState,
                min_shard_dim: int = 512) -> TrainState:
    """Lay a full :class:`TrainState` out on the mesh, in place: with
    ``n_model > 1`` the rank keeps its rows of the split Linears' weights,
    biases and Adam moments; batch norm and dropout get the data axis.
    Returns the state."""
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    moments = dict(zip(names, zip(state.mu, state.nu)))
    if mesh.n_model > 1:
        m, M = mesh.model_index, mesh.n_model
        tp = ColumnParallel(mesh.model_group, m, M)
        for layer in _split_layers(model, M, min_shard_dim):
            n = layer.conv.out_features // M
            rows = slice(m * n, (m + 1) * n)
            with torch.no_grad():
                layer.conv.weight = nn.Parameter(
                    layer.conv.weight[rows].clone())
                layer.conv.bias = nn.Parameter(layer.conv.bias[rows].clone())
            layer.tp = tp
            for pname, p in model.named_parameters():
                if p is layer.conv.weight or p is layer.conv.bias:
                    mu, nu = moments[pname]
                    moments[pname] = (mu[rows].clone(), nu[rows].clone())
    state.mu = [moments[n][0] for n in names]
    state.nu = [moments[n][1] for n in names]
    if mesh.data_group is not None:
        stats = BatchStats(mesh.data_group, mesh.n_data)
        for mod in model.modules():
            if isinstance(mod, Norm) and mod.kind == "batch":
                mod.reduce = stats
            if isinstance(mod, PNLayer):
                mod.batch_rows = (mesh.data_index, mesh.n_data)
    return state


def n_split(state: TrainState) -> int:
    """The number of parameter tensors split over the model axis."""
    return sum(2 for m in state.model.modules()
               if isinstance(m, PNLayer) and m.tp is not None)


def gather_state(mesh: Mesh, state: TrainState) -> TrainState:
    """A single-process copy of a laid-out state, the same on every rank:
    the split weights, biases and moments gathered over the model axis,
    the rank hooks removed.  Every rank of a model group calls it."""
    model = copy.deepcopy(state.model)
    names = [n for n, _ in model.named_parameters()]
    moments = dict(zip(names, zip(state.mu, state.nu)))
    for layer in model.modules():
        if isinstance(layer, Norm):
            layer.reduce = None
        if not isinstance(layer, PNLayer):
            continue
        layer.batch_rows = None
        tp, layer.tp = layer.tp, None
        if tp is None:
            continue
        full = {}
        for pname, p in model.named_parameters():
            if p is layer.conv.weight or p is layer.conv.bias:
                full[pname] = [gather_cat(t.detach(), tp.group, tp.index,
                                          tp.size, dim=0)
                               for t in (p, *moments[pname])]
        for pname, (p, mu, nu) in full.items():
            moments[pname] = (mu, nu)
            attr = pname.rsplit(".", 1)[1]
            setattr(layer.conv, attr, nn.Parameter(p))
    return TrainState(model, [moments[n][0] for n in names],
                      [moments[n][1] for n in names], state.step)


class ShardedEngine(Engine):
    """An :class:`Engine` whose steps run on this rank's part of a mesh
    and compute the single-process steps of the global batch."""

    def __init__(self, cfg: Config, mesh: Mesh, steps_per_epoch: int = 1000,
                 min_shard_dim: int = 512):
        super().__init__(cfg, steps_per_epoch, device=mesh.device)
        self.mesh = mesh
        self.min_shard_dim = min_shard_dim
        if mesh.data_group is not None:
            self._psum = functools.partial(psum_local,
                                           group=mesh.data_group)

    def init_state(self, seed: int = 0) -> TrainState:
        """The single-process initial state, laid out on the mesh."""
        return self.shard_state(super().init_state(seed))

    def shard_state(self, state: TrainState) -> TrainState:
        return shard_state(self.mesh, state, self.min_shard_dim)

    def gather_state(self, state: TrainState) -> TrainState:
        return gather_state(self.mesh, state)

    def place_batch(self, batch: Dict) -> Dict:
        return shard_batch(self.mesh, batch)

    def place_stacked(self, batches: Dict) -> Dict:
        return shard_stacked_batch(self.mesh, batches)

    def whole_points(self, batch: Dict) -> Dict:
        """A :class:`PointShards` batch with its point axis gathered over
        the model ranks (the inputs carry no gradient); any other batch
        as it is."""
        if not isinstance(batch, PointShards):
            return batch
        m = self.mesh
        return {k: gather_cat(v, m.model_group, m.model_index, m.n_model,
                              dim=1) if k in POINT_KEYS else v
                for k, v in batch.items()}

    def eval_step(self, state, batch: Dict) -> Dict[str, torch.Tensor]:
        return super().eval_step(state, self.whole_points(batch))

    def loss_and_grads(self, state: TrainState, batch: Dict,
                       generator: torch.Generator):
        """The rank's share of the gradient, summed over the data axis:
        the gradient of the global batch's loss (split parameters: this
        rank's rows of it).  The model ranks compute the replicated
        parameters' gradients and the running statistics each for itself,
        which a card need not repeat bit for bit (atomic sums in a
        convolution's backward); they take model rank 0's, so the
        replicas stay equal.  A point-sharded batch is gathered first."""
        loss, metrics, grads = super().loss_and_grads(
            state, self.whole_points(batch), generator)
        grads = _summed(grads, self.mesh.data_group)
        if self.mesh.n_model > 1:
            split = {id(p) for m in state.model.modules()
                     if isinstance(m, PNLayer) and m.tp is not None
                     for p in (m.conv.weight, m.conv.bias)}
            rep = [i for i, p in enumerate(state.model.parameters())
                   if id(p) not in split]
            for i, g in zip(rep, self._from_model_rank0(
                    [grads[i] for i in rep])):
                grads[i] = g
            stats = [b for m in state.model.modules()
                     if isinstance(m, Norm) and m.kind == "batch"
                     for b in (m.running_mean, m.running_var)]
            with torch.no_grad():
                for b, v in zip(stats, self._from_model_rank0(stats)):
                    b.copy_(v)
        return loss, metrics, grads

    def _from_model_rank0(self, tensors: List[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """Model rank 0's copies of ``tensors`` on every model rank: the
        other ranks add zeros to them in one all-reduce."""
        if self.mesh.model_index:
            tensors = [torch.zeros_like(t) for t in tensors]
        return _summed(tensors, self.mesh.model_group)


def _summed(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors summed over ``group`` through one all-reduce of their
    concatenation (a ``None`` group: as they are)."""
    if group is None or not tensors:
        return list(tensors)
    flat = _reduce_(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out
