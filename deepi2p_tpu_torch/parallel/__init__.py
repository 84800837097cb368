"""Training and registration over several ranks (``torch.distributed``),
counterpart of the JAX package's ``parallel``: a (data, model) layout of
ranks, the batch split over the data axis, the widest Linears split over
the model axis, and every reduction that makes a sharded step the
single-process step written out (:mod:`.mesh`, through the all-reduce
collectives of :mod:`.collectives`); the registration of a batch split
over ranks with per-pair inits (:mod:`.registration`); and a dry run over
N ranks (``python -m deepi2p_tpu_torch.parallel.dryrun``)."""
from .mesh import (Mesh, PointShards, ShardedEngine, gather_state,
                   make_mesh, shard_batch, shard_points, shard_stacked_batch,
                   shard_state)
