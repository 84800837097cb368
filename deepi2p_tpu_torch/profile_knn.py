"""Time the kNN kernel at the main path's four calls on the card.

    python -m deepi2p_tpu_torch.profile_knn

The forward (``config.oxford(batch_size=32)``, the synthetic batch of
seed 0) calls the kNN kernel four times: point -> node_a and node_b ->
cluster means in the encoder (bf16-rounded coordinates), point -> node_b
and node_a -> node_b in the detector.  For each call this prints the
kernel's time by CUDA events around one replay of a CUDA graph that
holds 20 calls (no host launch between them), and by CUDA events over
20 calls launched back to back from Python, where a call shorter than
the wrapper's launch is timed by the launch rate.  It uses only the
kNN wrapper's ``knn_cuda(q, db, k)``, so the same file times another
checkout's kernel when copied into its package.  Needs a CUDA device.
"""
from __future__ import annotations

import torch

from . import config
from .data import batch_to_torch, synthetic_batch
from .ops import node_mean_and_count
from .ops.knn_cuda import knn_cuda

REPS = 20


def graph_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around one
    replay of a CUDA graph that holds ``reps`` calls, after a warm-up call
    and a warm-up replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launched_ms(fn, reps: int = REPS) -> float:
    """Mean time of ``fn()`` in ms by CUDA events over ``reps`` calls
    launched back to back, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def forward_calls(batch, cfg):
    """The forward's four kNN calls: [(name, query, database, k)]."""
    bf = lambda t: t.to(torch.bfloat16).float().contiguous()
    pc, na, nb = batch["pc"], batch["node_a"], batch["node_b"]
    _, idx1 = knn_cuda(bf(pc), bf(na), cfg.k_interp_point_a)
    cmean, _ = node_mean_and_count(bf(pc), idx1[:, :, 0], cfg.node_a_num)
    return [("pc->node_a", bf(pc), bf(na), cfg.k_interp_point_a),
            ("node_b->cluster_mean", bf(nb), cmean.contiguous(), cfg.k_ab),
            ("pc->node_b", pc, nb, cfg.k_interp_point_b),
            ("node_a->node_b", na, nb, cfg.k_interp_ab)]


def main() -> None:
    cfg = config.oxford(batch_size=32)
    batch = batch_to_torch(synthetic_batch(cfg, seed=0), device="cuda")
    print(f"card {torch.cuda.get_device_name(0)}", flush=True)
    tot_g = tot_l = 0.0
    for name, q, db, k in forward_calls(batch, cfg):
        g = graph_ms(lambda: knn_cuda(q, db, k))
        l = launched_ms(lambda: knn_cuda(q, db, k))
        tot_g, tot_l = tot_g + g, tot_l + l
        print(f"knn {name}: B={q.shape[0]} N={q.shape[1]} M={db.shape[1]} "
              f"k={k}: CUDA graph {g:.4f} ms, back to back {l:.4f} ms",
              flush=True)
    print(f"knn: the four calls {tot_g:.4f} ms (CUDA graph), {tot_l:.4f} ms "
          f"(back to back)", flush=True)


if __name__ == "__main__":
    with torch.no_grad():
        main()
