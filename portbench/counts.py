"""Operations, bytes and model FLOPs of the benchmark's kernels and steps,
worked out from shapes, and the NVIDIA H100's published peaks.

Nothing here is read from the program: the kNN and 1-NN counts follow the
algorithms (a squared distance of D coordinates is 3D-1 operations, one
compare keeps the best), the LM count is a frozen copy of the label
table of ``deepi2p_tpu_torch/register/frustum_cuda.py::lm_ops``, and the
model FLOPs are twice the multiply-adds of the published architecture.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_F32_OPS = 67e12        # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bfloat16 tensor cores
PEAK_BYTES = 3.35e12        # HBM3

RESNET34 = (3, 4, 6, 3)
IMG_CHANNELS = (256, 512, 512)

# f32 operations per point and init of one LM sweep, (full sweep,
# cost-only last sweep), for inside- and outside-labelled points
LM_OPS = {4: {"in": (134, 35), "out": (102, 30)},
          6: {"in": (350, 47), "out": (222, 40)}}


def roofline_s(ops: float, nbytes: float, peak_ops: float = PEAK_F32_OPS
               ) -> float:
    """Least time of a kernel: the larger of its operations over the peak
    rate and its bytes (each read or written once) over the bandwidth."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def knn_s(B: int, N: int, M: int, D: int, k: int) -> float:
    """Bound of one kNN launch: B x N queries against B x M rows of D
    float32 coordinates, k float32 distances and int32 indices out."""
    ops = B * N * M * ((3 * D - 1) + 1)
    nbytes = 4 * (B * N * D + B * M * D) + 8 * B * N * k
    return roofline_s(ops, nbytes)


def detector_knn_calls(cfg: dict, B: int) -> List[Tuple[int, ...]]:
    """(B, N, M, D, k) of the forward's four kNN launches: points to
    node_a, node_b to the cluster means, points to node_b, node_a to
    node_b."""
    N, Ma, Mb = cfg["input_pt_num"], cfg["node_a_num"], cfg["node_b_num"]
    return [(B, N, Ma, 3, cfg["k_interp_point_a"]),
            (B, Mb, Ma, 3, cfg["k_ab"]),
            (B, N, Mb, 3, cfg["k_interp_point_b"]),
            (B, Ma, Mb, 3, cfg["k_interp_ab"])]


def nn1_ops(S: int, N: int, M: int, D: int = 3) -> int:
    """Operations of one 1-NN launch by brute force: S query sets of N
    points, each against its cloud's M rows."""
    return S * N * M * ((3 * D - 1) + 1)


def nn1_s(S: int, N: int, B: int, M: int, D: int = 3) -> float:
    """Bound of one 1-NN launch by brute force: S query sets of N points,
    S / B of them against each of B clouds of M rows."""
    nbytes = 4 * (S * N * D + B * M * D) + 8 * S * N
    return roofline_s(nn1_ops(S, N, M, D), nbytes)


def icp_nn1_shape(cfg: dict, traffic: dict) -> Tuple[int, int, int, int]:
    """(S, N, B, M) of one 1-NN launch of an ICP batch: B pairs' inits,
    rounded up to whole groups of 8, each a set of the N cloud points,
    against the pair's pseudo cloud of M points (the depth map at the
    traffic's stride)."""
    B = traffic["batch"]
    S = B * (-(-traffic["n_inits"] // 8) * 8)
    s = traffic["pseudo_stride"]
    M = -(-cfg["img_H"] // s) * -(-cfg["img_W"] // s)
    return S, cfg["input_pt_num"], B, M


def lm_ops(n_in: int, n_out: int, I: int, max_iter: int, P: int = 4) -> int:
    """f32 operations of one LM launch over n_in inside- and n_out
    outside-labelled points and I inits: max_iter full sweeps and the
    cost-only last one."""
    (f_in, c_in), (f_out, c_out) = LM_OPS[P]["in"], LM_OPS[P]["out"]
    return I * (n_in * (max_iter * f_in + c_in)
                + n_out * (max_iter * f_out + c_out))


def lm_s(n_in: int, n_out: int, I: int, max_iter: int, P: int = 4) -> float:
    """Bound of one LM launch: its operations; the bytes (points, labels,
    mask, inits and results once) never bind at these sizes but are
    counted."""
    n = n_in + n_out
    nbytes = 4 * (5 * n + 2 * I * (P + 1))
    return roofline_s(lm_ops(n_in, n_out, I, max_iter, P), nbytes)


def _conv_out(x: int, k: int, s: int) -> int:
    return (x + 2 * (k // 2) - k) // s + 1


def resnet34_flops(H: int, W: int) -> float:
    """Twice the multiply-adds of the ResNet-34 trunk (convolutions) on
    one H x W image, up to its last stage."""
    h, w = _conv_out(H, 7, 2), _conv_out(W, 7, 2)
    macs = h * w * 64 * 3 * 49
    h, w = _conv_out(h, 3, 2), _conv_out(w, 3, 2)       # max pool
    cin = 64
    for stage, (blocks, cout) in enumerate(zip(RESNET34, (64, 128, 256, 512))):
        for b in range(blocks):
            s = 2 if (stage > 0 and b == 0) else 1
            h, w = _conv_out(h, 3, s), _conv_out(w, 3, s)
            macs += h * w * cout * cin * 9 + h * w * cout * cout * 9
            if s != 1 or cin != cout:
                macs += h * w * cout * cin
            cin = cout
    return 2.0 * macs


def _mlp_macs(rows: int, cin: int, features: Iterable[int]) -> int:
    macs = 0
    for c in features:
        macs += rows * cin * c
        cin = c
    return macs


def detector_forward_flops(cfg: dict, B: int) -> float:
    """Model FLOPs of one forward over B pairs: twice the multiply-adds of
    the convolutions, the shared-point linear layers, the attention
    products and the k-neighbour interpolations (k products per point and
    channel, not the dense matrix the program multiplies)."""
    N, Ma, Mb = cfg["input_pt_num"], cfg["node_a_num"], cfg["node_b_num"]
    Ca, Cb, Cg = cfg["node_feature_a"], cfg["node_feature_b"], \
        cfg["global_feature"]
    k = cfg["k_ab"]
    s = cfg["img_fine_resolution_scale"]
    L = int(round(cfg["img_H"] / s)) * int(round(cfg["img_W"] / s))
    C16, C32, Cimg = IMG_CHANNELS
    macs = 0
    macs += _mlp_macs(N, 7, [Ca // 2] * 3)
    macs += _mlp_macs(N, Ca, [Ca] * 2)
    macs += _mlp_macs(Mb * k, 3 + Ca, [Cb, Cb])
    macs += _mlp_macs(Mb * k, 2 * Cb, [2 * Cb, Cb])
    macs += _mlp_macs(Mb, 3 + Cb, [Cg // 2, Cg])
    macs += _mlp_macs(Mb, Cb + Cimg, [256, L])
    macs += Mb * L * C32                                   # attention b
    macs += _mlp_macs(Mb, Cb + Cg + C32 + Cimg, [1024, 512, 512])
    macs += _mlp_macs(Ma, Ca + Cimg, [256, 4 * L])
    macs += Ma * 4 * L * C16                               # attention a
    macs += _mlp_macs(Ma, Ca + 512 + C16, [512, 128, 128])
    macs += N * cfg["k_interp_point_b"] * 512              # node_b -> points
    macs += Ma * cfg["k_interp_ab"] * 512                  # node_b -> node_a
    macs += N * cfg["k_interp_point_a"] * 128              # node_a -> points
    macs += _mlp_macs(N, 128 + 512 + Ca // 2 + Ca, [256, 256, 2 + L])
    return B * (2.0 * macs + resnet34_flops(cfg["img_H"], cfg["img_W"]))
