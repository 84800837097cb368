"""SO-Net-style point-cloud encoder, counterpart of the JAX package's
``models/pc_encoder.py`` (reference ``models/networks_pc.py:15-124``).

Point -> node_a assignment by kNN, cluster means, two PointNets with a
node max-pool fusion, the kNN fusion onto node_b
(``GeneralKNNFusionModule``, held under ``knnlayer`` as in the reference's
state_dict) and the global feature.  Channel plan for Ca=64, Cb=256,
Cg=512: first PN 7->[32,32,32]; second PN 64->[64,64]; kNN fusion
(3+64)->[256,256] | [512,256]; final PN (3+256)->[256,512].
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.dtypes import widen
from ..ops.knn import gather_knn, knn
from ..ops.segment import node_mean_and_count, node_pool_max, scatter_to_points
from .layers import PointNetMLP, make_layers, run_layers


class PCEncoderOut(NamedTuple):
    pc_centers: torch.Tensor        # (B, N, 3)
    cluster_mean: torch.Tensor      # (B, Ma, 3)
    min_k_idx: torch.Tensor         # (B, N, k_interp_point_a)
    first_pn_out: torch.Tensor      # (B, N, Ca/2)
    second_pn_out: torch.Tensor     # (B, N, Ca)
    node_a_features: torch.Tensor   # (B, Ma, Ca)
    node_b_features: torch.Tensor   # (B, Mb, Cb)
    global_feature: torch.Tensor    # (B, Cg)
    min_k_d2: torch.Tensor          # (B, N, k) squared distances


class KNNFusion(nn.Module):
    """kNN over nodes, decentred neighbour coordinates, two shared-MLP
    stacks with a max-pool fusion between them."""

    def __init__(self, Ca: int, Cb: int, k: int, **kw):
        super().__init__()
        self.k = k
        self.layers_before = make_layers(3 + Ca, [Cb, Cb],
                                         norm_act_at_last=True, **kw)
        self.layers_after = make_layers(2 * Cb, [2 * Cb, Cb],
                                        norm_act_at_last=True, **kw)

    def forward(self, query, database, database_features):
        """query (B,M,3), database (B,Md,3), features (B,Md,C) -> (B,M,Cb)."""
        _, idx = knn(query, database, self.k)                   # (B, M, K)
        nb_coord = gather_knn(database, idx)                    # (B,M,K,3)
        nb_feat = gather_knn(database_features, idx)            # (B,M,K,C)
        decentered = (widen(nb_coord)
                      - widen(query)[:, :, None, :]).detach()
        y = torch.cat([decentered, widen(nb_feat)], dim=-1)
        y = run_layers(self.layers_before, y)
        pooled = torch.amax(y, dim=2, keepdim=True)
        y = torch.cat([pooled.expand_as(y), y], dim=-1)
        y = run_layers(self.layers_after, y)
        return torch.amax(y, dim=2)


class PCEncoder(nn.Module):
    def __init__(self, Ca: int = 64, Cb: int = 256, Cg: int = 512,
                 k_interp_point_a: int = 3, k_ab: int = 16,
                 normalization: str = "batch", norm_momentum: float = 0.1,
                 activation: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(normalization=normalization, norm_momentum=norm_momentum,
                  activation=activation, dtype=dtype)
        half = Ca // 2
        self.k_interp_point_a = k_interp_point_a
        self.first_pointnet = PointNetMLP(7, [half] * 3,
                                          norm_act_at_last=True, **kw)
        self.second_pointnet = PointNetMLP(2 * half, [Ca] * 2,
                                           norm_act_at_last=True, **kw)
        self.knnlayer = KNNFusion(Ca, Cb, k_ab, **kw)
        self.final_pointnet = PointNetMLP(3 + Cb, [Cg // 2, Cg],
                                          norm_act_at_last=True, **kw)

    def forward(self, pc, intensity, sn, node_a, node_b) -> PCEncoderOut:
        """pc (B,N,3), intensity (B,N,1), sn (B,N,3), node_a (B,Ma,3),
        node_b (B,Mb,3), all in the compute dtype."""
        Ma = node_a.shape[1]
        min_k_d2, min_k_idx = knn(pc, node_a, self.k_interp_point_a)
        min_idx = min_k_idx[:, :, 0]
        cluster_mean, count = node_mean_and_count(pc, min_idx, Ma)
        has_points = (count > 0).to(pc.dtype)
        pc_centers = scatter_to_points(cluster_mean, min_idx)
        pc_decentered = (widen(pc) - pc_centers).detach()

        x = torch.cat([pc_decentered, widen(intensity), widen(sn)], dim=-1)
        first_pn_out = self.first_pointnet(x)
        pooled1, _ = node_pool_max(first_pn_out, min_idx, Ma,
                                   has_points=has_points)
        fused = torch.cat([first_pn_out, scatter_to_points(pooled1, min_idx)],
                          dim=-1)
        second_pn_out = self.second_pointnet(fused)
        node_a_features, _ = node_pool_max(second_pn_out, min_idx, Ma,
                                           has_points=has_points)

        node_b_features = self.knnlayer(node_b, cluster_mean,
                                        node_a_features)

        final_in = torch.cat([node_b, node_b_features], dim=-1)
        final = self.final_pointnet(final_in)
        global_feature = torch.amax(final, dim=1)

        return PCEncoderOut(pc_centers, cluster_mean, min_k_idx,
                            first_pn_out, second_pn_out, node_a_features,
                            node_b_features, global_feature,
                            min_k_d2=min_k_d2)
