"""Attention-fusion frustum classifier, counterpart of the JAX package's
``models/detector.py`` (reference ``models/networks_united.py:14-210``).

A point tower (:class:`PCEncoder`) and an image tower
(:class:`ImageEncoder`) fused by per-node attention over the ResNet s16/s32
maps, an interpolation pyramid back to points, and a per-point head with 2
coarse (inside/outside frustum) and ``H/32 * W/32`` fine logits.

The forward makes four kNN calls (point->node_a and node_b->cluster means
in the encoder, point->node_b and node_a->node_b here), each one launch of
the kNN kernel on the card.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..ops.interpolate import interpolate_inverse_dist
from ..ops.knn import knn
from .img_encoder import ImageEncoder
from .layers import PointNetMLP, init_params_
from .pc_encoder import PCEncoder

IMG_CHANNELS = (256, 512, 512)     # resnet34: s16, s32, global


class KeypointDetector(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        Ca, Cb, Cg = cfg.node_feature_a, cfg.node_feature_b, cfg.global_feature
        C16, C32, Cimg = IMG_CHANNELS
        L = cfg.num_fine_classes
        kw = dict(normalization=cfg.normalization, activation=cfg.activation,
                  norm_act_at_last=False, dtype=self.dtype)
        self.pc_encoder = PCEncoder(
            Ca=Ca, Cb=Cb, Cg=Cg, k_interp_point_a=cfg.k_interp_point_a,
            k_ab=cfg.k_ab, normalization=cfg.normalization,
            activation=cfg.activation, dtype=self.dtype)
        self.img_encoder = ImageEncoder()
        self.node_b_attention_pn = PointNetMLP(Cb + Cimg, [256, L], **kw)
        self.node_b_pn = PointNetMLP(Cb + Cg + C32 + Cimg, [1024, 512, 512],
                                     **kw)
        self.node_a_attention_pn = PointNetMLP(Ca + Cimg, [256, 4 * L], **kw)
        self.node_a_pn = PointNetMLP(Ca + 512 + C16, [512, 128, 128], **kw)
        # the reference's head dropout [0.5, 0.5, 0] is off in inference
        head_in = 128 + 512 + Ca // 2 + Ca
        head = [256, 256, 2 + L] if cfg.is_fine_resolution else [128, 128, 2]
        self.per_point_pn = PointNetMLP(head_in, head, **kw)

    def forward(self, pc, intensity, sn, node_a, node_b, img):
        """pc (B,N,3), intensity (B,N,1), sn (B,N,3), node_a (B,Ma,3),
        node_b (B,Mb,3), img (B,H,W,3) -> (coarse (B,N,2), fine (B,N,L))
        f32 logits, or coarse only when ``cfg.is_fine_resolution`` is off.
        """
        cfg, dt = self.cfg, self.dtype
        B = pc.shape[0]
        Ma, Mb = node_a.shape[1], node_b.shape[1]
        L = cfg.num_fine_classes

        enc = self.pc_encoder(pc.to(dt), intensity.to(dt), sn.to(dt),
                              node_a.to(dt), node_b.to(dt))
        s16, s32, img_global = self.img_encoder(img.to(dt))
        s16 = s16.reshape(B, -1, s16.shape[-1])          # (B, 4L, 256)
        s32 = s32.reshape(B, -1, s32.shape[-1])          # (B, L, 512)

        glob_b = img_global[:, None, :].expand(B, Mb, img_global.shape[-1])
        glob_a = img_global[:, None, :].expand(B, Ma, img_global.shape[-1])
        pc_glob = enc.global_feature[:, None, :].expand(
            B, Mb, enc.global_feature.shape[-1])

        # node_b attention over the s32 map
        nb_att = self.node_b_attention_pn(
            torch.cat([enc.node_b_features, glob_b], dim=-1))
        nb_img = torch.bmm(nb_att, s32) / L
        up_node_b = self.node_b_pn(
            torch.cat([enc.node_b_features, pc_glob, nb_img, glob_b], dim=-1))

        # interpolate node_b -> points (kNN on the f32 inputs)
        pb_d2, pb_idx = knn(pc, node_b, cfg.k_interp_point_b)
        interp_pb = interpolate_inverse_dist(pc.to(dt), node_b.to(dt),
                                             up_node_b, pb_idx, dist2=pb_d2)

        # node_a attention over the s16 map
        na_att = self.node_a_attention_pn(
            torch.cat([enc.node_a_features, glob_a], dim=-1))
        na_img = torch.bmm(na_att, s16) / (4 * L)

        # interpolate node_b -> node_a
        ab_d2, ab_idx = knn(node_a, node_b, cfg.k_interp_ab)
        interp_ab = interpolate_inverse_dist(node_a.to(dt), node_b.to(dt),
                                             up_node_b, ab_idx, dist2=ab_d2)
        up_node_a = self.node_a_pn(
            torch.cat([enc.node_a_features, interp_ab, na_img], dim=-1))

        # interpolate node_a -> points, reusing the encoder's kNN
        interp_pa = interpolate_inverse_dist(pc.to(dt), node_a.to(dt),
                                             up_node_a, enc.min_k_idx,
                                             dist2=enc.min_k_d2)

        head_in = torch.cat([interp_pa, interp_pb, enc.first_pn_out,
                             enc.second_pn_out], dim=-1)
        scores = self.per_point_pn(head_in).float()
        if cfg.is_fine_resolution:
            return scores[:, :, :2], scores[:, :, 2:]
        return scores


def build_detector(cfg: Config, *, device="cuda", seed: int = 0
                   ) -> KeypointDetector:
    """A :class:`KeypointDetector` with seeded weights, in eval mode, on
    ``device`` (the card unless the caller names the CPU)."""
    dev = resolve_device(device)
    model = KeypointDetector(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
