"""Weight bridge: flax ``params`` / ``batch_stats`` trees -> the port.

The trees arrive as nested dicts of numpy arrays (as the JAX package's
checkpoints hold them).  The port's module names are the reference's
state_dict names, which are also what the JAX package's
``export_torch_detector`` writes, so one name mapping serves both; it is
a copy kept here because the port does not import the JAX package.

    <stack>/dense_{i}/kernel (Cin, Cout)   -> <stack>.layers.{i}.conv.weight
    <stack>/norm_{i}/BatchNorm_0/{scale,bias}, batch_stats {mean,var}
                                           -> <stack>.layers.{i}.norm.*
    pc_encoder/knn_before|knn_after        -> pc_encoder.knnlayer.
                                              layers_before|layers_after.{i}
    img_encoder/backbone/...               -> torchvision resnet names

:func:`load_state_dict` takes either this module's output or a torch-style
state_dict such as ``export_torch_detector``'s, whose Linear weights are
(Cout, Cin, 1): trailing singleton axes are dropped to fit the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# port module prefix -> flax module path (PointNet stacks)
PN_MAP: Dict[str, Tuple[str, ...]] = {
    "pc_encoder.first_pointnet.layers": ("pc_encoder", "first_pointnet"),
    "pc_encoder.second_pointnet.layers": ("pc_encoder", "second_pointnet"),
    "pc_encoder.final_pointnet.layers": ("pc_encoder", "final_pointnet"),
    "pc_encoder.knnlayer.layers_before": ("pc_encoder", "knn_before"),
    "pc_encoder.knnlayer.layers_after": ("pc_encoder", "knn_after"),
    "node_b_attention_pn.layers": ("node_b_attention_pn",),
    "node_b_pn.layers": ("node_b_pn",),
    "node_a_attention_pn.layers": ("node_a_attention_pn",),
    "node_a_pn.layers": ("node_a_pn",),
    "per_point_pn.layers": ("per_point_pn",),
}
BACKBONE = ("img_encoder", "backbone")
BACKBONE_PREFIX = "img_encoder.backbone"


def _get(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _np(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def stack_state_dict(ptree: Dict, stree: Dict, prefix: str
                     ) -> Dict[str, np.ndarray]:
    """One flax ``PointNetMLP`` (its param and batch_stats subtrees) ->
    the port's ``{prefix}.{i}.conv/norm.*`` entries."""
    sd: Dict[str, np.ndarray] = {}
    i = 0
    while f"dense_{i}" in ptree:
        base = f"{prefix}.{i}"
        dense = ptree[f"dense_{i}"]
        sd[f"{base}.conv.weight"] = _np(dense["kernel"]).T
        sd[f"{base}.conv.bias"] = _np(dense["bias"])
        norm = ptree.get(f"norm_{i}", {})
        for kind in ("BatchNorm_0", "GroupNorm_0"):
            if kind in norm:
                sd[f"{base}.norm.weight"] = _np(norm[kind]["scale"])
                sd[f"{base}.norm.bias"] = _np(norm[kind]["bias"])
        bn_s = stree.get(f"norm_{i}", {}).get("BatchNorm_0")
        if bn_s:
            sd[f"{base}.norm.running_mean"] = _np(bn_s["mean"])
            sd[f"{base}.norm.running_var"] = _np(bn_s["var"])
        i += 1
    return sd


def state_dict_from_flax(params: Dict, batch_stats: Dict
                         ) -> Dict[str, np.ndarray]:
    """flax trees of the JAX ``KeypointDetector`` -> the port's state_dict
    (numpy values, Linear weights (Cout, Cin))."""
    sd: Dict[str, np.ndarray] = {}
    for prefix, path in PN_MAP.items():
        ptree = _get(params, path)
        if ptree is not None:
            sd.update(stack_state_dict(ptree, _get(batch_stats, path) or {},
                                       prefix))

    bb_p = _get(params, BACKBONE)
    bb_s = _get(batch_stats, BACKBONE) or {}
    if bb_p is not None:
        def conv(dst, p):
            sd[f"{dst}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)

        def bn(dst, p, s):
            sd[f"{dst}.weight"] = _np(p["scale"])
            sd[f"{dst}.bias"] = _np(p["bias"])
            sd[f"{dst}.running_mean"] = _np(s["mean"])
            sd[f"{dst}.running_var"] = _np(s["var"])

        pre = BACKBONE_PREFIX
        conv(f"{pre}.conv1", bb_p["conv1"])
        bn(f"{pre}.bn1", bb_p["bn1"], bb_s["bn1"])
        for stage in range(1, 5):
            b = 0
            while f"layer{stage}_{b}" in bb_p:
                blk_p = bb_p[f"layer{stage}_{b}"]
                blk_s = bb_s[f"layer{stage}_{b}"]
                base = f"{pre}.layer{stage}.{b}"
                for name in ("conv1", "conv2"):
                    conv(f"{base}.{name}", blk_p[name])
                for name in ("bn1", "bn2"):
                    bn(f"{base}.{name}", blk_p[name], blk_s[name])
                if "down_conv" in blk_p:
                    conv(f"{base}.downsample.0", blk_p["down_conv"])
                    bn(f"{base}.downsample.1", blk_p["down_bn"],
                       blk_s["down_bn"])
                b += 1
    return sd


def load_state_dict(model: nn.Module, sd: Dict) -> None:
    """Copy a numpy/torch state_dict into ``model`` (strict: every key of
    the model must be given and no other), dropping trailing singleton
    axes of torch-style Conv1d weights."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, dst in own.items():
            src = torch.as_tensor(np.asarray(sd[name], dtype=np.float32))
            if src.shape != dst.shape:
                head, tail = src.shape[:dst.dim()], src.shape[dst.dim():]
                if head != dst.shape or any(t != 1 for t in tail):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} does "
                                     f"not fit {tuple(dst.shape)}")
                src = src.reshape(dst.shape)
            dst.copy_(src)
