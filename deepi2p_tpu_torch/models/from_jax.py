"""Weight bridge between flax ``params`` / ``batch_stats`` trees and the
port, both ways.

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
:func:`flax_from_state_dict` is the inverse of :func:`state_dict_from_flax`:
it undoes the transposes (Dense kernels (Cin, Cout), convolutions HWIO)
and serves any dict keyed by the port's parameter names, a gradient too.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

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


_PN_RE = re.compile(r"^(.*)\.(\d+)\.(conv|norm)\.(\w+)$")
_BLOCK_RE = re.compile(r"^layer(\d+)\.(\d+)\.(.+)$")
_NORM_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def flax_key(name: str, normalization: str = "batch"
             ) -> Tuple[str, Tuple[str, ...], Optional[Tuple[int, ...]]]:
    """A port state_dict name -> (flax root ``params`` or ``batch_stats``,
    path in that tree, axis permutation from the port's layout to flax's
    or None)."""
    m = _PN_RE.match(name)
    if m and m.group(1) in PN_MAP:
        prefix, i, part, leaf = m.groups()
        path = PN_MAP[prefix]
        if part == "conv":
            if leaf == "weight":
                return "params", path + (f"dense_{i}", "kernel"), (1, 0)
            return "params", path + (f"dense_{i}", "bias"), None
        root, fleaf = _NORM_LEAF[leaf]
        kind = "BatchNorm_0" if normalization == "batch" else "GroupNorm_0"
        return root, path + (f"norm_{i}", kind, fleaf), None
    pre = BACKBONE_PREFIX + "."
    if not name.startswith(pre):
        raise KeyError(f"{name}: no flax counterpart")
    rest, leaf = name[len(pre):].rsplit(".", 1)
    m = _BLOCK_RE.match(rest)
    if m:
        stage, b, mod = m.groups()
        mod = {"downsample.0": "down_conv", "downsample.1": "down_bn"}.get(
            mod, mod)
        path = BACKBONE + (f"layer{stage}_{b}", mod)
    else:
        path = BACKBONE + (rest,)
    if "conv" in path[-1]:
        return "params", path + ("kernel",), (2, 3, 1, 0)
    root, fleaf = _NORM_LEAF[leaf]
    return root, path + (fleaf,), None


def flax_from_state_dict(sd: Dict, normalization: str = "batch"
                         ) -> Tuple[Dict, Dict]:
    """The port's state_dict (tensors or arrays; or a dict of gradients
    keyed by parameter name) -> flax (params, batch_stats) trees of f32
    numpy arrays, the inverse of :func:`state_dict_from_flax`."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, value in sd.items():
        root, path, perm = flax_key(name, normalization)
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") \
            else np.asarray(value)
        arr = _np(arr)
        if perm is not None:
            arr = np.ascontiguousarray(arr.transpose(perm))
        node = trees[root]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return trees["params"], trees["batch_stats"]


# --------------------------------------------------------------------------
# DepthNet (models/depth.py)
# --------------------------------------------------------------------------

# port leaf -> (flax submodule, flax leaf, axis permutation to flax)
_DEPTH_LEAF = {"conv.weight": ("Conv_0", "kernel", (2, 3, 1, 0)),
               "norm.weight": ("GroupNorm_0", "scale", None),
               "norm.bias": ("GroupNorm_0", "bias", None)}
_HEAD_LEAF = {"head.weight": ("kernel", (2, 3, 1, 0)),
              "head.bias": ("bias", None)}
_DEPTH_PORT = {(sub, leaf): port for port, (sub, leaf, _) in
               _DEPTH_LEAF.items()}


def depth_flax_key(name: str) -> Tuple[Tuple[str, ...], Optional[tuple]]:
    """A DepthNet state_dict name -> (flax params path, axis permutation
    from the port's layout to flax's or None): ``enc0.conv.weight`` (OIHW)
    -> ``('enc0', 'Conv_0', 'kernel')`` (HWIO)."""
    if name in _HEAD_LEAF:
        leaf, perm = _HEAD_LEAF[name]
        return ("head", leaf), perm
    block, _, rest = name.partition(".")
    if rest not in _DEPTH_LEAF or not re.fullmatch(r"(enc\d+b?|dec\d+)",
                                                   block):
        raise KeyError(f"{name}: not a DepthNet parameter")
    sub, leaf, perm = _DEPTH_LEAF[rest]
    return (block, sub, leaf), perm


def depth_state_dict_from_flax(params: Dict) -> Dict[str, np.ndarray]:
    """A flax DepthNet ``params`` tree (with or without its ``params``
    root) -> the port's state_dict (f32 numpy; kernels HWIO -> OIHW)."""
    tree = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            name = _depth_port_name(path + (key,))
            _, perm = depth_flax_key(name)
            arr = _np(value)
            if perm is not None:
                arr = arr.transpose(np.argsort(perm))
            sd[name] = np.array(arr, np.float32, order="C")
    walk(tree, ())
    return sd


def _depth_port_name(path: Tuple[str, ...]) -> str:
    """A flax DepthNet params path -> the port's state_dict name."""
    if path[0] == "head" and len(path) == 2:
        return f"head.{'weight' if path[1] == 'kernel' else path[1]}"
    if len(path) != 3 or path[1:] not in _DEPTH_PORT:
        raise KeyError(f"{'/'.join(path)}: not a DepthNet parameter")
    return f"{path[0]}.{_DEPTH_PORT[path[1:]]}"


def flax_from_depth_state_dict(sd: Dict) -> Dict:
    """The port's DepthNet state_dict (tensors or arrays) -> the flax
    ``{'params': ...}`` tree of f32 numpy arrays, the inverse of
    :func:`depth_state_dict_from_flax`."""
    tree: Dict = {}
    for name, value in sd.items():
        path, perm = depth_flax_key(name)
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") \
            else np.asarray(value)
        arr = _np(arr)
        if perm is not None:
            arr = arr.transpose(perm)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


# --------------------------------------------------------------------------
# The layer library (models/extra_layers.py)
# --------------------------------------------------------------------------

_NORM_KINDS = ("BatchNorm_0", "GroupNorm_0")
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_DENSE_RE = re.compile(r"^(dense|norm)_(\d+)$")


def _extra_name(path: Tuple[str, ...]) -> str:
    """A flax path of an ``extra_layers`` module -> the port's name."""
    *mods, leaf = path
    if len(mods) >= 2 and mods[-1] in _NORM_KINDS:
        # a NormLayer: PointNetMLP's norm_{i}, or a block's "norm"
        m = _DENSE_RE.match(mods[-2])
        base = (mods[:-2] + ["layers", m.group(2), "norm"] if m
                else mods[:-1])
        return ".".join(base + [_BN_LEAF[leaf]])
    if mods and _DENSE_RE.match(mods[-1]):
        i = _DENSE_RE.match(mods[-1]).group(2)
        return ".".join(mods[:-1] + ["layers", i, "conv",
                                     "weight" if leaf == "kernel" else leaf])
    if mods and mods[-1].endswith("_bn"):
        return ".".join(mods + [_BN_LEAF[leaf]])
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


def extra_state_dict_from_flax(params: Dict, batch_stats: Optional[Dict] = None
                               ) -> Dict[str, np.ndarray]:
    """The variables of a flax module of ``extra_layers`` (its ``params``
    and ``batch_stats`` trees, with or without their root key) -> the
    state_dict of the port's module of the same name and sizes: Dense
    kernels (Cin, Cout) -> Linear weights (Cout, Cin), convolution kernels
    HWIO -> OIHW, norm ``scale``/``mean``/``var`` -> ``weight``/
    ``running_mean``/``running_var``."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            arr = _np(value)
            if key == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            sd[_extra_name(path + (key,))] = np.array(arr, np.float32,
                                                      order="C")
    walk(params.get("params", params), ())
    if batch_stats:
        walk(batch_stats.get("batch_stats", batch_stats), ())
    return sd
