"""Plain PyTorch reference of the DeepI2P detector (lijx10/DeepI2P
``models/networks_united.py``, ``networks_pc.py``, ``resnet.py``), its
labels and loss (``multimodal_classifier.py``, ``focal_loss.py``) and
Adam, written from the published model and the configuration files.

It imports nothing of the program.  The parameters live in a flat state
dict whose names follow the reference's (torchvision's for the ResNet,
``layers.{i}.conv`` / ``layers.{i}.norm`` for the PointNets), so the same
dict loads into the program.

Precision is the configuration's: activations (the point tower's inputs
too) in ``compute_dtype``, parameters kept in float32 and cast for each
product, batch statistics and the losses in float32.  ``quant`` replaces
the operands of every convolution, linear layer and batched product by a
lower-precision copy (the control); its gradient passes straight through.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

IMG_CHANNELS = (256, 512, 512)
HEAD_DROPOUT = (0.5, 0.5, 0.0)
RESNET34 = (3, 4, 6, 3)
BN_EPS = 1e-5

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
Spec = Tuple[str, Tuple[int, ...], str, float]   # name, shape, kind, std


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), in ``x``'s dtype; the gradient passes through."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-30) / 448.0
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


# -- the parameters -----------------------------------------------------------

def _mlp_spec(prefix: str, cin: int, features, norm_act_at_last: bool
              ) -> Iterator[Spec]:
    for i, c in enumerate(features):
        p = f"{prefix}.{i}"
        yield f"{p}.conv.weight", (c, cin), "normal", math.sqrt(2.0 / cin)
        yield f"{p}.conv.bias", (c,), "zeros", 0.0
        if i < len(features) - 1 or norm_act_at_last:
            yield from _norm_spec(f"{p}.norm", c)
        cin = c


def _norm_spec(p: str, c: int) -> Iterator[Spec]:
    yield f"{p}.weight", (c,), "ones", 0.0
    yield f"{p}.bias", (c,), "zeros", 0.0
    yield f"{p}.running_mean", (c,), "zeros", 0.0
    yield f"{p}.running_var", (c,), "ones", 0.0


def _conv_spec(name: str, cout: int, cin: int, k: int) -> Spec:
    return name, (cout, cin, k, k), "normal", math.sqrt(2.0 / (cout * k * k))


def _resnet_spec(p: str) -> Iterator[Spec]:
    yield _conv_spec(f"{p}.conv1.weight", 64, 3, 7)
    yield from _norm_spec(f"{p}.bn1", 64)
    cin = 64
    for stage, (blocks, cout) in enumerate(zip(RESNET34, (64, 128, 256, 512))):
        for b in range(blocks):
            q = f"{p}.layer{stage + 1}.{b}"
            yield _conv_spec(f"{q}.conv1.weight", cout, cin, 3)
            yield from _norm_spec(f"{q}.bn1", cout)
            yield _conv_spec(f"{q}.conv2.weight", cout, cout, 3)
            yield from _norm_spec(f"{q}.bn2", cout)
            if (stage > 0 and b == 0) or cin != cout:
                yield _conv_spec(f"{q}.downsample.0.weight", cout, cin, 1)
                yield from _norm_spec(f"{q}.downsample.1", cout)
            cin = cout


def param_spec(cfg: dict) -> List[Spec]:
    """Every tensor of the state dict: (name, shape, init, std)."""
    Ca, Cb, Cg = cfg["node_feature_a"], cfg["node_feature_b"], \
        cfg["global_feature"]
    C16, C32, Cimg = IMG_CHANNELS
    L = num_fine(cfg)
    half = Ca // 2
    out: List[Spec] = []
    e = "pc_encoder"
    out += _mlp_spec(f"{e}.first_pointnet.layers", 7, [half] * 3, True)
    out += _mlp_spec(f"{e}.second_pointnet.layers", 2 * half, [Ca] * 2, True)
    out += _mlp_spec(f"{e}.knnlayer.layers_before", 3 + Ca, [Cb, Cb], True)
    out += _mlp_spec(f"{e}.knnlayer.layers_after", 2 * Cb, [2 * Cb, Cb], True)
    out += _mlp_spec(f"{e}.final_pointnet.layers", 3 + Cb, [Cg // 2, Cg],
                     True)
    out += _resnet_spec("img_encoder.backbone")
    out += _mlp_spec("node_b_attention_pn.layers", Cb + Cimg, [256, L], False)
    out += _mlp_spec("node_b_pn.layers", Cb + Cg + C32 + Cimg,
                     [1024, 512, 512], False)
    out += _mlp_spec("node_a_attention_pn.layers", Ca + Cimg, [256, 4 * L],
                     False)
    out += _mlp_spec("node_a_pn.layers", Ca + 512 + C16, [512, 128, 128],
                     False)
    out += _mlp_spec("per_point_pn.layers", 128 + 512 + Ca // 2 + Ca,
                     [256, 256, 2 + L], False)
    return out


def num_fine(cfg: dict) -> int:
    s = cfg["img_fine_resolution_scale"]
    return int(round(cfg["img_H"] / s)) * int(round(cfg["img_W"] / s))


def make_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights made on ``device`` in one draw: He normal by
    fan in for linear layers, by fan out for convolutions, zero biases,
    unit norm scales, identity running statistics."""
    spec = param_spec(cfg)
    n = sum(math.prod(s) for _, s, kind, _ in spec if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(n, generator=gen, device=device)
    sd, off = {}, 0
    for name, shape, kind, std in spec:
        if kind == "normal":
            k = math.prod(shape)
            sd[name] = z[off:off + k].view(shape) * std
            off += k
        elif kind == "ones":
            sd[name] = torch.ones(shape, device=device)
        else:
            sd[name] = torch.zeros(shape, device=device)
    return sd


HEAD_BIAS = "per_point_pn.layers.2.conv.bias"


def calibrate(sd: Dict[str, torch.Tensor], cfg: dict, inputs) -> None:
    """Condition seeded weights on ``inputs``, in place: every batch norm's
    running statistics set to the batch statistics of one train-mode pass,
    each variance plus one, which keeps the logits of order one; then the
    head's last bias set so that each logit's mean over the points of an
    eval-mode pass is zero, so that the coarse argmax is not the same for
    nearly every point."""
    stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    with torch.no_grad():
        forward(sd, cfg, inputs, train=True, stats=stats)
        for p, (mean, var) in stats.items():
            sd[f"{p}.running_mean"] = mean.reshape(-1).clone()
            sd[f"{p}.running_var"] = var.reshape(-1) + 1.0
        coarse, fine = forward(sd, cfg, inputs)
        mean = torch.cat([coarse, fine], dim=-1).reshape(
            -1, coarse.shape[-1] + fine.shape[-1]).mean(dim=0)
        sd[HEAD_BIAS] = sd[HEAD_BIAS] - mean


# -- the layers ---------------------------------------------------------------

class Net:
    """The state dict, the precision and the mode of one forward."""

    def __init__(self, sd, cfg: dict, train: bool, quant: Quant,
                 generator: Optional[torch.Generator], stats):
        self.sd, self.train, self.gen, self.stats = sd, train, generator, stats
        self.dt = getattr(torch, cfg["compute_dtype"])
        self.q = quant or (lambda x: x)

    def w(self, name: str) -> torch.Tensor:
        return self.q(self.sd[name].to(self.dt))

    def norm(self, p: str, x: torch.Tensor, ch: int) -> torch.Tensor:
        """Batch norm in float32 over every axis but ``ch``; train mode
        takes the batch's mean and biased variance ``E[x^2] - E[x]^2``."""
        xf = x.float()
        shape = [1] * x.dim()
        shape[ch] = -1
        if self.train:
            axes = [a for a in range(x.dim()) if a != ch % x.dim()]
            mean = xf.mean(dim=axes, keepdim=True)
            var = torch.clamp((xf * xf).mean(dim=axes, keepdim=True)
                              - mean * mean, min=0.0)
            if self.stats is not None:
                self.stats[p] = (mean.detach(), var.detach())
        else:
            mean = self.sd[f"{p}.running_mean"].reshape(shape)
            var = self.sd[f"{p}.running_var"].reshape(shape)
        mul = torch.rsqrt(var + BN_EPS) * self.sd[f"{p}.weight"].reshape(shape)
        y = (xf - mean) * mul + self.sd[f"{p}.bias"].reshape(shape)
        return y.to(x.dtype)

    def mlp(self, p: str, x: torch.Tensor, n_layers: int,
            norm_act_at_last: bool, dropout=None) -> torch.Tensor:
        for i in range(n_layers):
            q = f"{p}.{i}"
            x = F.linear(self.q(x.to(self.dt)), self.w(f"{q}.conv.weight"),
                         self.sd[f"{q}.conv.bias"].to(self.dt))
            if i < n_layers - 1 or norm_act_at_last:
                x = F.relu(self.norm(f"{q}.norm", x, -1))
            rate = dropout[i] if dropout else 0.0
            if self.gen is not None and 0.0 < rate < 1.0:
                u = torch.rand(x.shape, generator=self.gen,
                               device=self.gen.device).to(x.device)
                x = torch.where(u < 1.0 - rate, x / (1.0 - rate),
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))
        return x

    def conv(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        w = self.w(name)
        return F.conv2d(self.q(x), w, None, stride, w.shape[-1] // 2)

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self.q(a), self.q(b))


def knn(query: torch.Tensor, database: torch.Tensor, k: int):
    """Exact kNN: float32 squared distances summed coordinate by
    coordinate, the k smallest by a stable sort (ties to the lower
    index).  (B,N,3), (B,M,3) -> (d2 (B,N,k), idx (B,N,k) int64)."""
    q, db = query.float(), database.float()
    d2 = sum((db[:, None, :, d] - q[:, :, None, d]) ** 2 for d in range(3))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, C), idx (B, ...) -> (B, ..., C)."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def interpolate(feat: torch.Tensor, idx: torch.Tensor,
                d2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance interpolation of the reference: weights ``1 - d /
    sum(d)`` over the k neighbours (sqrt clamped at 1e-12), summed in
    float32 over the weights and features rounded to the features'
    dtype."""
    d = torch.sqrt(torch.clamp(d2.float(), min=1e-12))
    w = 1.0 - d / d.sum(dim=-1, keepdim=True)               # (B, N, k)
    # gathered in float32, so the backward sums into the features' gradient
    # in float32 and rounds once, as a product's accumulator does
    nb = gather_rows(feat.float(), idx)                     # (B, N, k, C)
    return (w.to(feat.dtype).float()[..., None] * nb).sum(dim=2).to(
        feat.dtype)


def node_pool(feat: torch.Tensor, assign: torch.Tensor, M: int,
              has: torch.Tensor) -> torch.Tensor:
    """Max of (B, N, C) features over the points of each of M nodes, 0
    for empty nodes."""
    B, N, C = feat.shape
    out = torch.full((B, M, C), -torch.inf, dtype=feat.dtype,
                     device=feat.device)
    out = out.scatter_reduce(1, assign[..., None].expand(B, N, C), feat,
                             reduce="amax", include_self=True)
    return torch.where(has[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))


# -- the forward --------------------------------------------------------------

def resnet(net: Net, img: torch.Tensor):
    """img (B, H, W, 3) -> (s16, s32 maps channel-last, global (B, 512))."""
    p = "img_encoder.backbone"
    x = img.to(net.dt).permute(0, 3, 1, 2)
    x = F.relu(net.norm(f"{p}.bn1", net.conv(f"{p}.conv1.weight", x, 2), 1))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    maps = []
    cin = 64
    for stage, (blocks, cout) in enumerate(zip(RESNET34, (64, 128, 256, 512))):
        for b in range(blocks):
            q = f"{p}.layer{stage + 1}.{b}"
            stride = 2 if (stage > 0 and b == 0) else 1
            y = F.relu(net.norm(f"{q}.bn1",
                                net.conv(f"{q}.conv1.weight", x, stride), 1))
            y = net.norm(f"{q}.bn2", net.conv(f"{q}.conv2.weight", y, 1), 1)
            if stride != 1 or cin != cout:
                x = net.norm(f"{q}.downsample.1",
                             net.conv(f"{q}.downsample.0.weight", x, stride),
                             1)
            x = F.relu(y + x)
            cin = cout
        maps.append(x)
    glob = x.float().mean(dim=(2, 3)).to(x.dtype)
    return (maps[2].permute(0, 2, 3, 1), maps[3].permute(0, 2, 3, 1), glob)


def forward(sd, cfg: dict, inputs, *, train: bool = False, quant: Quant = None,
            generator: Optional[torch.Generator] = None, stats=None):
    """inputs: pc (B,N,3), intensity (B,N,1), sn (B,N,3), node_a (B,Ma,3),
    node_b (B,Mb,3), img (B,H,W,3), float32 -> (coarse (B,N,2), fine
    (B,N,L)) float32 logits.  ``train`` normalises by the batch's
    statistics, which ``stats`` collects; ``generator`` draws the head's
    dropout masks, layer by layer (no dropout without one)."""
    net = Net(sd, cfg, train, quant, generator, stats)
    dt = net.dt
    pc32, intensity, sn, node_a32, node_b32, img = inputs
    B, N, _ = pc32.shape
    Ma, Mb = node_a32.shape[1], node_b32.shape[1]
    L = num_fine(cfg)
    Ca = cfg["node_feature_a"]
    e = "pc_encoder"
    pc, node_a, node_b = (x.to(dt) for x in (pc32, node_a32, node_b32))

    # point tower: points to their nearest node_a, cluster means
    a_d2, a_idx = knn(pc, node_a, cfg["k_interp_point_a"])
    assign = a_idx[:, :, 0]
    count = torch.zeros(B, Ma, device=pc.device).scatter_add_(
        1, assign, torch.ones(B, N, device=pc.device))
    total = torch.zeros(B, Ma, 3, device=pc.device).scatter_add_(
        1, assign[..., None].expand(B, N, 3), pc.float())
    cluster_mean = total / (count + 1e-5)[..., None]
    has = count > 0
    centers = gather_rows(cluster_mean, assign)
    x = torch.cat([pc.float() - centers, intensity.to(dt).float(),
                   sn.to(dt).float()], dim=-1)
    first = net.mlp(f"{e}.first_pointnet.layers", x, 3, True)
    pooled = node_pool(first, assign, Ma, has)
    second = net.mlp(f"{e}.second_pointnet.layers",
                     torch.cat([first, gather_rows(pooled, assign)], -1), 2,
                     True)
    node_a_feat = node_pool(second, assign, Ma, has)

    # kNN fusion onto node_b
    _, f_idx = knn(node_b, cluster_mean, cfg["k_ab"])
    nb = gather_rows(cluster_mean, f_idx) - node_b.float()[:, :, None]
    y = torch.cat([nb, gather_rows(node_a_feat, f_idx).float()], dim=-1)
    y = net.mlp(f"{e}.knnlayer.layers_before", y, 2, True)
    y = torch.cat([y.amax(dim=2, keepdim=True).expand_as(y), y], dim=-1)
    y = net.mlp(f"{e}.knnlayer.layers_after", y, 2, True)
    node_b_feat = y.amax(dim=2)
    final = net.mlp(f"{e}.final_pointnet.layers",
                    torch.cat([node_b, node_b_feat], dim=-1), 2, True)
    pc_glob = final.amax(dim=1)

    # image tower and the attention fusion
    s16, s32, img_glob = resnet(net, img)
    s16 = s16.reshape(B, -1, s16.shape[-1])
    s32 = s32.reshape(B, -1, s32.shape[-1])
    glob_b = img_glob[:, None].expand(B, Mb, -1)
    glob_a = img_glob[:, None].expand(B, Ma, -1)
    att_b = net.mlp("node_b_attention_pn.layers",
                    torch.cat([node_b_feat, glob_b], -1), 2, False)
    b_img = net.bmm(att_b, s32) / L
    up_b = net.mlp("node_b_pn.layers", torch.cat(
        [node_b_feat, pc_glob[:, None].expand(B, Mb, -1), b_img, glob_b], -1),
        3, False)
    pb_d2, pb_idx = knn(pc32, node_b32, cfg["k_interp_point_b"])
    interp_pb = interpolate(up_b, pb_idx, pb_d2)
    att_a = net.mlp("node_a_attention_pn.layers",
                    torch.cat([node_a_feat, glob_a], -1), 2, False)
    a_img = net.bmm(att_a, s16) / (4 * L)
    ab_d2, ab_idx = knn(node_a32, node_b32, cfg["k_interp_ab"])
    up_a = net.mlp("node_a_pn.layers", torch.cat(
        [node_a_feat, interpolate(up_b, ab_idx, ab_d2), a_img], -1), 3, False)
    interp_pa = interpolate(up_a, a_idx, a_d2)
    head = torch.cat([interp_pa, interp_pb, first, second], dim=-1)
    scores = net.mlp("per_point_pn.layers", head, 3, False,
                     dropout=HEAD_DROPOUT).float()
    return scores[..., :2], scores[..., 2:]


# -- labels, loss, Adam -------------------------------------------------------

def labels(pc, P, K, cfg: dict):
    """Coarse (inside the frustum) and fine (grid cell, clipped into
    range) labels (B, N) of the true pose, in float32."""
    H, W, s = cfg["img_H"], cfg["img_W"], cfg["img_fine_resolution_scale"]
    pc, P, K = pc.float(), P.float(), K.float()
    cam = torch.einsum("bij,bnj->bni", P[:, :3, :3], pc) + P[:, None, :3, 3]
    hom = torch.einsum("bij,bnj->bni", K, cam)
    z = hom[..., 2]
    px, py = hom[..., 0] / z, hom[..., 1] / z
    coarse = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
              & (z > 0.1)).long()
    W_f, H_f = int(round(W / s)), int(round(H / s))
    fine = (torch.floor(px / s) + torch.floor(py / s) * W_f).long()
    return coarse, torch.clamp(fine, 0, W_f * H_f - 1)


def loss(coarse_logits, fine_logits, coarse, fine, cfg: dict):
    """Focal loss on the coarse logits (alpha 0.5, gamma 2, 1e-6 on the
    probabilities and on the one-hot target) times ``coarse_loss_alpha``,
    plus the cross-entropy of the fine logits over the inside points."""
    p = torch.softmax(coarse_logits, dim=-1) + 1e-6
    onehot = F.one_hot(coarse, 2).float() + 1e-6
    focal = -0.5 * (1.0 - p) ** 2 * torch.log(p)
    c = (onehot * focal).sum(dim=-1).mean() * cfg["coarse_loss_alpha"]
    logp = torch.log_softmax(fine_logits, dim=-1)
    ce = -torch.gather(logp, -1, fine[..., None])[..., 0]
    m = coarse.float()
    return c + (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


ADAM = (0.9, 0.999, 1e-8)


def adam(params: List[torch.Tensor], grads, mu, nu, count: int,
         lr: float) -> None:
    """One Adam step in place (``count`` steps taken before it)."""
    b1, b2, eps = ADAM
    t = count + 1
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(g * g * (1.0 - b2))
            p.add_(-lr * (m / (1.0 - b1 ** t))
                   / (torch.sqrt(v / (1.0 - b2 ** t)) + eps))


def learning_rate(cfg: dict, step: int, steps_per_epoch: int) -> float:
    epoch = step // steps_per_epoch
    lr = cfg["lr"] * cfg["lr_decay_scale"] ** (epoch // cfg["lr_decay_step"])
    return max(lr, cfg["lr_clip"])
