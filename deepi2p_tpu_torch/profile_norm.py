"""The norm kernel pair at the train step's shapes on the card.

    python -m deepi2p_tpu_torch.profile_norm [--batch 64]

At the KITTI train step's norms (B = 64, N = 20480, 160x512, bf16
activations, f32 parameters, train mode, ReLU after): the head's layers
(B N points x 256), the point tower's first PointNet (B x N x 32) and the
ResNet stem (B x 64 x 80 x 256) as the convolutions lay it out
(channels-last in memory) and as a contiguous NCHW tensor.  For each:
the kernel against the plain version (``Norm.plain`` + ReLU, autograd;
norm-wise relative gaps of y, dx, dweight, dbias, the running
statistics), whether two kernel calls are bitwise equal, and device
times (the sums of the kernels' device times under ``torch.profiler``):
the kernel path's forward (PyTorch's statistics, then the apply pass)
and backward (three kernels), its bound (the bf16 bytes of x read and y
written, and of x and dy read and dx written, each once, over 3.35
TB/s), the plain version's forward + backward, and
``torch.nn.functional.batch_norm`` + ``relu``'s, a yardstick the port
never calls.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import copy
import json

import torch
import torch.nn.functional as F

from .models.layers import Norm
from .ops.norm_cuda import norm_cuda

PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 10


def shapes(B: int, N: int = 20480, H: int = 80, W: int = 256):
    """name -> (shape, channel axis, channels-last memory)."""
    return {
        "head": ((B * N, 256), -1, False),
        "point": ((B, N, 32), -1, False),
        "stem": ((B, 64, H, W), 1, True),
        "stem_nchw": ((B, 64, H, W), 1, False),
    }


def make(shape, ch, channels_last, seed: int = 0):
    """Seeded bf16 x and dy on the card and a train-mode norm with f32
    parameters and statistics away from their initial values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=g, device="cuda") * 1.7 + 0.4).to(
        torch.bfloat16)
    dy = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    C = shape[ch]
    norm = Norm(C, "batch", channel_axis=ch).cuda()
    with torch.no_grad():
        norm.weight.copy_(torch.rand(C, generator=g, device="cuda") + 0.5)
        norm.bias.copy_(torch.randn(C, generator=g, device="cuda") * 0.3)
        norm.running_mean.normal_(generator=g)
        norm.running_var.uniform_(0.5, 1.5, generator=g)
    return x, dy, norm


def forward(norm, x, kernel: bool):
    return norm(x, relu=True) if kernel else F.relu(norm.plain(x))


def step(norm, x, dy, kernel: bool):
    """y, dx, dweight, dbias of one forward and backward."""
    x = x.detach().requires_grad_(True)
    y = forward(norm, x, kernel)
    return (y.detach(), *torch.autograd.grad(y, (x, norm.weight, norm.bias),
                                             dy))


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def compare(shape, ch, channels_last, seed: int = 0) -> dict:
    """Kernel against plain version, and the kernel against itself."""
    x, dy, norm = make(shape, ch, channels_last, seed)
    ref = copy.deepcopy(norm)
    again = copy.deepcopy(norm)
    got = step(norm, x, dy, True)
    want = step(ref, x, dy, False)
    rep = step(again, x, dy, True)
    out = {k: rel(a, b) for k, a, b in zip(("y", "dx", "dweight", "dbias"),
                                           got, want)}
    out["y_differ_share"] = float((got[0] != want[0]).double().mean())
    out["running_mean"] = rel(norm.running_mean, ref.running_mean)
    out["running_var"] = rel(norm.running_var, ref.running_var)
    out["bitwise_repeat"] = (
        all(torch.equal(a, b) for a, b in zip(got, rep))
        and torch.equal(norm.running_mean, again.running_mean)
        and torch.equal(norm.running_var, again.running_var))
    return out


def device_us(fn, reps: int = REPS) -> dict:
    """Device us of each kernel ``fn()`` launches, the mean over ``reps``
    calls, by ``torch.profiler`` (a call of these shapes enqueues in
    about as long as the card runs it, so CUDA events around the calls
    would time the host)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = float(us) / reps
    return out


def times(shape, ch, channels_last) -> dict:
    """Device ms (the sums of the kernels' device times) of the kernel
    path's forward (PyTorch's statistics and the apply pass) and backward,
    of its apply pass alone, its bound, the plain version's forward +
    backward and batch_norm's."""
    x, dy, norm = make(shape, ch, channels_last)
    xg = x.detach().requires_grad_(True)
    params = (xg, norm.weight, norm.bias)
    y = forward(norm, xg, True)
    fwd = device_us(lambda: forward(norm, xg, True))
    bwd = device_us(lambda: torch.autograd.grad(y, params, dy,
                                                retain_graph=True))
    plain = device_us(lambda: step(norm, x, dy, False), max(2, REPS // 2))
    rm, rv = norm.running_mean.clone(), norm.running_var.clone()

    def library():
        xi = xg.view(-1, shape[-1]) if ch == -1 and len(shape) > 2 else xg
        yl = F.relu(F.batch_norm(xi, rm, rv, norm.weight, norm.bias,
                                 training=True, momentum=0.1, eps=norm.eps))
        return torch.autograd.grad(yl, params, dy.view(yl.shape))

    n = x.numel()
    fwd_ms, bwd_ms = sum(fwd.values()) / 1e3, sum(bwd.values()) / 1e3
    bound = (2 + 2 + 2 + 2 + 2) * n / PEAK_BYTES * 1e3
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                apply_ms=sum(v for k, v in fwd.items()
                             if "rows_kernel" in k or "planes_kernel" in k)
                / 1e3,
                bound_ms=bound, roofline_pct=100 * bound / (fwd_ms + bwd_ms),
                plain_ms=sum(plain.values()) / 1e3,
                library_ms=sum(device_us(library).values()) / 1e3,
                bwd_kernels_us={k[:60]: round(v, 3) for k, v in bwd.items()})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    print(f"card {torch.cuda.get_device_name(0)}")
    for name, (shape, ch, cl) in shapes(args.batch).items():
        before = norm_cuda.launches
        row = dict(shape=list(shape), channels_last=cl,
                   **compare(shape, ch, cl), **times(shape, ch, cl))
        row["launches"] = norm_cuda.launches - before
        print(json.dumps({name: row}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
