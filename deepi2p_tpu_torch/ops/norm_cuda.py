"""Batch and instance norm (+ ReLU) on the card (``csrc/norm.cu``).

:func:`norm_cuda` is what ``models/layers.py::Norm`` runs on a CUDA
tensor: a ``torch.autograd.Function``.  Its forward widens and squares
``x`` in one pass, leaves the two reductions to PyTorch
(``Norm.moments``, so the statistics are the reference's bit for bit),
takes the per-channel numbers in one small kernel and normalises,
shifts, casts and applies the ReLU in one pass; its backward is the
gradient-sum pass, the finalize and the dx pass.  It saves ``x`` and
four numbers per channel, not the f32 copies that autograd of ``Norm``'s
tensor code keeps, and recomputes the ReLU's mask from ``x``.
``norm_cuda.launches`` counts the kernel launches: 3 a train-mode
forward, 2 an eval-mode one, 3 a backward (4 under ``Norm.reduce``).

The plain versions are ``Norm.plain`` (the forward, ``Norm``'s tensor
code, which the CPU runs and the CPU tests hold to the JAX package),
:func:`channel_stats_plain` (its per-channel numbers) and
:func:`norm_backward_plain` (the closed-form backward the kernel
implements).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import _build
from .dtypes import widen

_K = _build.constants("norm.cu")
THREADS = _K["kThreads"]
# blocks per SM a pass aims at; more only where the tensor has the rows
BLOCKS_PER_SM = 8
APPLY, GRAD_SUMS, GRAD = range(3)
DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


class NormView(NamedTuple):
    """A norm's input as the contiguous (G, O, C, I) the kernel walks:
    statistics per (g, c) over (o, i)."""
    G: int
    O: int
    C: int
    I: int


class NormPlan(NamedTuple):
    vec: int      # elements per load: 16 bytes' worth, or 1
    tx: int       # threads across the channels (I == 1), else 0
    P: int        # slabs of each (g, c): blocks, and partial sums


def norm_view(x: torch.Tensor, channel_axis: int, kind: str):
    """``(p, pos, view)``: ``p = x.movedim(channel_axis, pos)`` contiguous,
    for the first ``pos`` of the channel axis's own place, the last and
    the second where that is so without a copy (channel-last points, NCHW
    maps, NCHW maps that lie channels-last in memory, NHWC views of NCHW
    maps), else a contiguous copy; ``view`` its :class:`NormView`.  Batch
    norm reduces every axis but the channels (G = 1); instance norm every
    axis but the channels and the first (G = ``x.shape[0]``)."""
    ch = channel_axis % x.dim()
    if x.is_contiguous():
        pos, p = ch, x
    else:
        for pos in dict.fromkeys((x.dim() - 1, 1)):
            if pos < x.dim():
                p = x.movedim(ch, pos)
                if p.is_contiguous():
                    break
        else:
            pos, p = ch, x.contiguous()
    G = x.shape[0] if kind == "instance" and ch != 0 else 1
    shape = p.shape
    return p, pos, NormView(G, math.prod(shape[:pos]) // G, shape[pos],
                            math.prod(shape[pos + 1:]))


@functools.lru_cache(maxsize=None)
def norm_plan(view: NormView, itemsize: int, aligned: bool,
              sms: int) -> NormPlan:
    """The launch of one element pass over ``view`` on a card of ``sms``
    SMs.  Loads are 16 bytes where the channels (I == 1) or a plane
    (I > 1) divide into them and the pointers are ``aligned`` to 16
    bytes.  Rows (I == 1): ``tx`` threads across the channel vectors (at
    most :data:`THREADS`), the rest of a block's threads down the rows.
    Each (g, c) is cut into P slabs so the grid holds about
    :data:`BLOCKS_PER_SM` blocks per SM, but never more slabs than a block
    has thread rows (I == 1) or threads (I > 1) to fill once."""
    G, O, C, I = view
    v = 16 // itemsize
    vec = v if aligned and (C if I == 1 else I) % v == 0 else 1
    if I == 1:
        tx = min(C // vec, THREADS)
        blocks = G * -(-(C // vec) // tx)
        most = -(-O // (THREADS // tx))
    else:
        tx = 0
        blocks = G * C
        most = -(-O * (I // vec) // THREADS)
    want = -(-sms * BLOCKS_PER_SM // blocks)
    return NormPlan(vec, tx, max(1, min(want, most)))


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _plan(view: NormView, *tensors: torch.Tensor) -> NormPlan:
    t = tensors[0]
    return norm_plan(view, t.element_size(),
                     all(u.data_ptr() % 16 == 0 for u in tensors),
                     _sms(t.device.index))


def current_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s card, as a raw handle (what
    ``torch.cuda.current_stream(d).cuda_stream`` gives, without building a
    ``Stream``: this path issues several launches a layer)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The precision of a dtype's statistics (``ops.dtypes.widen``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_pass(which, p, dy, out, stats, bias, coef, partials, relu, view,
              plan, stream):
    G, O, C, I = view
    code = _build.load_library().norm_pass(
        which, DTYPES[p.dtype], p.data_ptr(), _ptr(dy), _ptr(out),
        stats.data_ptr(), bias.data_ptr(), _ptr(coef), _ptr(partials),
        int(relu), G, O, C, I, plan.P, plan.vec, plan.tx, stream)
    _build.check(code, "norm_pass")
    norm_cuda.launches += 1


def _finalize_bwd(p, part, count, stream, *, keep=None, sums=None,
                  coef=None):
    code = _build.load_library().norm_finalize_bwd(
        DTYPES[p.dtype], part.data_ptr(), part.shape[-1], part.shape[1],
        float(count), _ptr(keep), _ptr(sums), _ptr(coef), stream)
    _build.check(code, "norm_finalize_bwd")
    norm_cuda.launches += 1


def _combined(reduce, local: torch.Tensor, n: int):
    """``Norm.reduce`` on the local (2, C) sums: the sums over the ranks,
    as (2, C, 1) partials, and their count."""
    s, ss, n = reduce(local[:1], local[1:], n)
    return torch.cat([s.reshape(1, -1), ss.reshape(1, -1)])[..., None], n


def _widen_square(x: torch.Tensor, stream: int):
    """``(xf, xsq)``: the dense ``x`` in the precision of its statistics
    (``x`` itself for f32 and f64, as ``ops.dtypes.widen`` gives it) and
    its square, with ``x``'s strides, in one pass."""
    acc = _acc(x.dtype)
    xsq = torch.empty_like(x, dtype=acc)
    xf = x if x.dtype == acc else torch.empty_like(xsq)
    n = x.numel()
    v = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, xf, xsq))
    vec = v if aligned and n % v == 0 else 1
    blocks = max(1, min(-(-n // (vec * THREADS)),
                        _sms(x.device.index) * BLOCKS_PER_SM))
    code = _build.load_library().norm_widen_square(
        DTYPES[x.dtype], x.data_ptr(), None if xf is x else xf.data_ptr(),
        xsq.data_ptr(), n, vec, blocks, stream)
    _build.check(code, "norm_widen_square")
    norm_cuda.launches += 1
    return xf, xsq


def channel_stats(norm, x: torch.Tensor, weight: torch.Tensor,
                  stream: int):
    """The forward's per-channel numbers as the kernel takes them, a
    (4, G C) tensor in the accumulator precision: mean, ``rstd =
    rsqrt(var + eps)``, ``mul = rstd weight`` and 1 where the variance was
    not clamped (the backward's); train mode updates the running
    statistics.  ``x`` is dense.  The moments are PyTorch's reductions
    (``Norm.moments``) over the widened ``x`` and its square, so this is
    :func:`channel_stats_plain` bit for bit.  ``stream``: the raw handle
    of the current stream (:func:`current_stream`)."""
    batch_stats = norm.kind == "instance" or norm.training
    if batch_stats:
        mean, ex2 = norm.moments(*_widen_square(x, stream))
    else:
        mean, ex2 = norm.running_mean, norm.running_var
    mean, ex2 = mean.reshape(-1).contiguous(), ex2.reshape(-1).contiguous()
    C = weight.numel()
    stats = mean.new_empty((4, mean.numel()))
    running = (norm.kind == "batch" and norm.training)
    code = _build.load_library().norm_channel_stats(
        DTYPES[x.dtype], mean.data_ptr(), ex2.data_ptr(), weight.data_ptr(),
        norm.running_mean.data_ptr() if running else None,
        norm.running_var.data_ptr() if running else None, stats.data_ptr(),
        mean.numel() // C, C, norm.eps, norm.decay, int(batch_stats), stream)
    _build.check(code, "norm_channel_stats")
    norm_cuda.launches += 1
    return stats


def channel_stats_plain(norm, x: torch.Tensor, weight: torch.Tensor):
    """:func:`channel_stats` as tensor code: ``Norm.statistics`` (which
    ``Norm.plain`` normalises with), then ``Norm.plain``'s ``rstd`` and
    ``mul``."""
    batch_stats = norm.kind == "instance" or norm.training
    mean, var, clamped = norm.statistics(widen(x) if batch_stats else x)
    rstd = torch.rsqrt(var + norm.eps)
    shape = [1] * x.dim()
    shape[norm.channel_axis] = -1
    mul = rstd * weight.reshape(shape)
    keep = (torch.ones_like(mean) if clamped is None
            else clamped.logical_not().to(mean.dtype))
    return torch.stack([mean.reshape(-1), rstd.reshape(-1), mul.reshape(-1),
                        keep.reshape(-1)])


class _NormFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, norm, relu):
        p, pos, view = norm_view(x, norm.channel_axis, norm.kind)
        ch = norm.channel_axis % x.dim()
        stream = current_stream(x)
        # x, or its contiguous copy where x was not dense
        xd = p if pos == ch else p.movedim(pos, ch)
        stats = channel_stats(norm, xd, weight, stream)
        y = torch.empty_like(xd)
        yp = y if pos == ch else y.movedim(ch, pos)
        _run_pass(APPLY, p, None, yp, stats, bias, None, None, relu, view,
                  _plan(view, p, yp), stream)
        ctx.save_for_backward(p, bias, stats)
        ctx.norm, ctx.relu, ctx.pos, ctx.ch, ctx.view = (norm, relu, pos, ch,
                                                        view)
        return y

    @staticmethod
    def backward(ctx, dy):
        p, bias, stats = ctx.saved_tensors
        norm, view, pos, ch = ctx.norm, ctx.view, ctx.pos, ctx.ch
        G, O, C, I = view
        count = O * I
        stream = current_stream(p)
        dy = (dy if pos == ch else dy.movedim(ch, pos)).contiguous()
        plan = _plan(view, p, dy)
        part = p.new_empty((2, G * C, plan.P), dtype=stats.dtype)
        _run_pass(GRAD_SUMS, p, dy, None, stats, bias, None, part, ctx.relu,
                  view, plan, stream)
        sums = p.new_empty((2, G * C), dtype=stats.dtype)
        coef = None
        if norm.kind == "instance" or norm.training:
            coef = torch.empty_like(sums)
            keep = stats[3]
            if norm.kind == "batch" and norm.reduce is not None:
                _finalize_bwd(p, part, count, stream, sums=sums)
                total, n = _combined(norm.reduce, sums, count)
                _finalize_bwd(p, total, n, stream, keep=keep, coef=coef)
            else:
                _finalize_bwd(p, part, count, stream, keep=keep, sums=sums,
                              coef=coef)
        else:
            _finalize_bwd(p, part, count, stream, sums=sums)
        dxp = torch.empty_like(p)
        _run_pass(GRAD, p, dy, dxp, stats, bias, coef, None, ctx.relu, view,
                  _plan(view, p, dy, dxp), stream)
        if G > 1:
            sums = sums.view(2, G, C).sum(1)
        return (dxp if pos == ch else dxp.movedim(pos, ch)), sums[1], \
            sums[0], None, None


def norm_cuda(norm, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """``norm`` (a ``models/layers.py::Norm``) on the CUDA tensor ``x``,
    followed by a ReLU where ``relu``: the same function as
    ``Norm.plain`` (+ ``F.relu``), in train mode updating the running
    statistics in place."""
    if x.device.type != "cuda":
        raise ValueError("norm_cuda takes a CUDA tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"norm_cuda takes bf16, f32 or f64, not {x.dtype}")
    if x.numel() == 0:
        raise ValueError("norm_cuda takes a non-empty tensor")
    acc = _acc(x.dtype)
    params = [norm.weight, norm.bias]
    if norm.kind == "batch":
        params += [norm.running_mean, norm.running_var]
    if any(t.dtype != acc or t.device != x.device for t in params):
        raise TypeError(f"norm_cuda: a {x.dtype} input takes the norm's "
                        f"parameters and statistics in {acc} on its device")
    return _NormFunction.apply(x, norm.weight, norm.bias, norm, relu)


norm_cuda.launches = 0


def norm_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                        stats: torch.Tensor, bias: torch.Tensor, *,
                        channel_axis: int, kind: str, relu: bool,
                        batch_stats: bool, reduce=None):
    """dx, dweight, dbias of the norm (+ ReLU) in the closed form the
    kernel implements, from :func:`channel_stats`'s ``stats`` (mean, rstd,
    mul, keep per (g, c)).  With ``xhat = (x - mean) rstd``, ``dy'`` the
    gradient masked by the ReLU (0 where the rounded forward output is
    <= 0) and ``n`` the count of a channel: ``dx = mul (dy' - sum(dy') / n
    - xhat sum(dy' xhat) / n)``, the sums over the ranks under ``reduce``,
    the last term 0 where the variance was clamped (the clamp's gradient
    is 0 there); with running statistics (``batch_stats`` False, eval
    mode), constants, ``dx = mul dy'``.  ``dweight = sum(dy' xhat)``,
    ``dbias = sum(dy')`` over this process's data."""
    ch = channel_axis % x.dim()
    p, pos, (G, O, C, I) = norm_view(x, channel_axis, kind)
    x4 = widen(p).reshape(G, O, C, I)
    g4 = widen(dy.movedim(ch, pos)).reshape(G, O, C, I)
    mean, rstd, mul, keep = (t.reshape(G, 1, C, 1) for t in stats)
    if relu:
        y = ((x4 - mean) * mul + bias.reshape(1, 1, C, 1)).to(x.dtype)
        g4 = torch.where(y <= 0, torch.zeros_like(g4), g4)
    xhat = (x4 - mean) * rstd
    sa, sb = g4.sum((1, 3)), (g4 * xhat).sum((1, 3))
    dweight, dbias = sb.sum(0), sa.sum(0)
    if not batch_stats:
        dx4 = mul * g4
    else:
        n = O * I
        if reduce is not None:
            sa, sb, n = reduce(sa, sb, n)
        ma = (sa / n).reshape(G, 1, C, 1)
        mb = torch.where(keep != 0, (sb / n).reshape(G, 1, C, 1),
                         torch.zeros_like(keep))
        dx4 = mul * (g4 - ma - xhat * mb)
    dx = dx4.to(x.dtype).reshape(p.shape).movedim(pos, ch)
    return dx, dweight, dbias
