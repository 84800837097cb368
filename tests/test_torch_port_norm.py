"""The norm kernel pair (``ops/norm_cuda.py``, ``csrc/norm.cu``) and its
plain versions.

On the CPU: the closed-form backward the kernel implements
(``norm_backward_plain``) against autograd of ``Norm``'s tensor code, in
float64 within 1e-10, over layouts, kinds, the ReLU, both modes, a
clamped variance and a ``reduce`` hook; the (G, O, C, I) view and the
launch plan the wrapper hands the kernel; and that a CPU tensor takes
the plain path.

On the card (marker ``chip``; ``python -m pytest --noconftest -m chip
tests/test_torch_port_norm.py``): the kernel against the plain version
in bf16, f32 and f64 (y and the running statistics bitwise, the
gradients within stated tolerances), and two calls on the same inputs
bitwise equal.
"""
import copy

import pytest
import torch
import torch.nn.functional as F

from deepi2p_tpu_torch.models.layers import Norm, PNLayer
from deepi2p_tpu_torch.ops import norm_cuda as nc
from torch_port_fixtures import one_torch_thread  # noqa: F401

# (x shape, channel axis, memory layout)
LAYOUTS = {
    "points": ((3, 17, 8), -1, None),
    "nchw": ((3, 8, 5, 6), 1, None),
    "nchw_last": ((3, 8, 5, 6), 1, torch.channels_last),
}
CLOSED_FORM_RTOL = 1e-10


def make_x(layout, dtype=torch.float64, device="cpu", seed=0):
    shape, ch, fmt = LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 1.7 + 0.4)
    x = x.to(dtype).to(device)
    if fmt is not None:
        x = x.contiguous(memory_format=fmt)
    return x, ch


def make_norm(C, kind, ch, dtype=torch.float64, device="cpu", seed=1,
              train=True):
    norm = Norm(C, kind, channel_axis=ch).to(device=device, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(C, generator=g, dtype=dtype) + 0.5)
        norm.bias.copy_(torch.randn(C, generator=g, dtype=dtype) * 0.3)
        if kind == "batch":
            norm.running_mean.copy_(torch.randn(C, generator=g, dtype=dtype))
            norm.running_var.copy_(torch.rand(C, generator=g, dtype=dtype)
                                   + 0.5)
    return norm.train(train)


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def autograd_of_norm(norm, x, dy, relu):
    """y and (dx, dweight, dbias) of ``Norm``'s tensor code by autograd."""
    x = x.detach().requires_grad_(True)
    y = norm.plain(x)
    if relu:
        y = F.relu(y)
    dx, dw, db = torch.autograd.grad(y, (x, norm.weight, norm.bias), dy)
    return y.detach(), dx, dw, db


def closed_form(norm, x, dy, relu):
    """(dx, dweight, dbias) by ``norm_backward_plain`` on the statistics
    the forward takes (``channel_stats_plain``)."""
    x = x.detach()
    batch_stats = norm.kind == "instance" or norm.training
    with torch.no_grad():
        stats = nc.channel_stats_plain(norm, x, norm.weight)
        return nc.norm_backward_plain(
            x, dy, stats, norm.bias, channel_axis=norm.channel_axis,
            kind=norm.kind, relu=relu, batch_stats=batch_stats,
            reduce=norm.reduce if batch_stats else None)


def check_closed_form(norm, x, relu, seed=2):
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(x.shape, generator=g, dtype=x.dtype)
    want = autograd_of_norm(copy.deepcopy(norm), x, dy, relu)[1:]
    got = closed_form(norm, x, dy, relu)
    for name, a, b in zip(("dx", "dweight", "dbias"), got, want):
        assert a.shape == b.shape, name
        assert rel(a, b) < CLOSED_FORM_RTOL, (name, rel(a, b))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("kind", ["batch", "instance"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_closed_form_backward_is_autograd_of_norm(layout, kind, relu, train):
    x, ch = make_x(layout)
    norm = make_norm(x.shape[ch], kind, ch, train=train)
    check_closed_form(norm, x, relu)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_closed_form_with_a_clamped_variance(layout, relu):
    """A channel of one repeated value whose E[x^2] - mean^2 rounds below
    0: the variance is clamped and its term drops from dx."""
    x, ch = make_x(layout)
    C = x.shape[ch]
    norm = make_norm(C, "batch", ch)
    for v in (0.1, 0.3, 0.7, 1.1, 1.3, 2.9, 3.7, 0.35, 0.55, 0.15):
        x.select(ch, 0).fill_(v)
        clamped = copy.deepcopy(norm).statistics(x)[2].reshape(-1)
        if clamped[0]:
            break
    assert bool(clamped[0]) and not bool(clamped[1:].any())
    check_closed_form(norm, x, relu)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_closed_form_under_a_reduce_hook(layout, relu):
    """``Norm.reduce`` as over two ranks holding the same data: the
    hook doubles the sums and the count, and its gradient flows back
    through both, as through ``parallel/collectives.py::BatchStats``."""
    x, ch = make_x(layout)
    norm = make_norm(x.shape[ch], "batch", ch)
    calls = []

    def doubled(s, ss, n):
        calls.append(n)
        return 2 * s, 2 * ss, 2 * n

    norm.reduce = doubled
    check_closed_form(norm, x, relu)
    assert len(calls) == 3      # autograd's forward, the closed form's two


# (shape, channel axis, kind, memory layout or permutation) -> pos, view
VIEWS = [
    ((4, 10, 6), -1, "batch", None, 2, (1, 40, 6, 1)),
    ((4, 10, 6), -1, "instance", None, 2, (4, 10, 6, 1)),
    ((4, 10, 3, 6), -1, "batch", None, 3, (1, 120, 6, 1)),
    ((2, 6, 5, 7), 1, "batch", None, 1, (1, 2, 6, 35)),
    ((2, 6, 5, 7), 1, "instance", None, 1, (2, 1, 6, 35)),
    ((2, 6, 5, 7), 1, "batch", torch.channels_last, 3, (1, 70, 6, 1)),
    ((2, 6, 5, 7), 1, "instance", torch.channels_last, 3, (2, 35, 6, 1)),
    # an NHWC view of an NCHW map (models/extra_layers.py's convolutions)
    ((2, 5, 7, 6), -1, "batch", (0, 2, 3, 1), 1, (1, 2, 6, 35)),
    ((2, 5, 7, 6), -1, "instance", (0, 2, 3, 1), 1, (2, 1, 6, 35)),
]


@pytest.mark.parametrize("shape,ch,kind,layout,pos,view", VIEWS)
def test_view_walks_memory_in_order_without_a_copy(shape, ch, kind, layout,
                                                   pos, view):
    if isinstance(layout, tuple):
        nchw = (shape[0], shape[-1], *shape[1:-1])
        x = torch.randn(nchw).permute(*layout)
    else:
        x = torch.randn(shape)
        if layout is not None:
            x = x.contiguous(memory_format=layout)
    p, got_pos, got = nc.norm_view(x, ch, kind)
    assert (got_pos, tuple(got)) == (pos, view)
    assert p.is_contiguous() and p.data_ptr() == x.data_ptr()
    assert torch.equal(p.movedim(got_pos, ch % x.dim()), x)


def test_view_of_a_strided_tensor_is_a_contiguous_copy():
    x = torch.randn(4, 10, 12)[:, ::2, :6]
    p, pos, view = nc.norm_view(x, -1, "batch")
    assert p.is_contiguous() and torch.equal(p, x)
    assert (pos, tuple(view)) == (2, (1, 20, 6, 1))


H100_SMS = 132


@pytest.mark.parametrize("view,itemsize,aligned,plan", [
    # the head's 2 layers at B = 64, N = 20480: 8 channels a 16-byte load,
    # a warp a row, 8 slabs per SM
    ((1, 1310720, 256, 1), 2, True, (8, 32, 1056)),
    ((1, 1310720, 256, 1), 4, True, (4, 64, 1056)),
    ((1, 1310720, 256, 1), 8, True, (2, 128, 1056)),
    # the ResNet stem, channels-last in memory: 8 threads a row
    ((1, 1310720, 64, 1), 2, True, (8, 8, 1056)),
    # a width 16 bytes do not divide, or an unaligned pointer: 1 a load
    ((1, 1000, 100, 1), 2, True, (1, 100, 500)),
    ((1, 1000, 256, 1), 2, False, (1, 256, 1000)),
    # few rows: a slab per thread row, no fewer
    ((1, 10, 64, 1), 2, True, (8, 8, 1)),
    ((1, 100, 64, 1), 2, True, (8, 8, 4)),
    # NCHW: a block per (channel, slab)
    ((1, 64, 64, 20480), 2, True, (8, 0, 17)),
    ((1, 64, 512, 80), 2, True, (8, 0, 3)),
    ((1, 64, 512, 80), 2, False, (1, 0, 3)),
    ((8, 1, 64, 33), 4, True, (1, 0, 1)),
])
def test_plan(view, itemsize, aligned, plan):
    assert tuple(nc.norm_plan(nc.NormView(*view), itemsize, aligned,
                              H100_SMS)) == plan


def test_plan_follows_the_kernel_sizes():
    assert nc.THREADS == 256
    for view in [(1, 7, 24, 1), (3, 5, 4096, 1), (2, 3, 5, 7)]:
        vec, tx, P = nc.norm_plan(nc.NormView(*view), 2, True, H100_SMS)
        G, O, C, I = view
        assert (C if I == 1 else I) % vec == 0 and P >= 1
        if I == 1:
            assert 0 < tx <= nc.THREADS and tx <= C // vec
            assert P <= -(-O // (nc.THREADS // tx))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_cpu_tensor_takes_the_plain_path(layout):
    x, ch = make_x(layout, torch.float32)
    norm = make_norm(x.shape[ch], "batch", ch, torch.float32)
    before = nc.norm_cuda.launches
    ref = copy.deepcopy(norm)
    xr = x.clone().requires_grad_(True)
    y = norm(xr, relu=True)
    y.sum().backward()
    assert nc.norm_cuda.launches == before == 0
    assert torch.equal(y, F.relu(ref.plain(x)))
    assert torch.equal(norm.running_mean, ref.running_mean)
    with pytest.raises(ValueError, match="CUDA"):
        nc.norm_cuda(norm, x)


@pytest.mark.parametrize("activation", ["relu", "elu"])
def test_pn_layer_fuses_only_a_relu(activation):
    layer = PNLayer(5, 8, norm_act=True, normalization="batch",
                    activation=activation, dtype=torch.float32)
    assert layer.fuse_relu == (activation == "relu")
    x = torch.randn(2, 9, 5)
    h = F.linear(x, layer.conv.weight, layer.conv.bias)
    act = F.relu if activation == "relu" else F.elu
    assert torch.equal(layer(x), act(copy.deepcopy(layer.norm).plain(h)))


# --- on the card -----------------------------------------------------------

# the gradients, kernel against plain version on the card, norm-wise:
# (dx, dweight, dbias).  The closed form rounds at other points than
# autograd's f32 chain and sums in another order; bf16: dx is rounded to
# bf16 (2^-8 relative) by both after that
CARD_RTOL = {
    torch.bfloat16: (1e-2, 1e-3, 1e-3),
    torch.float32: (1e-4, 1e-5, 1e-5),
    torch.float64: (1e-10, 1e-12, 1e-12),
}
CARD_LAYOUTS = {
    **LAYOUTS,
    "head": ((2, 4096, 256), -1, None),
    "stem": ((4, 64, 40, 128), 1, torch.channels_last),
    "nchw_big": ((4, 64, 40, 128), 1, None),
    "odd": ((3, 999, 100), -1, None),
    # 2 bytes past a 16-byte boundary: loads of one element
    "offset": ((2, 640, 64), -1, "offset"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def card_case(layout, dtype, kind, relu, train, seed=0, reduce=None):
    """Kernel and plain version on the same CUDA inputs: their outputs,
    gradients and running statistics."""
    shape, ch, fmt = CARD_LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 1.7 + 0.4).to("cuda", dtype)
    if fmt == "offset":
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(shape)
    elif fmt is not None:
        x = x.contiguous(memory_format=fmt)
    dy = torch.randn(shape, generator=g).to("cuda", dtype)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    norm = make_norm(shape[ch], kind, ch, acc, "cuda", train=train)
    norm.reduce = reduce
    ref = copy.deepcopy(norm)
    want = autograd_of_norm(ref, x, dy, relu)
    xk = x.detach().requires_grad_(True)
    y = norm(xk, relu=relu)
    got = (y.detach(), *torch.autograd.grad(y, (xk, norm.weight,
                                                norm.bias), dy))
    stats = [(norm.running_mean, ref.running_mean),
             (norm.running_var, ref.running_var)] if kind == "batch" else []
    return got, want, stats


def check_card_case(dtype, got, want, stats):
    """y and the running statistics bitwise (the same statistics, the
    same operations); the gradients within ``CARD_RTOL``."""
    y, want_y = got[0], want[0]
    assert y.dtype == want_y.dtype and y.stride() == want_y.stride()
    assert torch.equal(y, want_y)
    for name, a, b, tol in zip(("dx", "dweight", "dbias"), got[1:], want[1:],
                               CARD_RTOL[dtype]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert rel(a.double(), b.double()) < tol, (name, rel(a.double(),
                                                             b.double()))
    for a, b in stats:
        assert torch.equal(a, b)


@pytest.mark.chip
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("dtype", list(CARD_RTOL), ids=str)
@pytest.mark.parametrize("layout", list(CARD_LAYOUTS))
def test_kernel_against_plain_on_the_card(card, layout, dtype, relu):
    before = nc.norm_cuda.launches
    check_card_case(dtype, *card_case(layout, dtype, "batch", relu, True))
    assert nc.norm_cuda.launches - before == 6


@pytest.mark.chip
@pytest.mark.parametrize("case", ["instance", "eval", "reduce", "clamped"])
@pytest.mark.parametrize("layout", ["points", "nchw", "stem"])
def test_kernel_modes_on_the_card(card, layout, case):
    dtype = torch.float32
    if case == "clamped":
        shape, ch, fmt = CARD_LAYOUTS[layout]
        x = torch.full(shape, 0.1, dtype=dtype, device="cuda")
        if fmt is not None:
            x = x.contiguous(memory_format=fmt)
        norm = make_norm(shape[ch], "batch", ch, dtype, "cuda")
        ref = copy.deepcopy(norm)
        dy = torch.randn(shape, device="cuda")
        want = autograd_of_norm(ref, x, dy, True)
        xk = x.clone().requires_grad_(True)
        y = norm(xk, relu=True)
        got = (y.detach(), *torch.autograd.grad(
            y, (xk, norm.weight, norm.bias), dy))
        # the variance is 0 or round-off, clamped or not: y is the bias
        # under the ReLU, dx the masked dy less its mean times rstd w, and
        # dweight sums dy' against xhat = (x - mean) rstd, which is the
        # mean's round-off (a few ulps of 0.1) times rstd = eps^-1/2: each
        # side's is noise within that bound
        assert torch.equal(got[0], want[0])
        assert torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
        assert torch.allclose(got[3], want[3], rtol=1e-5, atol=1e-4)
        axes = [a for a in range(len(shape)) if a != ch % len(shape)]
        noise = (dy.abs().sum(axes) * 4 * torch.finfo(dtype).eps * 0.1
                 / norm.eps ** 0.5)
        assert bool((got[2].abs() <= noise).all())
        assert bool((want[2].abs() <= noise).all())
        return
    kind = "instance" if case == "instance" else "batch"

    def doubled(s, ss, n):
        return 2 * s, 2 * ss, 2 * n

    check_card_case(dtype, *card_case(
        layout, dtype, kind, True, case != "eval",
        reduce=doubled if case == "reduce" else None))


@pytest.mark.chip
@pytest.mark.parametrize("case", ["train", "eval", "instance", "reduce"])
@pytest.mark.parametrize("dtype", list(CARD_RTOL), ids=str)
@pytest.mark.parametrize("layout", ["points", "stem", "nchw_big"])
def test_channel_stats_is_its_plain_version_on_the_card(card, layout, dtype,
                                                        case):
    """The per-channel numbers and the running statistics bitwise those
    of ``Norm.statistics`` and ``Norm.plain``'s rsqrt and product."""
    shape, ch, fmt = CARD_LAYOUTS[layout]
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=g) * 1.7 + 0.4).to("cuda", dtype)
    if fmt is not None:
        x = x.contiguous(memory_format=fmt)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    kind = "instance" if case == "instance" else "batch"
    norm = make_norm(shape[ch], kind, ch, acc, "cuda", train=case != "eval")
    if case == "reduce":
        norm.reduce = lambda s, ss, n: (2 * s, 2 * ss, 2 * n)
    ref = copy.deepcopy(norm)
    got = nc.channel_stats(norm, x, norm.weight, nc.current_stream(x))
    want = nc.channel_stats_plain(ref, x, ref.weight)
    assert torch.equal(got, want)
    for a, b in zip(norm.buffers(), ref.buffers()):
        assert torch.equal(a, b)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("layout", ["head", "stem", "nchw_big"])
def test_kernel_is_bitwise_repeatable_on_the_card(card, layout, dtype):
    first, _, stats = card_case(layout, dtype, "batch", True, True)
    again, _, stats2 = card_case(layout, dtype, "batch", True, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for (a, _), (b, _) in zip(stats, stats2):
        assert torch.equal(a, b)
