"""The frustum inits depend on the seed only, not on the device: the
port's ``sample_inits`` draws on its generator's device and moves the
draws to ``ang``'s, and the harness seeds CPU generators for the frustum
method and the frustum ICP seeds (the JAX package's ``jax.random`` is the
same on every backend too).  The ``meta`` device stands in for the card,
which this machine lacks: inits for an ``ang`` there must still be drawn
by the CPU generator, and the harness runs there with its solvers
recorded."""
import os

import jax  # noqa: F401  (port tests hold both frameworks)
import math

import numpy as np
import pytest
import torch

from deepi2p_tpu_torch.eval import dump as tdump
from deepi2p_tpu_torch.eval import harness
from deepi2p_tpu_torch.register import frustum as tf
from deepi2p_tpu_torch.register.icp import ICPResult

H, W = 160, 512
K_NP = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]],
                np.float32)


@pytest.mark.parametrize("is_2d", [True, False])
def test_sample_inits_depend_on_the_seed_only(is_2d):
    """A CPU generator: the same seed gives the same inits for any ang
    (the draws are ry - ang and tz), equal to the generator's own normal
    and uniform draws, and they land on ang's device."""
    B, n = 3, 16
    sigma, amp = 10.0 * math.pi / 180.0, 10.0
    angs = [torch.tensor([0.3, -1.0, 2.5]), torch.tensor([-2.0, 0.0, 1.0])]
    outs = [tf.sample_inits(torch.Generator().manual_seed(11), a, n,
                            is_2d=is_2d) for a in angs]
    g = torch.Generator().manual_seed(11)
    noise = torch.randn(B, n, generator=g)
    u = torch.rand(B, n, generator=g)
    ry_col, tz_col = (0, 3) if is_2d else (1, 5)
    for a, th in zip(angs, outs):
        assert tuple(th.shape) == (B, n, 4 if is_2d else 6)
        torch.testing.assert_close(th[..., ry_col], a[:, None] + sigma * noise,
                                   rtol=0, atol=0)
        torch.testing.assert_close(th[..., tz_col], (u * 2.0 - 1.0) * amp,
                                   rtol=0, atol=0)
    # ang elsewhere: the CPU generator still makes the draws (its state
    # moves on exactly as above) and the inits land on ang's device
    g_meta = torch.Generator().manual_seed(11)
    meta = tf.sample_inits(g_meta, angs[0].to("meta"), n, is_2d=is_2d)
    assert meta.device.type == "meta" and meta.shape == outs[0].shape
    assert torch.equal(g_meta.get_state(), g.get_state())


def _dump_dir(tmp_path, n=2, N=64):
    """A dump of n pairs (identity poses, half the points inside) and
    their pseudo clouds."""
    rng = np.random.default_rng(0)
    out, pdir = tmp_path / "dump", tmp_path / "pseudo"
    out.mkdir()
    pdir.mkdir()
    for i in range(n):
        pc = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
        inside = (pc[:, 2] > 0).astype(np.int64)
        zeros = np.zeros(N, np.int64)
        tdump.save_sample_dump(str(out), f"{i:06d}_00", pc=pc,
                               coarse_pred=inside, coarse_label=inside,
                               fine_pred=zeros, fine_label=zeros, K=K_NP,
                               P=np.eye(4, dtype=np.float32)[:3])
        np.save(os.path.join(pdir, f"{i:06d}_00_pc.npy"), pc[:40].T)
    return str(out), str(pdir)


@pytest.fixture
def recorded(monkeypatch):
    """Replace the solvers the harness calls by recorders: the frustum
    solve notes its generator and gives identity poses; ICP gives the
    seeds back."""
    gens = []

    def solve(pc, pred, K, *, generator=None, **kw):
        gens.append(generator)
        B = pc.shape[0]
        return torch.eye(4).repeat(B, 1, 1), torch.zeros(B)

    def icp(source, target, generator, *, P_seed=None, **kw):
        B = source.shape[0]
        P = torch.eye(4).repeat(B, 1, 1) if P_seed is None else \
            torch.as_tensor(P_seed)
        return ICPResult(P=P, fitness=torch.zeros(B))

    monkeypatch.setattr(harness, "solve_frustum_batch", solve)
    monkeypatch.setattr(harness, "icp_batch", icp)
    return gens


# the harness on the meta device (its tensors go there, the recorders
# answer on the CPU): a generator made for the harness's device would be
# refused there, and a CPU one is what the fix asks for
@pytest.mark.parametrize("method,icp_seed", [("frustum", "none"),
                                             ("icp", "frustum")])
def test_harness_draws_frustum_inits_on_a_cpu_generator(tmp_path, recorded,
                                                        method, icp_seed):
    out, pdir = _dump_dir(tmp_path)
    summ = harness.evaluate_registration(
        out, method=method, icp_seed=icp_seed, pseudo_dir=pdir, H=H, W=W,
        batch_size=2, n_inits=8, max_iter=2, device="meta")
    assert summ["num_pairs"] == 2
    assert len(recorded) == 1
    gen = recorded[0]
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
