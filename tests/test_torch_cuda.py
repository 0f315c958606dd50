"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Run on a machine with an NVIDIA card (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each wrapper is held against its plain version on the same CUDA tensors
in float64 (1e-10 relative to each output's max-abs), the wrappers refuse
inputs their kernels do not take, and one Newton update of a small fleet
on the card matches the same update on the CPU."""
import numpy as np
import pytest
import torch

from robotoc_tpu_torch import problems
from robotoc_tpu_torch.models import robot as rm
from robotoc_tpu_torch.ops import condense as cd
from robotoc_tpu_torch.riccati import backward_sweep as bs
from robotoc_tpu_torch.solver import ocp_solver as OS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fleet(p, Bn=2):
    sol = OS.make_initial_solution(p.model, p.contacts, p.limits, 1e-3,
                                   p.grid, p.q0, p.v0).map(
        lambda x: x.expand((Bn,) + x.shape).contiguous())
    rng = np.random.default_rng(0)
    dq = torch.as_tensor(0.03 * rng.standard_normal((Bn, 18)),
                         dtype=p.model.dtype, device=p.model.device)
    q0s = rm.integrate(p.model, p.q0.expand(Bn, 19), dq)
    return sol, q0s, torch.zeros_like(dq)


def _close(got, want, tol=1e-10):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert float((g - w).abs().max()) <= tol * max(
            float(w.abs().max()), 1e-30)


def test_condense_kernels_match_plain(dev):
    p = problems.anymal_standing(N=4, device=dev)
    sol, q0s, v0s = _fleet(p)
    sb, gb, _, _, _ = OS._fleet(sol, p.grid, q0s, v0s)
    pre = OS.stage_inputs(p.model, p.contacts, p.limits, 1e-3, (p.cost,),
                          sb, gb)
    x = {k: pre[k].contiguous() for k in cd.IN_NAMES}
    cd.reset_launches()
    out_k = cd.condense(x, use_kernels=True)
    out_p = cd.condense(x, use_kernels=False)
    _close([out_k[n] for n in cd.OUT_NAMES], [out_p[n] for n in cd.OUT_NAMES])
    assert all(w.launches == 1 for w in cd.WRAPPERS)


@pytest.mark.parametrize("nf", [0, 12])
def test_bwd_kernel_matches_plain(dev, nf):
    import chip_smoke
    args = chip_smoke.lqr_inputs(nf, torch.float64, dev)
    _close(bs.bwd(*args), bs.bwd_plain(*args))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    M = torch.zeros(4, 18, 18, dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        cd.kc(M[:, :20], M[:, :20, :12], M[:, :20, 0])
    G = torch.zeros(4, 48, 30, device=dev).transpose(-1, -2)
    with pytest.raises(ValueError):
        cd.k3(G, *[torch.zeros(s, device=dev) for s in
                   [(4, 30), (4, 48), (4, 18, 18), (4, 18, 18), (4, 18),
                    (4, 18), (4,), (4, 36), (4, 36)]])


def test_update_on_card_matches_cpu(dev):
    results = []
    for d in (dev, torch.device("cpu")):
        p = problems.anymal_standing(N=4, device=d)
        sol, q0s, v0s = _fleet(p)
        new, kkt, _, _ = OS._update(p.model, p.contacts, p.limits, 1e-3,
                                    0.995, (p.cost,), sol, p.grid, q0s, v0s)
        results.append((new, kkt))
    (nc, kc), (nh, kh) = results
    assert torch.allclose(kc.cpu(), kh, rtol=1e-10)
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm"):
        want = getattr(nh, name)
        err = float((getattr(nc, name).cpu() - want).abs().max())
        assert err <= 1e-8 * max(1.0, float(want.abs().max())), name
