"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Run on a machine with an NVIDIA card (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each wrapper is held against its plain version on the same CUDA tensors
in float64 (1e-10 relative to each output's max-abs; the 34-row Kc on
dense rows also in float32, 1e-4), the wrappers refuse
inputs their kernels do not take, and one Newton update of a small fleet
on the card matches the same update on the CPU, for the standing problem,
for the trot (impact slots, switching rows, the chain kernel K6 with the
cost fold) and for the iCub walk (K6's surface-contact instance, the
34-row Kc)."""
import numpy as np
import pytest
import torch

from robotoc_tpu_torch import problems
from robotoc_tpu_torch.models import robot as rm
from robotoc_tpu_torch.ops import chain as chn
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
    args = chip_smoke.lqr_inputs(nf, torch.float64, dev, chip_smoke.N)
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


@pytest.mark.parametrize("make,t0", [(problems.anymal_trot, 0.35),
                                     (problems.icub_walk, 0.62)],
                         ids=["point", "surface"])
@pytest.mark.parametrize("with_cost", [False, True])
def test_chain_kernel_matches_plain(dev, with_cost, make, t0):
    import chip_smoke
    p = make(N=4, device=dev, t0=t0)
    sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, 2)
    sb, gb, _, _, _ = OS._fleet(chip_smoke.perturbed(p.model, sol), p.grid,
                                q0s, v0s)
    args, cost = chip_smoke.chain_args(p.model, p.mpc.contacts, p.costs, sb,
                                       gb, with_cost)
    chn.chain.launches = 0
    got = chn.chain(p.model, p.mpc.contacts, *args, *cost)
    want = chn.chain_plain(p.model, p.mpc.contacts, *args, *cost)
    assert chn.chain.launches == 1
    names = chn._OUTS + (chn._COST_OUTS if with_cost else ())
    _close([got[n] for n in names], [want[n] for n in names])


def test_trot_update_on_card_matches_cpu(dev):
    results = []
    for d in (dev, torch.device("cpu")):
        p = problems.anymal_trot(N=4, device=d)
        sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, 2)
        new, kkt, _, _ = p.solver.update(p.grid, q0s, v0s, sol)
        results.append((new, kkt))
    (nc, kc), (nh, kh) = results
    assert torch.allclose(kc.cpu(), kh, rtol=1e-10)
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "xi"):
        want = getattr(nh, name)
        err = float((getattr(nc, name).cpu() - want).abs().max())
        assert err <= 1e-8 * max(1.0, float(want.abs().max())), name


def test_kc_34_rows_matches_plain(dev):
    """Kc on the walk's 2 x 17 wrench-cone rows."""
    p = problems.icub_walk(N=4, device=dev, t0=0.62)
    sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, 2)
    sb, gb, _, _, _ = OS._fleet(sol, p.grid, q0s, v0s)
    pre = OS.stage_inputs(p.model, p.mpc.contacts, p.mpc.limits, 1e-3,
                          p.costs, sb, gb)
    args = [pre[k].contiguous() for k in ("dgdq", "dgdf", "d_cone")]
    assert args[2].shape[-1] == 34
    cd.kc.launches = 0
    _close(cd.kc(*args), cd.kc_plain(*args))
    assert cd.kc.launches == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_kc_34_rows_dense_matches_plain(dev, dtype, tol):
    """Kc at 34 rows on seeded dense rows (the walk's own dgdq rows are
    zero) at the walk fleet's 128 x 28 stage slots."""
    rng = np.random.default_rng(5)
    S = 128 * 28
    args = [torch.as_tensor(x, dtype=dtype, device=dev) for x in (
        rng.standard_normal((S, 34, 18)), rng.standard_normal((S, 34, 12)),
        np.exp(rng.standard_normal((S, 34))))]
    cd.kc.launches = 0
    _close(cd.kc(*args), cd.kc_plain(*args), tol)
    assert cd.kc.launches == 1


def test_walk_update_on_card_matches_cpu(dev):
    results = []
    for d in (dev, torch.device("cpu")):
        p = problems.icub_walk(N=4, device=d, t0=0.62)
        sol, q0s, v0s = problems.fleet(p.solver, p.grid, p.q0, p.v0, 2,
                                       scale=0.0075)
        new, kkt, _, _ = p.solver.update(p.grid, q0s, v0s, sol)
        results.append((new, kkt))
    (nc, kc), (nh, kh) = results
    assert torch.allclose(kc.cpu(), kh, rtol=1e-10)
    for name in ("q", "v", "a", "u", "f", "lmd", "gmm", "xi"):
        want = getattr(nh, name)
        err = float((getattr(nc, name).cpu() - want).abs().max())
        assert err <= 1e-8 * max(1.0, float(want.abs().max())), name
