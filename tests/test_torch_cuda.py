"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Run on a machine with an NVIDIA card (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each wrapper is held against its plain version on the same CUDA tensors
in float64 (1e-10 relative to each output's max-abs; K1, K2 and Kc at
the fleets' stage counts on seeded inputs and K6 also in float32, 1e-4,
K1's and K2's outputs filled with NaN first; K3 the same way; K6 also on the full
iCub's nv 35 tree), the wrappers refuse
inputs their kernels do not take (K6 a chain layout past its workspace),
and one Newton update of a small fleet
on the card matches the same update on the CPU, for the standing problem,
for the trot (impact slots, switching rows, the chain kernel K6 with the
cost fold) and for the iCub walk (K6's surface-contact instance, the
34-row Kc). The closed loop's plant replays its substeps as one CUDA graph
on the card: the replay equals the same ops launched one by one."""
import dataclasses

import numpy as np
import pytest
import torch

from robotoc_tpu_torch import convert, problems
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
    """At the standing path's 128 x 20, and at B = 3 scenarios of N = 1
    step (no step fetched ahead) in float64 and float32."""
    import chip_smoke
    args = chip_smoke.lqr_inputs(nf, torch.float64, dev, chip_smoke.N)
    _close(bs.bwd(*args), bs.bwd_plain(*args))
    # per-step fields (B, N, ...) keep their last step; QxxN, lxN (8, 9)
    # are per scenario
    small = [None if x is None else
             (x[:3] if i in (8, 9) else x[:3, -1:]).contiguous()
             for i, x in enumerate(args)]
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        a = [None if x is None else x.to(dtype) for x in small]
        bs.bwd.launches = 0
        _close(bs.bwd(*a), bs.bwd_plain(*a), tol)
        assert bs.bwd.launches == 1


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
    # 1, 3 and 7 stages (a warp per stage, four to a block: the last block
    # part full), float64 and float32
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        model = convert.astype(p.model, dtype)
        contacts = convert.astype(p.mpc.contacts, dtype)
        for S in (1, 3, 7):
            a = [x[-S:].to(dtype).contiguous() for x in args + list(cost)]
            got = chn.chain(model, contacts, *a)
            want = chn.chain_plain(model, contacts, *a)
            _close([got[n] for n in names], [want[n] for n in names], tol)


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


@pytest.mark.parametrize("rows,fleet", [(20, 128 * 20), (20, 128 * 24),
                                        (34, 128 * 28)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_kc_matches_plain_on_stage_counts(dev, rows, fleet, dtype, tol):
    """Kc (a warp per stage, four stages a block) at 20 and 34 rows on
    seeded dense rows: 1, 3 and 7 stages (the last block part full) and
    the fleets' stage counts (standing 128 x 20, trot 128 x 24, walk
    128 x 28)."""
    rng = np.random.default_rng(rows)
    for S in (1, 3, 7, fleet):
        args = [torch.as_tensor(x, dtype=dtype, device=dev) for x in (
            rng.standard_normal((S, rows, 18)),
            rng.standard_normal((S, rows, 12)),
            np.exp(rng.standard_normal((S, rows))))]
        cd.kc.launches = 0
        _close(cd.kc(*args), cd.kc_plain(*args), tol)
        assert cd.kc.launches == 1


def _k1_args(rng, S, dtype, dev):
    """Seeded K1 inputs: M symmetric positive definite, J of full row rank,
    about a third of the contact rows inactive."""
    X = rng.standard_normal((S, 18, 18))
    M = X @ np.swapaxes(X, -1, -2) / 18 + np.eye(18)
    ins = (M, 0.3 * rng.standard_normal((S, 12, 18)),
           (rng.uniform(size=(S, 12)) < 0.3).astype(float),
           rng.standard_normal((S, 18, 48)), rng.standard_normal((S, 12, 48)),
           rng.standard_normal((S, 18)), rng.standard_normal((S, 12)))
    return [torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
            for x in ins]


def _k2_args(rng, S, dtype, dev):
    shapes = ((30, 48), (30,), (18, 18), (18, 18), (12, 12), (18, 18),
              (12, 12), (18, 12), (48,), (30,))
    return [torch.as_tensor(rng.standard_normal((S,) + sh), dtype=dtype,
                            device=dev) for sh in shapes]


# K1's and K2's library entries, their dims, inputs and output shapes
_K12 = {"k1": ("rtt_condense_k1", (18, 12, 48), _k1_args,
               ((18, 18), (18, 12), (12, 12), (30, 48), (30,))),
        "k2": ("rtt_condense_k2", (18, 12, 12), _k2_args,
               ((36, 36), (36, 12), (12, 12), (48,)))}


@pytest.mark.parametrize("name", ["k1", "k2"])
@pytest.mark.parametrize("fleet", [128 * 20, 128 * 24, 128 * 28])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_k1_k2_match_plain_on_stage_counts(dev, name, fleet, dtype, tol):
    """K1 (a warp per stage, four stages a block) and K2 (a block of four
    warps per stage) on seeded inputs: 1, 3 and 7 stages (K1's last block
    part full) and the fleets' stage counts (standing 128 x 20, trot
    128 x 24, walk 128 x 28); the library's outputs filled with NaN first,
    so that an entry the kernel does not write shows; the wrapper counts
    its launch."""
    entry, dims, make, shapes = _K12[name]
    wrapper, plain = getattr(cd, name), getattr(cd, name + "_plain")
    rng = np.random.default_rng(fleet + (name == "k2"))
    for S in (1, 3, 7, fleet):
        args = make(rng, S, dtype, dev)
        want = plain(*args)
        outs = [torch.full((S,) + sh, float("nan"), dtype=dtype, device=dev)
                for sh in shapes]
        cd._launch(name, getattr(cd._lib(), entry), dims, args, outs)
        torch.cuda.synchronize()
        _close(outs, want, tol)
        wrapper.launches = 0
        _close(wrapper(*args), want, tol)
        assert wrapper.launches == 1


def _k3_args(rng, S, dtype, dev):
    shapes = ((30, 48), (30,), (48,), (18, 18), (18, 18), (18,), (18,), (),
              (36,), (36,))
    return [torch.as_tensor(rng.standard_normal((S,) + sh), dtype=dtype,
                            device=dev) for sh in shapes]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_k3_matches_plain_on_stage_counts(dev, dtype, tol):
    """K3 (a thread per 16-byte column chunk of a stage) on seeded inputs:
    1, 3 and 7 stages (a block's last stages part full) and the fleets'
    stage counts (standing 128 x 20, trot 128 x 24, walk 128 x 28); the
    library's outputs filled with NaN first, so that an entry the kernel
    does not write shows; the wrapper counts its launch."""
    shapes = ((36, 36), (36, 12), (36,), (36,), (12,))
    rng = np.random.default_rng(3)
    for S in (1, 3, 7, 128 * 20, 128 * 24, 128 * 28):
        args = _k3_args(rng, S, dtype, dev)
        want = cd.k3_plain(*args)
        outs = [torch.full((S,) + sh, float("nan"), dtype=dtype, device=dev)
                for sh in shapes]
        cd._launch("k3", cd._lib().rtt_condense_k3, (18, 12, 12), args,
                   outs)
        torch.cuda.synchronize()
        _close(outs, want, tol)
        cd.k3.launches = 0
        _close(cd.k3(*args), want, tol)
        assert cd.k3.launches == 1


@pytest.mark.parametrize("with_cost", [False, True])
def test_chain_kernel_nv35_matches_plain(dev, with_cost):
    """K6 on the full iCub (nv 35, the torso chain carrying both arms,
    two soles) on seeded stages: 1, 3 and 7 stages and 64, in float64 and
    float32."""
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        model, contacts = problems.icub_soles(dtype=dtype, device=dev)
        names = chn._OUTS + (chn._COST_OUTS if with_cost else ())
        for S in (1, 3, 7, 64):
            args, cost = problems.chain_stages(model, contacts, S, seed=S,
                                               with_cost=with_cost)
            chn.chain.launches = 0
            got = chn.chain(model, contacts, *args, *cost)
            want = chn.chain_plain(model, contacts, *args, *cost)
            assert chn.chain.launches == 1
            _close([got[n] for n in names], [want[n] for n in names], tol)


def test_chain_refuses_a_layout_past_its_workspace(dev):
    """The full iCub's joints hung as one serial chain of 29: longer than
    the nv 35 instance's workspace holds (csrc/chain_stage.cuh, ChainTree);
    the launch refuses it and the wrapper raises, launching nothing."""
    model, contacts = problems.icub_soles(device=dev)
    serial = dataclasses.replace(model, parents=(-1,) + tuple(
        range(model.nj - 1)))
    args, _ = problems.chain_stages(model, contacts, 2, seed=1)
    chn.chain.launches = 0
    with pytest.raises(ValueError, match="do not fit"):
        chn.chain(serial, contacts, *args)
    assert chn.chain.launches == 0


def test_plant_graph_replay_matches_its_ops(dev):
    """The plant's step on the card (its 10 substeps replayed as one
    captured CUDA graph) equals the same substeps launched op by op, on
    two consecutive ticks from a state with feet in the ground (1e-12 of
    max(1, |x|))."""
    p = problems.anymal_trot_sim(N=4, device=dev)
    sim = p.simulator
    q = p.q0.clone()
    q[2] -= 0.01
    state = sim.init(q, torch.full((18,), 0.1, dtype=q.dtype, device=dev))
    u = torch.linspace(-5.0, 5.0, 12, dtype=q.dtype, device=dev)
    for _ in range(2):
        got = sim.step(state, u, n_substeps=10)
        want = sim._substeps(state, u, 10)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-12 * max(
                1.0, float(w.abs().max()))
        state = got
    assert len(sim._graphs) == 1
