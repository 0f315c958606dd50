"""The Unitree A1 on the port against the JAX package, f64, on the CPU.

  * The bundled description and the model's kinematics and dynamics
    (forward kinematics of the feet, CoM, rnea, crba) on seeded states:
    1e-12 (the derivatives are K6's outputs, held against the XLA oracle
    below).
  * The chain kernel K6 on the A1 tree: its chain layout (four chains of
    three joints on the base, as ANYmal's, the feet on the chains in
    another order), K6's (18, 13, 4, point) instance named for it; on the
    stage slots of the A1 trot (examples/a1_trot_mpc.py's gait at N = 6,
    planned at t = 0.35, its gait stack folding) at an iterate moved by
    numpy-seeded noise, without and with the cost fold, at the tolerances
    tests/test_torch_chain.py holds ANYmal to: chain_plain against the XLA
    oracles 1e-9 and against pallas_chain.make_chain(interpret=True) 1e-6,
    K6's host build (g++) against chain_plain 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import A1_FEET, A1_Q0, assert_close, jit_unoptimised
from test_torch_chain import (_case, _check_host_build,
                              _check_pallas_interpret, _check_xla_oracles,
                              host)  # noqa: F401 (a fixture)

from robotoc_tpu.models import contacts as jct
from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.models import robot as jrm
from robotoc_tpu_torch import problems
from robotoc_tpu_torch.models import contacts as tct
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.ops import chain as chn


@pytest.fixture(scope="module")
def models():
    jm = jload("a1")
    tm = load_robot("a1", device="cpu")
    return (jm, tm, jct.make_contacts(jm, A1_FEET, baumgarte_time_step=0.05),
            tct.make_contacts(tm, A1_FEET, baumgarte_time_step=0.05))


def test_a1_description_matches_jax(models):
    jm, tm, jc, tc = models
    assert (tm.nq, tm.nv, tm.nj, tm.dimu) == (jm.nq, jm.nv, jm.nj, jm.dimu)
    for f in dataclasses.fields(tm):
        want = getattr(jm, f.name, None)
        got = getattr(tm, f.name)
        if isinstance(got, torch.Tensor) and want is not None:
            assert_close(got.numpy(), np.asarray(want), 0.0, f.name)
        elif isinstance(got, (tuple, int, str)) and want is not None:
            assert tuple(np.atleast_1d(got)) == tuple(np.atleast_1d(want)), \
                f.name
    assert tuple(tc.frame_ids) == tuple(jc.frame_ids)
    assert problems.A1_FEET == tuple(A1_FEET)
    assert_close(problems.a1_q0(), np.asarray(A1_Q0), 0.0)
    assert_close(np.asarray([problems.a1_terrain(x, y) for x, y in
                             ((0.3, -0.2), (1.1, 0.4))]),
                 [0.03 * np.sin(4 * x) * np.cos(3 * y) + 0.04 * x
                  for x, y in ((0.3, -0.2), (1.1, 0.4))], 1e-15)


def _quantities(rm, model, fids, q, v, a):
    """One state's kinematics and dynamics through a package's robot
    module `rm`."""
    R_w, p_w = rm.forward_kinematics(model, q)
    feet = [rm.frame_placement(model, f, R_w, p_w) for f in fids]
    return ([R for R, _ in feet], [p for _, p in feet], rm.com(model, q),
            rm.rnea(model, q, v, a), rm.crba(model, q))


def test_a1_model_matches_jax(models):
    jm, tm, jc, tc = models
    rng = np.random.default_rng(8)
    n = 4
    dq0 = 0.3 * rng.standard_normal((n, 18))
    q = np.asarray(jax.vmap(lambda d: jrm.integrate(
        jm, jnp.asarray(A1_Q0), d))(dq0))
    v, a = (rng.standard_normal((n, 18)) for _ in range(2))
    fids = tuple(jc.frame_ids)
    want = jit_unoptimised(jax.vmap(
        lambda *x: _quantities(jrm, jm, fids, *x)))(
        q, v, a)
    got = torch.func.vmap(lambda *x: _quantities(trm, tm, fids, *x))(
        *[torch.as_tensor(x) for x in (q, v, a)])
    w_leaves, g_leaves = jax.tree.leaves(want), jax.tree.leaves(
        jax.tree.map(lambda x: x.numpy(), got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(w_leaves) == len(g_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert_close(g / scale, np.asarray(w) / scale, 1e-12, f"leaf {i}")


def test_a1_chain_layout(models):
    """Four chains of three joints on the base, like ANYmal's; the feet
    (FL, RL, FR, RR) sit on chains 1, 3, 0, 2 (ANYmal's LF, LH, RF, RH on
    0, 2, 1, 3). The (18, 13, 4, point) instance, in the library
    csrc/chain.cu, takes it (its host build below)."""
    _, tm, _, tc = models
    lay = chn.chain_layout(tm, tc)
    assert lay.first == (1, 4, 7, 10) and lay.length == (3, 3, 3, 3)
    assert lay.parent == (0, 0, 0, 0) and lay.level == (0, 0, 0, 0)
    assert lay.contact_chain == (1, 3, 0, 2)
    assert chn.chain_supported(tm, tc)
    meta = chn.chain_meta(tm, tc)
    assert chn._dims(meta) in chn.KERNEL_DIMS
    assert chn.KERNEL_LIBRARY.get(chn._dims(meta), "chain") == "chain"


def _jax_a1_trot(N=6, t0=0.35):
    """The A1 trot of examples/a1_trot_mpc.py (step 0.15 m, yaw pi/18 a
    step, swing 0.25 s, first swing at 0.5 s) planned at t0, JAX side, in
    the dict layout of _torch_cases.jax_trot."""
    from robotoc_tpu.mpc.mpc_trot import MPCTrot
    m = jload("a1")
    mpc = MPCTrot(m, T=0.5, N=N, feet=A1_FEET, baumgarte_time_step=0.05)
    planner = mpc.make_planner()
    planner.set_gait_pattern(np.array([0.15, 0, 0]), np.pi / 18)
    mpc.set_gait_pattern(planner, swing_height=0.1, swing_time=0.25,
                         stance_time=0.0, swing_start_time=0.5)
    q0, v0 = jnp.asarray(A1_Q0), jnp.zeros(18)
    mpc.planner.init(q0)
    mpc.config_cost = mpc.config_cost.replace(q_ref=q0)
    grid, costs = mpc._build_schedule_and_costs(t0, q0, v0)
    return dict(model=m, mpc=mpc, contacts=mpc.contacts, limits=mpc.limits,
                grid=grid, costs=costs, q0=q0, v0=v0)


@pytest.fixture(scope="module")
def a1_case():
    return _case(_jax_a1_trot(), seed=15, scale=0.1)


def test_a1_cost_fold_inputs_match_jax(a1_case):
    for i, (t, j) in enumerate(zip(a1_case["cost_t"], a1_case["cost_j"])):
        assert_close(t.numpy(), np.asarray(j), 1e-14, f"cost input {i}")


@pytest.mark.parametrize("with_cost", [False, True])
def test_a1_chain_plain_matches_xla_oracles(a1_case, with_cost):
    _check_xla_oracles(a1_case, with_cost)


@pytest.mark.parametrize("with_cost", [False, True])
def test_a1_chain_plain_matches_pallas_interpret(a1_case, with_cost):
    _check_pallas_interpret(a1_case, with_cost)


@pytest.mark.parametrize("with_cost", [False, True])
def test_a1_host_build_matches_chain_plain(a1_case, host, with_cost):
    _check_host_build(a1_case, host, with_cost)
