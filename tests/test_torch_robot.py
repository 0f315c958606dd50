"""The port's robot model, contacts, constraints, costs and state equation
against the JAX package's on ANYmal, f64 on the CPU, 1e-10. Each function
gets the same seeded numpy inputs in both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import FEET, Q_STAND, fields, jit_unoptimised

from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.models import robot as jrm
from robotoc_tpu.models import contacts as jct
from robotoc_tpu.constraints import friction_cone as jfc
from robotoc_tpu.constraints import joint_limits as jjl
from robotoc_tpu.costs import config_cost as jcc
from robotoc_tpu.dynamics import state_equation as jse
from robotoc_tpu_torch import convert
from robotoc_tpu_torch.models import load_robot as tload
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.models import contacts as tct
from robotoc_tpu_torch.constraints import friction_cone as tfc
from robotoc_tpu_torch.constraints import joint_limits as tjl
from robotoc_tpu_torch.costs import config_cost as tcc
from robotoc_tpu_torch.dynamics import state_equation as tse

TOL = 1e-10


@pytest.fixture(scope="module")
def models():
    jm = jload("anymal")
    tm = tload("anymal", dtype=torch.float64, device="cpu")
    jc = jct.make_contacts(jm, FEET, baumgarte_time_step=0.04)
    tc = tct.make_contacts(tm, FEET, baumgarte_time_step=0.04)
    return jm, tm, jc, tc


def _inputs(seed):
    rng = np.random.default_rng(seed)
    jm = jload("anymal")
    q = np.asarray(jrm.integrate(jm, jnp.asarray(Q_STAND),
                                 0.2 * rng.standard_normal(18)))
    v, a = rng.standard_normal(18), rng.standard_normal(18)
    f = rng.standard_normal(12) + np.tile([0, 0, 100.0], 4)
    p_ref = rng.standard_normal((4, 3))
    fric = rng.uniform(0.5, 0.9, 4)
    return q, v, a, f, p_ref, fric


def _close(t_out, j_out, tol=TOL):
    t_leaves = jax.tree.leaves(jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, t_out,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    j_leaves = jax.tree.leaves(j_out)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


def _T(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _J(*xs):
    return [jnp.asarray(x) for x in xs]


_JITTED = {}


def _jit(fn, *consts):
    """fn(*consts, *args) jitted (without backend optimisation): one
    compile in place of the eager dispatch of every op (and of every op of
    a jacfwd) of the reference;
    made once per function and constants (the module's models), so that
    a parametrized test's later cases reuse the compile."""
    key = (fn,) + tuple(id(c) for c in consts)
    if key not in _JITTED:
        _JITTED[key] = jit_unoptimised(lambda *args: fn(*consts, *args))
    return _JITTED[key]


def test_load_robot_fields(models):
    """load_robot of the port's own description copy equals the JAX
    model field by field, and so does the model built by convert."""
    jm, tm, _, _ = models
    ref = fields(jm)
    for tmodel in (tm, convert.robot_model(ref, device="cpu")):
        for name, val in ref.items():
            got = getattr(tmodel, name)
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(got.numpy(), val, err_msg=name)
            else:
                assert got == val, name
    assert tm.frame_id("LF_FOOT") == jm.frame_id("LF_FOOT")


def test_contact_model_fields(models):
    jm, tm, jc, tc = models
    for name, val in fields(jc).items():
        got = getattr(tc, name)
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), val, err_msg=name)
        else:
            assert got == val, name
    cm = np.array([1.0, 0.0, 1.0, 1.0])
    _close(tc.force_mask(torch.as_tensor(cm)), jc.force_mask(jnp.asarray(cm)))
    _close(tc.cone_mask(torch.as_tensor(cm)), jc.cone_mask(jnp.asarray(cm)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lie_configuration_ops(models, seed):
    jm, tm, _, _ = models
    q, v, _, _, _, _ = _inputs(seed)
    q1, _, _, _, _, _ = _inputs(seed + 10)
    _close(trm.integrate(tm, *_T(q, v)),
           _jit(jrm.integrate, jm)(*_J(q, v)))
    _close(trm.difference(tm, *_T(q, q1)),
           _jit(jrm.difference, jm)(*_J(q, q1)))
    _close(trm.d_difference_dq0(tm, *_T(q, q1)),
           _jit(jrm.d_difference_dq0, jm)(*_J(q, q1)))
    _close(trm.d_difference_dq1(tm, *_T(q, q1)),
           _jit(jrm.d_difference_dq1, jm)(*_J(q, q1)))


def test_kinematics(models):
    jm, tm, _, _ = models
    q = _inputs(2)[0]
    Rt, pt = trm.forward_kinematics(tm, *_T(q))
    Rj, pj = jrm.forward_kinematics(jm, *_J(q))
    _close((Rt, pt), (Rj, pj))
    for f in FEET:
        fid = jm.frame_id(f)
        _close(trm.frame_placement(tm, fid, Rt, pt),
               jrm.frame_placement(jm, fid, Rj, pj))


@pytest.mark.parametrize("with_force", [False, True])
def test_rnea_crba(models, with_force):
    jm, tm, jc, tc = models
    q, v, a, f, _, _ = _inputs(3)
    fj_t = tct.contact_forces_to_joint(tm, tc, *_T(f)) if with_force \
        else None
    fj_j = jct.contact_forces_to_joint(jm, jc, *_J(f)) if with_force \
        else None
    _close(trm.rnea(tm, *_T(q, v, a), fj_t),
           _jit(jrm.rnea, jm)(*_J(q, v, a), fj_j))
    _close(trm.crba(tm, *_T(q)), _jit(jrm.crba, jm)(*_J(q)))
    _close(trm.rnea_derivatives(tm, *_T(q, v, a), fj_t),
           _jit(jrm.rnea_derivatives, jm)(*_J(q, v, a), fj_j))


def test_baumgarte_residual(models):
    jm, tm, jc, tc = models
    q, v, a, _, p_ref, _ = _inputs(4)
    _close(tct.baumgarte_residual(tm, tc, *_T(q, v, a, p_ref)),
           jct.baumgarte_residual(jm, jc, *_J(q, v, a, p_ref)))


@pytest.mark.parametrize("seed", [5, 6])
def test_fused_stage_derivatives(models, seed):
    jm, tm, jc, tc = models
    q, v, a, f, p_ref, fric = _inputs(seed)
    _close(tct.fused_stage_outputs(tm, tc, *_T(q, v, a, f, fric, p_ref)),
           _jit(jct.fused_stage_outputs, jm, jc)(
               *_J(q, v, a, f, fric, p_ref)))
    _close(tct.fused_stage_derivatives(tm, tc, *_T(q, v, a, f, fric, p_ref)),
           _jit(jct.fused_stage_derivatives, jm, jc)(
               *_J(q, v, a, f, fric, p_ref)))


def test_friction_cone(models):
    jm, tm, jc, tc = models
    q, _, _, f, _, fric = _inputs(7)
    _close(tfc.residual_and_jac(tm, tc, *_T(q, f, fric)),
           _jit(jfc.residual_and_jac, jm, jc)(*_J(q, f, fric)))


def test_state_equation(models):
    jm, tm, _, _ = models
    q, v, _, _, _, _ = _inputs(8)
    q1 = _inputs(9)[0]
    dt = 0.025
    _close(tse.linearize(tm, *_T(q, v), dt, *_T(q1)),
           _jit(jse.linearize, jm)(*_J(q, v), dt, *_J(q1)))


def test_joint_limits(models):
    jm, tm, _, _ = models
    rng = np.random.default_rng(10)
    q, v, a, _, _, _ = _inputs(10)
    u = 30 * rng.standard_normal(12)
    jl_ = jjl.make_joint_limits(jm, u_limit=jnp.full(12, 80.0),
                                v_limit=jnp.full(12, 15.0))
    tl_ = tjl.make_joint_limits(tm, u_limit=torch.full((12,), 80.0,
                                                       dtype=torch.float64),
                                v_limit=torch.full((12,), 15.0,
                                                   dtype=torch.float64))
    for name, val in fields(jl_).items():
        np.testing.assert_array_equal(getattr(tl_, name).numpy(), val,
                                      err_msg=name)
    e_t = tjl.constraint_values(tm, tl_, *_T(q, v, u, a))
    e_j = jjl.constraint_values(jm, jl_, *_J(q, v, u, a))
    _close(e_t, e_j)
    s = rng.uniform(0.5, 2.0, e_j.shape)
    z = rng.uniform(0.5, 2.0, e_j.shape)
    _close(tjl.condense(tm, tl_, e_t, *_T(s, z), 1e-3),
           jjl.condense(jm, jl_, e_j, *_J(s, z), 1e-3))
    _close(tjl.dual_residual(tm, tl_, *_T(z)),
           jjl.dual_residual(jm, jl_, *_J(z)))


def test_config_cost(models):
    jm, tm, _, _ = models
    rng = np.random.default_rng(11)
    q, v, a, _, _, _ = _inputs(11)
    u = rng.standard_normal(12)
    qw = np.array([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12)
    vw = np.array([100.0] * 6 + [1.0] * 12)
    kw = dict(q_weight=qw, v_weight=vw, a_weight=1e-6, u_weight=1e-1,
              q_weight_terminal=qw, v_weight_terminal=vw)
    jc_ = jcc.make_config_cost(jm, q_ref=jnp.asarray(Q_STAND), **kw)
    tc_ = tcc.make_config_cost(tm, q_ref=np.array(Q_STAND), **kw)
    _close(tcc.quadratize_stage(tm, tc_, *_T(q, v, a, u), 0.025),
           _jit(jcc.quadratize_stage, jm, jc_)(*_J(q, v, a, u), 0.025))
    _close(tcc.quadratize_terminal(tm, tc_, *_T(q, v)),
           _jit(jcc.quadratize_terminal, jm, jc_)(*_J(q, v)))


@pytest.fixture(scope="module")
def arms():
    """The iiwa14 (fixed base) in both packages."""
    return jload("iiwa14"), tload("iiwa14", dtype=torch.float64,
                                  device="cpu")


@pytest.mark.parametrize("robot", ["anymal", "iiwa14"])
def test_plant_model_functions(models, arms, robot):
    """normalize (off the unit quaternion sphere), joint_velocities,
    frame_velocity (the ANYmal's feet; the iiwa14's world frame, which
    hangs on the root: zero, and its last frame) and nonlinear_effects, on
    three seeded states: 1e-12."""
    jm, tm = (models[0], models[1]) if robot == "anymal" else arms
    rng = np.random.default_rng(12)
    if robot == "anymal":
        q = np.stack([_inputs(s)[0] for s in (12, 13, 14)])
        q[:, 3:7] *= rng.uniform(0.8, 1.2, (3, 1))
    else:
        q = rng.standard_normal((3, jm.nq))
    v = rng.standard_normal((3, jm.nv))
    assert any(p < 0 for p in tm.frame_parents) == (robot == "iiwa14")
    _close(trm.normalize(tm, *_T(q)),
           _jit(jax.vmap(lambda x: jrm.normalize(jm, x)))(*_J(q)), 1e-12)
    if robot == "anymal":
        norms = torch.linalg.norm(trm.normalize(tm, *_T(q))[:, 3:7], dim=-1)
        np.testing.assert_allclose(norms.numpy(), 1.0, rtol=0, atol=1e-15)
    q = np.asarray(jax.vmap(lambda x: jrm.normalize(jm, x))(jnp.asarray(q)))
    fids = (tuple(tm.frame_id(f) for f in FEET) if robot == "anymal"
            else (0, len(tm.frame_parents) - 1))

    def jfns(q_, v_):
        return (jrm.joint_velocities(jm, q_, v_),
                [jrm.frame_velocity(jm, f, q_, v_) for f in fids],
                jrm.nonlinear_effects(jm, q_, v_))

    want = _jit(jax.vmap(jfns))(*_J(q, v))
    qt, vt = _T(q, v)
    got = (trm.joint_velocities(tm, qt, vt),
           [trm.frame_velocity(tm, f, qt, vt) for f in fids],
           trm.nonlinear_effects(tm, qt, vt))
    _close(got, want, 1e-12)
    for i, f in enumerate(fids):
        if tm.frame_parents[f] < 0:
            assert float(got[1][i].abs().max()) == 0.0
    assert (robot == "iiwa14") == (tm.frame_parents[fids[0]] < 0)
