"""The trot slice's host-side modules against the JAX package, f64, on the
mid-gait ANYmal trot at N = 10: CoM, the step references, the task costs,
the MPC's schedule and reference baking, and align_solution. Inputs are
the JAX problem's objects converted to the port and numpy-seeded states.
The impact functions, the impact stage and the switching constraint are
in tests/test_torch_impact.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (anymal_states, assert_close, close_tree,
                          jax_trot, np_tree, trot_iterate, trot_to_torch)

from robotoc_tpu.models import robot as jrm
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch import convert, problems
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.solver import ocp_solver as TOS

TOL = 1e-10


@pytest.fixture(scope="module")
def case():
    jt = jax_trot(10)
    return jt, trot_to_torch(jt)


def test_com_and_frame_position(case):
    jt, tp = case
    q = torch.as_tensor(anymal_states(tp["model"], 3, 0)[0])
    ref = jax.jit(jax.vmap(lambda x: jrm.com(jt["model"], x)))(q.numpy())
    assert_close(trm.com(tp["model"], q).numpy(), ref, TOL, "com")
    fid = tp["model"].frame_id("LF_FOOT")
    ref = jax.jit(jax.vmap(lambda x: jrm.frame_position(
        jt["model"], fid, x)))(q.numpy())
    assert_close(trm.frame_position(tp["model"], fid, q).numpy(), ref, TOL)


def test_step_references(case):
    jt, tp = case
    _, br, task = jt["costs"]
    _, tbr, ttask = tp["costs"]
    ts = np.concatenate([np.asarray(jt["grid"].t),
                         np.linspace(0.0, 1.2, 41)])
    want = np_tree(jax.jit(jax.vmap(
        lambda t: task._ref_active(t, jnp.float64)))(ts))
    got = ttask._ref_active(torch.as_tensor(ts))
    close_tree(got, want, 1e-14, "task refs")
    want = np_tree(jax.jit(jax.vmap(lambda t: br.ref(t)[0]))(ts))
    assert_close(tbr.ref(torch.as_tensor(ts))[0].numpy(), want, 1e-14,
                 "base rotation ref")


@pytest.mark.parametrize("kind", ["stage", "terminal", "impact", "kin"])
def test_task_costs(case, kind):
    """BaseRotationCost and MultiFrameTaskCost at three states and times;
    "kin": the multi-frame cost with the task rows handed in."""
    jt, tp = case
    q, v, dv, _ = anymal_states(tp["model"], 3, 3)
    ts = np.array([0.36, 0.52, 0.7])
    dt = np.full(3, 0.025)
    nf = 12
    jm, tm = jt["model"], tp["model"]
    for jc, tc in zip(jt["costs"][1:], tp["costs"][1:]):
        if kind == "stage":
            def jfn(q, v, t, dt, c=jc):
                return c.quadratize_stage(jm, nf, q, v, v, v[6:], None, t, dt)

            def tfn(q, v, t, dt, c=tc):
                return c.quadratize_stage(tm, nf, q, v, v, v[6:], None, t, dt)
            args = (q, v, ts, dt)
        elif kind == "terminal":
            def jfn(q, v, t, c=jc):
                return c.quadratize_terminal(jm, q, v, t)

            def tfn(q, v, t, c=tc):
                return c.quadratize_terminal(tm, q, v, t)
            args = (q, v, ts)
        elif kind == "impact":
            def jfn(q, v, dv, t, c=jc):
                return c.quadratize_impact(jm, q, v, dv, t)

            def tfn(q, v, dv, t, c=tc):
                return c.quadratize_impact(tm, q, v, dv, t)
            args = (q, v, dv, ts)
        else:
            if not hasattr(jc, "kin_frame_ids"):
                continue

            def jfn(q, v, dv, t, dt, c=jc):
                task = c._task(jm, q)
                Jq = jrm.tangent_jacobian(jm, q, lambda x: c._task(jm, x))
                return (c.quadratize_stage_kin(jm, nf, q, v, v, v[6:], None,
                                               t, dt, task, Jq),
                        c.quadratize_impact_kin(jm, q, v, dv, t, task, Jq),
                        task, Jq)

            def tfn(q, v, dv, t, dt, task, Jq, c=tc):
                return (c.quadratize_stage_kin(tm, nf, q, v, v, v[6:], None,
                                               t, dt, task, Jq),
                        c.quadratize_impact_kin(tm, q, v, dv, t, task, Jq))
            args = (q, v, dv, ts, dt)
        want = np_tree(jax.jit(jax.vmap(jfn))(*args))
        targs = [torch.as_tensor(a) for a in args]
        if kind == "kin":
            targs += [torch.as_tensor(want[2]), torch.as_tensor(want[3])]
            want = want[:2]
        got = torch.func.vmap(tfn)(*targs)
        close_tree(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want], TOL,
                    name=f"{kind} {type(tc).__name__}")


@pytest.mark.parametrize("t0", [0.35, 0.6])
def test_schedule_and_costs(t0):
    """The port's MPCTrot bakes the same grid and reference arrays as the
    JAX package's (mid-swing at 0.35 and 0.6)."""
    jt = jax_trot(10, t0=t0)
    tp = problems.anymal_trot(N=10, device="cpu", t0=t0)
    assert tp.mpc.n_reserved == jt["mpc"].n_reserved
    for name, val in vars(jt["grid"]).items():
        assert_close(getattr(tp.grid, name).numpy(), np.asarray(val), 1e-15,
                     name)
    jcfg, jbr, jtask = jt["costs"]
    cfg, br, task = tp.costs
    for name in ("q_ref", "v_ref", "q_weight", "v_weight", "a_weight",
                 "u_weight", "q_weight_terminal", "v_weight_terminal",
                 "q_weight_impact", "v_weight_impact", "dv_weight_impact"):
        assert_close(getattr(cfg, name).numpy(), np.asarray(
            getattr(jcfg, name)), 0.0, name)
    for jref, ref in ((jbr.ref, br.ref), (jtask.foot_refs, task.foot_refs),
                      (jtask.com_ref, task.com_ref)):
        for name, val in vars(jref).items():
            assert_close(getattr(ref, name).numpy(), np.asarray(val), 1e-15,
                         f"{type(ref).__name__}.{name}")
    assert task.frame_ids == tuple(jtask.frame_ids)
    for name in ("foot_weight", "com_weight", "foot_weight_impact"):
        assert_close(getattr(task, name).numpy(),
                     np.asarray(getattr(jtask, name)), 0.0, name)


def test_align_solution(case):
    """Warm start re-aligned from the t = 0.35 grid onto the t = 0.375
    grid, with manifold interpolation of q."""
    jt, tp = case
    jt2 = jax_trot(10, t0=0.375)
    f = trot_iterate(tp, seed=8)
    want = np_tree(JOS.align_solution(
        JOS.Solution(**{k: jnp.asarray(v) for k, v in f.items()}),
        jt["grid"], jt2["grid"], model=jt["model"]))
    got = TOS.align_solution(convert.solution(f, device="cpu"), tp["grid"],
                             convert.grid_data(vars(jt2["grid"]),
                                               device="cpu"),
                             model=tp["model"])
    for name, val in vars(want).items():
        close_tree([getattr(got, name).numpy()], [val], TOL, name=name)
