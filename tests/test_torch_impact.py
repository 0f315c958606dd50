"""The trot slice's impact modules against the JAX package, f64, on the
mid-gait ANYmal trot at N = 10: the impact functions of models/contacts
and the impact stage (stage_pre on every reserved slot, expand). Inputs
are the JAX problem's objects converted to the port and numpy-seeded
states. The switching constraint and the impact quadratization of the
cost stack are in tests/test_torch_trot.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import (anymal_states, close_tree, jax_trot, jit_unoptimised,
                          np_tree, trot_iterate, trot_to_torch)

from robotoc_tpu.models import contacts as jct
from robotoc_tpu.ocp import impact_stage as jistage
from robotoc_tpu_torch.models import contacts as tct
from robotoc_tpu_torch.ocp import impact_stage as tistage

TOL = 1e-10


@pytest.fixture(scope="module")
def case():
    jt = jax_trot(10)
    return jt, trot_to_torch(jt)


def test_impact_functions(case):
    jt, tp = case
    q, v, dv, lam = anymal_states(tp["model"], 2, 1)
    fric = np.full((2, 4), 0.6)
    p_ref = 0.2 * np.random.default_rng(2).standard_normal((2, 4, 3))
    jm, jc, tm, tc = jt["model"], jt["contacts"], tp["model"], tp["contacts"]
    for name, args in (("impact_velocity_residual", (q, v)),
                       ("impact_velocity_derivatives", (q, v)),
                       ("contact_position_residual", (q, p_ref)),
                       ("contact_position_derivative", (q, p_ref))):
        jfn, tfn = getattr(jct, name), getattr(tct, name)
        want = np_tree(jit_unoptimised(jax.vmap(
            lambda *a: jfn(jm, jc, *a)))(*args))
        got = torch.func.vmap(lambda *a: tfn(tm, tc, *a))(
            *[torch.as_tensor(a) for a in args])
        close_tree(got if isinstance(want, tuple) else [got],
                    want if isinstance(want, tuple) else [want], TOL,
                    name=name)
    args = (q, dv, v, lam, fric)
    for with_task in (False, True):
        want = np_tree(jit_unoptimised(jax.vmap(
            lambda *a: jct.fused_impact_derivatives(
                jm, jc, *a, with_task=with_task)))(*args))
        got = torch.func.vmap(lambda *a: tct.fused_impact_derivatives(
            tm, tc, *a, with_task=with_task))(
            *[torch.as_tensor(a) for a in args])
        close_tree(got, want, TOL, name=f"fused_impact task={with_task}")


def _slots(jt, f, idx):
    g = {k: np.array(v) for k, v in vars(jt["grid"]).items()}
    pick = lambda x: x[idx]                                # noqa: E731
    return (pick(g["t"][:-1]), pick(g["dt"]), np.full(len(idx), 1e-3),
            pick(f["q"][:-1]), pick(f["v"][:-1]), pick(f["a"][:-1]),
            pick(f["u"][:-1]), pick(f["f"][:-1]), pick(f["beta"][:-1]),
            pick(f["mu"][:-1]), pick(f["lmd"][:-1]), pick(f["gmm"][:-1]),
            pick(f["lmd"][1:]), pick(f["gmm"][1:]), pick(f["q"][1:]),
            pick(f["v"][1:]), pick(f["s_lim"]), pick(f["z_lim"]),
            pick(f["s_cone"]), pick(f["z_cone"]), pick(g["imp_mask"][:-1]),
            pick(g["p_ref"][:-1]), pick(g["friction"][:-1]))


def test_impact_stage(case):
    """stage_pre on every impact slot (one real impact, the rest
    pass-throughs) and expand from seeded directions."""
    jt, tp = case
    f = trot_iterate(tp, seed=4)
    idx = np.nonzero(np.asarray(jt["grid"].is_impact)[:-1])[0]
    args = _slots(jt, f, idx)
    jfn = lambda *a: jistage.stage_pre(                    # noqa: E731
        jt["model"], jt["contacts"], jt["costs"], jt["limits"], *a)
    want = np_tree(jit_unoptimised(jax.vmap(jfn))(*args))
    got = torch.func.vmap(lambda *a: tistage.stage_pre(
        tp["model"], tp["contacts"], tp["costs"], tp["limits"], *a))(
        *[torch.as_tensor(a) for a in args])
    assert set(got) == set(want)
    for k in want:
        close_tree([got[k].numpy()], [want[k]], TOL, name=k)
    # expansion through the port's condensed blocks, both sides
    from robotoc_tpu_torch.ocp import contact_stage as tstage
    from robotoc_tpu_torch.ops import condense as tcd
    ko = tcd.condense({k: got[k] for k in tcd.IN_NAMES}, use_kernels=False)
    blocks = tstage.stage_finish(18, 12, 12, got, ko)
    rng = np.random.default_rng(5)
    n = len(idx)
    dqv = rng.standard_normal((2, n, 18))
    gmm_new = rng.standard_normal((n, 18))
    jblocks = jistage.StageBlocks(*[jnp.asarray(x.numpy()) for x in blocks])
    want = np_tree(jit_unoptimised(jax.vmap(lambda b, *a: jistage.expand(
        jt["model"], jt["contacts"], 1e-3, b, *a)))(
        jblocks, dqv[0], dqv[1], gmm_new, args[7], args[8], args[9],
        args[18], args[19], args[20], args[22], args[3]))
    got = torch.func.vmap(lambda b, *a: tistage.expand(
        tp["model"], tp["contacts"], 1e-3, b, *a))(
        blocks, *[torch.as_tensor(x) for x in (
            dqv[0], dqv[1], gmm_new, args[7], args[8], args[9], args[18],
            args[19], args[20])])
    close_tree(got, want, TOL, name="expand")
