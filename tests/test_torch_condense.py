"""The port's per-stage evaluation and condensing against the JAX package.

S = 8 stages of the golden ANYmal contact OCP, moved off the warm start by
seeded numpy noise: the port's vmapped `stage_pre` against JAX's (1e-10),
and the plain versions of the condense kernels K1, Kc, K2, K3 on the JAX
`stage_pre` outputs against the Pallas kernels in interpret mode
(`pallas_condense.make_condense(..., interpret=True)`) and against the
vmapped `contact_stage.condense_jax` (1e-9). f64 on the CPU."""
import functools

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp

from _torch_cases import (assert_close, fields, jax_init_solution,
                          jax_problem, np_tree, perturbed_solution,
                          to_torch)

from robotoc_tpu.ocp import contact_stage as jstage
from robotoc_tpu.ops import pallas_condense as pc
from robotoc_tpu.solver import ocp_solver as JOS
from robotoc_tpu_torch.ocp import contact_stage as tstage
from robotoc_tpu_torch.ops import condense as cd

TOL = 1e-9
N = 8


def _pre_args(sol, grid, barrier):
    """stage_pre's per-stage arguments from numpy solution/grid fields."""
    dt = grid["dt"]
    return (grid["t"][:-1], dt, np.full_like(dt, barrier),
            sol["q"][:-1], sol["v"][:-1], sol["a"][:-1], sol["u"][:-1],
            sol["f"][:-1], sol["beta"][:-1], sol["mu"][:-1],
            sol["lmd"][:-1], sol["gmm"][:-1], sol["lmd"][1:],
            sol["gmm"][1:], sol["q"][1:], sol["v"][1:], sol["s_lim"],
            sol["z_lim"], sol["s_cone"], sol["z_cone"],
            grid["contact_mask"][:-1], grid["p_ref"][:-1],
            grid["friction"][:-1], grid["R_ref"][:-1])


@pytest.fixture(scope="module")
def stages():
    jp = jax_problem(N)
    tp = to_torch(jp)
    jsolver = JOS.OCPSolver(jp["model"], jp["contacts"], (jp["cost"],),
                            jp["limits"], T=0.5, N=N)
    sol = perturbed_solution(
        jax_init_solution(jsolver, jp["grid"], jp["q0"], jp["v0"]), seed=0)
    args = _pre_args(sol, fields(jp["grid"]), 1e-3)
    pre_fn = functools.partial(jstage.stage_pre, jp["model"], jp["contacts"],
                               (jp["cost"],), jp["limits"])
    pre_j = np_tree(jax.jit(jax.vmap(pre_fn))(*[jnp.asarray(a)
                                                 for a in args]))
    pre_t = vmap(functools.partial(
        tstage.stage_pre, tp["model"], tp["contacts"], (tp["cost"],),
        tp["limits"]))(*[torch.as_tensor(np.array(a)) for a in args])
    kin = {k: v for k, v in pre_j.items() if not k.startswith("aux_")}
    dims = (18, 12, 12, 20)
    ref_pallas = np_tree(pc.make_condense(*dims, interpret=True)(
        **{k: jnp.asarray(v) for k, v in kin.items()}))
    ref_jax = np_tree(jax.jit(jax.vmap(functools.partial(
        jstage.condense_jax, 18, 12, 12)))(
        {k: jnp.asarray(v) for k, v in kin.items()}))
    port = cd.condense({k: torch.as_tensor(np.array(v))
                        for k, v in kin.items()})
    port = {k: v.numpy() for k, v in port.items()}
    return dict(pre_j=pre_j, pre_t=pre_t, pallas=ref_pallas, jax=ref_jax,
                port=port, kin=kin)


def test_stage_pre_matches(stages):
    pre_j, pre_t = stages["pre_j"], stages["pre_t"]
    assert set(pre_j) == set(pre_t)
    for name in pre_j:
        assert_close(pre_t[name].numpy(), pre_j[name], 1e-10, name)


KERNEL_OUTPUTS = {
    "K1": ("inv11", "inv12", "Sinv", "G", "c0"),
    "Kc": ("coneHqf", "Hff_c"),
    "K2": ("Qxx", "Qxu", "Quu"),
    "K3": ("A", "Bm", "xres", "lx", "lu"),
}


@pytest.mark.parametrize("oracle", ["pallas", "jax"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_OUTPUTS))
def test_condense_plain_matches(stages, kernel, oracle):
    for name in KERNEL_OUTPUTS[kernel]:
        assert_close(stages["port"][name], stages[oracle][name], TOL,
                     f"{kernel}:{name}")


def test_wrappers_take_the_plain_path_on_cpu(stages):
    """On CPU tensors the wrappers return their plain version's result
    and launch nothing."""
    x = {k: torch.as_tensor(np.array(v)) for k, v in stages["kin"].items()}
    cd.reset_launches()
    out_w = cd.condense(x, use_kernels=True)
    out_p = cd.condense(x, use_kernels=False)
    for name in cd.OUT_NAMES:
        assert torch.equal(out_w[name], out_p[name]), name
    assert all(w.launches == 0 for w in cd.WRAPPERS)


def test_stage_finish_and_expand(stages):
    """stage_finish's y-space blocks and one stage expansion against the
    JAX package (single stage of the flat batch)."""
    jp = jax_problem(N)
    tp = to_torch(jp)
    pre_j = stages["pre_j"]
    ko_j = {k: jnp.asarray(v) for k, v in stages["jax"].items()}
    blocks_j = jax.vmap(functools.partial(jstage.stage_finish, 18, 12, 12))(
        {k: jnp.asarray(v) for k, v in pre_j.items()}, ko_j)
    blocks_t = tstage.stage_finish(
        18, 12, 12, {k: torch.as_tensor(v) for k, v in pre_j.items()},
        {k: torch.as_tensor(v) for k, v in stages["jax"].items()})
    for name in ("Hy", "Cwy", "gy", "kkt_sq"):
        assert_close(getattr(blocks_t, name).numpy(),
                     np.asarray(getattr(blocks_j, name)), 1e-10, name)
    rng = np.random.default_rng(1)
    i = 3
    dq, dv = rng.standard_normal(18), rng.standard_normal(18)
    du, gn = rng.standard_normal(12), rng.standard_normal(18)
    s = np.exp(rng.standard_normal(96))
    z = np.exp(rng.standard_normal(96))
    sc = np.exp(rng.standard_normal(20))
    zc = np.exp(rng.standard_normal(20))
    f, beta, mu = (rng.standard_normal(12), rng.standard_normal(18),
                   rng.standard_normal(12))
    cm = np.array([1.0, 1.0, 0.0, 1.0])
    out_j = jstage.expand(
        jp["model"], jp["contacts"], jp["limits"], 1e-3,
        jax.tree.map(lambda x: x[i], blocks_j),
        *[jnp.asarray(x) for x in (dq, dv, du, gn)], 0.025,
        *[jnp.asarray(x) for x in (f, beta, mu, s, z, sc, zc, cm)],
        jnp.full(4, 0.7), jnp.zeros(19))   # fric, q: unused by expand
    out_t = tstage.expand(
        tp["model"], tp["contacts"], tp["limits"], 1e-3,
        type(blocks_t)(*[x[i] for x in blocks_t]),
        *[torch.as_tensor(x) for x in (dq, dv, du, gn)], 0.025,
        *[torch.as_tensor(x) for x in (f, beta, mu, s, z, sc, zc, cm)])
    for a, b in zip(out_t, out_j):
        assert_close(a.numpy(), np.asarray(b), 1e-10)
