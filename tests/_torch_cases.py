"""Shared builders for the PyTorch port's tests (tests/test_torch_*.py).

The ANYmal standing contact OCP of tests/test_golden_traces.py is built
with the JAX package, and its objects are handed to the port through
`robotoc_tpu_torch.convert` as field dictionaries of numpy arrays, so both
packages compute from the same inputs. Inputs the tests invent come from
numpy seeds.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from robotoc_tpu_torch import convert

FEET = ["LF_FOOT", "LH_FOOT", "RF_FOOT", "RH_FOOT"]
Q_STAND = [0, 0, 0.4792, 0, 0, 0, 1, -0.1, 0.7, -1.0, -0.1, -0.7, 1.0, 0.1,
           0.7, -1.0, 0.1, -0.7, 1.0]


def fields(obj):
    """Fields of a JAX-package dataclass: arrays as numpy, statics as
    they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (str, bool, int, float, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def np_tree(x):
    """JAX pytree -> the same structure with numpy leaves."""
    return jax.tree.map(np.asarray, x)


def jax_problem(N=4, dtype=jnp.float64):
    """The golden ANYmal standing OCP, JAX side."""
    from robotoc_tpu.constraints.joint_limits import make_joint_limits
    from robotoc_tpu.costs.config_cost import make_config_cost
    from robotoc_tpu.models import (forward_kinematics, frame_placement,
                                    load_robot)
    from robotoc_tpu.models.contacts import make_contacts
    from robotoc_tpu.planner.contact_sequence import (ContactSchedule,
                                                      discretize)
    m = load_robot("anymal", dtype=dtype)
    contacts = make_contacts(m, FEET, baumgarte_time_step=0.04)
    q0 = jnp.asarray(Q_STAND, dtype)
    qw = jnp.asarray([0, 0, 0, 250000, 250000, 250000] + [0.0001] * 12,
                     dtype)
    vw = jnp.asarray([100.0] * 6 + [1.0] * 12, dtype)
    cost = make_config_cost(m, q_ref=q0, q_weight=qw, v_weight=vw,
                            a_weight=1e-6, u_weight=1e-1,
                            q_weight_terminal=qw, v_weight_terminal=vw)
    lim = make_joint_limits(m, u_limit=jnp.full(12, 80.0, dtype),
                            v_limit=jnp.full(12, 15.0, dtype))
    Rw, pw = forward_kinematics(m, q0)
    plc = np.stack([np.asarray(frame_placement(m, m.frame_id(f), Rw, pw)[1])
                    for f in FEET])
    grid = discretize(ContactSchedule(nc=4).init([True] * 4, plc), 0.0, 0.5,
                      N, dtype=dtype, use_native=False)
    return dict(model=m, contacts=contacts, cost=cost, limits=lim,
                grid=grid, q0=q0, v0=jnp.zeros(18, dtype))


def to_torch(jp, dtype=torch.float64):
    """The JAX problem's objects converted to the port's, on the CPU."""
    kw = dict(dtype=dtype, device="cpu")
    return dict(
        model=convert.robot_model(fields(jp["model"]), **kw),
        contacts=convert.contact_model(fields(jp["contacts"]), **kw),
        cost=convert.config_cost(fields(jp["cost"]), **kw),
        limits=convert.joint_limits(fields(jp["limits"]), **kw),
        grid=convert.grid_data(fields(jp["grid"]), **kw),
        q0=torch.as_tensor(np.array(jp["q0"]), dtype=dtype),
        v0=torch.as_tensor(np.array(jp["v0"]), dtype=dtype))


def perturbed_solution(jsol, seed, scale=0.05):
    """Numpy fields of a JAX Solution moved off its warm start, so that
    every stage block is non-trivial. q moves in the tangent space
    through the JAX package's integrate; the PDIPM pairs stay positive."""
    from robotoc_tpu.models import load_robot
    from robotoc_tpu.models import robot as rm
    rng = np.random.default_rng(seed)
    f = fields(jsol)
    m = load_robot("anymal")
    S = f["q"].shape[0]
    f["q"] = np.asarray(rm.integrate(m, jnp.asarray(f["q"]),
                                     scale * rng.standard_normal((S, 18))))
    for name in ("v", "a", "u", "lmd", "gmm", "beta", "mu"):
        f[name] = f[name] + scale * rng.standard_normal(f[name].shape)
    f["f"] = f["f"] + 5.0 * rng.standard_normal(f["f"].shape)
    for name in ("s_lim", "z_lim", "s_cone", "z_cone"):
        f[name] = f[name] * np.exp(0.3 * rng.standard_normal(f[name].shape))
    return f


def assert_close(actual, desired, tol, name=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=tol, atol=tol, err_msg=name)
