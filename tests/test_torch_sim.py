"""The port's closed-loop plant and driver (robotoc_tpu_torch/sim) against
the JAX package's (robotoc_tpu/sim), f64 on the CPU.

  * `_contact_forces` and `_sim_step` on seeded ANYmal states (feet above
    the ground, feet in it, and feet sliding with the Coulomb cap
    min(mu fn, kt |vt|) at mu fn), on flat ground and on the A1 crawl
    example's height map written once in jnp and once in torch: 1e-12 of
    each output's largest magnitude (at least one).
  * `LeggedSimulator.step` with 10 substeps: 1e-11.
  * `MPCSimulation.run` against the JAX driver on one deterministic stub
    MPC (its KKT a function of t and of its update count; its control
    input and its policy's feedforward torques move by a fixed step at
    each update, so that the one-tick delay shows), for each
    feedback_policy x feedback_delay x steps per update in {1, 2}, 12
    ticks: every log to 1e-12, and `save` writes the same five files.

The closed loop with the real MPCTrot is in tests/test_torch_trot_slice.py,
beside that file's JAX MPCTrot.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import close_tree, FEET, jit_unoptimised, Q_STAND

from robotoc_tpu.models import contacts as jct
from robotoc_tpu.models import load_robot as jload
from robotoc_tpu.mpc.control_policy import ControlPolicy as JPolicy
from robotoc_tpu.sim import mpc_simulation as jms
from robotoc_tpu.sim import simulator as jsim
from robotoc_tpu_torch.models import contacts as tct
from robotoc_tpu_torch.models import load_robot as tload
from robotoc_tpu_torch.models import robot as trm
from robotoc_tpu_torch.mpc import ControlPolicy as TPolicy
from robotoc_tpu_torch.sim import simulator as tsim
from robotoc_tpu_torch.sim import LeggedSimulator, MPCSimulation

# the plant's default ground (z 0, kp, kd, mu, kt) and the closed loop's
# substep and control period
GROUND = (0.0, 2e4, 200.0, 0.7, 300.0)
SIM_DT, CONTROL_DT = 2.5e-4, 0.0025


def terrain_jnp(x, y):
    """The height map of examples/a1_crawl_terrain_mpc.py, in jnp."""
    return 0.03 * jnp.sin(4.0 * x) * jnp.cos(3.0 * y) + 0.04 * x


def terrain_torch(x, y):
    """The same height map on tensors."""
    return 0.03 * torch.sin(4.0 * x) * torch.cos(3.0 * y) + 0.04 * x


TERRAINS = {"flat": (None, None), "terrain": (terrain_jnp, terrain_torch)}


@pytest.fixture(scope="module")
def models():
    jm = jload("anymal")
    tm = tload("anymal", dtype=torch.float64, device="cpu")
    jc = jct.make_contacts(jm, FEET, baumgarte_time_step=0.05)
    tc = tct.make_contacts(tm, FEET, baumgarte_time_step=0.05)
    return jm, tm, jc, tc


def _states():
    """Six ANYmal states (q, v) and controls u, numpy: the base raised by
    5 cm (every foot above the ground), lowered by 1 cm with small
    velocities (two feet in the ground, the damper acting), and lowered
    by 1 cm moving at 1 m/s along x (the feet in the ground slide: kt |vt|
    above mu fn, the Coulomb cap at mu fn); joints moved by 0.02 N(0, 1)."""
    rng = np.random.default_rng(0)
    q = np.tile(np.asarray(Q_STAND, float), (6, 1))
    q[:, 2] += [0.05, 0.05, -0.01, -0.01, -0.01, -0.01]
    q[:, 7:] += 0.02 * rng.standard_normal((6, 12))
    v = 0.05 * rng.standard_normal((6, 18))
    v[4:, 0] += 1.0
    u = 20.0 * rng.standard_normal((6, 12))
    return q, v, u


def _world_forces(tm, tc, q, f_local):
    """Each contact's force in the world frame, (..., nc, 3)."""
    R_w, p_w = trm.forward_kinematics(tm, q)
    out = []
    for c, fid in enumerate(tc.frame_ids):
        R = trm.frame_placement(tm, fid, R_w, p_w)[0]
        out.append(trm._mv(R, f_local[..., 3 * c:3 * c + 3]))
    return torch.stack(out, dim=-2)


@pytest.mark.parametrize("ground", sorted(TERRAINS))
def test_contact_forces_match_jax(models, ground):
    jm, tm, jc, tc = models
    jter, tter = TERRAINS[ground]
    q, v, _ = _states()
    want = jit_unoptimised(jax.vmap(lambda q_, v_: jsim._contact_forces(
        jm, jc, *GROUND, q_, v_, terrain=jter)))(jnp.asarray(q),
                                                   jnp.asarray(v))
    got = tsim._contact_forces(tm, tc, *GROUND, torch.as_tensor(q),
                               torch.as_tensor(v), terrain=tter)
    close_tree([got.numpy()], [np.asarray(want)], 1e-12, ground)
    # the cases cover the three branches: no contact, the viscous
    # tangential force, and the Coulomb cap at mu fn
    fw = _world_forces(tm, tc, torch.as_tensor(q), got)
    fn, ft = fw[..., 2], torch.linalg.norm(fw[..., :2], dim=-1)
    mu = GROUND[3]
    # |ft| = mu fn |vt| / (|vt| + 1e-8) under the cap
    capped = (fn > 0) & (torch.abs(ft - mu * fn) <= 1e-7 * fn)
    assert bool((fn[:2] == 0).any()) and bool(capped[4:].any())
    assert bool((~capped[2:4] & (fn[2:4] > 0)).any())
    if ground == "flat":
        assert bool((fn[:2] == 0).all())


@pytest.mark.parametrize("ground", sorted(TERRAINS))
def test_sim_step_matches_jax(models, ground):
    jm, tm, jc, tc = models
    jter, tter = TERRAINS[ground]
    q, v, u = _states()
    t = np.linspace(0.0, 0.1, 6)

    def one(q_, v_, t_, u_):
        return jsim._sim_step(jm, jc, SIM_DT, *GROUND,
                              jsim.SimState(q_, v_, t_), u_, terrain=jter)

    want = jit_unoptimised(jax.vmap(one))(
        *[jnp.asarray(x) for x in (q, v, t, u)])
    got = tsim._sim_step(tm, tc, SIM_DT, *GROUND,
                         tsim.SimState(*[torch.as_tensor(x)
                                         for x in (q, v, t)]),
                         torch.as_tensor(u), terrain=tter)
    close_tree([x.numpy() for x in got], [np.asarray(x) for x in want],
               1e-12, ground)
    # the configuration stays on the unit quaternion sphere
    np.testing.assert_allclose(
        torch.linalg.norm(got.q[:, 3:7], dim=-1).numpy(), 1.0, rtol=0,
        atol=1e-15)


def test_simulator_step_matches_jax(models):
    jm, tm, jc, tc = models
    jp = jsim.LeggedSimulator(jm, jc, sim_dt=SIM_DT)
    tp = LeggedSimulator(tm, tc, sim_dt=SIM_DT)
    q, v, u = _states()
    js = jp.step(jp.init(q[4], v[4], 0.1), jnp.asarray(u[4]),
                 n_substeps=10)
    ts = tp.step(tp.init(q[4], v[4], 0.1), torch.as_tensor(u[4]),
                 n_substeps=10)
    assert ts.q.dtype == torch.float64 and ts.q.device.type == "cpu"
    close_tree([x.numpy() for x in ts], [np.asarray(x) for x in js], 1e-11,
               "10 substeps")
    np.testing.assert_allclose(float(ts.t), 0.1 + 10 * SIM_DT, rtol=0,
                               atol=1e-15)


@pytest.fixture(scope="module")
def plants(models):
    """The JAX and the port plant on flat ground for the driver (the JAX
    one compiles its step once for the module)."""
    jm, tm, jc, tc = models
    return (jsim.LeggedSimulator(jm, jc, sim_dt=SIM_DT),
            LeggedSimulator(tm, tc, sim_dt=SIM_DT))


class _StubMPC:
    """A deterministic MPC for the driver. `update_solution` counts its
    calls and returns a KKT made from t and that count; the control input
    and the policy's feedforward torques move by DU at each update; the
    policy holds the standing joints with fixed PD gains. `lib` makes the
    arrays: the port's tensors or the JAX package's arrays."""
    rng = np.random.default_rng(3)
    U0, DU = 10.0 * rng.standard_normal(12), rng.standard_normal(12)
    TAU = 5.0 * rng.standard_normal(12)
    KP = 100.0 * np.eye(12) + rng.standard_normal((12, 12))
    KD = 5.0 * np.eye(12)

    def __init__(self, lib, policy):
        self.lib, self.policy, self.k = lib, policy, 0
        self.seen = []

    def update_solution(self, t, dt, q, v):
        self.k += 1
        self.seen.append((t, dt))
        return 1.0 + 10.0 * t + 0.5 * self.k

    def get_initial_control_input(self):
        return self.lib(self.U0 + self.k * self.DU)

    def get_control_policy(self, t):
        return self.policy(
            t=t, tauJ=self.lib(self.TAU + self.k * self.DU),
            qJ=self.lib(np.asarray(Q_STAND[7:], float)),
            dqJ=self.lib(np.zeros(12)), Kp=self.lib(self.KP),
            Kd=self.lib(self.KD))


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("delay", [False, True])
@pytest.mark.parametrize("policy", [False, True])
def test_driver_matches_jax(plants, tmp_path, policy, delay, steps):
    jp, tp = plants
    kw = dict(t0=0.0, q0=np.asarray(Q_STAND, float), simulation_time=0.03,
              control_dt=CONTROL_DT, feedback_policy=policy,
              feedback_delay=delay, simulation_steps_per_mpc_update=steps)
    jstub = _StubMPC(jnp.asarray, JPolicy)
    tstub = _StubMPC(torch.as_tensor, TPolicy)
    want = jms.MPCSimulation(jp).run(jstub, **kw).as_arrays()
    driver = MPCSimulation(tp)
    got = driver.run(tstub, **kw).as_arrays()
    assert got["q"].shape == (12, 19) and got["u"].shape == (12, 12)
    assert tstub.k == jstub.k == 12 // steps
    np.testing.assert_allclose([s[0] for s in tstub.seen],
                               [s[0] for s in jstub.seen], rtol=0,
                               atol=1e-15)
    for name in ("t", "q", "v", "u", "kkt"):
        close_tree([got[name]], [want[name]], 1e-12, name)
    # the logs on disk: the same five files, the same numbers
    jdir = jms.MPCSimulationLog(**{k: list(v) for k, v in want.items()}
                                ).save(str(tmp_path / "jax"))
    tdir = driver.log.save(str(tmp_path / "port"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == sorted(
        f"{k}.log" for k in ("t", "q", "v", "u", "kkt"))
    for name in os.listdir(jdir):
        close_tree([np.loadtxt(os.path.join(tdir, name))],
                   [np.loadtxt(os.path.join(jdir, name))], 1e-12, name)
