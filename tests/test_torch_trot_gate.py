"""The trot's float32 drift gate (chip_smoke.trot_gate, plant_test) on the
CPU.

On the card chip_smoke.py holds the B = 128 trot fleet's float32 step
through the kernels to the float64 step: each field's drift (its distance
from the plain float64 step, over the largest change that step made) at
most TROT_K times the largest drift of the plain float32 steps, from the
iterate and from two jittered copies of it; beside it one step of a
float64 fleet through the kernels against the plain one, to 1e-8. Here
the same functions run on a trot fleet of B = 2 at N = 4 (the smallest
horizon that keeps the 4 impact slots and the switching rows), where the
wrappers run their plain versions: the unplanted step passes both gates,
and relative noise of 1e-4 planted in K1's outputs (where the solver looks
K1 up) is refused by the drift gate and by the old agreement. The gate's
readings start the float64 fleet one step in from a float32-rounded
iterate with its base quaternion rescaled to unit length
(chip_smoke.on_sphere): off the unit sphere K6 and its plain version
differ in their q derivatives, as the last test shows on K6's host build.
"""
import ctypes
import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from robotoc_tpu_torch import kernels  # noqa: E402
from robotoc_tpu_torch.ops import chain as chn  # noqa: E402
from robotoc_tpu_torch.solver import ocp_solver as OS  # noqa: E402


@pytest.fixture
def one_thread():
    """One intra-op thread: the fleet's small ops gain nothing from more,
    and the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_drift_gate_passes_the_step_and_refuses_a_plant(one_thread):
    f32_, f64_ = torch.float32, torch.float64
    p, mk, (sol0, q0s, v0s) = cs.trot_fleet(f32_, "cpu", n=4, b=2)
    p64, mk64, (sol64, q64, v64) = cs.trot_fleet(f64_, "cpu", n=4, b=2)
    assert int(p.grid.is_impact.sum()) == 4
    out_k = cs._mpc_step(mk(True), p.grid, sol0, q0s, v0s)
    out_p = cs._mpc_step(mk(False), p.grid, sol0, q0s, v0s)
    f32 = (mk, p.grid, sol0, q0s, v0s)
    # raises if the float64 agreement or the drift gate does not hold
    gate = cs.trot_gate("cpu", f32, (mk64, p64.grid, sol64, q64, v64),
                        out_k, out_p)
    assert not gate["over_gate"]
    assert set(gate["plain"]) == {"plain"} | {
        f"plain jittered {s}" for s in cs.JITTER_SEEDS}
    assert max(gate["drift_ratio"].values()) <= cs.TROT_K
    (rec,) = cs.plant_test("cpu", f32, out_p, gate, sol64,
                           cases=[("K1", "noise", cs.PLANT_EPS, True)])
    assert rec["drift_refuses"] and rec["old_refuses"]
    assert rec["max_drift_ratio"] > cs.TROT_K


def _host_chain(model, contacts, args):
    """K6's host build (csrc/host_shim.cpp) on these stages, float64."""
    lib = kernels.host_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_host_chain.argtypes = [I, I, I, I, P, P, P, P, ctypes.c_longlong]
    lib.rtt_host_chain.restype = I
    consts, topo = chn.model_tables(model, contacts, torch.float64, "cpu")
    shapes = chn._out_shapes(chn.chain_meta(model, contacts))
    got = {n: torch.full((args[0].shape[0],) + shapes[n], float("nan"),
                         dtype=torch.float64) for n in chn._OUTS}
    P = ctypes.c_void_p
    rc = lib.rtt_host_chain(
        model.nv, 0, contacts.n_contacts, contacts.types[0],
        P(consts.data_ptr()), P(topo.data_ptr()),
        (P * len(args))(*[t.data_ptr() for t in args]),
        (P * len(chn._OUTS))(*[got[n].data_ptr() for n in chn._OUTS]),
        args[0].shape[0])
    assert rc == 0
    return got


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not "
                    "installed")
def test_k6_and_plain_differ_only_off_the_unit_sphere(one_thread):
    """On the stage slots of a float64 trot fleet whose (perturbed) iterate
    was rounded through float32, the base quaternion sits off the unit
    sphere by float32 rounding; there K6 (seeding a base tangent with
    R(q) hat(e)) and chain_plain (jacfwd through q (+) e: |q|^2 R(q / |q|)
    hat(e)) agree on every value and dv, da, force derivative to 1e-12,
    and differ in the q derivatives by about |q|^2 - 1. With the
    quaternion rescaled to unit length (chip_smoke.on_sphere) every output
    agrees to 1e-12."""
    p, _, (sol, q0s, v0s) = cs.trot_fleet(torch.float64, "cpu", n=4, b=2)
    contacts = p.mpc.contacts
    off = cs.perturbed(p.model, sol).map(
        lambda x: x.to(torch.float32).to(torch.float64))
    q_derivs = ("dtau_dq", "dCdq", "dgdq", "dtask")
    for s in (off, cs.on_sphere(p.model, off)):
        sol_b, grid_b, _, _, _ = OS._fleet(s, p.grid, q0s, v0s)
        args, _ = cs.chain_args(p.model, contacts, p.costs, sol_b, grid_b,
                                False)
        want = chn.chain_plain(p.model, contacts, *args)
        got = _host_chain(p.model, contacts, args)
        err = {n: float((got[n] - want[n]).abs().max())
               / max(float(want[n].abs().max()), 1.0) for n in chn._OUTS}
        dev = float((args[0][:, 3:7].norm(dim=-1) ** 2 - 1).abs().max())
        assert all(v <= 1e-12 for n, v in err.items() if n not in q_derivs)
        if s is off:
            assert 1e-8 < dev < 2e-7
            assert 0.1 * dev < max(err[n] for n in q_derivs) < 10 * dev
        else:
            assert dev < 1e-15
            assert all(err[n] <= 1e-12 for n in q_derivs)
