"""The port's Riccati solves against the JAX package: the plain version of
the backward-sweep kernel K5 (riccati/backward_sweep.py) with its forward
rollout, and the serial riccati/lqr.py, on seeded random LQR data for a
fleet of B = 2 scenarios of N = 4 steps, without and with masked switching
rows (nf = 0, 3). Oracles: the Pallas sweep in interpret mode
(`pallas_scan.make_solve(interpret=True)`) and the serial `lqr.solve`,
both vmapped over the fleet. f64 on the CPU, 1e-9."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import jit_unoptimised

from robotoc_tpu.core.structs import LQRData as JLQRData
from robotoc_tpu.riccati import lqr as jlqr
from robotoc_tpu.riccati import pallas_scan
from robotoc_tpu_torch import convert
from robotoc_tpu_torch.riccati import backward_sweep
from robotoc_tpu_torch.riccati import lqr as tlqr

TOL = 1e-9
B, N, NX, NU = 2, 4, 8, 4


def _random_data(seed, nf):
    """Well-conditioned fleet LQR data as numpy fields (B, N, ...)."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: 0.3 * rng.standard_normal((B,) + sh)   # noqa: E731

    def spd(X, n):
        return X @ np.swapaxes(X, -1, -2) + 2.0 * np.eye(n)

    f = dict(A=r(N, NX, NX) + np.eye(NX), B=r(N, NX, NU), xres=r(N, NX),
             Qxx=spd(r(N, NX, NX), NX), Qxu=0.1 * r(N, NX, NU),
             Quu=spd(r(N, NU, NU), NU), lx=r(N, NX), lu=r(N, NU),
             Qxx_N=spd(r(NX, NX), NX), lx_N=r(NX))
    if nf:
        sw = ((rng.uniform(size=(B, N, nf)) < 0.5)
              * (rng.uniform(size=(B, N, 1)) < 0.6)).astype(float)
        sw[:, 1] = 1.0          # one fully constrained step per scenario
        f.update(Phix=r(N, nf, NX) * sw[..., None],
                 Phiu=r(N, nf, NU) * sw[..., None], Pc=r(N, nf) * sw, sw=sw)
    return f


def _jax(fields):
    return JLQRData(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.fixture(scope="module", params=[0, 3], ids=["nf0", "nf3"])
def case(request):
    nf = request.param
    fields = _random_data(nf + 1, nf)
    dx0 = 0.1 * np.random.default_rng(7).standard_normal((B, NX))
    data_j = _jax(fields)
    pal = jit_unoptimised(jax.vmap(pallas_scan.make_solve(interpret=True)))(
        data_j, jnp.asarray(dx0))
    ser = jit_unoptimised(jax.vmap(jlqr.solve))(data_j, jnp.asarray(dx0))
    data_t = convert.lqr_data(fields, device="cpu")
    port = backward_sweep.solve(data_t, torch.as_tensor(dx0))
    port_lqr = tlqr.solve(data_t, torch.as_tensor(dx0))
    return nf, pal, ser, port, port_lqr


def _cmp(port, ref, with_policy):
    for a, b in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    if with_policy:
        for name in ("K", "k", "P", "p", "Mx", "mx"):
            a, b = getattr(port[3], name), getattr(ref[3], name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=TOL, atol=TOL, err_msg=name)


def test_backward_sweep_matches_pallas(case):
    nf, pal, _, port, _ = case
    _cmp(port, pal, with_policy=True)


def test_backward_sweep_matches_serial_lqr(case):
    nf, _, ser, port, _ = case
    _cmp(port, ser, with_policy=True)


def test_serial_lqr_matches(case):
    nf, _, ser, _, port_lqr = case
    _cmp(port_lqr, ser, with_policy=True)


def test_bwd_wrapper_takes_the_plain_path_on_cpu(case):
    nf = case[0]
    f = _random_data(11, nf)
    t = convert.lqr_data(f, device="cpu")
    args = [t.A, t.B, t.xres, t.Qxx, t.Qxu, t.Quu, t.lx, t.lu, t.Qxx_N,
            t.lx_N, t.Phix, t.Phiu, t.Pc, t.sw]
    before = backward_sweep.bwd.launches
    out_w = backward_sweep.bwd(*args)
    out_p = backward_sweep.bwd_plain(*args)
    for a, b in zip(out_w, out_p):
        assert (a is None and b is None) or torch.equal(a, b)
    assert backward_sweep.bwd.launches == before
