"""K6 on the full iCub's soles near the SE(3) log's branch cut, against the
JAX package's Pallas kernel (open check C1 of ROADMAP.md).

The full iCub's soles sit near pi from the identity; with reference
rotations near the identity (R_ref = so3_exp(0.2 N(0, 1))) the Baumgarte
rows' rotation log works near its branch cut, where two correct
evaluations may differ by a turn. The JAX package holds its Pallas kernel
against its XLA oracle on exactly this data at 1e-5
(tests/test_pallas_chain.py, test_chain_surface_matches_jacfwd: S = 5,
PRNGKey(2)). The same data, made by JAX and handed over as numpy, goes
through the port's two routes: K6's host build (csrc/chain_stage.cuh,
IcubSoles), which mirrors the Pallas kernel, and chain_plain; both against
the Pallas kernel in interpret mode at the JAX test's 1e-5. Their match
with the XLA oracle, the route chain_plain mirrors, is held in
tests/test_torch_chain_layout.py.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax

from _torch_cases import host_chain, icub_soles_jax

from robotoc_tpu.ops import pallas_chain as pch
from robotoc_tpu_torch import kernels, problems
from robotoc_tpu_torch.ops import chain as chn


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_host_chain.argtypes = [I, I, I, I, P, P, P, P, ctypes.c_longlong]
    lib.rtt_host_chain.restype = I
    return lib


def test_routes_match_pallas_near_the_branch_cut(host):
    m, contacts, ins = icub_soles_jax()
    assert pch.chain_supported(m, contacts)
    pallas = jax.jit(pch.make_chain(m, contacts, interpret=True))(*ins)
    model, cts = problems.icub_soles(device="cpu")
    plain = chn.chain_plain(model, cts, *[torch.as_tensor(x) for x in ins])
    got = host_chain(host, model, cts, ins,
                     {n: plain[n].shape for n in chn._OUTS})
    for n in chn._OUTS:
        want = np.asarray(pallas[n])
        for route, x in (("host build", got[n]), ("chain_plain", plain[n])):
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{route} {n}")
