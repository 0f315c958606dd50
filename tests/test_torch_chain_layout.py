"""The chain kernel K6's layout table and its full-iCub instance on the CPU.

K6 reads its chain layout from the model (ops/chain.chain_layout, the table
csrc/chain_math.cuh's ChainModel reads). The full iCub (nv 35: two legs and
a torso whose last joint carries both arms) on surface contacts at both
soles (rect 0.1 x 0.05, the setup of tests/test_pallas_chain.py) is the
tree that is not a star; its stages are made from numpy seeds
(problems.chain_stages):
  * the layout table against the model's tree, for the three trees K6 is
    built for, and the refusals of trees it does not take; the host build
    takes each tree's layout and refuses one past its workspace;
  * chain_plain against the JAX package's XLA fused_stage_derivatives
    (with_task): 1e-9 of each output's max-abs (at least one);
  * the g++ build of K6's arithmetic for the nv 35 tree
    (csrc/chain_stage.cuh, IcubSoles) against chain_plain, without and
    with the cost fold: 1e-10; its operation count;
  * near the SE(3) log's branch cut (the JAX package's own data for its
    surface kernel test, open check C1 of ROADMAP.md): K6's host build and
    chain_plain against the XLA oracle, at the JAX test's 1e-5 and at
    1e-10 of each output's max-abs, and against the Pallas kernel in
    interpret mode at the JAX test's 1e-5.

Near the branch cut: the full iCub's soles sit near pi from the identity;
with reference rotations near the identity (R_ref = so3_exp(0.2 N(0, 1)))
the Baumgarte rows' rotation log works near its branch cut, where two
correct evaluations may differ by a turn. The JAX package holds its Pallas
kernel against its XLA oracle on exactly this data at 1e-5
(tests/test_pallas_chain.py, test_chain_surface_matches_jacfwd: S = 5,
PRNGKey(2)). The same data, made by JAX and handed over as numpy, goes
through the port's two routes: K6's host build (csrc/chain_stage.cuh,
IcubSoles), which mirrors the Pallas kernel, and chain_plain, the route
that mirrors the XLA oracle.
"""
import ctypes
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import host_chain, icub_soles_jax, jit_unoptimised

from robotoc_tpu.models import contacts as jct
from robotoc_tpu.ops import pallas_chain as pch
from robotoc_tpu_torch import kernels, problems
from robotoc_tpu_torch.models import load_robot
from robotoc_tpu_torch.models.contacts import SURFACE, make_contacts
from robotoc_tpu_torch.ops import chain as chn

S = 4


@pytest.fixture(scope="module")
def icub():
    return problems.icub_soles(device="cpu")


def _chains_by_walk(model):
    """Chains from the parents alone: a new chain at every child of the
    base or of a joint with several children, or whose parent is not the
    joint before it."""
    par = list(model.parents)
    kids = [par.count(j) for j in range(model.nj)]
    chains = []
    for j in range(1, model.nj):
        if par[j] == 0 or par[j] != j - 1 or kids[par[j]] > 1:
            chains.append([j])
        else:
            chains[-1].append(j)
    return chains


def _tree(name):
    model = load_robot(name, device="cpu")
    if name == "anymal":
        return model, make_contacts(model, ("LF_FOOT", "LH_FOOT", "RF_FOOT",
                                            "RH_FOOT"))
    return model, make_contacts(model, ("l_sole", "r_sole"),
                                types=(SURFACE, SURFACE))


def _host_rc(host, model, contacts):
    """rtt_host_chain on no stages: 0 when the library takes the tree and
    its layout."""
    consts, topo = chn.model_tables(model, contacts, torch.float64, "cpu")
    P = ctypes.c_void_p
    return host.rtt_host_chain(model.nv, 0, contacts.n_contacts,
                               contacts.types[0], P(consts.data_ptr()),
                               P(topo.data_ptr()), (P * 7)(), (P * 13)(), 0)


@pytest.mark.parametrize("name", ["anymal", "icub_lower_half", "icub"])
def test_layout_matches_the_tree(name, host):
    model, contacts = _tree(name)
    lay = chn.chain_layout(model, contacts)
    par = list(model.parents)
    chains = _chains_by_walk(model)
    assert [list(range(f, f + n)) for f, n in zip(lay.first, lay.length)
            ] == chains
    for c, joints in enumerate(chains):
        assert lay.parent[c] == par[joints[0]]
        assert all(lay.joint_chain[j] == c for j in joints)
        # the level counts the chains between a chain and the base; the
        # chains below one follow it in order
        up, lev = lay.parent[c], 0
        while up != 0:
            lev, up = lev + 1, par[lay.first[lay.joint_chain[up]]]
        assert lay.level[c] == lev
        below = [d for d in range(len(chains)) if d != c and any(
            j in chains[c] for j in _path(par, chains[d][0]))]
        assert below == list(range(c + 1, c + 1 + lay.n_desc[c]))
        # a chain hangs from the last joint of the chain above it
        if lay.parent[c]:
            assert chains[lay.joint_chain[lay.parent[c]]][-1] == lay.parent[c]
    assert lay.joint_chain[0] == -1
    for k, fid in enumerate(contacts.frame_ids):
        assert lay.contact_chain[k] == lay.joint_chain[model.frame_parents[fid]]
    want = {"anymal": ((3,) * 4, (0,) * 4),
            "icub_lower_half": ((6, 6), (0, 0)),
            "icub": ((6, 6, 3, 7, 7), (0, 0, 0, 1, 1))}[name]
    assert (lay.length, lay.level) == want
    dims = (model.nv, model.nj, contacts.n_contacts, contacts.types[0])
    assert dims in chn.KERNEL_DIMS
    assert _host_rc(host, model, contacts) == 0


@pytest.mark.parametrize("name", ["anymal", "icub_lower_half", "icub"])
def test_host_build_refuses_a_layout_past_its_workspace(name, host):
    """The same joints hung as one serial chain: longer than the tree's
    workspace holds (csrc/chain_stage.cuh, ChainTree), which the host
    build and the operation count refuse (-2), as the card's launch does."""
    model, contacts = _tree(name)
    serial = dataclasses.replace(model, parents=(-1,) + tuple(
        range(model.nj - 1)))
    assert chn.chain_layout(serial, contacts).length == (model.nj - 1,)
    assert _host_rc(host, serial, contacts) == -2
    args, _ = problems.chain_stages(model, contacts, 1, seed=1)
    with pytest.raises(ValueError, match="no count"):
        chn.op_count(serial, contacts, *args)


def _path(par, j):
    """Joint j and the joints above it, up to the base."""
    out = []
    while j > 0:
        out.append(j)
        j = par[j]
    return out


def test_layout_refuses_other_trees(icub):
    model, contacts = icub
    # numbered breadth first: the torso's two arms interleaved
    par = list(model.parents)
    order = list(range(16)) + [j for pair in zip(range(16, 23),
                                                 range(23, 30))
                               for j in pair]
    new = {old: i for i, old in enumerate(order)}
    bad = dataclasses.replace(model, parents=tuple(
        -1 if par[o] < 0 else new[par[o]] for o in order))
    with pytest.raises(ValueError, match="depth first"):
        chn.chain_layout(bad, contacts)
    fixed = dataclasses.replace(model, jtypes=(0,) * model.nj)
    with pytest.raises(ValueError, match="revolute"):
        chn.chain_layout(fixed, contacts)


@functools.lru_cache(maxsize=None)
def _soles_jax():
    """The JAX package's full iCub on both soles and its own seeded stages
    (tests/test_pallas_chain.py's), built once per module."""
    return icub_soles_jax()


@functools.lru_cache(maxsize=None)
def _xla_oracle():
    """fused_stage_derivatives (with_task) of the full iCub on both soles,
    jitted and vmapped once per module: both tests below call it at S = 5
    stages, so one compile serves both."""
    m, contacts, _ = _soles_jax()

    def one(q, v, a, f, fr, pr, R):
        res = jct.fused_stage_derivatives(m, contacts, q, v, a, f, fr, pr, R,
                                          with_task=True)
        ((tau, C, g, dgdf), (dtq, dtv, M), (dCq, dCv, J), dgdq) = res[:4]
        return dict(tau=tau, dtau_dq=dtq, dtau_dv=dtv, M=M, C=C, dCdq=dCq,
                    dCdv=dCv, J=J, g=g, dgdq=dgdq, dgdf=dgdf,
                    task=res[4][0], dtask=res[4][1])

    return jit_unoptimised(jax.vmap(one))


def test_chain_plain_matches_xla(icub):
    """chain_plain on the port's seeded stages (problems.chain_stages, 5
    stages: the oracle's compile is shared with the branch-cut test)."""
    model, contacts = icub
    args, _ = problems.chain_stages(model, contacts, 5, seed=2)
    got = chn.chain_plain(model, contacts, *args)
    ref = _xla_oracle()(*[jnp.asarray(x.numpy()) for x in args])
    for name in chn._OUTS:
        want = np.asarray(ref[name])
        err = float(np.abs(got[name].numpy() - want).max())
        assert err <= 1e-9 * max(1.0, float(np.abs(want).max())), name


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = kernels.host_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_host_chain.argtypes = [I, I, I, I, P, P, P, P, ctypes.c_longlong]
    lib.rtt_host_chain.restype = I
    return lib


@pytest.mark.parametrize("with_cost", [False, True])
def test_host_build_matches_chain_plain(icub, host, with_cost):
    """K6's body for the nv 35 tree against chain_plain, float64: 1e-10."""
    model, contacts = icub
    args, cost = problems.chain_stages(model, contacts, S, seed=3,
                                       with_cost=with_cost)
    want = chn.chain_plain(model, contacts, *args, *cost)
    names = chn._OUTS + (chn._COST_OUTS if with_cost else ())
    got = host_chain(host, model, contacts, args + cost,
                     {n: want[n].shape for n in names})
    for n in names:
        err = float((got[n] - want[n]).abs().max())
        assert err <= 1e-10 * max(1.0, float(want[n].abs().max())), n


def test_op_count_nv35(icub):
    """K6's operation count on the nv 35 tree: additive over stages, more
    tangent than value operations."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    model, contacts = icub
    args, cost = problems.chain_stages(model, contacts, S, seed=4,
                                       with_cost=True)
    val, tan = chn.op_count(model, contacts, *args, *cost)
    parts = [chn.op_count(model, contacts, *[x[sl] for x in args + cost])
             for sl in (slice(0, 1), slice(1, None))]
    assert (val, tan) == tuple(map(sum, zip(*parts)))
    assert 0 < val < tan


def test_routes_follow_xla_near_the_branch_cut(host):
    """K6's host build and chain_plain on the JAX test's full-iCub data
    against fused_stage_derivatives (with_task) under jax.jit: within the
    JAX test's 1e-5, and both follow it to 1e-10 of each output's max-abs
    (the Pallas kernel in interpret mode sits 1e-5 off it there, its
    polynomial acos amplified through the log's Jacobian)."""
    _, _, ins = _soles_jax()
    xla = _xla_oracle()(*ins)
    model, cts = problems.icub_soles(device="cpu")
    plain = chn.chain_plain(model, cts, *[torch.as_tensor(x) for x in ins])
    got = host_chain(host, model, cts, ins,
                     {n: plain[n].shape for n in chn._OUTS})
    for n in chn._OUTS:
        want = np.asarray(xla[n])
        scale = max(1.0, float(np.abs(want).max()))
        for route, x in (("host build", got[n]), ("chain_plain", plain[n])):
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{route} {n}")
            err = float(np.abs(x.numpy() - want).max())
            assert err <= 1e-10 * scale, (route, n, err, scale)


def test_routes_match_pallas_near_the_branch_cut(host):
    """K6's host build and chain_plain on the same data against the Pallas
    kernel in interpret mode, at the JAX test's 1e-5."""
    m, contacts, ins = _soles_jax()
    assert pch.chain_supported(m, contacts)
    pallas = jit_unoptimised(pch.make_chain(m, contacts, interpret=True))(*ins)
    model, cts = problems.icub_soles(device="cpu")
    plain = chn.chain_plain(model, cts, *[torch.as_tensor(x) for x in ins])
    got = host_chain(host, model, cts, ins,
                     {n: plain[n].shape for n in chn._OUTS})
    for n in chn._OUTS:
        want = np.asarray(pallas[n])
        for route, x in (("host build", got[n]), ("chain_plain", plain[n])):
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{route} {n}")
