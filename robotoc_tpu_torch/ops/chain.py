"""Stage kinematic chain and its derivatives over a flat batch of stages:
kernel K6.

Port of robotoc_tpu/ops/pallas_chain.py. The JAX package evaluates, for
every stage of the fleet, inverse dynamics, the Baumgarte contact
residuals, the friction-cone rows and the task rows (feet + CoM) with their
q/v/a Jacobians in one Pallas TPU kernel (`_chain_kernel`,
pallas_chain.py:481, launch :1110) that propagates structured forward-mode
tangents by hand. With `with_cost` the kernel also folds the gait cost
stack's Gauss-Newton blocks and the Lie state-equation base blocks. Here
it is the hand-written CUDA kernel csrc/chain.cu (per-stage arithmetic in
csrc/chain_stage.cuh, the tree's chain layout read from the model by
`chain_layout`; the full iCub's instance in csrc/chain_icub.cu);
`chain_plain` is the plain PyTorch version: the port's own composition
of `fused_stage_derivatives(with_task=True)`, the stack's stage
quadratization and `se.linearize_base`, reshaped to the kernel's
outputs.

Inputs and outputs are batch-first (S, ...), S = B * (stages per
scenario) flattened, with the JAX kernel's names and layouts (_OUTS,
_COST_OUTS). `chain` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises; `chain.launches` counts launches.
The contact stack is uniform: all point contacts (the feet of ANYmal or of
the A1, one instance: their trees differ only in the chain layout's
contact-to-chain map and in the constants the kernel reads) or all
surface contacts (the iCub soles: SE(3)-log Baumgarte rows against R_ref,
17-row wrench cones on the sole rectangle); a mixed stack raises
NotImplementedError.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from .. import kernels
from ..costs import config_cost as cc
from ..costs.task_cost import (BaseRotationCost, MultiFrameTaskCost,
                               base_rotation_quad, task_quad_kin)
from ..dynamics import state_equation as se
from ..models import contacts as ct
from ..models import robot as rm
from ..models import urdf

_OUTS = ("tau", "dtau_dq", "dtau_dv", "M", "C", "dCdq", "dCdv", "J",
         "g", "dgdq", "dgdf", "task", "dtask")
_COST_OUTS = ("cq_cost", "cq_lq", "cq_lv", "cq_la", "cq_lu", "cq_Wq",
              "se_Aqq6", "se_J1binv", "se_xres")
# cost-fold inputs: u, dt, task refs, task activity, base-rotation quat,
# q/v/a/u/task/base-rotation weights, q_ref, v_ref, q_next
N_COST_IN = 14
# (nv, nj, nc, contact type) the CUDA library is instantiated for
# (csrc/chain_stage.cuh, ChainTree, which also sets the capacities of each
# tree's chain layout: the launch refuses a layout past them)
KERNEL_DIMS = ((18, 13, 4, ct.POINT),      # ANYmal or the A1, four feet
               (18, 13, 2, ct.SURFACE),    # iCub lower half, soles
               (35, 30, 2, ct.SURFACE))    # full iCub, soles
# the library (csrc/<name>.cu) of each instantiation; "chain" otherwise
KERNEL_LIBRARY = {(35, 30, 2, ct.SURFACE): "chain_icub"}


class ChainMeta(NamedTuple):
    nq: int
    nv: int
    nj: int
    nf: int
    nc: int
    ncone: int
    nu: int
    with_cost: bool
    ctype: int              # ct.POINT or ct.SURFACE (uniform stacks)


def contact_type(contacts) -> int:
    """The type every contact of the stack has; a mixed point/surface
    stack raises NotImplementedError (K6 takes uniform stacks, as every
    MPC of the JAX package builds them)."""
    types = set(contacts.types)
    if len(types) != 1:
        raise NotImplementedError("the chain kernel K6 takes stacks of one "
                                  f"contact type, got {contacts.types}")
    return types.pop()


def chain_meta(model, contacts, with_cost=False) -> ChainMeta:
    return ChainMeta(nq=model.nq, nv=model.nv, nj=model.nj,
                     nf=contacts.max_dimf, nc=contacts.n_contacts,
                     ncone=contacts.dimc_cone, nu=model.dimu,
                     with_cost=bool(with_cost),
                     ctype=contact_type(contacts))


def chain_supported(model, contacts) -> bool:
    """Uniform point or surface stacks on a tree whose parents precede
    their children."""
    return (contacts.n_contacts > 0 and len(set(contacts.types)) == 1
            and all(p < i for i, p in enumerate(model.parents)))


class ChainLayout(NamedTuple):
    """The tree cut into chains, as K6 reads it (csrc/chain_math.cuh,
    ChainModel): per chain its first joint, length, parent joint (0: the
    base), level (chains between it and the base) and the number of chains
    below it (they follow it in order); per contact the chain its frame
    sits on (-1: the base); per joint its chain (-1: the base)."""
    first: tuple
    length: tuple
    parent: tuple
    level: tuple
    n_desc: tuple
    contact_chain: tuple
    joint_chain: tuple


def chain_layout(model, contacts) -> ChainLayout:
    """The chain layout of a free base (joint 0) carrying revolute joints
    numbered depth first (joint j at velocity index j + 5): a chain is a
    run of consecutive joints, each the only child of the one before, that
    starts at a child of the base or of a branch point (a joint with
    several children) and ends at a leaf or a branch point, so that chains
    hang only from the last joint of another. Raises ValueError for a tree
    K6 does not take."""
    par, jt, nj = list(model.parents), list(model.jtypes), model.nj
    if (nj < 2 or par[0] != -1 or jt[0] != urdf.FREE
            or any(t != urdf.REVOLUTE for t in jt[1:])
            or any(model.v_offs[j] != j + 5 or model.q_offs[j] != j + 6
                   for j in range(1, nj))):
        raise ValueError("chain: the kernel takes a free base (joint 0) "
                         "carrying revolute joints, joint j at velocity "
                         "index j + 5")
    kids = [sum(p == j for p in par) for j in range(nj)]
    first, length, parent, level = [], [], [], []
    joint_chain = [-1] * nj
    for j in range(1, nj):
        p = par[j]
        if p == 0 or p != j - 1 or kids[p] > 1:   # a chain starts at j
            if p and j - 1 != p and kids[p] == 1:
                raise ValueError("chain: joints are not numbered depth "
                                 "first")
            first.append(j)
            length.append(0)
            parent.append(p)
            level.append(0 if p == 0 else level[joint_chain[p]] + 1)
        length[-1] += 1
        joint_chain[j] = len(first) - 1
    up = [-1 if p == 0 else joint_chain[p] for p in parent]
    n_desc = []
    for c in range(len(first)):
        below = [d for d in range(len(first)) if d != c and _above(up, c, d)]
        if below != list(range(c + 1, c + 1 + len(below))):
            raise ValueError("chain: joints are not numbered depth first")
        n_desc.append(len(below))
    contact_chain = [joint_chain[model.frame_parents[f]]
                     for f in contacts.frame_ids]
    return ChainLayout(tuple(first), tuple(length), tuple(parent),
                       tuple(level), tuple(n_desc), tuple(contact_chain),
                       tuple(joint_chain))


def _above(up, c, d):
    """True when chain c lies on the path from chain d to the base."""
    while d >= 0:
        d = up[d]
        if d == c:
            return True
    return False


def cost_fold_supported(model, costs, contacts) -> bool:
    """True when `costs` is exactly the gait stack the kernel quadratizes:
    (ConfigurationSpaceCost with a constant q_ref, BaseRotationCost,
    MultiFrameTaskCost over the contact frames) on a floating-base model.
    A time-varying reference (q_ref_fn) is not folded: the kernel reads
    one q_ref for every stage."""
    if not model.floating_base or len(costs) != 3:
        return False
    cfg, br, task = costs
    return (isinstance(cfg, cc.ConfigurationSpaceCost)
            and cfg.q_ref_fn is None
            and isinstance(br, BaseRotationCost)
            and isinstance(task, MultiFrameTaskCost)
            and tuple(task.frame_ids) == tuple(contacts.frame_ids))


def cost_fold_inputs(model, contacts, costs, grid, sol):
    """The N_COST_IN per-stage inputs of the cost fold for a fleet (grid
    and solution fields (B, S, ...)), flattened to (B * (S-1), ...): the
    reference values (the step look-ups stay here, in tensor code) and the
    weights broadcast over the stages."""
    cfg, br, task = costs
    ts = grid.t[:, :-1]
    S = ts.numel()
    ref, act = task._ref_active(ts)
    quat_ref = br.ref(ts)[0]

    def flat(x):
        return x.reshape((S,) + tuple(x.shape[2:])).contiguous()

    def each(x):
        return x.expand((S,) + tuple(x.shape)).contiguous()

    return (flat(sol.u[:, :-1]), grid.dt.reshape(S, 1).contiguous(),
            flat(ref), flat(act), flat(quat_ref), each(cfg.q_weight),
            each(cfg.v_weight), each(cfg.a_weight), each(cfg.u_weight),
            each(task.task_weight(task.foot_weight, task.com_weight)),
            each(br.weight), each(cfg.q_ref), each(cfg.v_ref),
            flat(sol.q[:, 1:]))


def _out_shapes(meta: ChainMeta):
    nv, nf, ncone = meta.nv, meta.nf, meta.ncone
    ntask = 3 * meta.nc + 3
    out = {"tau": (nv,), "dtau_dq": (nv, nv), "dtau_dv": (nv, nv),
           "M": (nv, nv), "C": (nf,), "dCdq": (nf, nv), "dCdv": (nf, nv),
           "J": (nf, nv), "g": (ncone,), "dgdq": (ncone, nv),
           "dgdf": (ncone, nf), "task": (ntask,), "dtask": (ntask, nv)}
    if meta.with_cost:
        out.update({"cq_cost": (1,), "cq_lq": (nv,), "cq_lv": (nv,),
                    "cq_la": (nv,), "cq_lu": (meta.nu,), "cq_Wq": (nv, nv),
                    "se_Aqq6": (6, 6), "se_J1binv": (6, 6),
                    "se_xres": (nv,)})
    return out


def _in_shapes(meta: ChainMeta):
    nq, nv, nc, nu = meta.nq, meta.nv, meta.nc, meta.nu
    ntask = 3 * nc + 3
    shapes = [(nq,), (nv,), (nv,), (meta.nf,), (nc,), (nc, 3), (nc, 3, 3)]
    if meta.with_cost:
        shapes += [(nu,), (1,), (ntask,), (ntask,), (4,), (nv,), (nv,),
                   (nv,), (nu,), (ntask,), (3,), (nq,), (nv,), (nq,)]
    return shapes


def _identity_R_ref(q, nc):
    """R_ref for a caller that gives none: the identity for every contact
    (point contacts do not read it)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return eye.expand((q.shape[0], nc, 3, 3)).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the kernel's oracle)
# ---------------------------------------------------------------------------

def _plain_one(model, contacts, with_cost, q, v, a, f_eff, fric, p_ref,
               R_ref, *cost_ins):
    ((tau, C, g, dgdf), (dtq, dtv, M), (dCq, dCv, J), dgdq,
     (task, dtask)) = ct.fused_stage_derivatives(
        model, contacts, q, v, a, f_eff, fric, p_ref, R_ref, with_task=True)
    out = dict(tau=tau, dtau_dq=dtq, dtau_dv=dtv, M=M, C=C, dCdq=dCq,
               dCdv=dCv, J=J, g=g, dgdq=dgdq, dgdf=dgdf, task=task,
               dtask=dtask)
    if not with_cost:
        return out
    (u, dtl, tref, tact, brq, wq, wv, wa, wu, wtask, wbr, qref, vref,
     qnext) = cost_ins
    dt = dtl[0]
    cfg = cc.ConfigurationSpaceCost(
        q_ref=qref, v_ref=vref, q_weight=wq, v_weight=wv, a_weight=wa,
        u_weight=wu, q_weight_terminal=wq, v_weight_terminal=wv,
        q_weight_impact=wq, v_weight_impact=wv, dv_weight_impact=wv)
    c0, lq0, lv0, la0, lu0, Wq0 = cc.quadratize_stage(model, cfg, q, v, a, u,
                                                      dt)[:6]
    c1, lq1, Wq1 = base_rotation_quad(model, q, brq, torch.ones_like(dt),
                                      wbr)
    c2, lq2, Wq2 = task_quad_kin(tref, tact, wtask, task, dtask)
    # the stack's sum in its order: config, base rotation, task
    cost = c0 + dt * c1 + dt * c2
    lq = lq0 + dt * lq1 + dt * lq2
    Wq = Wq0 + dt * Wq1 + dt * Wq2
    Aqq, J1b_inv, xres = se.linearize_base(model, q, v, dt, qnext)
    out.update(cq_cost=cost.reshape(1), cq_lq=lq, cq_lv=lv0,
               cq_la=la0, cq_lu=lu0, cq_Wq=Wq, se_Aqq6=Aqq[:6, :6],
               se_J1binv=J1b_inv, se_xres=xres)
    return out


def chain_plain(model, contacts, q, v, a, f_eff, fric, p_ref, R_ref=None,
                *cost_ins):
    """K6's function in plain PyTorch over (S, ...) stages -> dict of
    (S, ...) outputs. R_ref (S, nc, 3, 3): the surface contacts' reference
    rotations (None: the identity; point contacts do not read it). With
    the N_COST_IN cost-fold inputs the cq_*/se_* outputs are added."""
    contact_type(contacts)
    if R_ref is None:
        R_ref = _identity_R_ref(q, contacts.n_contacts)
    with_cost = len(cost_ins) == N_COST_IN
    if cost_ins and not with_cost:
        raise ValueError(f"chain: {len(cost_ins)} cost-fold inputs, expected "
                         f"{N_COST_IN}")

    def one(*args):
        return _plain_one(model, contacts, with_cost, *args)

    return vmap(one)(q, v, a, f_eff, fric, p_ref, R_ref, *cost_ins)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def model_tables(model, contacts, dtype, device):
    """The kernel's model constants (dtype) and topology (int32, the chain
    layout included), the layouts of csrc/chain_math.cuh::ChainModel."""
    fids = list(contacts.frame_ids)
    npf = lambda x: np.asarray(x.detach().cpu().double())   # noqa: E731
    per_joint = np.concatenate([
        npf(model.Xtree_R).reshape(model.nj, 9), npf(model.Xtree_p),
        npf(model.axis), npf(model.mass)[:, None], npf(model.com),
        npf(model.inertia).reshape(model.nj, 9)], axis=1)
    per_contact = np.concatenate([
        npf(model.frame_R)[fids].reshape(-1, 9), npf(model.frame_p)[fids],
        npf(contacts.kp)[:, None], npf(contacts.kv)[:, None],
        npf(contacts.rect)], axis=1)
    consts = np.concatenate([per_joint.reshape(-1), npf(model.gravity),
                             per_contact.reshape(-1),
                             [float(npf(model.mass).sum())]])
    levels = rm.chain_levels(model)
    starts = np.cumsum([0] + [len(idxs) for _, idxs in levels])
    lay = chain_layout(model, contacts)
    per_chain = np.zeros((model.nj, 5), dtype=np.int64)
    per_chain[:len(lay.first)] = np.stack(
        [lay.first, lay.length, lay.parent, lay.level, lay.n_desc], axis=1)
    topo = np.concatenate([
        model.parents, model.jtypes, model.q_offs, model.v_offs,
        [model.frame_parents[f] for f in fids],
        [len(lay.first), max(lay.level) + 1], per_chain.reshape(-1),
        lay.contact_chain, lay.joint_chain, [len(levels)], starts,
        [j for _, idxs in levels for j in idxs]]).astype(np.int32)
    return (torch.as_tensor(consts, dtype=dtype, device=device),
            torch.as_tensor(topo, device=device))


_TABLES = {}


def _tables(model, contacts, dtype, device):
    """model_tables on the device, and the chain layout's longest chain
    and number of levels, computed once per (model, contacts, dtype,
    device)."""
    key = (id(model), id(contacts), dtype, str(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not model or hit[1] is not contacts:
        lay = chain_layout(model, contacts)
        hit = (model, contacts) + model_tables(model, contacts, dtype,
                                               device) + (
            (max(lay.length), max(lay.level) + 1),)
        _TABLES[key] = hit
    return hit[2:]


def _lib(meta):
    lib = kernels.library(KERNEL_LIBRARY.get(_dims(meta), "chain"))
    if not getattr(lib, "_rtt_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rtt_chain.argtypes = [I] * 8 + [P] * 4 + [ctypes.c_longlong, P]
        lib.rtt_chain.restype = I
        lib._rtt_typed = True
    return lib


def chain(model, contacts, q, v, a, f_eff, fric, p_ref, R_ref=None,
          *cost_ins):
    """K6 on S stages -> dict of outputs (see chain_plain)."""
    if q.device.type == "cpu":
        return chain_plain(model, contacts, q, v, a, f_eff, fric, p_ref,
                           R_ref, *cost_ins)
    meta = chain_meta(model, contacts, with_cost=len(cost_ins) == N_COST_IN)
    if cost_ins and not meta.with_cost:
        raise ValueError(f"chain: {len(cost_ins)} cost-fold inputs, expected "
                         f"{N_COST_IN}")
    if not chain_supported(model, contacts):
        raise ValueError("chain: parents must precede their children")
    S = q.shape[0]
    if R_ref is None:
        R_ref = _identity_R_ref(q, meta.nc)
    ins = [q, v, a, f_eff, fric, p_ref, R_ref] + list(cost_ins)
    kernels.check_args("chain", ins, [(S,) + s for s in _in_shapes(meta)])
    consts, topo, (max_len, n_levels) = _tables(model, contacts, q.dtype,
                                                q.device)
    shapes = _out_shapes(meta)
    names = _OUTS + (_COST_OUTS if meta.with_cost else ())
    outs = {n: torch.empty((S,) + shapes[n], dtype=q.dtype, device=q.device)
            for n in names}
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(names))(
        *[outs[n].data_ptr() for n in names])
    rc = _lib(meta).rtt_chain(
        kernels.DTYPE_CODE[q.dtype], int(meta.with_cost), meta.nv, meta.nj,
        meta.nc, meta.ctype, max_len, n_levels, kernels.ptr(consts),
        kernels.ptr(topo), in_ptrs, out_ptrs, S, kernels.stream(q))
    if rc == -1:
        raise ValueError(f"chain: no kernel for (nv, nj, nc, type) = "
                         f"{_dims(meta)} / {q.dtype}; built for "
                         f"{KERNEL_DIMS}")
    if rc == -2:
        raise ValueError(f"chain: chains of up to {max_len} joints on "
                         f"{n_levels} levels do not fit the kernel for "
                         f"{_dims(meta)} (csrc/chain_stage.cuh, ChainTree)")
    if rc != 0:
        raise RuntimeError(f"chain: CUDA launch failed (cudaError {rc})")
    chain.launches += 1
    return outs


chain.launches = 0


def _dims(meta: ChainMeta):
    return (meta.nv, meta.nj, meta.nc, meta.ctype)


def op_count(model, contacts, q, v, a, f_eff, fric, p_ref, R_ref=None,
             *cost_ins):
    """(value, tangent) operations of K6 on these S stages: its body's
    arithmetic, operations on structural zeros left out
    (csrc/chain_flops.cpp, built with g++). Inputs as for `chain`, on any
    device."""
    meta = chain_meta(model, contacts, with_cost=len(cost_ins) == N_COST_IN)
    if _dims(meta) not in KERNEL_DIMS:
        raise ValueError(f"op_count: built for {KERNEL_DIMS}")
    if R_ref is None:
        R_ref = _identity_R_ref(q, meta.nc)
    ins = [t.detach().to("cpu", torch.float64).contiguous()
           for t in (q, v, a, f_eff, fric, p_ref, R_ref) + tuple(cost_ins)]
    consts, topo = model_tables(model, contacts, torch.float64, "cpu")
    lib = kernels.host_library("chain_flops")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_chain_flops.argtypes = [I, I, I, I, P, I, P, P,
                                    ctypes.c_longlong, P]
    out = (ctypes.c_longlong * 2)()
    rc = lib.rtt_chain_flops(meta.nv, int(meta.with_cost), meta.nc,
                             meta.ctype, P(consts.data_ptr()),
                             consts.numel(), P(topo.data_ptr()),
                             (P * len(ins))(*[t.data_ptr() for t in ins]),
                             ins[0].shape[0], out)
    if rc != 0:
        raise ValueError(f"op_count: no count for {_dims(meta)}")
    return int(out[0]), int(out[1])
