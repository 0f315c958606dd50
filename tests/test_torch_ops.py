"""The port's ops (linalg, lie, spatial) against the JAX package's, f64 on
the CPU, 1e-12. Inputs come from a numpy seed and reach both packages as
numpy arrays."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robotoc_tpu.ops import lie as jlie
from robotoc_tpu.ops import linalg as jlinalg
from robotoc_tpu.ops import spatial as jspatial
from robotoc_tpu_torch.ops import lie as tlie
from robotoc_tpu_torch.ops import linalg as tlinalg
from robotoc_tpu_torch.ops import spatial as tspatial

TOL = 1e-12
rng = np.random.default_rng(0)


def _both(fn_j, fn_t, *args):
    out_j = fn_j(*[jnp.asarray(a) for a in args])
    out_t = fn_t(*[torch.as_tensor(np.array(a)) for a in args])
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


def _spd(n, batch=4):
    X = rng.standard_normal((batch, n, n))
    return X @ np.swapaxes(X, -1, -2) + n * np.eye(n)


def _kkt(batch=4):
    M = _spd(6, batch)
    J = rng.standard_normal((batch, 3, 6))
    D = np.zeros((batch, 3, 3))
    return np.concatenate([np.concatenate([M, np.swapaxes(J, -1, -2)], -1),
                           np.concatenate([J, -D], -1)], -2)


@pytest.mark.parametrize("case", ["spd", "kkt"])
def test_gauss_jordan_inverse(case):
    A = _spd(7) if case == "spd" else _kkt()
    _both(jlinalg.gauss_jordan_inverse, tlinalg.gauss_jordan_inverse, A)


def test_spd_inverse_and_solve():
    A = _spd(5)
    _both(jlinalg.spd_inverse, tlinalg.spd_inverse, A)
    _both(jlinalg.spd_solve, tlinalg.spd_solve, A,
          rng.standard_normal((4, 5)))
    _both(jlinalg.spd_solve, tlinalg.spd_solve, A,
          rng.standard_normal((4, 5, 3)))


def test_pivoted_gauss_jordan_inverse():
    # a matrix whose leading pivot is zero needs the row swaps
    A = rng.standard_normal((6, 6))
    A[0, 0] = 0.0
    _both(jlinalg.pivoted_gauss_jordan_inverse,
          tlinalg.pivoted_gauss_jordan_inverse, A)
    # batched on the port side, one by one on the JAX side
    Ab = rng.standard_normal((3, 6, 6))
    out = tlinalg.pivoted_gauss_jordan_inverse(torch.as_tensor(Ab)).numpy()
    for i in range(3):
        np.testing.assert_allclose(
            out[i], np.asarray(jlinalg.pivoted_gauss_jordan_inverse(
                jnp.asarray(Ab[i]))), rtol=TOL, atol=TOL)


def _quat(n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rot(n):
    return np.asarray(jlie.quat_to_rot(jnp.asarray(_quat(n))))


# rotation vectors with large, moderate and Taylor-regime angles
_W = np.concatenate([rng.standard_normal((4, 3)),
                     1e-9 * rng.standard_normal((2, 3)), np.zeros((1, 3))])
_NU = np.concatenate([rng.standard_normal((4, 6)),
                      np.concatenate([rng.standard_normal((2, 3)),
                                      1e-9 * rng.standard_normal((2, 3))],
                                     -1)])

LIE_CASES = {
    "hat": (("hat",), lambda: (_W,)),
    "quat_mul": (("quat_mul",), lambda: (_quat(5), _quat(5))),
    "quat_conj": (("quat_conj",), lambda: (_quat(5),)),
    "quat_normalize": (("quat_normalize",),
                       lambda: (rng.standard_normal((5, 4)),)),
    "quat_to_rot": (("quat_to_rot",), lambda: (_quat(5),)),
    "rot_to_quat": (("rot_to_quat",), lambda: (_rot(6),)),
    "so3_exp_quat": (("so3_exp_quat",), lambda: (_W,)),
    "quat_log": (("quat_log",), lambda: (_quat(6),)),
    "so3_exp": (("so3_exp",), lambda: (_W,)),
    "so3_log": (("so3_log",), lambda: (_rot(6),)),
    "so3_left_jacobian": (("so3_left_jacobian",), lambda: (_W,)),
    "se3_mul": (("se3_mul",), lambda: (_rot(3), rng.standard_normal((3, 3)),
                                       _rot(3),
                                       rng.standard_normal((3, 3)))),
    "se3_inv": (("se3_inv",), lambda: (_rot(3), rng.standard_normal((3, 3)))),
    "se3_exp": (("se3_exp",), lambda: (_NU,)),
    "se3_exp_quat": (("se3_exp_quat",), lambda: (_NU,)),
    "se3_log": (("se3_log",), lambda: (_rot(5), rng.standard_normal((5, 3)))),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie(name):
    (fn,), make = LIE_CASES[name]
    _both(getattr(jlie, fn), getattr(tlie, fn), *make())


def _motion(n=5):
    return rng.standard_normal((n, 6))


SPATIAL_CASES = {
    "motion_cross": lambda: (_motion(), _motion()),
    "force_cross": lambda: (_motion(), _motion()),
    "motion_transform": lambda: (_rot(5), rng.standard_normal((5, 3)),
                                 _motion()),
    "motion_transform_inv": lambda: (_rot(5), rng.standard_normal((5, 3)),
                                     _motion()),
    "force_transform": lambda: (_rot(5), rng.standard_normal((5, 3)),
                                _motion()),
    "force_transform_inv": lambda: (_rot(5), rng.standard_normal((5, 3)),
                                    _motion()),
    "inertia_apply": lambda: (rng.uniform(1, 5, 5),
                              rng.standard_normal((5, 3)), _spd(3, 5),
                              _motion()),
    "inertia_matrix": lambda: (rng.uniform(1, 5, 5),
                               rng.standard_normal((5, 3)), _spd(3, 5)),
}


@pytest.mark.parametrize("name", sorted(SPATIAL_CASES))
def test_spatial(name):
    _both(getattr(jspatial, name), getattr(tspatial, name),
          *SPATIAL_CASES[name]())
