"""The port's sweep cost table (multimodars_torch.ops.sweep) against the JAX
package's XLA tables and its Pallas kernel in interpret mode.

Both packages get the same float64 numpy inputs, made from a seed.  The
plain version (what a CPU tensor takes) must match ``rotation_cost_table``
and ``_lb_cost_table`` to rtol 1e-12 with equal argmins: both evaluate the
same difference-form d2 per element and reduce with exact min/max, so only
last-ulp differences of the rotation remain.  The Pallas kernel evaluates
the Gram form, so it is held to the rtol 1e-10 of the JAX package's own
interpret-mode test.  The CUDA kernel itself is tested on the card, by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodars_torch.ops import sweep
from multimodars_tpu.ops.pallas_kernels import rotation_cost_table_pallas
from multimodars_tpu.ops.rotation_search import (
    _lb_cost_table,
    candidate_angles,
    rotation_cost_table,
)


def _case(F, N, M, invalid_t=0, invalid_r=0, empty=False, centers=None,
          step=1.0, rng_deg=10.0, limes=10.0, seed=0):
    rng = np.random.default_rng(seed)
    test = rng.standard_normal((F, N, 2))
    ref = rng.standard_normal((F, M, 2))
    tmask = np.ones((F, N), bool)
    rmask = np.ones((F, M), bool)
    if invalid_t:
        tmask[:, -invalid_t:] = False
        tmask[0, 1] = False  # an interior hole too
    if invalid_r:
        rmask[:, -invalid_r:] = False
    if empty:
        tmask[0] = False  # pair 0: empty test set
        rmask[-1] = False  # last pair: empty ref set
    c = np.zeros(F) if centers is None else np.asarray(centers, float)
    angles, valid = candidate_angles(jnp.asarray(c), step, rng_deg, limes)
    return dict(
        test=test, ref=ref, tmask=tmask, rmask=rmask,
        angles=np.asarray(angles), valid=np.asarray(valid),
    )


CASES = {
    "plain": dict(F=3, N=50, M=60),
    "invalid_rows_cols": dict(F=3, N=50, M=60, invalid_t=5, invalid_r=7),
    "clamped_grid": dict(F=2, N=30, M=30, centers=[0.15, -0.15], step=0.5,
                         rng_deg=5.0),
    "collapsed_window": dict(F=2, N=20, M=25, centers=[0.3, -0.3], step=0.5,
                             rng_deg=5.0),
    "empty_set": dict(F=3, N=40, M=40, empty=True),
}


def _torch_args(c, dense):
    def t(a):
        return torch.tensor(a)

    return (
        t(c["test"]), t(c["ref"]),
        None if dense else t(c["tmask"]), None if dense else t(c["rmask"]),
        t(c["angles"]), t(c["valid"]),
    )


def _jax_args(c):
    return (
        jnp.asarray(c["test"]), jnp.asarray(c["ref"]),
        jnp.asarray(c["tmask"]), jnp.asarray(c["rmask"]),
        jnp.asarray(c["angles"]), jnp.asarray(c["valid"]),
    )


def _assert_tables_match(got, want, rtol):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0.0)
    assert (got.argmin(axis=1) == want.argmin(axis=1)).all()


# (case, dense): the masked cases run masked only
TABLE_CASES = [(n, False) for n in sorted(CASES)] + [
    (n, True) for n in sorted(CASES) if n not in ("invalid_rows_cols", "empty_set")
]


@pytest.mark.parametrize("name, dense", TABLE_CASES)
def test_exact_table_matches_jax(name, dense):
    c = _case(**CASES[name])
    launches = sweep.launches
    got = sweep.cost_table(*_torch_args(c, dense), dense=dense)
    want = rotation_cost_table(*_jax_args(c), dense=dense)
    _assert_tables_match(got, want, rtol=1e-12)
    assert sweep.launches == launches  # a CPU tensor never launches
    if name == "empty_set":
        assert (np.asarray(got)[[0, -1]][c["valid"][[0, -1]]] == 0.0).all()


@pytest.mark.parametrize("name, dense", TABLE_CASES)
def test_lower_bound_table_matches_jax(name, dense):
    c = _case(**CASES[name])
    got = sweep.cost_table(
        *_torch_args(c, dense), dense=dense,
        outer_stride_test=6, outer_stride_ref=6,
    )
    want = _lb_cost_table(*_jax_args(c), 6, dense)
    _assert_tables_match(got, want, rtol=1e-12)
    exact = sweep.cost_table(*_torch_args(c, dense), dense=dense).numpy()
    fin = np.isfinite(exact)
    assert (np.asarray(got)[fin] <= exact[fin]).all()  # a true lower bound


def test_unequal_outer_strides():
    """Each stride subsamples only its own outer side."""
    c = _case(**CASES["invalid_rows_cols"])
    args = _torch_args(c, False)
    got = sweep.cost_table(*args, outer_stride_test=3, outer_stride_ref=1)
    t, r, tm, rm, a, v = args
    from multimodars_torch.ops.hausdorff import directed_sq

    th = a.T[:, :, None]
    rot = torch.stack(
        [t[None, ..., 0] * torch.cos(th) - t[None, ..., 1] * torch.sin(th),
         t[None, ..., 0] * torch.sin(th) + t[None, ..., 1] * torch.cos(th)], -1
    )
    fwd = directed_sq(rot[:, :, ::3], r[None], tm[None, :, ::3], rm[None], False)
    bwd = directed_sq(r[None], rot, rm[None], tm[None], False)
    want = torch.where(v, torch.maximum(fwd, bwd).T, torch.inf)
    _assert_tables_match(got, want, rtol=1e-12)


@pytest.mark.parametrize(
    "name", ["plain", "invalid_rows_cols", "clamped_grid", "collapsed_window"]
)
def test_plain_matches_pallas_interpret(name):
    c = _case(**CASES[name])
    got = sweep.cost_table(*_torch_args(c, False))
    want = rotation_cost_table_pallas(*_jax_args(c), interpret=True)
    got = np.asarray(got)
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)
    assert (got.argmin(axis=1) == want.argmin(axis=1)).all()


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: a.update(test=a["test"].float()), "dtype"),
        (lambda a: a.update(test=a["test"].transpose(0, 1).contiguous()
                            .transpose(0, 1)), "contiguous"),
        (lambda a: a.update(tmask=a["tmask"].to(torch.uint8)), "dtype"),
        (lambda a: a.update(valid=a["valid"][:, :-1]), "shape"),
        (lambda a: a.update(ref=a["ref"][:-1]), "shape"),
    ],
)
def test_kernel_input_checks_raise(mutate, match):
    c = _case(**CASES["plain"])
    keys = ("test", "ref", "tmask", "rmask", "angles", "valid")
    args = dict(zip(keys, _torch_args(c, False)))
    mutate(args)
    with pytest.raises(ValueError, match=match):
        sweep.check_inputs(*(args[k] for k in keys), False, 1, 1)


def test_unsupported_device_raises():
    c = _case(**CASES["plain"])
    args = [None if a is None else a.to("meta") for a in _torch_args(c, True)]
    with pytest.raises(ValueError, match="no sweep kernel"):
        sweep.cost_table(*args, dense=True)
