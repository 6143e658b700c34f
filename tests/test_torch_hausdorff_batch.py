"""The shared-reference masked Hausdorff table of the PyTorch port
(``ops.hausdorff_batch``), the centerline refine's grid, against the JAX
package's ``hausdorff_sq_masked`` on the broadcast inputs the JAX refine
builds (centerline_align.py:505-516 there).

On the CPU the port takes the plain version; float64 values must agree to
rel 1e-12.  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from multimodars_torch.ops import hausdorff_batch as hb
from multimodars_tpu.ops.hausdorff import hausdorff_sq_masked as jax_masked


def _case(S, K, n, m, seed, empty=None):
    """Candidates p [S*K, n, 2] and reference sets q [S, m, 2] with random
    masks and slots of unequal width; ``empty`` = "p" or "q" empties one
    set of the first candidate or reference slot."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 3.0, (S * K, n, 2)) + 200.0
    q = rng.normal(0.0, 3.0, (S, m, 2)) + 200.0
    pmask = rng.random((S * K, n)) > 0.2
    qmask = rng.random((S, m)) > 0.2
    # unequal widths: each slot's tail is padding
    for c in range(S * K):
        pmask[c, rng.integers(n // 2, n + 1):] = False
    for s in range(S):
        qmask[s, rng.integers(m // 2, m + 1):] = False
    pmask[:, 0] = True
    qmask[:, 0] = True
    if empty == "p":
        pmask[0] = False
    elif empty == "q":
        qmask[0] = False
    return p, pmask, q, qmask


def _jax_table(p, pmask, q, qmask, K):
    """The JAX refine's evaluation: q broadcast to every candidate."""
    S, m = q.shape[:2]
    qb = np.broadcast_to(q[:, None], (S, K, m, 2)).reshape(S * K, m, 2)
    qmb = np.broadcast_to(qmask[:, None], (S, K, m)).reshape(S * K, m)
    return np.asarray(jax_masked(qb, p, qmb, pmask), dtype=np.float64)


def _torch_args(p, pmask, q, qmask):
    return (torch.tensor(p), torch.tensor(pmask), torch.tensor(q),
            torch.tensor(qmask))


@pytest.mark.parametrize("empty", [None, "p", "q"])
@pytest.mark.parametrize("K", [1, 7])
@pytest.mark.parametrize("S", [1, 3])
def test_shared_ref_matches_jax_broadcast(S, K, empty):
    p, pmask, q, qmask = _case(S, K, 37, 45, seed=10 * S + K, empty=empty)
    want = _jax_table(p, pmask, q, qmask, K)
    got = hb.hausdorff_sq_shared_ref(*_torch_args(p, pmask, q, qmask), K)
    assert got.dtype == torch.float64 and tuple(got.shape) == (S * K,)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    if empty == "p":
        assert got[0] == 0.0
    if empty == "q":
        assert (got[:K] == 0.0).all()
    assert (got[want > 0] > 0).all()


def test_plain_version_chunks_without_changing_values(monkeypatch):
    """The plain version evaluates bounded chunks of candidates; a budget
    of one candidate per chunk gives the same table bit for bit."""
    p, pmask, q, qmask = _case(3, 7, 30, 41, seed=4)
    args = _torch_args(p, pmask, q, qmask)
    whole = hb.hausdorff_sq_shared_ref_plain(*args, 7)
    monkeypatch.setattr(hb, "_PLAIN_TILE_BUDGET", 1)
    one_by_one = hb.hausdorff_sq_shared_ref_plain(*args, 7)
    assert torch.equal(whole, one_by_one)


def test_float64_table_equals_numpy_exact():
    """The float64 table equals the host's exact numpy expression
    (dx*dx + dy*dy, exact min and max) bit for bit: the property the
    refine's certification relies on."""
    p, pmask, q, qmask = _case(2, 3, 25, 33, seed=8)
    got = hb.hausdorff_sq_shared_ref(*_torch_args(p, pmask, q, qmask), 3).numpy()
    for c in range(6):
        a, b = p[c][pmask[c]], q[c // 3][qmask[c // 3]]
        dx = a[:, None, 0] - b[None, :, 0]
        dy = a[:, None, 1] - b[None, :, 1]
        d2 = dx * dx + dy * dy
        assert got[c] == max(d2.min(axis=1).max(), d2.min(axis=0).max())


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: a.update(p=a["p"].float()), "dtype"),
        (lambda a: a.update(pmask=a["pmask"].to(torch.uint8)), "dtype"),
        (lambda a: a.update(q=a["q"][:, :, :1].contiguous()), "shape"),
        (lambda a: a.update(qmask=a["qmask"][:-1]), "shape"),
        (lambda a: a.update(p=a["p"].transpose(0, 1).contiguous()
                            .transpose(0, 1)), "contiguous"),
        (lambda a: a.update(K=4), "reference sets"),
    ],
)
def test_kernel_input_checks_raise(mutate, match):
    p, pmask, q, qmask = _case(3, 7, 12, 15, seed=2)
    args = dict(zip(("p", "pmask", "q", "qmask"), _torch_args(p, pmask, q, qmask)))
    args["K"] = 7
    mutate(args)
    with pytest.raises(ValueError, match=match):
        hb.check_inputs(args["p"], args["pmask"], args["q"], args["qmask"], args["K"])


def test_unsupported_device_raises():
    p, pmask, q, qmask = _case(1, 1, 5, 6, seed=1)
    args = [t.to("meta") for t in _torch_args(p, pmask, q, qmask)]
    with pytest.raises(ValueError, match="no hausdorff_batch kernel"):
        hb.hausdorff_sq_shared_ref(*args, 1)
