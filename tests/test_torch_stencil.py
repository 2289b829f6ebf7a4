"""Port parity: the plain stencil operators of ``poisson_tpu_torch.ops.stencil``
against ``poisson_tpu.ops.stencil`` in fp64, on seeded random fields,
unbatched and with a leading batch axis (per-member coefficients too).

Tolerance: 2 ulp. The elementwise operators repeat the JAX operation order
and come out bitwise equal. The reduction (``dot_weighted``) sums in another
order than XLA's, whose own sum lands up to ~8 ulp from the exact value on
these inputs; so the port's reduction is held to 2 ulp of the exactly summed
value (``math.fsum``), and the JAX one to it at 1e-13 relative."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.ops import stencil as jst
from poisson_tpu_torch.ops import stencil as st

H1, H2 = 0.05, 0.03
SHAPE = (21, 17)


def _fields(batch: int | None, seed: int):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    w = np.zeros(lead + SHAPE)
    w[..., 1:-1, 1:-1] = rng.random(lead + (SHAPE[0] - 2, SHAPE[1] - 2))
    a = 1.0 + rng.random(lead + SHAPE)
    b = 1.0 + rng.random(lead + SHAPE)
    d = 1.0 + rng.random(lead + (SHAPE[0] - 2, SHAPE[1] - 2))
    return w, a, b, d


def _pair(name, w, a, b, d):
    """(port result, JAX result) of op ``name`` on the same inputs."""
    T = lambda x: torch.tensor(x)
    J = lambda x: jnp.asarray(x)
    if name == "apply_A":
        return (st.apply_A(T(w), T(a), T(b), H1, H2),
                jst.apply_A(J(w), J(a), J(b), H1, H2))
    if name == "diag_D":
        return st.diag_D(T(a), T(b), H1, H2), jst.diag_D(J(a), J(b), H1, H2)
    if name == "apply_Dinv":
        return st.apply_Dinv(T(w), T(d)), jst.apply_Dinv(J(w), J(d))
    if name == "dot_weighted":
        return (st.dot_weighted(T(w), T(a), H1, H2),
                jst.dot_weighted(J(w), J(a), H1, H2))
    if name == "interior":
        return st.interior(T(w)), jst.interior(J(w))
    if name == "pad_interior":
        inner = w[..., 1:-1, 1:-1]
        return st.pad_interior(T(inner)), jst.pad_interior(J(inner))
    raise AssertionError(name)


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("name", ["apply_A", "diag_D", "apply_Dinv",
                                  "dot_weighted", "interior", "pad_interior"])
def test_op_matches_jax_fp64(name, batch):
    fields = _fields(batch, seed=len(name))
    got, want = _pair(name, *fields)
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float64
    assert got.shape == want.shape
    if name != "dot_weighted":
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
        return
    w, a = fields[0], fields[1]
    members = [(w, a)] if batch is None else list(zip(w, a))
    exact = np.array([
        math.fsum((wm[1:-1, 1:-1] * am[1:-1, 1:-1]).ravel()) * (H1 * H2)
        for wm, am in members
    ]).reshape(got.shape)
    np.testing.assert_array_max_ulp(got, exact, maxulp=2)
    np.testing.assert_allclose(want, exact, rtol=1e-13)


def test_unbatched_coefficients_broadcast_over_batch():
    w, a, b, _ = _fields(4, seed=7)
    a1, b1 = torch.tensor(a[0]), torch.tensor(b[0])
    stacked = st.apply_A(torch.tensor(w), a1, b1, H1, H2)
    for m in range(4):
        one = st.apply_A(torch.tensor(w[m]), a1, b1, H1, H2)
        torch.testing.assert_close(stacked[m], one, rtol=0, atol=0)
