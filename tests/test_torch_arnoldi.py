"""The port's Arnoldi exponential and CholeskyQR³ against the JAX package.

Same inputs (numpy, seeded) through ``pytdscf_tpu.mps.integrator`` /
``kernels`` and their ``pytdscf_torch`` counterparts, in complex128 on the
CPU.  Both Arnoldi loops run classical Gram–Schmidt, the same order-12
Taylor exponential of the Hessenberg block and the same stopping rule, so
the results agree to round-off (≤ 1e-10, with the same Krylov dimension);
the port projects against the live rows only, where the JAX loop also
multiplies the exact-zero padded rows.  The relaxed contract is tested
with a second exact operator standing in for the low-precision matvec, so
that both packages see identical matvecs.  CholeskyQR³ runs the same three
Gram/Cholesky/solve rounds: Q and R agree to 1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.linalg
import torch

from pytdscf_torch.mps import integrator as TI
from pytdscf_torch.mps import kernels as TK

torch.set_num_threads(1)

TOL = 1e-10


def _cx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _operators(n, seed=0):
    """A non-Hermitian H (Liouvillian-like: Hermitian part plus a decay) and
    a nearby stand-in for the relaxed matvec."""
    rng = np.random.default_rng(seed)
    A = _cx(rng, n, n)
    H = 0.5 * (A + A.conj().T) / np.sqrt(n) - 0.05j * np.eye(n)
    H_lo = H + 1e-3 * _cx(rng, n, n) / np.sqrt(n)
    v = _cx(rng, n)
    return H, H_lo, v


def _jax_run(H, H_lo, v, scale, thresh, max_dim, relax_after):
    import jax.numpy as jnp

    from pytdscf_tpu.mps import integrator as JI

    Hj, Hlo = jnp.asarray(H), jnp.asarray(H_lo)
    kw = {}
    if relax_after is not None:
        kw = dict(matvec_lo=lambda x: Hlo @ x, relax_after=relax_after)
    out, k, bad = JI.krylov_expm(
        lambda x: Hj @ x, jnp.asarray(v), scale, thresh, max_dim=max_dim,
        conserve_norm=False, arnoldi=True, return_iterations=True, **kw,
    )
    return np.asarray(out), int(k), bool(bad)


def _port_run(H, H_lo, v, scale, thresh, max_dim, relax_after):
    Ht, Hlo = torch.from_numpy(H), torch.from_numpy(H_lo)
    kw = {}
    if relax_after is not None:
        kw = dict(matvec_lo=lambda x: Hlo @ x, relax_after=relax_after)
    out, k, bad = TI.krylov_expm(
        lambda x: Ht @ x, torch.from_numpy(v), scale, thresh,
        max_dim=max_dim, conserve_norm=False, arnoldi=True,
        return_iterations=True, **kw,
    )
    return out.numpy(), int(k), bool(bad)


@pytest.mark.parametrize("relax_after", [None, 1, 2])
@pytest.mark.parametrize("n,max_dim,thresh", [
    (60, 12, 1e-9),  # converges inside the buffer
    (60, 4, 1e-12),  # hits the cap
    (5, 8, 1e-14),  # k_max >= n: the whole space, never capped
])
def test_arnoldi_matches_jax(n, max_dim, thresh, relax_after):
    H, H_lo, v = _operators(n)
    scale = -0.5j * 0.8
    got, k_t, bad_t = _port_run(H, H_lo, v, scale, thresh, max_dim, relax_after)
    want, k_j, bad_j = _jax_run(H, H_lo, v, scale, thresh, max_dim, relax_after)
    assert (k_t, bad_t) == (k_j, bad_j)
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
    if n <= max_dim:
        assert not bad_t
    if n <= max_dim and relax_after is None:
        exact = scipy.linalg.expm(scale * H) @ v
        assert np.max(np.abs(got - exact)) < 1e-9 * np.max(np.abs(exact))
    if relax_after is not None:
        # the low matvec really entered: without it the result moves
        plain, _, _ = _port_run(H, H_lo, v, scale, thresh, max_dim, None)
        assert np.max(np.abs(got - plain)) > 1e-8


def test_arnoldi_counts_relaxed_matvecs():
    H, H_lo, v = _operators(40, seed=3)
    calls = {"hi": 0, "lo": 0}

    def hi(x):
        calls["hi"] += 1
        return torch.from_numpy(H) @ x

    def lo(x):
        calls["lo"] += 1
        return torch.from_numpy(H_lo) @ x

    _, k, _ = TI.krylov_expm(hi, torch.from_numpy(v), -0.3j, 1e-10, 9,
                             conserve_norm=False, arnoldi=True,
                             return_iterations=True, matvec_lo=lo,
                             relax_after=2)
    assert calls == {"hi": min(k, 2), "lo": max(k - 2, 0)}


@pytest.mark.parametrize("k", [1, 3, 7])
def test_expm_taylor_small_matches_scipy(k):
    rng = np.random.default_rng(k)
    for norm in (0.01, 1.0, 40.0):
        A = _cx(rng, k, k)
        A *= norm / np.max(np.sum(np.abs(A), axis=0))
        got = TI._expm_taylor_small(torch.from_numpy(A)).numpy()
        want = scipy.linalg.expm(A)
        assert np.max(np.abs(got - want)) <= 1e-11 * max(1.0, np.max(np.abs(want)))


def test_expm_taylor_small_propagates_nan():
    A = torch.full((3, 3), float("nan"), dtype=torch.complex128)
    assert torch.isnan(TI._expm_taylor_small(A)).all()


@pytest.mark.parametrize("dead", [[], [0, 5, 191]])
def test_cholesky_qr_matches_jax(dead):
    import pytdscf_tpu.mps.kernels as JK

    rng = np.random.default_rng(21)
    m = _cx(rng, 256, 192)
    m[:, dead] = 0.0
    q_t, r_t = TK._cholesky_qr(torch.from_numpy(m))
    q_j, r_j = JK._cholesky_qr(m)
    q_t, r_t = q_t.numpy(), r_t.numpy()
    assert np.max(np.abs(q_t - np.asarray(q_j))) < TOL
    assert np.max(np.abs(r_t - np.asarray(r_j))) < TOL * np.max(np.abs(r_t))
    assert np.max(np.abs(q_t @ r_t - m)) < 1e-12 * np.max(np.abs(m))
    live = [k for k in range(192) if k not in dead]
    g = q_t[:, live].conj().T @ q_t[:, live]
    assert np.max(np.abs(g - np.eye(len(live)))) < 1e-12
    for k in dead:
        assert not q_t[:, k].any() and not r_t[k].any()


def test_thin_qr_dispatch():
    rng = np.random.default_rng(22)
    big = torch.from_numpy(_cx(rng, 200, 192))
    q, r = TK.thin_qr(big)
    q_c, r_c = TK._cholesky_qr(big)
    assert torch.equal(q, q_c) and torch.equal(r, r_c)
    small = torch.from_numpy(_cx(rng, 40, 30))
    q, r = TK.thin_qr(small)
    q_m, r_m = TK._mgs_qr(small)
    assert torch.equal(q, q_m) and torch.equal(r, r_m)
