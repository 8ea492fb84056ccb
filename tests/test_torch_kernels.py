"""The port's tensor kernels and Lanczos integrator against the JAX package.

Same inputs (numpy, seeded) through ``pytdscf_tpu.mps.kernels`` /
``integrator.krylov_expm`` and their ``pytdscf_torch`` counterparts, in
complex128 on the CPU.  The contractions agree to round-off (≤ 1e-12: the
same sums in another order).  The Krylov exponential agrees to ≤ 1e-10 with
the same Krylov dimension: both run the same recurrence and stopping rule
with an ``eigh`` of T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytdscf_tpu.mps.kernels as JK
from pytdscf_torch.mps import integrator as TI
from pytdscf_torch.mps import kernels as TK
from pytdscf_tpu.mps import integrator as JI
from pytdscf_tpu.mps import tdvp as JT

torch.set_num_threads(1)

TOL = 1e-12


def _cx(rng, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return a / np.linalg.norm(a)


def _site(rng, l=5, d=3, r=4, w=3, hermitian=False):
    psi, L, W, R = _cx(rng, l, d, r), _cx(rng, l, w, l), _cx(rng, w, d, d, w), _cx(rng, r, w, r)
    if hermitian:
        L = 0.5 * (L + L.transpose(2, 1, 0).conj())
        R = 0.5 * (R + R.transpose(2, 1, 0).conj())
        W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())
    return psi, L, W, R


def _close(t_out, j_out, tol=TOL):
    t = t_out.numpy() if isinstance(t_out, torch.Tensor) else np.asarray(t_out)
    j = np.asarray(j_out)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= tol * max(1.0, np.max(np.abs(j)))


T = torch.from_numpy


def _case(name, rng):
    psi, L, W, R = _site(rng)
    A = _cx(rng, 5, 3, 4)  # left-bond 5, right 4
    B = _cx(rng, 5, 3, 4)
    S = _cx(rng, 5, 5)
    sig = _cx(rng, 5, 4)
    Lk, Rk = _cx(rng, 5, 3, 5), _cx(rng, 4, 3, 4)
    if name == "heff_apply":
        return TK.heff_apply(T(L), T(W), T(R), T(psi)), JK.heff_apply(L, W, R, psi)
    if name == "keff_apply":
        return TK.keff_apply(T(Lk), T(Rk), T(sig)), JK.keff_apply(Lk, Rk, sig)
    if name == "renorm_block_left":
        return (TK.renorm_block_left(T(L), T(A), T(W), T(B)),
                JK.renorm_block_left(L, A, W, B))
    if name == "renorm_block_right":
        Rb = _cx(rng, 4, 3, 4)
        return (TK.renorm_block_right(T(Rb), T(A), T(W), T(B)),
                JK.renorm_block_right(Rb, A, W, B))
    if name == "absorb_right":
        return TK.absorb_right(T(sig), T(B[:4])), JK.absorb_right(sig, B[:4])
    if name == "absorb_left":
        return TK.absorb_left(T(A), T(sig.T)), JK.absorb_left(A, sig.T)
    if name == "ovlp_left_conj":
        return TK.ovlp_left_conj(T(S), T(A), T(B)), JK.ovlp_left_conj(S, A, B)
    if name == "ovlp_left_noconj":
        return (TK.ovlp_left_noconj(T(S), T(A), T(B)),
                JK.ovlp_left_noconj(S, A, B))
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "heff_apply", "keff_apply", "renorm_block_left", "renorm_block_right",
    "absorb_right", "absorb_left", "ovlp_left_conj", "ovlp_left_noconj",
])
def test_contraction_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    t_out, j_out = _case(name, rng)
    _close(t_out, j_out)


def test_stack_split_states():
    rng = np.random.default_rng(1)
    parts = [_cx(rng, 2, 3, 4), _cx(rng, 5, 2)]
    shapes = [p.shape for p in parts]
    t_vec = TK.stack_states([T(p) for p in parts])
    j_vec = JK.stack_states([jnp.asarray(p) for p in parts])
    _close(t_vec, j_vec, 0.0)
    for a, b in zip(TK.split_states(t_vec, shapes), JK.split_states(j_vec, shapes)):
        _close(a, b, 0.0)


def _rank_deficient(rng, n, r, dead):
    m = _cx(rng, n, r)
    m[:, dead] = 0.0
    return m


@pytest.mark.parametrize("kind", ["full", "deficient", "square"])
def test_mgs_qr_matches_jax(kind):
    rng = np.random.default_rng(3)
    m = {
        "full": lambda: _cx(rng, 48, 12),
        "deficient": lambda: _rank_deficient(rng, 40, 10, [3, 7]),
        "square": lambda: _rank_deficient(rng, 8, 8, [5]),
    }[kind]()
    q_t, r_t = TK._mgs_qr(T(m))
    q_j, r_j = JK._mgs_qr(jnp.asarray(m))
    _close(q_t, q_j)
    _close(r_t, r_j)


@pytest.fixture
def jax_mgs_gauge(monkeypatch):
    """Pin the JAX package's thin QR to its XLA MGS(×2) on the CPU (the
    convention its accelerator runs use), clearing traces made under the
    other convention before and after."""
    monkeypatch.setattr(JK, "_PALLAS_QR_FORCE", True)
    monkeypatch.setattr(JK, "_PALLAS_QR_OFF", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("shape", [(4, 3, 5), (5, 3, 4), (1, 8, 8)])
def test_gauge_moves_match_jax(shape, jax_mgs_gauge):
    rng = np.random.default_rng(4)
    psi = _cx(rng, *shape)
    psi[..., -1] = 0.0  # a dead channel: its completion is part of the result
    for t_fn, j_fn in ((TK.qr_right, JK.qr_right), (TK.lq_left, JK.lq_left)):
        t_a, t_b = t_fn(T(psi))
        j_a, j_b = j_fn(jnp.asarray(psi))
        _close(t_a, j_a)
        _close(t_b, j_b)


@pytest.mark.parametrize("scale,conserve", [
    (-0.3j, True), (-0.3, True), (-2.0j, False),
])
def test_krylov_expm_matches_jax(scale, conserve):
    rng = np.random.default_rng(6)
    psi, L, W, R = _site(rng, hermitian=True)
    shapes = (psi.shape,)
    jmv = JT._make_hmatvec(
        ((0, 0),), (jnp.asarray(L),), (jnp.asarray(W),), (jnp.asarray(R),),
        shapes, 1, jnp.complex128,
    )
    j_out, j_k, j_bad = JI.krylov_expm(
        jmv, jnp.asarray(psi.reshape(-1)), jnp.asarray(scale, jnp.complex128),
        1e-9, max_dim=20, conserve_norm=conserve, return_iterations=True,
    )
    Lt, Wt, Rt = T(L), T(W), T(R)

    def tmv(v):
        return TK.heff_apply(Lt, Wt, Rt, v.reshape(psi.shape)).reshape(-1)

    t_out, t_k, t_bad = TI.krylov_expm(
        tmv, T(psi.reshape(-1)), scale, 1e-9, max_dim=20,
        conserve_norm=conserve, return_iterations=True,
    )
    assert t_k == int(j_k) and t_bad == bool(j_bad)
    _close(t_out, j_out, 1e-10)


def test_krylov_expm_full_space_is_never_capped():
    """k_max ≥ n: the space is spanned, so the cap flag stays off (a zero
    threshold never converges and runs to the cap)."""
    rng = np.random.default_rng(8)
    h = _cx(rng, 6, 6)
    h = h + h.conj().T
    v = _cx(rng, 6)
    j_out, j_k, j_bad = JI.krylov_expm(
        lambda x: jnp.asarray(h) @ x, jnp.asarray(v),
        jnp.asarray(-1.0j, jnp.complex128), 0.0, max_dim=20,
        return_iterations=True,
    )
    t_out, t_k, t_bad = TI.krylov_expm(
        lambda x: T(h) @ x, T(v), -1.0j, 0.0, max_dim=20,
        return_iterations=True,
    )
    assert t_k == int(j_k) == 6 and not t_bad and not bool(j_bad)
    _close(t_out, j_out, 1e-10)
