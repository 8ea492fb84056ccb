"""The MGS(×2) gauge QR of the port (``mps/cuda_qr.py``).

Its plain PyTorch version is held on the CPU, in complex64, against the
fused Pallas kernel ``pallas_qr.mgs_qr_fused`` run in interpret mode, with
the criteria of ``tests/test_pallas_qr.py``: orthogonality, Q·R = m, and
structural parity (same algorithm, float32 rounding), including the
deterministic completion of dead columns with a zero R diagonal.

The CUDA kernel is held against the plain version by the tests marked
``cuda``, which need an NVIDIA GPU and skip elsewhere.  JAX is imported
inside the ``jx`` fixture, so those tests also run where JAX is not
installed (``python -m pytest --noconftest -m cuda ...``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytdscf_torch.mps import cuda_qr as CQ

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from pytdscf_tpu.mps import pallas_qr

    return jnp, pallas_qr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cx(rng, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (a / np.linalg.norm(a)).astype(np.complex64)


def _check(q, r, m, q_ref, r_ref, tol_match=5e-6):
    """The ``_check`` criteria of tests/test_pallas_qr.py (numpy arrays)."""
    n, k = m.shape
    orth = np.linalg.norm(np.eye(k) - q.conj().T @ q)
    rec = np.linalg.norm(q @ r - m)
    assert orth < 1e-5 * k, orth
    assert rec < 1e-5 * np.linalg.norm(m) + 1e-7, rec
    dq = np.linalg.norm(q - q_ref)
    dr = np.linalg.norm(r - r_ref)
    assert dq < tol_match * np.sqrt(q_ref.size), dq
    assert dr < tol_match * np.sqrt(r_ref.size) * np.linalg.norm(m) + 1e-6, dr


def _both(jx, m):
    jnp, PQ = jx
    q_j, r_j = PQ.mgs_qr_fused(jnp.asarray(m))
    q_t, r_t = CQ.mgs_qr_plain(torch.from_numpy(m))
    return q_t.numpy(), r_t.numpy(), np.asarray(q_j), np.asarray(r_j)


@pytest.mark.parametrize("shape", [(48, 12), (240, 30), (64, 30), (30, 30)])
def test_plain_matches_pallas_kernel(jx, shape):
    m = _cx(np.random.default_rng(4), *shape)
    q, r, q_j, r_j = _both(jx, m)
    _check(q, r, m, q_j, r_j)


def test_plain_rank_deficient_exact_zero_columns(jx):
    m = _cx(np.random.default_rng(1), 40, 10)
    m[:, [3, 7]] = 0.0
    q, r, q_j, _ = _both(jx, m)
    # dead columns: zero R diagonal, completed orthonormal Q column
    assert abs(r[3, 3]) < 1e-6 and abs(r[7, 7]) < 1e-6
    assert abs(np.linalg.norm(q[:, 3]) - 1.0) < 1e-5
    assert np.linalg.norm(np.eye(10) - q.conj().T @ q) < 1e-4
    assert np.linalg.norm(q - q_j) < 1e-4
    assert np.linalg.norm(q @ r - m) < 1e-6


def test_plain_rank1_plus_tail():
    """One big singular value and a 1e-7 tail, the early-trajectory
    Schmidt spectrum: Q stays orthonormal and Q·R = m."""
    rng = np.random.default_rng(2)
    u = rng.standard_normal((60, 1)) + 1j * rng.standard_normal((60, 1))
    v = rng.standard_normal((1, 12)) + 1j * rng.standard_normal((1, 12))
    tail = rng.standard_normal((60, 12)) + 1j * rng.standard_normal((60, 12))
    m = u @ v + 1e-7 * tail
    m = torch.from_numpy((m / np.linalg.norm(m)).astype(np.complex64))
    q, r = CQ.mgs_qr_plain(m)
    eye = torch.eye(12, dtype=m.dtype)
    assert float(torch.linalg.matrix_norm(eye - q.conj().T @ q)) < 1e-4
    assert float(torch.linalg.matrix_norm(q @ r - m)) < 1e-5


def test_wrapper_runs_plain_version_on_cpu():
    m = torch.from_numpy(_cx(np.random.default_rng(6), 24, 6))
    before = CQ.mgs_qr.plain_calls, CQ.mgs_qr.launches
    q, r = CQ.mgs_qr(m)
    q_ref, r_ref = CQ.mgs_qr_plain(m)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    assert (CQ.mgs_qr.plain_calls, CQ.mgs_qr.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        CQ.mgs_qr(m.T)  # N < r


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape,dead", [
    ((240, 30), []), ((240, 30), [3, 7, 29]), ((90, 30), []), ((64, 30), []),
    ((8, 8), [5]), ((240, 8), []), ((64, 1), []),
    # the χ=1024 chain's edge gauge: Q too large for shared memory
    ((1024, 64), []), ((1024, 64), [5, 63]),
])
def test_kernel_matches_plain_on_card(cuda, shape, dead):
    m_np = _cx(np.random.default_rng(7), *shape)
    m_np[:, dead] = 0.0
    m = torch.from_numpy(m_np).to(cuda)
    launches = CQ.mgs_qr.launches
    q, r = CQ.mgs_qr(m)
    q_ref, r_ref = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    assert CQ.mgs_qr.launches == launches + 1
    _check(q.cpu().numpy(), r.cpu().numpy(), m_np, q_ref.cpu().numpy(),
           r_ref.cpu().numpy())
    for k in dead:
        assert abs(complex(r[k, k])) < 1e-6


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    m = torch.zeros((40, 10), dtype=torch.complex128, device=cuda)
    with pytest.raises(TypeError):
        CQ.mgs_qr(m)
    with pytest.raises(ValueError):
        CQ.mgs_qr(m.to(torch.complex64).T)  # N < r
    with pytest.raises(ValueError):
        CQ.mgs_qr(torch.zeros((40, 20), dtype=torch.complex64, device=cuda)[:, ::2])
