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


def _rank1_tail(n: int, k: int) -> np.ndarray:
    """One big singular value and a 1e-7 tail, the early-trajectory
    Schmidt spectrum: every column after the first is dead (its residual
    0.2-0.6 of the rank threshold at (60, 12))."""
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, 1)) + 1j * rng.standard_normal((n, 1))
    v = rng.standard_normal((1, k)) + 1j * rng.standard_normal((1, k))
    tail = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    m = u @ v + 1e-7 * tail
    return (m / np.linalg.norm(m)).astype(np.complex64)


def test_plain_rank1_plus_tail():
    """The rank-1 matrix with a 1e-7 tail: Q stays orthonormal and Q·R =
    m."""
    m = torch.from_numpy(_rank1_tail(60, 12))
    q, r = CQ.mgs_qr_plain(m)
    eye = torch.eye(12, dtype=m.dtype)
    assert float(torch.linalg.matrix_norm(eye - q.conj().T @ q)) < 1e-4
    assert float(torch.linalg.matrix_norm(q @ r - m)) < 1e-5


def _completion_case(delta: float, dtype) -> torch.Tensor:
    """A (4, 3) matrix whose dead column 1 is completed from e_1: column 0
    is e_1 + δ·e_3 (normalised), so e_1 keeps a residual of ≈ δ against
    it (δ = 0: e_1 lies in its span); column 2 is live."""
    m = np.zeros((4, 3), dtype=np.complex128)
    m[1, 0], m[3, 0] = 1.0, delta
    m[:, 0] /= np.linalg.norm(m[:, 0])
    m[:, 2] = [0.3, 0.1j, 0.5, -0.2]
    return torch.from_numpy(m).to(dtype)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plain_completion_past_the_span(dtype):
    """e_{k mod N} in the span of the earlier columns leaves no residual:
    the completion scans on to e_2 (ROADMAP C4), orthonormal, zero R
    diagonal, Q·R = m."""
    m = _completion_case(0.0, dtype)
    q, r = CQ.mgs_qr_plain(m)
    want = torch.zeros(4, dtype=dtype)
    want[2] = 1.0
    assert torch.allclose(q[:, 1], want, atol=1e-6)
    assert abs(complex(r[1, 1])) == 0.0
    eye = torch.eye(3, dtype=dtype)
    assert float(torch.linalg.matrix_norm(eye - q.conj().T @ q)) < 1e-6
    assert float(torch.linalg.matrix_norm(q @ r - m)) < 1e-6


@pytest.mark.parametrize("delta", [1.0e-03, 1.0e-05])
def test_plain_completion_above_the_noise_floor_is_jax(jx, delta):
    """A residual above the float32 noise floor (16·eps·√N = 3.8e-6 at
    N = 4) keeps the JAX package's completion e_{k mod N}: the same Q as
    ``pallas_qr.mgs_qr_fused`` (to 1e-5), orthonormal to 1e-6 (the second
    pass makes it so even at δ = 1e-5)."""
    assert CQ.completion_tol(torch.complex64, 4) < delta
    m = _completion_case(delta, torch.complex64).numpy()
    q, r, q_j, r_j = _both(jx, m)
    assert np.abs(q - q_j).max() < 1e-5
    assert abs(q[3, 1]) > 0.99  # e_1 less its part along column 0
    assert np.linalg.norm(np.eye(3) - q.conj().T @ q) < 1e-6
    assert np.linalg.norm(q @ r - m) < 1e-6


def test_route_by_shape():
    """Every MGS shape of the 184-site chain takes the one-block route (the
    kernel it had before the cluster route); the radical pair's (1024, 64)
    edge gauge takes the cluster; only a Q beyond a cluster's shared memory
    takes device memory."""
    from pytdscf_torch.models.holstein import singlet_fission_chain
    from pytdscf_torch.mps.lattice import bond_dims_for_site

    phys = [b.nprim for b in singlet_fission_chain()[0]]
    chain = set()
    for p, d in enumerate(phys):
        l, r = bond_dims_for_site(phys, p, 30)
        chain |= {(l * d, r), (r * d, l)}  # qr_right, lq_left operands
    chain = {(n, k) for n, k in chain if n >= k}
    assert (240, 30) in chain
    assert {CQ.route(n, r) for n, r in chain} == {"block"}
    for shape in ((4, 4), (16, 4), (64, 16), (256, 64), (240, 30)):
        assert CQ.route(*shape) == "block"
    assert CQ.route(1024, 64) == "cluster"
    assert CQ.route(256, 120) == "cluster"  # Nc = 32 rows per CTA
    assert CQ.route(4096, 64) == "device"
    # the device route keeps only the coefficients in shared memory: it
    # takes any N, and refuses only r beyond three columns of them
    assert CQ.route(40000, 64) == "device"
    with pytest.raises(ValueError):
        CQ.route(20000, 10000)
    assert CQ.smem_bytes(1024, 64, "cluster") <= CQ.MAX_SMEM < CQ.smem_bytes(1024, 64)
    # the one-block footprint: Q, factored in place, and three coefficient
    # columns
    assert CQ.smem_bytes(240, 30) == 8 * (240 * 30 + 3 * 30)
    assert CQ.smem_bytes(560, 20) == 8 * (560 * 20 + 3 * 20)


def test_wrapper_runs_plain_version_on_cpu():
    m = torch.from_numpy(_cx(np.random.default_rng(6), 24, 6))
    before = CQ.mgs_qr.plain_calls, CQ.mgs_qr.launches
    q, r = CQ.mgs_qr(m)
    q_ref, r_ref = CQ.mgs_qr_plain(m)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    assert (CQ.mgs_qr.plain_calls, CQ.mgs_qr.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        CQ.mgs_qr(m.T)  # N < r


def _card_matrix(shape, dead, case: str) -> np.ndarray:
    """The card test's operand: seeded random columns with the ``dead``
    ones zero; ``"span"``: column 0 is also e_k for the first dead column
    k, so e_{k mod N} lies in the span of the earlier columns and the
    completion scans on; ``"rank1"``: :func:`_rank1_tail`."""
    if case == "rank1":
        return _rank1_tail(*shape)
    m = _cx(np.random.default_rng(7), *shape)
    m[:, dead] = 0.0
    if case == "span":
        m[:, 0] = 0.0
        m[dead[0] % shape[0], 0] = 0.2
    return m


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape,dead,case", [
    ((240, 30), [], "random"), ((240, 30), [3, 7, 29], "random"),
    ((90, 30), [], "random"), ((64, 30), [], "random"),
    ((8, 8), [5], "random"), ((240, 8), [], "random"),
    ((64, 1), [], "random"),
    # the one-block shapes of pyrazine, model B and butadiene
    ((560, 20), [], "random"), ((560, 20), [3, 11, 19], "random"),
    ((200, 20), [], "random"), ((200, 20), [0, 10], "random"),
    ((72, 12), [], "random"), ((72, 12), [5, 11], "random"),
    # e_7 in the span of column 0: the completion scans on to e_8
    ((560, 20), [7], "span"),
    # every column after the first dead, each completed
    ((60, 12), [], "rank1"), ((560, 20), [], "rank1"),
    # more earlier columns than warps: a second round of dot products
    ((256, 64), [40], "random"),
    # the χ=1024 radical pair's edge gauge: Q on a cluster of 8 CTAs
    ((1024, 64), [], "random"), ((1024, 64), [5, 63], "random"),
    ((1024, 64), [0], "random"),
    # completions e_40 and e_100 in the CTAs of rank 1 and 3 (32 rows each)
    ((256, 120), [40, 100], "random"),
    # Q in device memory
    ((4096, 64), [9], "random"),
])
def test_kernel_matches_plain_on_card(cuda, shape, dead, case):
    m_np = _card_matrix(shape, dead, case)
    m = torch.from_numpy(m_np).to(cuda)
    way = CQ.route(*shape)
    launches, by_route = CQ.mgs_qr.launches, CQ.mgs_qr.route_launches[way]
    q, r = CQ.mgs_qr(m)
    q2, r2 = CQ.mgs_qr(m)
    q_ref, r_ref = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    assert CQ.mgs_qr.launches == launches + 2
    assert CQ.mgs_qr.route_launches[way] == by_route + 2
    assert torch.equal(q, q2) and torch.equal(r, r2)
    _check(q.cpu().numpy(), r.cpu().numpy(), m_np, q_ref.cpu().numpy(),
           r_ref.cpu().numpy())
    # the same dead/live decisions as the plain version
    assert torch.equal(r.diagonal() == 0, r_ref.diagonal() == 0)
    for k in dead:
        assert abs(complex(r[k, k])) < 1e-6
    if case == "rank1":
        assert int((r.diagonal() == 0).sum()) == shape[1] - 1


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.0, 1.0e-05, 1.0e-03])
def test_kernel_completion_matches_plain_on_card(cuda, delta):
    """The kernel's completion bar is the plain version's: it scans past a
    canonical vector in the span (δ = 0) and keeps one above the noise
    floor."""
    m = _completion_case(delta, torch.complex64).to(cuda)
    q, r = CQ.mgs_qr(m)
    q_ref, r_ref = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    assert float((q - q_ref).abs().max()) < 1e-6
    assert float((r - r_ref).abs().max()) < 1e-6


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    m = torch.zeros((40, 10), dtype=torch.complex128, device=cuda)
    with pytest.raises(TypeError):
        CQ.mgs_qr(m)
    with pytest.raises(ValueError):
        CQ.mgs_qr(m.to(torch.complex64).T)  # N < r
    with pytest.raises(ValueError):
        CQ.mgs_qr(torch.zeros((40, 20), dtype=torch.complex64, device=cuda)[:, ::2])
