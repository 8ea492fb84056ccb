"""The Lanczos exponential of the port (``mps/cuda_lanczos.py``).

Its plain PyTorch version is held on the CPU against the JAX package:
in complex64 against the fused Pallas kernel ``lanczos_expm_fused`` run in
interpret mode, with the tolerances of ``tests/test_pallas_lanczos.py``
(same Krylov dimension, ‖Δψ‖ < 5e-6: both are float32 with a Taylor-
substepped tridiagonal exponential, summed in other orders), and in
complex128 against ``krylov_expm`` (same Krylov dimension, ≤ 1e-9: the
Taylor form of exp(scale·T)e₀ agrees with ``eigh`` to ~1e-11 per call).

The CUDA kernel itself is held against the plain version by the tests
marked ``cuda``, which need an NVIDIA GPU and skip elsewhere.  JAX is
imported inside the ``jx`` fixture, so those tests also run where JAX is
not installed (``python -m pytest --noconftest -m cuda ...``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_cluster_replay as replay
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import kernels as TK

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from pytdscf_tpu.mps import pallas_lanczos, tdvp
    from pytdscf_tpu.mps.integrator import krylov_expm

    return SimpleNamespace(
        jnp=jnp, PLZ=pallas_lanczos, tdvp=tdvp, krylov_expm=krylov_expm
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rand_site(seed, l, d, r, w):
    rng = np.random.default_rng(seed)

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.linalg.norm(a)

    psi, L, R, W = cx(l, d, r), cx(l, w, l), cx(r, w, r), cx(w, d, d, w)
    # Hermitian H_eff: L/R Hermitian in (bra, ket), W in (i, j)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())
    return psi, L, W, R


def _t(x, dtype=torch.complex64):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("scale", [-0.25j, -0.25])
def test_heff_plain_matches_pallas_kernel(jx, scale):
    l, d, r, w = 6, 4, 6, 3
    psi, L, W, R = _rand_site(3, l, d, r, w)
    c64 = jx.jnp.complex64
    ch = jx.PLZ.heff_channels(*(jx.jnp.asarray(x, c64) for x in (L, W, R)))
    ref, k_ref, bad_ref = jx.PLZ.lanczos_expm_fused(
        ch, jx.jnp.asarray(psi.reshape(-1), c64), (l, d, r),
        jx.jnp.asarray(scale, c64), 1e-6, 10, True,
    )
    H, Rt = CL.heff_channels(_t(L), _t(W), _t(R))
    out, st = CL.lanczos_expm_plain(
        H, Rt, _t(psi).reshape(l * d, r), scale, 1e-6, 10, True
    )
    assert st.tolist() == [int(k_ref), int(bool(bad_ref))]
    err = np.linalg.norm(out.numpy().reshape(-1) - np.asarray(ref))
    assert err < 5e-6, err


def test_keff_plain_matches_pallas_kernel(jx):
    kdim, w = 8, 3
    rng = np.random.default_rng(11)

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.linalg.norm(a)

    L, R, sig = cx(kdim, w, kdim), cx(kdim, w, kdim), cx(kdim, kdim)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    c64 = jx.jnp.complex64
    kch = jx.PLZ.keff_channels(jx.jnp.asarray(L, c64), jx.jnp.asarray(R, c64))
    ref, k_ref, _ = jx.PLZ.lanczos_expm_fused(
        kch, jx.jnp.asarray(sig.reshape(-1), c64), (kdim, 1, kdim),
        jx.jnp.asarray(0.25j, c64), 1e-6, 10, True,
    )
    H, Rt = CL.keff_channels(_t(L), _t(R))
    out, st = CL.lanczos_expm_plain(H, Rt, _t(sig), 0.25j, 1e-6, 10, True)
    assert st.tolist()[0] == int(k_ref)
    assert np.linalg.norm(out.numpy().reshape(-1) - np.asarray(ref)) < 5e-6


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 5e-5),
                                       (torch.complex128, 1e-9)])
def test_plain_breakdown_exact_subspace(dtype, tol):
    """An eigenvector start gives exp(scale·λ)·v, phase included."""
    l, d, r, w = 4, 3, 4, 2
    psi, L, W, R = _rand_site(5, l, d, r, w)
    H, Rt = CL.heff_channels(_t(L, dtype), _t(W, dtype), _t(R, dtype))
    n = l * d * r
    eye = torch.eye(n, dtype=torch.complex128)
    H2, Rt2 = CL.heff_channels(*(_t(x, torch.complex128) for x in (L, W, R)))
    dense = torch.stack([
        CL._matvec(H2, Rt2, eye[:, i].reshape(l * d, r)).reshape(n)
        for i in range(n)
    ], dim=1).numpy()
    wv, U = np.linalg.eigh(dense)
    v = _t(U[:, 0].reshape(l * d, r), dtype)
    out, st = CL.lanczos_expm_plain(H, Rt, v, -0.3j, 1e-6, 10, True)
    expect = np.exp(-0.3j * wv[0]) * U[:, 0]
    err = np.linalg.norm(out.numpy().reshape(-1) - expect)
    assert err < tol, (err, st.tolist())
    assert st.tolist()[1] == 0


@pytest.mark.parametrize("kind", ["prop", "imag", "keff", "edge", "whole"])
def test_plain_matches_krylov_expm_c128(jx, kind):
    """``whole``: n = 6 < max_dim, so k_max = n and ``bad`` is forced off."""
    c128 = jx.jnp.complex128
    if kind == "keff":
        psi, L, W, R = _rand_site(13, 7, 1, 7, 3)
        sig = psi.reshape(7, 7)
        mv = jx.tdvp._make_kmatvec(
            ((0, 0),), (jx.jnp.asarray(L),), (jx.jnp.asarray(R),),
            ((7, 7),), 1, c128,
        )
        H, Rt = CL.keff_channels(_t(L, torch.complex128), _t(R, torch.complex128))
        v, scale = sig, 0.4j
    else:
        l, d, r, w = {"edge": (1, 8, 8, 4), "whole": (1, 3, 2, 2)}.get(
            kind, (5, 3, 6, 4))
        psi, L, W, R = _rand_site(17, l, d, r, w)
        mv = jx.tdvp._make_hmatvec(
            ((0, 0),), (jx.jnp.asarray(L),), (jx.jnp.asarray(W),),
            (jx.jnp.asarray(R),), ((l, d, r),), 1, c128,
        )
        H, Rt = CL.heff_channels(*(_t(x, torch.complex128) for x in (L, W, R)))
        v, scale = psi.reshape(l * d, r), (-0.3 if kind == "imag" else -0.3j)
    ref, k_ref, bad_ref = jx.krylov_expm(
        mv, jx.jnp.asarray(v.reshape(-1), c128), jx.jnp.asarray(scale, c128),
        1e-9, max_dim=10, conserve_norm=True, return_iterations=True,
    )
    out, st = CL.lanczos_expm_plain(
        H, Rt, _t(v, torch.complex128), scale, 1e-9, 10, True
    )
    assert st.tolist() == [int(k_ref), int(bool(bad_ref))]
    assert np.max(np.abs(out.numpy().reshape(-1) - np.asarray(ref))) <= 1e-9


def test_channels_reproduce_heff_and_keff():
    """Σ_c H_c (ψ Rt_c) is the engine's heff_apply (and keff_apply)."""
    l, d, r, w = 5, 3, 4, 3
    psi, L, W, R = _rand_site(7, l, d, r, w)
    c = torch.complex128
    fac = torch.tensor(1.7, dtype=torch.float64)
    H, Rt = CL.heff_channels(_t(L, c), _t(W, c), _t(R, c), fac)
    got = CL._matvec(H, Rt, _t(psi, c).reshape(l * d, r)).reshape(l, d, r)
    ref = 1.7 * TK.heff_apply(_t(L, c), _t(W, c), _t(R, c), _t(psi, c))
    assert float(torch.max(torch.abs(got - ref))) < 1e-13
    Lk, Rk = _t(L, c), _t(_rand_site(9, r, 1, r, w)[3], c)
    sig = _t(psi.reshape(l, d * r)[:, :r], c)
    Hk, Rtk = CL.keff_channels(Lk, Rk)
    got_k = CL._matvec(Hk, Rtk, sig)
    assert float(torch.max(torch.abs(got_k - TK.keff_apply(Lk, Rk, sig)))) < 1e-13


def test_wrapper_runs_plain_version_on_cpu():
    psi, L, W, R = _rand_site(21, 3, 4, 5, 2)
    ch = CL.heff_channels(_t(L), _t(W), _t(R))
    v = _t(psi).reshape(12, 5)
    before = CL.lanczos_expm.plain_calls, CL.lanczos_expm.launches
    out, st = CL.lanczos_expm(ch, v, -0.2j, 1e-6, 10, True)
    ref, st_ref = CL.lanczos_expm_plain(*ch, v, -0.2j, 1e-6, 10, True)
    assert torch.equal(out, ref) and torch.equal(st, st_ref)
    assert CL.lanczos_expm.plain_calls == before[0] + 1
    assert CL.lanczos_expm.launches == before[1]
    with pytest.raises(ValueError):
        CL.lanczos_expm(ch, v.reshape(5, 12), -0.2j, 1e-6, 10, True)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("shape,conserve", [
    ((1, 8, 8, 4), True), ((3, 8, 5, 3), False), ((9, 3, 5, 3), True),
    ((30, 8, 30, 4), True),
])
def test_cluster_replay_matches_plain_c128(shape, conserve, C):
    """The cluster route's algorithm (row split with empty ranks, the x
    gather, rank-ordered partial sums; ``tests/torch_cluster_replay.py``)
    at M = 8, 24, 27 and 240, with M < C and M mod C != 0 among them,
    equals the plain version in complex128."""
    l, d, r, w = shape
    M = l * d
    psi, L, W, R = _rand_site(43, l, d, r, w)
    c = torch.complex128
    H, Rt = CL.heff_channels(_t(L, c), _t(W, c), _t(R, c))
    v = _t(psi, c).reshape(M, r)
    splits = replay.row_split(M, C)
    # consecutive rows, all of them; ranks past the end own none
    assert [s.start for s in splits[1:]] == [s.stop for s in splits[:-1]]
    assert splits[-1].stop == M
    rows, st = replay.lanczos(H, Rt, v, -0.5j, 1e-6, 10, conserve, C)
    ref, st_ref = CL.lanczos_expm_plain(H, Rt, v, -0.5j, 1e-6, 10, conserve)
    assert st == st_ref.tolist()
    assert float(torch.max(torch.abs(replay.gather(rows) - ref))) < 1e-12


def test_route_by_shape():
    """The chain's H steps (M = l·d ≥ 64) take clusters of 16, its (30, 30)
    K steps clusters of 8, the edge sites (M = 8) one block: each the
    largest size that leaves every CTA MIN_ROWS_PER_CTA rows.  A cluster
    route's shared memory counts the gathered x, the intermediate and its
    own rows."""
    for M, r, nc in ((240, 30, 4), (90, 30, 4), (64, 30, 4), (240, 8, 3)):
        assert CL.route(M, r, nc) == "cluster"
        assert CL.cluster_size(M, r, nc) == 16
    assert CL.route(30, 30, 4) == "cluster"
    assert CL.cluster_size(30, 30, 4) == 8
    assert CL.route(8, 8, 3) == "block"
    assert CL.cluster_size(8, 8, 3) is None
    assert CL.plan(30, 30, 4, 10) == ("cluster", 8, True, 8 * 11 * 4 * 30)
    assert CL.plan(8, 8, 3, 10) == ("block", 1, False, 16 * 8 * 8)
    assert CL.plan(30, 30, 4, 10, "cluster", 16)[:2] == ("cluster", 16)
    assert CL.smem_bytes(4, 240, 30, 16) == 8 * (
        240 * 30 + 6 * 15 * 30 + 4 * 15 * 33 + 32)
    assert CL.smem_bytes(4, 240, 30, 8) == 8 * (
        240 * 30 + 6 * 30 * 30 + 4 * 30 * 33 + 16)
    # at 16 CTAs the bulk rows of H (115 KB) stay in shared memory, at 8 not
    resident = 8 * (240 * 30 + 6 * 15 * 30 + 4 * 15 * 241 + 32)
    assert CL.smem_bytes(4, 240, 30, 16, resident=True) == resident
    assert resident <= CL.MAX_SMEM < CL.smem_bytes(4, 240, 30, 8, True)
    # an x too large for one CTA's shared memory stays on one block
    assert CL.route(1024, 64, 8) == "block"
    with pytest.raises(ValueError, match="does not fit"):
        CL.plan(1024, 64, 8, 10, "cluster")


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (30, 8, 30, 4), (30, 3, 30, 4), (1, 8, 8, 4), (8, 8, 1, 4), (30, 1, 30, 4),
])
def test_kernel_matches_plain_on_card(cuda, shape):
    l, d, r, w = shape
    psi, L, W, R = _rand_site(31, l, d, r, w)
    ch = CL.heff_channels(*(_t(x).to(cuda) for x in (L, W, R)))
    v = _t(psi).reshape(l * d, r).to(cuda)
    launches = CL.lanczos_expm.launches
    out, st = CL.lanczos_expm(ch, v, -0.5j, 1e-6, 10, True)
    ref, st_ref = CL.lanczos_expm_plain(*ch, v, -0.5j, 1e-6, 10, True)
    torch.cuda.synchronize()
    assert CL.lanczos_expm.launches == launches + 1
    assert st.tolist() == st_ref.tolist()
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    psi, L, W, R = _rand_site(33, 4, 3, 4, 2)
    ch = CL.heff_channels(*(_t(x).to(cuda) for x in (L, W, R)))
    v = _t(psi).reshape(12, 4).to(cuda)
    with pytest.raises(TypeError):
        CL.lanczos_expm(tuple(c.to(torch.complex128) for c in ch),
                        v.to(torch.complex128), -0.5j, 1e-6, 10, True)
    with pytest.raises(ValueError):
        CL.lanczos_expm(ch, v, -0.5j, 1e-6, 33, True)


@pytest.mark.cuda
@pytest.mark.parametrize("way,cluster", [("block", 16), ("cluster", 8),
                                         ("cluster", 16)])
@pytest.mark.parametrize("shape", [
    (30, 8, 30, 4), (30, 3, 30, 4), (1, 8, 8, 4), (3, 9, 1, 4),
])
def test_kernel_routes_match_plain_on_card(cuda, way, cluster, shape):
    """Both routes at the chain's shapes (bulk, exciton site, the edge
    M = 8, and M = 27 which 8 and 16 do not divide): ‖Δψ‖ < 5e-6, the
    plain version's status, and a second launch equal bit for bit."""
    l, d, r, w = shape
    psi, L, W, R = _rand_site(37, l, d, r, w)
    ch = CL.heff_channels(*(_t(x).to(cuda) for x in (L, W, R)))
    v = _t(psi).reshape(l * d, r).to(cuda)
    before = dict(CL.lanczos_expm.route_launches)
    kw = dict(way=way, cluster=cluster)
    out, st = CL.lanczos_expm(ch, v, -0.5j, 1e-6, 10, True, **kw)
    again, st2 = CL.lanczos_expm(ch, v, -0.5j, 1e-6, 10, True, **kw)
    ref, st_ref = CL.lanczos_expm_plain(*ch, v, -0.5j, 1e-6, 10, True)
    torch.cuda.synchronize()
    assert CL.lanczos_expm.route_launches[way] == before[way] + 2
    assert st.tolist() == st_ref.tolist() == st2.tolist()
    assert torch.equal(out, again)
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6


@pytest.mark.cuda
def test_cluster_route_takes_the_bulk_and_the_k_steps(cuda):
    """A (30, 30) K step on its own route, a cluster of 8: the plain
    version's status and ‖Δψ‖ < 5e-6, counted by size."""
    rng = np.random.default_rng(39)
    L = rng.standard_normal((30, 4, 30)) + 1j * rng.standard_normal((30, 4, 30))
    L = 0.5 * (L + L.transpose(2, 1, 0).conj()) / np.linalg.norm(L)
    sig = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    kch = CL.keff_channels(_t(L).to(cuda), _t(L).to(cuda))
    v = _t(sig / np.linalg.norm(sig)).to(cuda)
    before = CL.lanczos_expm.cluster_launches.get(8, 0)
    out, st = CL.lanczos_expm(kch, v, 0.5j, 1e-6, 10, False)
    ref, st_ref = CL.lanczos_expm_plain(*kch, v, 0.5j, 1e-6, 10, False)
    assert CL.lanczos_expm.cluster_launches[8] == before + 1
    assert st.tolist() == st_ref.tolist()
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6


@pytest.mark.cuda
def test_cluster_that_cannot_be_scheduled_raises(cuda):
    """A cluster of 32 CTAs exceeds what the card schedules: the wrapper
    raises and launches nothing, on no other route."""
    psi, L, W, R = _rand_site(41, 30, 8, 30, 4)
    ch = CL.heff_channels(*(_t(x).to(cuda) for x in (L, W, R)))
    v = _t(psi).reshape(240, 30).to(cuda)
    before = CL.lanczos_expm.launches, dict(CL.lanczos_expm.route_launches)
    with pytest.raises(RuntimeError, match="cluster route"):
        CL.lanczos_expm(ch, v, -0.5j, 1e-6, 10, True, way="cluster",
                        cluster=32)
    assert (CL.lanczos_expm.launches,
            dict(CL.lanczos_expm.route_launches)) == before
