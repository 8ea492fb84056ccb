"""The Krylov program of ``pytdscf_torch.mps.integrator`` and its control
step (``mps/cuda_krylov.py``).

The program runs the loop unrolled, with the stopping decision taken on the
device by the control step; driven from the host it reads one flag per
iteration.  Held here, on the CPU:

* Arnoldi against the host loop it replaces (kept below as
  ``_arnoldi_host_loop``, the loop with its three host reads per
  iteration): bit for bit, the same operations in the same order;
* Lanczos against its host loop (``_lanczos_host_loop``, ``eigh`` of the
  tridiagonal and ψ-space convergence test): the program forms
  ``exp(scale·T)e₀`` by the control step's Taylor series and tests
  convergence through the Gram matrix, so the two agree to round-off
  (1e-12 relative in complex128) with the same Krylov dimension;
* both against the JAX package's ``krylov_expm`` in complex128 (1e-10);
* the host reads: at most one per iteration;
* the control step's decisions (breakdown, cap, the full space, relaxed
  counts).

The tests marked ``cuda`` hold the control kernel against its plain
version, the IF nodes of a capture, and a replayed radical-pair step
against a host-driven one on an NVIDIA GPU, and skip elsewhere (``python
-m pytest --noconftest -m cuda tests/test_torch_krylov.py``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from pytdscf_torch.mps import cuda_krylov as CK
from pytdscf_torch.mps import integrator as TI

torch.set_num_threads(1)

EPS = 1.0e-14


def _cx(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _operators(n, seed=0, hermitian=False):
    rng = np.random.default_rng(seed)
    H = _cx(rng, n, n) / np.sqrt(n)
    if hermitian:
        H = H + H.conj().T
    H_lo = H + 1e-3 * _cx(rng, n, n) / np.sqrt(n)
    if hermitian:
        H_lo = 0.5 * (H_lo + H_lo.conj().T)
    return H, H_lo, _cx(rng, n)


# --------------------------------------------- the loops the program replaced
def _arnoldi_host_loop(matvec, v0, scale, thresh, k_max):
    n = v0.shape[0]
    dtype = v0.dtype
    V = torch.zeros((k_max + 1, n), dtype=dtype)
    V[0] = v0
    H = torch.zeros((k_max + 1, k_max), dtype=dtype)
    c_prev = torch.zeros(k_max, dtype=dtype)
    for k in range(k_max):
        w = matvec(k, V[k])
        live = V[: k + 1]
        h = (live @ w.conj()).conj()
        w = w - h @ live
        b = torch.linalg.vector_norm(w)
        breakdown = bool(b < EPS)
        if not breakdown:
            V[k + 1] = w / b
        H[: k + 1, k] = h
        H[k + 1, k] = b
        c = torch.zeros(k_max, dtype=dtype)
        c[: k + 1] = TI._expm_taylor_small(scale * H[: k + 1, : k + 1])[:, 0]
        err = float(torch.linalg.vector_norm(c - c_prev))
        c_prev = c
        conv = k > 0 and err < thresh
        capped = k + 1 >= k_max
        if conv or breakdown or capped:
            return c[: k + 1] @ V[: k + 1], k + 1, capped and not conv and not breakdown


def _lanczos_host_loop(matvec, v0, scale, thresh, k_max):
    n = v0.shape[0]
    real = v0.real.dtype
    V = torch.zeros((k_max + 1, n), dtype=v0.dtype)
    V[0] = v0
    alpha = torch.zeros(k_max, dtype=real)
    beta = torch.zeros(k_max, dtype=real)
    psi_prev = torch.zeros_like(v0)
    for k in range(k_max):
        w = matvec(k, V[k])
        a = torch.sum(v0.conj() * w)
        w = w - a * V[k]
        if k > 0:
            w = w - beta[k - 1] * V[k - 1]
        b = torch.linalg.vector_norm(w)
        breakdown = bool(b < EPS)
        if not breakdown:
            V[k + 1] = w / b
        alpha[k] = a.real
        beta[k] = b
        T = (torch.diag(alpha[: k + 1]) + torch.diag(beta[:k], 1)
             + torch.diag(beta[:k], -1))
        w_e, U = torch.linalg.eigh(T)
        c = (U.to(v0.dtype) * torch.exp(scale * w_e.to(v0.dtype))) @ U[0].to(
            v0.dtype)
        psi_next = c @ V[: k + 1]
        err = float(torch.linalg.vector_norm(psi_next - psi_prev))
        psi_prev = psi_next
        conv = k > 0 and err < thresh
        capped = k + 1 >= k_max
        if conv or breakdown or capped:
            return psi_next, k + 1, capped and not conv and not breakdown


def _host_expm(loop, H, H_lo, v, scale, thresh, max_dim, relax_after):
    Ht, Hlo = torch.from_numpy(H), torch.from_numpy(H_lo)
    vt = torch.from_numpy(v)
    n = vt.shape[0]
    k_max = min(max_dim, n)

    def mv(k, x):
        if relax_after is not None and k >= relax_after:
            return Hlo @ x
        return Ht @ x

    beta0 = torch.linalg.vector_norm(vt)
    psi, k, bad = loop(mv, vt / beta0, scale, thresh, k_max)
    if k_max >= n:
        bad = False
    return (psi * beta0).numpy(), k, bad


def _program_expm(arnoldi, H, H_lo, v, scale, thresh, max_dim, relax_after):
    Ht, Hlo = torch.from_numpy(H), torch.from_numpy(H_lo)
    kw = {}
    if relax_after is not None:
        kw = dict(matvec_lo=lambda x: Hlo @ x, relax_after=relax_after)
    out, k, bad = TI.krylov_expm(
        lambda x: Ht @ x, torch.from_numpy(v), scale, thresh,
        max_dim=max_dim, conserve_norm=False, arnoldi=arnoldi,
        return_iterations=True, **kw)
    return out.numpy(), k, bad


def _jax_expm(arnoldi, H, H_lo, v, scale, thresh, max_dim, relax_after):
    import jax.numpy as jnp

    from pytdscf_tpu.mps import integrator as JI

    Hj, Hlo = jnp.asarray(H), jnp.asarray(H_lo)
    kw = {}
    if relax_after is not None:
        kw = dict(matvec_lo=lambda x: Hlo @ x, relax_after=relax_after)
    out, k, bad = JI.krylov_expm(
        lambda x: Hj @ x, jnp.asarray(v), jnp.asarray(scale, jnp.complex128),
        thresh, max_dim=max_dim, conserve_norm=False, arnoldi=arnoldi,
        return_iterations=True, **kw)
    return np.asarray(out), int(k), bool(bad)


CASES = [
    (60, 12, 1e-9),  # converges inside the buffer
    (60, 4, 1e-12),  # hits the cap
    (5, 8, 1e-14),  # k_max >= n: the whole space, never capped
]


@pytest.mark.parametrize("relax_after", [None, 1])
@pytest.mark.parametrize("n,max_dim,thresh", CASES)
def test_arnoldi_program_matches_host_loop_bit_for_bit(n, max_dim, thresh,
                                                       relax_after):
    H, H_lo, v = _operators(n)
    scale = -0.5j * 0.8
    got, k, bad = _program_expm(True, H, H_lo, v, scale, thresh, max_dim,
                                relax_after)
    want, k_h, bad_h = _host_expm(_arnoldi_host_loop, H, H_lo, v, scale,
                                  thresh, max_dim, relax_after)
    assert (k, bad) == (k_h, bad_h)
    assert np.array_equal(got, want)
    j_out, k_j, bad_j = _jax_expm(True, H, H_lo, v, scale, thresh, max_dim,
                                  relax_after)
    assert (k, bad) == (k_j, bad_j)
    assert np.max(np.abs(got - j_out)) <= 1e-10 * np.max(np.abs(j_out))


@pytest.mark.parametrize("relax_after", [None, 1])
@pytest.mark.parametrize("n,max_dim,thresh", CASES)
def test_lanczos_program_matches_host_loop(n, max_dim, thresh, relax_after):
    H, H_lo, v = _operators(n, seed=4, hermitian=True)
    scale = -0.5j * 0.8
    got, k, bad = _program_expm(False, H, H_lo, v, scale, thresh, max_dim,
                                relax_after)
    want, k_h, bad_h = _host_expm(_lanczos_host_loop, H, H_lo, v, scale,
                                  thresh, max_dim, relax_after)
    assert (k, bad) == (k_h, bad_h)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    j_out, k_j, bad_j = _jax_expm(False, H, H_lo, v, scale, thresh, max_dim,
                                  relax_after)
    assert (k, bad) == (k_j, bad_j)
    assert np.max(np.abs(got - j_out)) <= 1e-10 * np.max(np.abs(j_out))


@pytest.mark.parametrize("arnoldi", [True, False])
def test_program_reads_one_flag_per_iteration(monkeypatch, arnoldi):
    """Driven from the host the program reads one flag per Krylov
    iteration after the first (whether it runs), and nothing else."""
    H, H_lo, v = _operators(60, seed=2, hermitian=not arnoldi)
    reads = []
    real_bool = torch.Tensor.__bool__

    def counted(self):
        reads.append(tuple(self.shape))
        return real_bool(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    out, status = TI.krylov_expm(
        lambda x: torch.from_numpy(H) @ x, torch.from_numpy(v), -0.4j, 1e-9,
        max_dim=20, arnoldi=arnoldi, return_status=True)
    monkeypatch.setattr(torch.Tensor, "__bool__", real_bool)
    k_used = int(status[0])
    assert 2 < k_used < 20
    # k_used − 1 flags said "run", the last one "stop"
    assert reads == [()] * k_used


def _ctl(k, kmax=6, b=1.0, thresh=1e-6, exact=False, relax_after=None,
         gram=False, seed=0):
    rng = np.random.default_rng(seed)
    T = torch.zeros((kmax + 1, kmax + 1), dtype=torch.complex128)
    T[: k + 1, : k + 1] = torch.from_numpy(0.3 * _cx(rng, k + 1, k + 1))
    T[k + 1, k] = b
    G = None
    if gram:
        A = _cx(rng, kmax + 1, kmax + 1)
        G = torch.from_numpy(np.eye(kmax + 1) + 0.01 * (A @ A.conj().T))
    c = torch.zeros(kmax, dtype=torch.complex128)
    flags = torch.zeros(kmax + 1, dtype=torch.bool)
    status = torch.zeros(3, dtype=torch.int32)
    calls = CK.krylov_ctl.plain_calls
    CK.krylov_ctl(T, G, c, flags, status, k=k, scale=-0.5j, thresh=thresh,
                  exact=exact, relax_after=relax_after)
    return T, c, flags, status, CK.krylov_ctl.plain_calls - calls


def test_control_step_decisions():
    # iteration 0 never converges; a live vector runs the next iteration
    T, c, flags, status, counts = _ctl(0)
    assert flags.tolist()[:2] == [True, False]
    assert status.tolist() == [1, 0, 0] and counts == 1
    want = TI._expm_taylor_small(-0.5j * T[:1, :1])[:, 0]
    assert torch.equal(c[:1], want) and not c[1:].any()
    # a breakdown stops without the cap flag
    _, _, flags, status, _ = _ctl(2, b=0.0)
    assert flags.tolist()[0] is False and flags.tolist()[3] is True
    assert status.tolist() == [3, 0, 0]
    # the cap: flagged, unless the space is the whole one
    _, _, flags, status, _ = _ctl(5, relax_after=2)
    assert flags.tolist()[0] is False and flags.tolist()[6] is True
    assert status.tolist() == [6, 1, 4]
    _, _, _, status, _ = _ctl(5, exact=True)
    assert status.tolist() == [6, 0, 0]
    # convergence from iteration 1 on, against the previous coefficients
    _, _, flags, _, _ = _ctl(3, thresh=1e3, gram=True)
    assert flags.tolist()[0] is False and flags.tolist()[4] is True


def test_control_step_lanczos_error_is_psi_space():
    """With the Gram matrix of the basis, the error is ‖Σ d_j V_j‖."""
    rng = np.random.default_rng(9)
    k, kmax, n = 3, 6, 40
    V = torch.from_numpy(_cx(rng, kmax + 1, n))
    G = (V.conj() @ V.T)
    c_prev = torch.zeros(kmax, dtype=torch.complex128)
    c_prev[:k] = torch.from_numpy(_cx(rng, k))
    T = torch.zeros((kmax + 1, kmax + 1), dtype=torch.complex128)
    T[: k + 1, : k + 1] = torch.from_numpy(0.2 * _cx(rng, k + 1, k + 1))
    T[k + 1, k] = 1.0
    c = c_prev.clone()
    want = None
    for thresh in (1e3, 1e-3):
        c = c_prev.clone()
        flags = torch.zeros(kmax + 1, dtype=torch.bool)
        status = torch.zeros(3, dtype=torch.int32)
        CK.krylov_ctl(T, G, c, flags, status, k=k, scale=-0.5j,
                      thresh=thresh, exact=False, relax_after=None)
        want = float(torch.linalg.vector_norm((c - c_prev) @ V[:kmax]))
        assert bool(flags[0]) == (thresh < want)
    assert 1e-3 < want < 1e3


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control kernel and IF nodes "
                    "run on the card")
    return torch.device("cuda")


def _ctl_inputs(rng, k, kmax, gram, dev, b=1.0):
    """An upper Hessenberg T whose scale·T has a norm of order one, as a
    Krylov step's (‖scale·T‖₁ of a few; not the cancelling products of a
    large random matrix), G near the identity, random c_prev."""
    T = torch.zeros((kmax + 1, kmax + 1), dtype=torch.complex64)
    h = np.triu(_cx(rng, k + 1, k + 1), -1) * 2.0 / np.sqrt(k + 1)
    T[: k + 1, : k + 1] = torch.from_numpy(h)
    T[k + 1, k] = b
    G = None
    if gram:
        A = _cx(rng, kmax + 1, kmax + 1)
        G = torch.from_numpy(np.eye(kmax + 1) + 0.01 * (A @ A.conj().T)).to(
            torch.complex64).to(dev)
    c = torch.zeros(kmax, dtype=torch.complex64)
    c[:k] = torch.from_numpy(0.1 * _cx(rng, k))
    return T.to(dev), G, c.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kmax", [7, 9, 32, 64])
@pytest.mark.parametrize("gram", [False, True])
def test_control_kernel_matches_plain(cuda, kmax, gram):
    """The control kernel against its plain version at k_used = m = 1, 2,
    8 (the one-warp kernel, m <= 8), 9, 32 and 64 (the block kernel), as
    far as k_max allows, and at m = 4 and k_max / 2."""
    rng = np.random.default_rng(kmax)
    ms = sorted({1, 2, 4, 8, 9, 32, 64, kmax // 2, kmax} & set(range(1, kmax + 1)))
    for m in ms:
        k = m - 1
        T, G, c = _ctl_inputs(rng, k, kmax, gram, cuda)
        out = {}
        for way, dev in (("kernel", cuda), ("plain", torch.device("cpu"))):
            cc = c.clone().to(dev)
            flags = torch.zeros(kmax + 1, dtype=torch.bool, device=dev)
            status = torch.zeros(3, dtype=torch.int32, device=dev)
            launches = CK.krylov_ctl.launches
            CK.krylov_ctl(T.to(dev), None if G is None else G.to(dev), cc,
                          flags, status, k=k, scale=-0.25j, thresh=1e-6,
                          exact=False, relax_after=1)
            assert CK.krylov_ctl.launches - launches == (way == "kernel")
            out[way] = (cc.cpu(), flags.cpu(), status.cpu())
        ck, fk, sk = out["kernel"]
        cp, fp, sp = out["plain"]
        # float32 products in another order through up to 12 + s dense
        # m×m products: 3.9e-6 measured at m = 17 (an H100)
        assert torch.max(torch.abs(ck - cp)) <= 2e-5 * max(1.0, float(
            torch.max(torch.abs(cp))))
        assert torch.equal(fk, fp) and torch.equal(sk, sp)


@pytest.mark.cuda
def test_if_nodes_run_only_flagged_bodies(cuda):
    """A Krylov program's IF nodes in a row, their conditions set by the
    control kernel itself: iteration k's body runs where the control step
    of iteration k−1 did not stop (here: no breakdown, ``T[k, k−1] = 1``),
    the gather node of the iteration that stopped runs and no other, what
    a body allocated stays the graph's, and the control kernel counts on
    the device only the launches that ran."""
    from pytdscf_torch.mps import step_graph

    kmax = 4
    x = torch.zeros(4, device=cuda)
    stop_at = torch.full((1,), -1.0, device=cuda)
    T = torch.zeros((kmax + 1, kmax + 1), dtype=torch.complex64, device=cuda)
    c = torch.zeros(kmax, dtype=torch.complex64, device=cuda)
    ctl_flags = torch.zeros(kmax + 1, dtype=torch.bool, device=cuda)
    status = torch.zeros(3, dtype=torch.int32, device=cuda)
    count = CK.krylov_ctl.replayed.setdefault(
        T.device.index, torch.zeros(1, dtype=torch.int32, device=cuda))
    branches = CK.GraphBranches(cuda, False, lambda: [], step_graph._diff)
    graph = torch.cuda.CUDAGraph()
    kw = dict(scale=-0.5j, thresh=1e-6, exact=False, relax_after=None)
    with torch.cuda.graph(graph):
        hs = branches.handles(2 * kmax - 1)
        handles = ([None, *hs[:kmax - 1]], hs[kmax - 1:])
        CK.krylov_ctl(T, None, c, ctl_flags, status, k=0, handles=handles,
                      **kw)
        for k in range(1, kmax):
            with branches.branch(handles[0][k]):
                y = torch.full((4,), float(k), device=cuda)
                x.add_(y)
                CK.krylov_ctl(T, None, c, ctl_flags, status, k=k,
                              handles=handles, **kw)
        for j in range(kmax):
            with branches.branch(handles[1][j]):
                stop_at.fill_(float(j))
    # n_live iterations without a breakdown: T[k+1, k] = 1 for k < n_live
    for n_live, want, runs in ((0, 0.0, 1), (1, 1.0, 2), (2, 3.0, 3),
                               (5, 6.0, 4)):
        T.zero_()
        for k in range(min(n_live, kmax)):
            T[k + 1, k] = 1.0
        c.zero_()
        x.zero_()
        count.zero_()
        stop_at.fill_(-1.0)
        graph.replay()
        junk = torch.full((1 << 16,), 7.0, device=cuda)
        torch.cuda.synchronize()
        assert torch.equal(x, torch.full((4,), want, device=cuda))
        assert bool((junk == 7.0).all())
        assert int(count) == runs
        assert float(stop_at) == runs - 1
    count.zero_()


def _rp_engine(dev, preset):
    from pytdscf_torch import Model
    from pytdscf_torch.config import Config
    from pytdscf_torch.models.radical_pair import (
        radical_pair_liouvillian,
        singlet_product_state,
    )
    from pytdscf_torch.mps.lattice import alloc_hartree_product, bond_dims_for_site
    from pytdscf_torch.mps.tdvp import TDVPEngine

    hfc = [0.15, 0.22, 0.3]
    basis, mpo, ele = radical_pair_liouvillian(
        hfcs_1=[(2, a) for a in hfc], hfcs_2=[(2, a) for a in hfc],
        split_electron=True)
    phys = [b.nstate for b in basis]
    vecs = singlet_product_state(basis, ele, split_electron=True)
    cores = alloc_hartree_product(phys, 4, vecs, space="liouville")
    rng = np.random.default_rng(42)
    full = []
    for p, c in enumerate(cores):
        m_l, m_r = bond_dims_for_site(phys, p, 64)
        x = np.zeros((m_l, phys[p], m_r), dtype=np.complex64)
        x[: c.shape[0], :, : c.shape[2]] = c
        x += 1e-4 * max(np.abs(c).max(), 1e-30) * (
            rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
        full.append(x)
    model = Model(basis, {"hamiltonian": mpo}, space="liouville", bond_dim=64)
    config = Config(integrator="arnoldi", max_krylov=7, thresh_exp=1e-6,
                    conserve_norm=False, space="liouville", dtype="complex64")
    engine = TDVPEngine([full], model.hamiltonian,
                        config.with_precision_preset(preset), dev)
    engine.right_canonicalize()
    return engine


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["balanced", "throughput"])
def test_radical_pair_replay_matches_host_steps(cuda, preset):
    """The radical pair's step recorded with its Krylov iterations as IF
    nodes: replays against host-driven steps, the same Krylov telemetry and
    the same counted launches (the replays' counted on the device)."""
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_renorm as CR

    def launches():
        return (CM.heff_lo.launches, CM.keff_lo.launches,
                CR.renorm_hi.launches, CR.matvec_hi.launches,
                CK.krylov_ctl.launches)

    ref, blk = _rp_engine(cuda, preset), _rp_engine(cuda, preset)
    assert blk.capturable()
    n = 4
    before = launches()
    for _ in range(n):
        ref.propagate(0.5)
    torch.cuda.synchronize()
    host = [a - b for a, b in zip(launches(), before)]
    before = launches()
    blk.propagate_steps(0.5, n)
    torch.cuda.synchronize()
    graph = [a - b for a, b in zip(launches(), before)]
    assert (blk.eager_steps, blk.graph_steps) == (1, n - 1)
    assert graph == host
    assert ref.krylov_stats() == blk.krylov_stats()
    gap = max(float(torch.max(torch.abs(a - b)))
              for a, b in zip(ref.cores[0], blk.cores[0]))
    scale = max(float(torch.max(torch.abs(a))) for a in ref.cores[0])
    assert gap <= 1e-5 * scale
    assert math.isfinite(abs(blk.trace()))
