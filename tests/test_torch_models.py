"""The JAX package's one-state nonadiabatic models through the port.

Pyrazine's QVC model, donor–acceptor models A and B and the LH2 chain
(``pytdscf_torch/models/``, copies of the JAX package's builders) run
through the port's ``Simulator`` on the CPU in complex128, held to the JAX
suite's own references: each JAX test body runs against the port
(``torch_ported.ported``), with its literals and tolerances: the
MPO-vs-dense checks at 1e-12 (LH2's MPO is held bit for bit to the JAX
package's in ``tests/test_torch_host_model.py``, whose own test holds it
to its dense matvec), the dense expm trajectories at 2e-5
(``tests/test_pyrazine.py``, ``test_donor_acceptor.py``, ``test_lh2.py``),
and the LVC exciton model's energy literal and site-3 density at 1e-9
(``tests/test_exciton_propagate.py``).  The exciton model's D=2 bonds are
rank deficient, so its trajectory depends on how the gauge QR completes
dead columns: its literals are LAPACK's (the JAX package's CPU gauge), and
the test pins the port to LAPACK's QR for it; under the port's own MGS
completions the density differs by 1.4e-4 (the JAX package pinned to MGS
agrees with the port to 1e-10: ``tests/test_torch_fused.py``).  Then the
slice as a whole: pyrazine's 4-mode reduction through both Simulators (3
steps: energies and ρ(0,0) within 1e-10).

The tests marked ``cuda`` hold the Lanczos kernel to its plain version at
the new models' shapes: pyrazine's bulk (200, 20) over 30 channels on the
cluster route and donor–acceptor model B's (560, 20) over 16 channels on
one block, and the MGS gauge at model B's (560, 20).  They need an NVIDIA
GPU and skip elsewhere; JAX is imported inside the tests that use it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps import kernels as K
from torch_ported import one_blas_thread, ported

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with one_blas_thread():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _jax_tests(name: str):
    import importlib

    return importlib.import_module(f"tests.{name}")


# ------------------------------------------------ the JAX suite's checks
@pytest.mark.parametrize("module,test", [
    ("test_donor_acceptor", "test_da_small_bath_mpo_matches_dense"),
    ("test_donor_acceptor", "test_da_b_mpo_matches_dense"),
])
def test_mpo_matches_dense(module, test):
    ported(getattr(_jax_tests(module), test))()


@pytest.mark.parametrize("module,test", [
    ("test_pyrazine", "test_pyrazine_4mode_matches_dense"),
    ("test_donor_acceptor", "test_da_no_bath_matches_dense"),
    ("test_donor_acceptor", "test_da_b_propagation_matches_expm"),
    ("test_lh2", "test_lh2_single_molecule_matches_dense"),
])
def test_trajectory_matches_dense(module, test, tmp_path, monkeypatch):
    ported(getattr(_jax_tests(module), test))(tmp_path, monkeypatch)


def test_pyrazine_full_mpo_compiles():
    ported(_jax_tests("test_pyrazine").test_pyrazine_full_24mode_mpo_compiles)()


def test_exciton_propagate_literals(tmp_path, monkeypatch):
    """``tests/test_exciton_propagate.py`` (energy 0.010000180312707298,
    ρ(3, 3) at the last step to 1e-9) with the port's gauge QR pinned to
    LAPACK's, whose completions its literals were computed with."""
    from pytdscf_torch.basis import Exciton, HarmonicOscillator as HO

    jt = _jax_tests("test_exciton_propagate")
    prim = [HO(8, f, units="cm-1") for f in jt.freqs_cm1] + [
        Exciton(nstate=2, names=["S0", "S1"])]
    build = ported(jt._build_hamiltonian, prim_info=prim)
    monkeypatch.setattr(K, "thin_qr", lambda m: torch.linalg.qr(m))
    from pytdscf_torch.util import read_nc

    ported(jt.test_exciton_propagate, prim_info=prim,
           _build_hamiltonian=build, read_nc=read_nc)(tmp_path, monkeypatch)


# ------------------------------------------------ the slice against JAX
def test_pyrazine_4mode_against_jax(tmp_path, monkeypatch):
    """Pyrazine's 4-mode reduction (nprim 6, D=36) through the port's and
    the JAX package's ``Simulator`` on the CPU in complex128, 1, 2 and 3
    steps of 0.5 fs: the energies and every row of ρ(0,0) within 1e-10."""
    from pytdscf_torch import Model, Simulator
    from pytdscf_torch.models import pyrazine_qvc
    from pytdscf_torch.util import read_nc
    from pytdscf_tpu.model import Model as JModel
    from pytdscf_tpu.models.pyrazine import pyrazine_qvc as j_pyrazine_qvc
    from pytdscf_tpu.simulator import Simulator as JSimulator

    monkeypatch.chdir(tmp_path)
    modes, nprim = [0, 1, 2, 5], 6
    weights = [[0.0, 1.0]] + [[1.0] + [0.0] * (nprim - 1)] * len(modes)

    def run(job, model_cls, build, sim, nstep):
        basis, ham = build(modes=modes, nprim=nprim)
        model = model_cls(basis, {"hamiltonian": ham}, bond_dim=36)
        model.init_HartreeProduct = [weights]
        energy, _ = sim(job, model).propagate(
            reduced_density=([(0, 0)], 1), maxstep=nstep, stepsize=0.5,
            autocorr=False, energy=True, norm=True, populations=False)
        rho = read_nc(f"{job}_prop/reduced_density.nc", [(0, 0)])[(0, 0)]
        return energy, np.asarray(rho)

    for nstep in (1, 2, 3):
        e_t, rho_t = run(f"t{nstep}", Model, pyrazine_qvc,
                         lambda j, m: Simulator(j, m, verbose=0,
                                                device="cpu"), nstep)
        e_j, rho_j = run(f"j{nstep}", JModel, j_pyrazine_qvc,
                         lambda j, m: JSimulator(j, m, verbose=0), nstep)
        assert rho_t.shape == rho_j.shape == (nstep, 2, 2)
        assert abs(e_t - e_j) < 1e-10
        np.testing.assert_allclose(rho_t, rho_j, rtol=0, atol=1e-10)


# ------------------------------------------------------------ on the card
def _site(seed: int, l: int, d: int, r: int, w: int):
    """A seeded Hermitian site: ψ (l, d, r), L (l, w, l), W (w, d, d, w),
    R (r, w, r), complex64."""
    rng = np.random.default_rng(seed)

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.linalg.norm(a)

    psi, L, R, W = cx(l, d, r), cx(l, w, l), cx(r, w, r), cx(w, d, d, w)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())
    return [torch.from_numpy(x).to(torch.complex64) for x in (psi, L, W, R)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,way", [
    ((20, 10, 20, 30), "cluster"),  # pyrazine's bulk H step, 30 channels
    ((20, 28, 20, 16), "block"),  # model B's bulk, 16 channels
])
def test_lanczos_kernel_at_model_shapes(cuda, shape, way):
    l, d, r, w = shape
    psi, L, W, R = (x.to(cuda) for x in _site(41, l, d, r, w))
    ch = CL.heff_channels(L, W, R)
    v = psi.reshape(l * d, r).contiguous()
    assert CL.route(l * d, r, w) == way
    assert CL.fits((l * d, r), w, 20)
    before = dict(CL.lanczos_expm.route_launches)
    out, st = CL.lanczos_expm(ch, v, -0.5j, 1e-6, 20, True)
    again, _ = CL.lanczos_expm(ch, v, -0.5j, 1e-6, 20, True)
    ref, st_ref = CL.lanczos_expm_plain(*ch, v, -0.5j, 1e-6, 20, True)
    torch.cuda.synchronize()
    assert CL.lanczos_expm.route_launches[way] == before[way] + 2
    assert st.tolist() == st_ref.tolist()
    assert torch.equal(out, again)
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [0, 12])
def test_mgs_kernel_at_model_b_gauge(cuda, dead):
    """MGS at model B's (560, 20) gauge, full rank and with 12 dead
    columns (a Hartree-product start): orthonormal, reconstructs the
    matrix, and agrees with its plain version."""
    rng = np.random.default_rng(43)
    m = rng.standard_normal((560, 20)) + 1j * rng.standard_normal((560, 20))
    m[:, 20 - dead:] = 0.0
    mat = torch.from_numpy(m).to(torch.complex64).to(cuda)
    launches = CQ.mgs_qr.launches
    q, rr = CQ.mgs_qr(mat)
    q_p, r_p = CQ.mgs_qr_plain(mat)
    torch.cuda.synchronize()
    assert CQ.mgs_qr.launches == launches + 1
    eye = torch.eye(20, dtype=q.dtype, device=cuda)
    assert float((q.conj().T @ q - eye).abs().max()) < 1e-5
    assert float((q @ rr - mat).abs().max()) < 1e-5
    assert float((q - q_p).abs().max()) < 1e-4
    assert float((rr - r_p).abs().max()) < 1e-4
