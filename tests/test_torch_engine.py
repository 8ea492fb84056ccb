"""The ported slice as a whole: TDVP steps of the port against the JAX engine.

The 6-site singlet-fission chain (``singlet_fission_chain(2, 3)``) at D=8
in complex128.  The JAX engine is pinned to the MGS(×2) gauge (the
convention of its accelerator runs, and the port's on every device): the
Hartree-product start is rank-deficient, so the fixed-D trajectory depends
on the dead-column completion frame, and LAPACK's completions would give a
different valid trajectory ~1e-4 away (``tests/test_pallas_lanczos.py``).
Its state enters the port through ``convert.from_numpy``; both then take
three steps of 0.2 fs.

The test marked ``cuda`` runs the slice through both kernels on an NVIDIA
GPU and skips elsewhere; JAX is imported inside the ``jx`` fixture, so it
also runs where JAX is not installed (``python -m pytest --noconftest -m
cuda ...``).

Tolerances: the two run the same recurrence, stopping rule and gauge in
float64, and differ only in the order of sums and in exp(scale·T)e₀ (eigh
in JAX, Taylor substeps in the port, ~1e-11 apart per call), so the dense
states agree to 1e-10 and ⟨H⟩ to 1e-12.  The overlap form of ``distance``
cannot resolve below ~1e-8 (it is the square root of a difference of
norms of order 1, so float64 round-off of 1e-16 appears as 1e-8): it is
held to 1e-7.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytdscf_torch import convert, units
from pytdscf_torch.config import Config
from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps.lattice import alloc_hartree_product
from pytdscf_torch.mps.tdvp import TDVPEngine

torch.set_num_threads(1)

DT = 0.2 / units.au_in_fs
N_LEFT, N_RIGHT, BOND = 2, 3, 8
NSITE = N_LEFT + 1 + N_RIGHT


def _start():
    basis, ham = singlet_fission_chain(n_left=N_LEFT, n_right=N_RIGHT)
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == N_LEFT else 0] = 1.0
        vecs.append(v)
    return [alloc_hartree_product(phys, BOND, vecs)], ham, phys


def _dense(cores):
    out = cores[0]
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, c)
    return out[0, ..., 0]


@pytest.fixture
def jx(monkeypatch):
    """The JAX engine, pinned to its XLA MGS(×2) gauge."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    monkeypatch.setattr(JK, "_PALLAS_QR_FORCE", True)
    monkeypatch.setattr(JK, "_PALLAS_QR_OFF", True)
    # the flags are read at trace time and are not part of any jit cache
    # key: drop traces made under the other convention, before and after
    jax.clear_caches()
    yield SimpleNamespace(Config=JConfig, TDVPEngine=JEngine)
    jax.clear_caches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_slice_matches_jax_engine(jx):
    cores, ham, phys = _start()
    jax_engine = jx.TDVPEngine(
        cores, ham, jx.Config(thresh_exp=1e-9, pallas_site=False)
    )
    fused = ham.fused_mpo(phys)
    cfg = Config(thresh_exp=1e-9, pytest_enabled=True)
    port = convert.from_numpy(jax_engine.to_numpy(), fused, cfg)
    for _ in range(3):
        lz0, qr0 = CL.lanczos_expm.plain_calls, CQ.mgs_qr.plain_calls
        jax_engine.propagate(DT)
        port.propagate(DT)
        # 2 half-sweeps × (6 H + 5 K) exponentials and 2 × 5 gauge moves
        assert CL.lanczos_expm.plain_calls - lz0 == 2 * (2 * NSITE - 1)
        assert CQ.mgs_qr.plain_calls - qr0 == 2 * (NSITE - 1)
        mirror = convert.from_numpy(jax_engine.to_numpy(), fused, cfg)
        assert port.distance(mirror) < 1e-7
        d = np.linalg.norm(
            _dense(port.to_numpy()[0]) - _dense(jax_engine.to_numpy()[0])
        )
        assert d < 1e-10, d
        e_port, e_jax = port.expectation().real, jax_engine.expectation().real
        assert abs(e_port - e_jax) < 1e-12
    assert abs(port.norm() - jax_engine.norm()) < 1e-12
    assert abs(port.autocorr() - jax_engine.autocorr()) < 1e-10
    *stats, relaxed = port.krylov_stats()
    assert stats == pytest.approx(jax_engine.krylov_stats())
    assert relaxed == 0  # Lanczos runs no relaxed matvec


def test_convert_round_trip():
    cores, ham, phys = _start()
    port = convert.from_numpy(cores, ham.fused_mpo(phys), Config())
    back = port.to_numpy()
    assert all(np.array_equal(a, b) for a, b in zip(back[0], cores[0]))
    # the port's own Hamiltonian builds the same engine
    own = TDVPEngine(cores, ham, Config())
    assert all(torch.equal(a, b) for a, b in zip(own.W, port.W))


@pytest.mark.parametrize("field,value,item", [
    ("relax", "imaginary", "A7"),
    ("relax", "improved", "A7"),
    ("krylov_relaxed", True, "A2"),  # relaxed Krylov with Lanczos
    ("splitting", "suzuki4", "A10"),
    ("splitting", "yoshida4", "A10"),
])
def test_outside_the_slice_raises(field, value, item):
    cores, ham, _ = _start()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        TDVPEngine(cores, ham, Config(**{field: value}))


def test_multi_state_and_gates_raise():
    cores, ham, _ = _start()
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        TDVPEngine(cores + cores, ham, Config())
    engine = TDVPEngine(cores, ham, Config())
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        engine.propagate(DT, kraus_op=object())


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_slice_on_card_tracks_cpu(cuda):
    """complex64 through both kernels on the card tracks the complex128
    plain path on the CPU at float32 scale (the bound of
    tests/test_pallas_lanczos.py's engine test)."""
    cores, ham, _ = _start()
    cpu = TDVPEngine(cores, ham, Config(thresh_exp=1e-9))
    card = TDVPEngine(cores, ham, Config(thresh_exp=1e-9, dtype="complex64"),
                      device=cuda)
    for _ in range(3):
        lz0, qr0 = CL.lanczos_expm.launches, CQ.mgs_qr.launches
        cpu.propagate(DT)
        card.propagate(DT)
        assert CL.lanczos_expm.launches - lz0 == 2 * (2 * NSITE - 1)
        assert CQ.mgs_qr.launches - qr0 == 2 * (NSITE - 1)
    mirror = convert.from_numpy(card.to_numpy(), ham.fused_mpo(card.phys_dims),
                                Config())
    assert cpu.distance(mirror) < 5e-5
    assert abs(cpu.expectation().real - card.expectation().real) < 1e-6
