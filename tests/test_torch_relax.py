"""Relaxation and operate of the port against the JAX package (ROADMAP
A7, one electronic state), on the CPU in complex128; the whole workflow is
``tests/test_torch_workflow.py``.

* The restarted-Lanczos ground state (``integrator.lanczos_ground_state``
  and ``ground_state_multi``, the plain version of the ground-state kernel)
  against the JAX functions on a random Hermitian matvec: the same
  recurrence, masked T and float64 ``eigh``, so the energies agree to
  1e-12 and the Ritz vectors to |⟨a|b⟩| ≥ 1 − 1e-12 (a Ritz vector is
  fixed up to a phase: raw vectors are never compared).
* Imaginary-time and improved relaxation, and ``apply_operator_fit``, of
  the port's engine against the JAX engine on a small SOP chain (the
  butadiene surface cut to its first four local modes, 5 primitives, D=4),
  three steps from the Hartree product: ⟨H⟩ to 1e-10 and |⟨port|JAX⟩| ≥
  1 − 1e-10.  The JAX engine is pinned to its MGS gauge, the port's (the
  start is rank-deficient, so the fixed-D trajectory depends on the
  completion frame, ``tests/test_torch_engine.py``).
* ``t2_trick=False``: the explicit ⟨Ψ(0)|Ψ(t)⟩ rows of ``autocorr.dat``
  (the file the spectrum reads) against the JAX Simulator's on the small
  chain, to 1e-10.

The tests marked ``cuda`` hold the ground-state kernel, and the Lanczos
and fused site kernels at a real (imaginary-time) scale, against their
plain versions on the card; they skip elsewhere.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_cluster_replay as replay
from pytdscf_torch import Simulator, units
from pytdscf_torch.basis.ho import PrimBas_HO
from pytdscf_torch.config import Config
from pytdscf_torch.model import BasInfo, Model
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.mps import integrator as TI
from pytdscf_torch.mps.tdvp import TDVPEngine
from pytdscf_torch.operators.sop import read_potential_nMR
from pytdscf_torch.potentials import load

torch.set_num_threads(1)

EFIELD = (1.0e-02, 1.0e-02, 1.0e-02)
SMALL_MODES = [9, 10, 11, 12]
SMALL_PRIM, SMALL_BOND = 5, 4
DT_RELAX = 0.1 / units.au_in_fs


def _small_models():
    """(H model, μ·E model) of the butadiene surface cut to four modes."""
    k_orig = load("c4h6_local_potential")["k_orig"]
    mu = load("c4h6_local_dipole")["mu"]
    prim = [[PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1,
                        SMALL_PRIM) for m in SMALL_MODES]]
    basinfo = BasInfo(prim)
    ham = read_potential_nMR(k_orig, active_modes=SMALL_MODES)
    mu_ham = read_potential_nMR(None, dipole_emu=mu, efield=EFIELD,
                                active_modes=SMALL_MODES)
    return (Model(basinfo, {"hamiltonian": ham}, bond_dim=SMALL_BOND),
            Model(basinfo, {"hamiltonian": mu_ham}, bond_dim=SMALL_BOND))


def _state(cores) -> np.ndarray:
    out = np.asarray(cores[0])
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, np.asarray(c))
    return out.reshape(-1)


def _overlap(a, b) -> float:
    a, b = _state(a), _state(b)
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.fixture(scope="module")
def jx():
    """The JAX package, its engine pinned to its XLA MGS(×2) gauge for the
    whole module (every JAX run here uses that gauge, so the traces are
    kept from test to test; the flags are read at trace time and are not
    part of any jit cache key, so the caches are dropped before and
    after)."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.mps import integrator as JI
    from pytdscf_tpu.mps import tdvp as JT
    from pytdscf_tpu.simulator import Simulator as JSimulator

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JK, "_PALLAS_QR_FORCE", True)
        mp.setattr(JK, "_PALLAS_QR_OFF", True)
        jax.clear_caches()
        yield SimpleNamespace(Config=JConfig, TDVPEngine=JT.TDVPEngine,
                              Simulator=JSimulator,
                              lanczos_ground_state=JI.lanczos_ground_state,
                              ground_state_multi=JT._ground_state_multi)
        jax.clear_caches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------- the ground state


@pytest.mark.parametrize("n", [7, 40, 150])
def test_ground_state_matches_jax(jx, n):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = (A + A.conj().T) / 2
    v = rng.normal(size=n) + 1j * rng.normal(size=n)
    At = torch.from_numpy(A)
    exact = np.linalg.eigvalsh(A)[0]

    def energy(x):
        return np.vdot(x, A @ x).real

    one_j = np.asarray(jx.lanczos_ground_state(lambda x: jnp.asarray(A) @ x,
                                               jnp.asarray(v)))
    one_t, k_fin, _ = TI.lanczos_ground_state(lambda x: At @ x,
                                                  torch.from_numpy(v))
    one_t = one_t.numpy()
    assert int(k_fin) == min(TI.GS_BLOCK_DIM, n)
    assert abs(energy(one_t) - energy(one_j)) < 1e-12
    assert abs(np.vdot(one_j, one_t)) > 1 - 1e-12
    many_j = np.asarray(jx.ground_state_multi(lambda x: jnp.asarray(A) @ x,
                                              jnp.asarray(v)))
    many_t, status = TI.ground_state_multi(lambda x: At @ x,
                                           torch.from_numpy(v))
    many_t = many_t.numpy()
    passes, iters, breaks = status.tolist()
    assert 2 <= passes <= TI.GS_MAX_RESTARTS
    assert iters <= passes * TI.GS_BLOCK_DIM
    assert abs(energy(many_t) - energy(many_j)) < 1e-12
    assert abs(np.vdot(many_j, many_t)) > 1 - 1e-12
    assert abs(energy(many_t) - exact) < 1e-12


def test_ground_state_channels_plain():
    """The kernel's plain version (channel matvec) on a CPU tensor through
    the wrapper, counted as a plain call, against the dense H_eff's lowest
    eigenpair."""
    rng = np.random.default_rng(5)
    nc, M, r = 3, 10, 4
    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    H = torch.from_numpy((H + H.conj().transpose(0, 2, 1)) / 2)
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    Rt = torch.from_numpy((Rt + Rt.conj().transpose(0, 2, 1)) / 2)
    v = torch.from_numpy(rng.normal(size=(M, r)) + 0j)
    calls = CL.ground_state.plain_calls
    out, status = CL.ground_state((H, Rt), v)
    assert CL.ground_state.plain_calls == calls + 1
    assert status.dtype == torch.int32 and status.shape == (3,)
    D = torch.einsum("cij,cba->iajb", H, Rt).reshape(M * r, M * r)
    lam, vec = torch.linalg.eigh(D)
    x = out.reshape(-1)
    assert abs(torch.vdot(x, D @ x).real.item() - lam[0].item()) < 1e-12
    assert abs(torch.vdot(vec[:, 0], x)).item() > 1 - 1e-10
    assert CL.gs_fits((M, r), nc)
    assert not CL.gs_fits((4096, 64), 64)


@pytest.mark.parametrize("nc,M,r,C", [(6, 20, 4, 16), (3, 6, 3, 1)])
def test_ground_state_schedule_replay_matches_plain_c128(nc, M, r, C):
    """The ground-state kernel's schedule (``tests/torch_cluster_replay.py``:
    each rank's rows of the matvec, u = H v_k − β v_{k−1} on its rows, α
    and the Ritz norm and energy as rank-ordered partials, the update, β
    and v_{k+1} on the whole vector) on a bulk-like cluster of 16 (ranks
    past the end own no rows) and on one CTA equals the plain version in
    complex128: energies to 1e-12, |⟨replay|plain⟩| ≥ 1 − 1e-12, the same
    passes, iterations and breakdowns."""
    rng = np.random.default_rng(nc * 1000 + M)
    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    H = torch.from_numpy((H + H.conj().transpose(0, 2, 1)) / (2 * M))
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    Rt = torch.from_numpy((Rt + Rt.conj().transpose(0, 2, 1)) / (2 * r))
    v = torch.from_numpy(rng.normal(size=(M, r)) + 1j * rng.normal(size=(M, r)))
    got, st = replay.ground_state(H, Rt, v, C)
    want, st_p = CL.ground_state_plain(H, Rt, v)

    def energy(x):
        return torch.vdot(x.reshape(-1), CL._matvec(H, Rt, x).reshape(-1)).real

    assert st == st_p.tolist()
    assert abs(float(energy(got) - energy(want.reshape(M, r)))) < 1e-12
    assert abs(torch.vdot(got.reshape(-1), want.reshape(-1))).item() > 1 - 1e-12


def test_gs_plan_at_the_relax_shapes():
    """The ground state's own route rule at every site shape of the relax
    stages (``gs_rule``, PERF.md §6): the cluster size and block size per
    shape, a layout that fits the CTA's shared memory, every route the
    rule picks among the kernel's candidates."""
    want = {(5, 9, 9): ("block", 1, 128), (3, 81, 9): ("cluster", 16, 512),
            (1, 81, 1): ("block", 1, 128), (5, 6, 6): ("block", 1, 128),
            (11, 36, 12): ("cluster", 16, 512),
            (20, 72, 12): ("cluster", 16, 512),
            (26, 72, 12): ("cluster", 16, 512),
            (30, 72, 12): ("cluster", 16, 512),
            (11, 72, 12): ("cluster", 16, 512),
            (5, 72, 6): ("cluster", 16, 512), (1, 36, 1): ("block", 1, 128)}
    assert sorted(want) == sorted(RELAX_SHAPES)
    for (nc, M, r), route in want.items():
        plan = CL.gs_plan(M, r, nc)
        assert plan[:3] == route, (nc, M, r)
        assert CL.gs_fits((M, r), nc)
        assert plan[1:3] in CL.gs_candidates(M, r, nc)
        kmax = min(TI.GS_BLOCK_DIM, M * r)
        assert plan[3:6] == (False, True, True), (nc, M, r)
        assert CL.gs_smem_bytes(nc, M, r, plan[1], kmax,
                                *plan[3:6]) <= CL.GS_MAX_SMEM
    with pytest.raises(ValueError):
        CL._gs_launch_plan(72, 12, 30, 1, 512)


#: (channels, M, r) at which ``gs_plan`` takes each layout ``(wide,
#: resident, v_shared)`` of a ground-state CTA (``gs_layout``)
GS_LAYOUT_SHAPES = {
    (5, 9, 9): (False, True, True), (2, 4, 111): (False, True, False),
    (30, 114, 4): (False, False, True), (10, 200, 20): (False, False, False),
    (3, 353, 4): (True, True, True), (2, 97, 99): (True, True, False),
    (4, 300, 30): (True, False, True), (2, 369, 28): (True, False, False),
}


@pytest.mark.parametrize("nc,M,r", sorted(GS_LAYOUT_SHAPES))
def test_gs_plan_layouts(nc, M, r):
    """Each layout of a ground-state CTA at a shape that takes it: the
    kernel takes the site (``gs_fits``), its shared memory fits, the wide
    layout asks device scratch for its (3·C + 2)·M·r whole-vector entries
    and the rows of the Krylov vectors for C·k_max·Mc·r where not
    shared."""
    wide, resident, v_shared = GS_LAYOUT_SHAPES[nc, M, r]
    assert CL.gs_fits((M, r), nc)
    way, C, threads, *layout, scratch = CL.gs_plan(M, r, nc)
    assert tuple(layout) == (wide, resident, v_shared)
    kmax = min(TI.GS_BLOCK_DIM, M * r)
    assert CL.gs_smem_bytes(nc, M, r, C, kmax, *layout) <= CL.GS_MAX_SMEM
    assert scratch == ((0 if v_shared else C * kmax * -(-M // C) * r)
                       + ((3 * C + 2) * M * r if wide else 0))


def test_gs_fits_every_lanczos_site():
    """The ground-state kernel takes every site whose working set the
    Lanczos exponential's kernel takes (within ``MAX_BYTES``, its shared
    memory on the route it picks: the rule the ground state followed
    before it had layouts of its own), on a grid of shapes up to M·r ≈ 25
    k entries."""
    for M in range(1, 400, 3):
        for r in (1, 2, 3, 4, 6, 9, 12, 20, 30, 50, 64, 100, 150, 200):
            for nc in (1, 3, 8, 16, 30, 64):
                kmax = min(TI.GS_BLOCK_DIM, M * r)
                size = CL.cluster_size(M, r, nc) or 1
                if (8 * (nc * (M * M + r * r) + (kmax + 1) * M * r)
                        <= CL.MAX_BYTES
                        and CL.smem_bytes(nc, M, r, size) <= CL.MAX_SMEM):
                    assert CL.gs_fits((M, r), nc), (nc, M, r)


# ---------------------------------------------------- the engine


@pytest.mark.parametrize("mode", ["imaginary", "improved"])
def test_relax_matches_jax_engine(jx, mode):
    model, _ = _small_models()
    cores = Simulator("small", model, device="cpu")._alloc_initial_cores()
    ham = model.hamiltonian
    jax_engine = jx.TDVPEngine(cores, ham,
                               jx.Config(relax=mode, pallas_site=False))
    port = TDVPEngine(cores, ham, Config(relax=mode, pytest_enabled=True),
                      "cpu")
    nsite = len(SMALL_MODES)
    e0 = port.expectation().real
    for _ in range(3):
        gs0 = CL.ground_state.plain_calls
        lz0 = CL.lanczos_expm.plain_calls
        jax_engine.propagate(DT_RELAX)
        port.propagate(DT_RELAX)
        if mode == "improved":
            # a ground state at every site, no exponential, no K step
            assert CL.ground_state.plain_calls - gs0 == 2 * nsite
            assert CL.lanczos_expm.plain_calls == lz0
        else:
            assert CL.lanczos_expm.plain_calls - lz0 == 2 * (2 * nsite - 1)
            assert CL.ground_state.plain_calls == gs0
        e_p = port.expectation().real
        assert abs(e_p - jax_engine.expectation().real) < 1e-10
        assert abs(port.norm() - 1.0) < 1e-12
        assert _overlap(port.to_numpy()[0], jax_engine.to_numpy()[0]) > 1 - 1e-10
        assert e_p < e0
        e0 = e_p
    if mode == "improved":
        stats = port.ground_state_stats()
        assert stats["calls"] == 3 * 2 * nsite == sum(stats["passes_hist"])
        assert stats["passes"] == sum(
            k * n for k, n in enumerate(stats["passes_hist"]))
        assert port.ground_state_stats()["calls"] == 0  # reset
        mean, calls, _, _ = port.krylov_stats()
        assert calls == 3 * 2 * nsite and mean > 1


def test_improved_einsum_route_matches_channels(monkeypatch):
    """A site past ``gs_fits`` runs ``ground_state_multi`` over the einsum
    matvec (and the step is no longer capturable): the same relaxation as
    the channel route to 1e-12 in ⟨H⟩."""
    model, _ = _small_models()
    cores = Simulator("small", model, device="cpu")._alloc_initial_cores()
    cfg = Config(relax="improved")
    channels = TDVPEngine(cores, model.hamiltonian, cfg, "cpu")
    einsum = TDVPEngine(cores, model.hamiltonian, cfg, "cpu")
    for _ in range(2):
        channels.propagate(DT_RELAX)
    monkeypatch.setattr(CL, "gs_fits", lambda shape, nc: False)
    assert not einsum.capturable()
    calls = CL.ground_state.plain_calls
    for _ in range(2):
        einsum.propagate(DT_RELAX)
    assert CL.ground_state.plain_calls == calls
    assert abs(einsum.expectation().real
               - channels.expectation().real) < 1e-12
    assert _overlap(einsum.to_numpy()[0], channels.to_numpy()[0]) > 1 - 1e-12


def test_relax_steps_program_matches_host_steps():
    """Improved relaxation through ``propagate_steps`` (the step program,
    uncaptured on the CPU) equals the host-driven steps bit for bit, and
    ``capturable`` admits it where every site takes the ground-state
    kernel."""
    model, _ = _small_models()
    cores = Simulator("small", model, device="cpu")._alloc_initial_cores()
    cfg = Config(relax="improved")
    a = TDVPEngine(cores, model.hamiltonian, cfg, "cpu")
    b = TDVPEngine(cores, model.hamiltonian, cfg, "cpu")
    assert b.capturable()
    for _ in range(3):
        a.propagate(DT_RELAX)
    b.propagate_steps(DT_RELAX, 3)
    for x, y in zip(a.to_numpy()[0], b.to_numpy()[0]):
        assert np.array_equal(x, y)
    assert a.ground_state_stats() == b.ground_state_stats()


def test_operate_matches_jax_engine(jx):
    model, model_mu = _small_models()
    cores = Simulator("small", model, device="cpu")._alloc_initial_cores()
    relaxed = jx.TDVPEngine(cores, model.hamiltonian,
                            jx.Config(relax="improved", pallas_site=False))
    for _ in range(2):
        relaxed.propagate(DT_RELAX)
    gs = relaxed.to_numpy()
    mu = model_mu.hamiltonian
    jax_engine = jx.TDVPEngine(gs, mu, jx.Config(apply_dipole=True))
    port = TDVPEngine(gs, mu, Config(apply_dipole=True), "cpu")
    n_j = jax_engine.apply_operator_fit(mu, maxiter=10)
    n_p = port.apply_operator_fit(mu, maxiter=10)
    assert abs(n_p / n_j - 1) < 1e-10
    assert port.env_stack is None
    assert abs(port.norm() - 1.0) < 1e-12
    assert _overlap(port.to_numpy()[0], jax_engine.to_numpy()[0]) > 1 - 1e-10


def test_explicit_autocorr_matches_jax(jx, tmp_path, monkeypatch):
    """``t2_trick=False``: the explicit ⟨Ψ(0)|Ψ(t)⟩ rows against the JAX
    Simulator's on the small chain from its Hartree product."""
    monkeypatch.chdir(tmp_path)
    model, _ = _small_models()
    rows = {}
    for tag, sim in (
        ("jax", jx.Simulator("jx", model, t2_trick=False, verbose=0)),
        ("port", Simulator("pt", model, t2_trick=False, verbose=0,
                           device="cpu")),
    ):
        sim.propagate(stepsize=0.2, maxstep=5)
        job = sim.jobname
        with open(f"{job}_prop/autocorr.dat") as fh:
            rows[tag] = np.array([[complex(x) for x in ln.split()]
                                  for ln in fh if not ln.startswith("#")])
    assert rows["port"].shape == rows["jax"].shape == (5, 2)
    assert np.abs(rows["port"][:, 0] - np.arange(5) * 0.2).max() < 1e-12
    assert np.abs(rows["port"] - rows["jax"]).max() < 1e-10
    assert abs(rows["port"][0, 1] - 1.0) < 1e-12


def test_relax_refusals_name_a3():
    """``proj_gs`` is ported (A3, ``tests/test_torch_multistate.py``): a
    model without ``primbas_gs`` starts from its own Hartree product."""
    model, _ = _small_models()
    sim = Simulator("x", model, proj_gs=True, device="cpu")
    assert sim.proj_gs and model.primbas_gs is None
    plain = Simulator("x", model, device="cpu")._alloc_initial_cores()
    for a, b in zip(sim._alloc_initial_cores(), plain):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="relax"):
        Config(relax="sideways")


# ---------------------------------------------------- on the card


def _random_channels(rng, nc, M, r, device):
    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    H = (H + H.conj().transpose(0, 2, 1)) / (2 * M)
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    Rt = (Rt + Rt.conj().transpose(0, 2, 1)) / (2 * r)
    v = rng.normal(size=(M, r)) + 1j * rng.normal(size=(M, r))
    return [torch.tensor(x, dtype=torch.complex64, device=device)
            for x in (H, Rt, v)]


#: (channels, M, r) of every site shape of the relax stages'
#: ``chip_smoke.py`` runs: H2O (3 modes, 9 primitives, D=9) and butadiene
#: (14 modes, 6 primitives, D=12)
RELAX_SHAPES = [(5, 9, 9), (3, 81, 9), (1, 81, 1), (5, 6, 6), (11, 36, 12),
                (20, 72, 12), (26, 72, 12), (30, 72, 12), (11, 72, 12),
                (5, 72, 6), (1, 36, 1)]


def _gs_check(cuda, nc, M, r, **route):
    """The kernel on ``route`` against its plain version on random
    channels: energies to 1e-6 relative, |⟨kernel|plain⟩| ≥ 1 − 1e-5, unit
    norm, a second launch bit-identical (float32 sums in another order:
    the pass counts may differ); the launch counted on its route."""
    H, Rt, v = _random_channels(np.random.default_rng(M * 100 + r), nc, M,
                                r, cuda)
    if "cluster" in route:
        way, size = CL._gs_launch_plan(M, r, nc, route["cluster"],
                                       route["threads"])[:2]

        def run():
            return CL._ground_state_on((H, Rt), v, **route)
    else:
        way, size = CL.gs_plan(M, r, nc, **route)[:2]

        def run():
            return CL.ground_state((H, Rt), v, **route)
    before = dict(CL.ground_state.route_launches)
    out, st = run()
    again, _ = run()
    want, _ = CL.ground_state_plain(H, Rt, v)

    def energy(x):
        return torch.vdot(x.reshape(-1),
                          CL._matvec(H, Rt, x).reshape(-1)).real.item()

    assert CL.ground_state.route_launches[way] == before[way] + 2
    assert (way == "block") == (size == 1)
    assert torch.equal(out, again)
    assert abs(energy(out) - energy(want)) <= 1e-6 * abs(energy(want))
    assert abs(torch.vdot(out.reshape(-1), want.reshape(-1))).item() > 1 - 1e-5
    assert abs(torch.linalg.vector_norm(out).item() - 1) < 1e-5
    passes, iters, _ = st.tolist()
    assert 2 <= passes <= TI.GS_MAX_RESTARTS and iters >= passes


@pytest.mark.cuda
@pytest.mark.parametrize("nc,M,r,way", [
    *[(*shape, None) for shape in RELAX_SHAPES],
    (5, 6, 6, "block"), (5, 81, 9, "block"), (3, 81, 1, None),
    *[(*shape, None) for shape in sorted(GS_LAYOUT_SHAPES)
      if shape not in RELAX_SHAPES],
])
def test_ground_state_kernel_matches_plain(cuda, nc, M, r, way):
    """The kernel against its plain version at every shape of the relax
    stages on the route and cluster size that ``gs_plan`` picks, on one
    CTA where asked, and on each layout of a CTA (``GS_LAYOUT_SHAPES``:
    H's rows resident or streamed, the Krylov vectors' rows in shared
    memory or device scratch, the whole vectors in shared memory or, wide,
    in device scratch), the layout asserted."""
    if (nc, M, r) in GS_LAYOUT_SHAPES:
        assert CL.gs_plan(M, r, nc, way)[3:6] == GS_LAYOUT_SHAPES[nc, M, r]
    _gs_check(cuda, nc, M, r, way=way)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,M,r", [(30, 72, 12), (3, 81, 9), (5, 9, 9)])
def test_ground_state_kernel_every_route(cuda, nc, M, r):
    """The kernel on every cluster size and block size it takes
    (``gs_candidates``) at a butadiene bulk and two H2O shapes."""
    for size, threads in CL.gs_candidates(M, r, nc):
        _gs_check(cuda, nc, M, r, cluster=size, threads=threads)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_lanczos_kernel_real_scale(cuda, sign):
    """The Lanczos kernel at a real scale (imaginary time: the H step
    decays, the K step grows) against its plain version, conserving the
    norm: the same status, ‖Δψ‖ < 5e-6."""
    H, Rt, v = _random_channels(np.random.default_rng(7), 30, 72, 12, cuda)
    scale = complex(sign * 0.5 * 4.0)
    got, st = CL.lanczos_expm((H, Rt), v, scale, 1e-9, 20, True)
    want, st_p = CL.lanczos_expm_plain(H, Rt, v, scale, 1e-9, 20, True)
    assert st.tolist() == st_p.tolist()
    assert torch.linalg.vector_norm(got - want).item() < 5e-6
    assert abs(torch.linalg.vector_norm(got).item() - 1) < 1e-5


@pytest.mark.cuda
def test_site_kernel_real_scale(cuda):
    """The fused site kernel at a real scale on a butadiene bulk site of
    the small chain's shapes widened to D=12: its outputs against the plain
    version's to 5e-6, the same status."""
    rng = np.random.default_rng(3)
    l, d, r, w = 12, 6, 12, 30

    def t(*shape):
        return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                            dtype=torch.complex64, device=cuda)

    L = t(l, w, l)
    L = (L + L.conj().permute(2, 1, 0)) / (2 * l)
    R = t(r, w, r)
    R = (R + R.conj().permute(2, 1, 0)) / (2 * r)
    W = t(w, d, d, w)
    W = (W + W.conj().permute(0, 2, 1, 3)) / (2 * w * d)
    psi, nxt = t(l, d, r), t(r, d, r)
    psi = psi / torch.linalg.vector_norm(psi)
    zero = torch.zeros((), dtype=torch.float32, device=cuda)
    args = (psi, nxt, L, W, R, complex(-2.0), 1e-9, zero, zero)
    kw = dict(forward=True, max_dim=20, conserve=True)
    got = CS.site_step_fused(*args, **kw)
    want = CS.site_step_fused_plain(*args, **kw)
    assert got[4].tolist() == want[4].tolist()
    for a, b in zip(got[1:4], want[1:4]):
        assert torch.max(torch.abs(a - b)).item() < 5e-6


@pytest.mark.cuda
def test_ground_state_kernel_on_butadiene_bulk(cuda):
    """The kernel against its plain version on the butadiene bulk site's
    own operands (D=12, 30 channels, a cluster) after one improved step on
    the card, the state's centre moved to the site: the energies to 1e-6
    relative and |⟨kernel|plain⟩| ≥ 1 − 1e-5."""
    from pytdscf_torch.mps import kernels as K

    k_orig = load("c4h6_local_potential")["k_orig"]
    modes = sorted({i for key in k_orig for i in key})
    prim = [[PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1, 6)
             for m in modes]]
    model = Model(BasInfo(prim), {"hamiltonian": read_potential_nMR(k_orig)},
                  bond_dim=12)
    cores = Simulator("c4h6", model, device="cpu")._alloc_initial_cores()
    engine = TDVPEngine(cores, model.hamiltonian,
                        Config(relax="improved", dtype="complex64"), cuda)
    engine.propagate(DT_RELAX)
    p = 6
    for q in range(p):
        a, sig = K.qr_right(engine.cores[0][q])
        engine.cores[0][q] = a
        engine.cores[0][q + 1] = K.absorb_right(sig, engine.cores[0][q + 1])
    L, lL = engine.build_left_env_stack()[p]
    R, lR = engine.build_right_env_stack()[engine.nsite - 1 - p]
    ch = CL.heff_channels(L, engine.W[p], R, torch.exp(lL + lR))
    psi = engine.cores[0][p]
    l, d, r = psi.shape
    v = psi.reshape(l * d, r).contiguous()
    assert CL.gs_plan(l * d, r, ch[0].shape[0])[0] == "cluster"
    out, _ = CL.ground_state(ch, v)
    want, _ = CL.ground_state_plain(*ch, v)

    def energy(x):
        return torch.vdot(x.reshape(-1),
                          CL._matvec(*ch, x).reshape(-1)).real.item()

    assert abs(energy(out) - energy(want)) <= 1e-6 * abs(energy(want))
    assert abs(torch.vdot(out.reshape(-1), want.reshape(-1))).item() > 1 - 1e-5
