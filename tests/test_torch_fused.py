"""The port's fused multi-step driver and deferred property fetch.

``TDVPEngine.propagate_steps`` / ``propagate_steps_collect`` run a block
of steps; where ``capturable()`` holds they run a step program over fixed
buffers (``mps/step_graph.py``), recorded as a CUDA graph on the card and
run uncaptured on the CPU, so these CPU tests cover its buffer logic.
``Simulator.propagate(fetch_stride=N)`` runs N-long blocks through
``Properties.run_fused_block`` and defers the other steps' reads to one
packed fetch (``Properties.flush``).  Held here: blocks against the
per-step loop on the 6-site singlet-fission chain (complex128), the
deferred observables against the JAX package's on the same state, the
LVC exciton model of ``tests/test_exciton_propagate.py`` through the
port's Simulator at strides 1, 3 and 4 against the JAX Simulator at
stride 4 (pinned to its MGS gauge, the port's), the backup boundary, the
capture decision, and the radical pair's Arnoldi blocks (relaxed Krylov
at "balanced" and "throughput", and exact) on the step program.  The JAX
runs are module-scoped and run once.

Tolerances: on the CPU the program runs the same operations on buffers
of the same layouts as ``propagate``, so blocks equal the per-step loop
to 1e-12 (measured: bit for bit), the radical pair's too.  Against JAX: the same
recurrence in float64, so 1e-10, the JAX package's own bar for its fused
driver (``tests/test_fused_driver.py``).

The tests marked ``cuda`` replay the step graph on an NVIDIA GPU and skip
elsewhere (``python -m pytest --noconftest -m cuda
tests/test_torch_fused.py``); JAX is imported only inside the CPU
fixtures.  Graph replay against host-launched steps: the same kernels on
the same operands in the same layouts, so the states agree to 1e-6
relative in complex64 and, as measured on an H100, bit for bit, with
equal launch counts and Krylov statistics.
"""

from __future__ import annotations

import functools
import os
import types

import numpy as np
import pytest
import torch

from pytdscf_torch import Model, Simulator, convert, units
from pytdscf_torch.basis import Exciton
from pytdscf_torch.basis.ho import HarmonicOscillator
from pytdscf_torch.config import Config
from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.mps.lattice import alloc_hartree_product
from pytdscf_torch.mps.tdvp import TDVPEngine, fetch_many
from pytdscf_torch.operators.hamiltonian import TensorHamiltonian
from pytdscf_torch.operators.tensor_op import TensorOperator
from pytdscf_torch.properties import Properties

torch.set_num_threads(1)

DT = 0.2 / units.au_in_fs
N_LEFT, N_RIGHT, BOND = 2, 3, 8
LVC_STEPS = 11  # not a multiple of 3 or 4: each strided run ends in a
# partial block
LVC_ENERGY = 0.010000180312707298  # tests/test_exciton_propagate.py


def _chain(device="cpu", dtype="complex128", **cfg) -> TDVPEngine:
    basis, ham = singlet_fission_chain(n_left=N_LEFT, n_right=N_RIGHT)
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == N_LEFT else 0] = 1.0
        vecs.append(v)
    cores = [alloc_hartree_product(phys, BOND, vecs)]
    cfg.setdefault("thresh_exp", 1e-9 if dtype == "complex128" else 1e-6)
    config = Config(dtype=dtype, pytest_enabled=True, **cfg)
    return TDVPEngine(cores, ham, config, device)


def _dense(engine) -> np.ndarray:
    cores = engine.to_numpy()[0]
    out = cores[0]
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, c)
    return out[0, ..., 0]


def _gap(a, b) -> float:
    return float(np.linalg.norm(_dense(a) - _dense(b)))


# ------------------------------------------------- blocks against steps
@pytest.mark.parametrize("fused_site", [False, True])
def test_propagate_steps_matches_per_step(fused_site):
    ref, blk = _chain(fused_site=fused_site), _chain(fused_site=fused_site)
    assert blk.capturable()
    for _ in range(4):
        ref.propagate(DT)
    blk.propagate_steps(DT, 4)
    assert _gap(ref, blk) < 1e-12
    assert abs(ref.expectation().real - blk.expectation().real) < 1e-12
    assert ref.krylov_stats() == blk.krylov_stats()
    # the CPU has no graph: every step of the program runs uncaptured
    assert (blk.eager_steps, blk.graph_steps) == (4, 0)
    assert len(blk._programs) == 1


def test_blocks_continue_correctly():
    """Two blocks (2 + 3 steps, one program) == one block of 5."""
    a, b = _chain(), _chain()
    a.propagate_steps(DT, 2)
    a.propagate_steps(DT, 3)
    b.propagate_steps(DT, 5)
    assert _gap(a, b) < 1e-12
    assert len(a._programs) == 1
    # after a block the engine holds the program's buffers
    assert a.cores[0][0] is a._programs[next(iter(a._programs))].buffers[0]


def test_collect_rows_are_pre_step_bundles():
    """Row t of propagate_steps_collect is the observables of the state
    before step t, as properties_bundle reads them on the per-step loop."""
    ref, blk = _chain(), _chain()
    want = []
    for _ in range(3):
        ref._ensure_right_stack()
        want.append(ref.properties_bundle())
        ref.propagate(DT)
    items, plan = blk.propagate_steps_collect(DT, 3)
    vals = fetch_many(items, blk.fetch_real_dtype())
    for t, w in enumerate(want):
        got = blk.properties_resolve([v[t] for v in vals], plan)
        for key in ("energy", "autocorr", "norm"):
            assert abs(got[key] - w[key]) < 1e-12, (t, key)
        assert got["populations"] == pytest.approx(w["populations"],
                                                   abs=1e-12)


# ------------------------------------------- deferred observables vs JAX
@pytest.fixture(scope="module")
def jax_props():
    """The state after one step of the port, and its observables through
    the JAX engine's properties_bundle with the right stack built (the
    top-block ⟨H⟩)."""
    import jax

    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.models.holstein import singlet_fission_chain as jchain
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    basis, ham = jchain(n_left=N_LEFT, n_right=N_RIGHT)
    phys = [b.nprim for b in basis]
    state = _chain()
    state.propagate(DT)
    cores = state.to_numpy()
    jax.clear_caches()
    try:
        engine = JEngine(cores, ham, JConfig(thresh_exp=1e-9))
        engine.env_stack = engine.build_right_env_stack()
        engine._env_side = "right"
        out = engine.properties_bundle()
    finally:
        jax.clear_caches()
    return types.SimpleNamespace(out=out, cores=cores,
                                 fused=ham.fused_mpo(phys))


@pytest.mark.parametrize("stack", ["right", "none"])
def test_properties_match_jax(jax_props, stack):
    """⟨H⟩ from the top block of the right stack, and from the chain
    recontraction where the engine holds no stack, with the T/2
    autocorrelation, norm and populations, equal the JAX package's."""
    port = convert.from_numpy(jax_props.cores, jax_props.fused,
                              Config(thresh_exp=1e-9), "cpu")
    if stack == "right":
        port._ensure_right_stack()
    assert (port.env_stack is None) == (stack == "none")
    items, plan = port.properties_submit()
    got = port.properties_resolve(fetch_many(items, torch.float64), plan)
    want = jax_props.out
    assert abs(got["energy"] - complex(want["energy"])) < 1e-10
    assert abs(got["autocorr"] - complex(want["autocorr"])) < 1e-10
    assert abs(got["norm"] - want["norm"]) < 1e-10
    assert np.allclose(got["populations"], want["populations"], atol=1e-10,
                       rtol=0)
    assert abs(got["energy"].real - port.expectation().real) < 1e-12


def test_right_block_in_complex128_matches_a_complex128_engine():
    """``_right_block(W, complex128)`` of a complex64 engine (the smoke's
    ``energy64``) equals the complex128 engine's block of the same cores,
    and the default one feeds ``expectation``."""
    e64 = _chain(dtype="complex64")
    e64.propagate(DT)
    cores = e64.to_numpy()
    basis, ham = singlet_fission_chain(n_left=N_LEFT, n_right=N_RIGHT)
    # the MPO as the complex64 engine holds it, rounded to complex64
    W = [np.asarray(w, np.complex64).astype(np.complex128)
         for w in ham.fused_mpo([b.nprim for b in basis])[0][0]]
    e128 = convert.from_numpy([[c.astype(np.complex128) for c in cores[0]]],
                              [[W]], Config(dtype="complex128"), "cpu")
    block, log = e64._right_block(e64.W, torch.complex128)
    want, want_log = e128._right_block(e128.W)
    assert block.dtype == torch.complex128 and log.dtype == torch.float64
    assert torch.allclose(block, want, rtol=0, atol=1e-12)
    assert abs(float(log) - float(want_log)) < 1e-12
    assert abs(e64.expectation() - e128.expectation()) < 1e-5


def test_fetch_many_is_one_packed_read():
    x = torch.tensor([1.5 - 2.0j, 3.0j], dtype=torch.complex64)
    y = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    z = torch.tensor(7.0, dtype=torch.float32)
    vx, vy, vz = fetch_many([x, y, z], torch.float32)
    assert vx.dtype == np.complex64 and vx.shape == (2,)
    assert np.array_equal(vx, x.numpy())
    assert np.array_equal(vy, y.numpy()) and vz.shape == () and vz == 7.0


# ------------------------------------------------ the LVC exciton model
prim_info = [HarmonicOscillator(8, f, units="cm-1")
             for f in (1000, 2000, 3000)] + [Exciton(nstate=2,
                                                     names=["S0", "S1"])]


def _lvc_hamiltonian():
    """The MPO of ``tests/test_exciton_propagate.py:_build_hamiltonian``,
    built by that function's own code from the port's basis and operator
    classes."""
    from tests import test_exciton_propagate as jt

    build = jt._build_hamiltonian
    scope = dict(build.__globals__, prim_info=prim_info,
                 TensorOperator=TensorOperator,
                 TensorHamiltonian=TensorHamiltonian)
    return types.FunctionType(build.__code__, scope)()


def _lvc_model(model_cls, prim, hamiltonian):
    model = model_cls(prim, {"hamiltonian": hamiltonian}, bond_dim=2)
    model.init_HartreeProduct = [
        [ho.get_unitary()[0].tolist() for ho in prim[:3]]
        + [np.array([0.0, 1.0]).tolist()]
    ]
    return model


def _lvc_port(jobname, stride, **kw):
    sim = Simulator(jobname, _lvc_model(Model, prim_info, _lvc_hamiltonian()),
                    device="cpu", verbose=0)
    energy, wf = sim.propagate(stepsize=0.1, maxstep=LVC_STEPS,
                               fetch_stride=stride, **kw)
    return energy, wf


def _rows(path) -> np.ndarray:
    """A .dat export as numbers; complex columns become two columns."""
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            vals = []
            for tok in line.split():
                c = complex(tok)
                vals.append(c.real)
                if "j" in tok:
                    vals.append(c.imag)
            rows.append(vals)
    return np.asarray(rows)


def _texts(jobname) -> dict[str, str]:
    return {name: open(os.path.join(f"{jobname}_prop", f"{name}.dat")).read()
            for name in ("autocorr", "populations")}


@pytest.fixture(scope="module")
def lvc_dir(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("lvc"))
    try:
        yield os.getcwd()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def lvc_stride1(lvc_dir):
    os.chdir(lvc_dir)
    energy, _ = _lvc_port("p1", 1)
    return energy, _texts("p1")


@pytest.fixture(scope="module")
def jax_lvc(lvc_dir):
    """The JAX Simulator at stride 4 (its fused block driver), MGS gauge."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.model import Model as JModel
    from pytdscf_tpu.simulator import Simulator as JSimulator
    from tests.test_exciton_propagate import _build_hamiltonian
    from tests.test_exciton_propagate import prim_info as jprim

    os.chdir(lvc_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JK, "_PALLAS_QR_FORCE", True)
        mp.setattr(JK, "_PALLAS_QR_OFF", True)
        mp.setenv("PYTDSCF_NO_COMPILE_CACHE", "1")
        jax.clear_caches()
        try:
            energy, _ = JSimulator(
                "jx4", _lvc_model(JModel, jprim, _build_hamiltonian()),
                backend="numpy", verbose=0,
            ).propagate(stepsize=0.1, maxstep=LVC_STEPS, fetch_stride=4)
        finally:
            jax.clear_caches()
    return energy, {name: _rows(os.path.join("jx4_prop", f"{name}.dat"))
                    for name in ("autocorr", "populations")}


@pytest.mark.parametrize("stride", [3, 4])
def test_lvc_strides_match_per_step(lvc_dir, lvc_stride1, stride):
    os.chdir(lvc_dir)
    energy, wf = _lvc_port(f"p{stride}", stride)
    e1, texts = lvc_stride1
    assert _texts(f"p{stride}") == texts
    assert len(texts["autocorr"].splitlines()) == 1 + LVC_STEPS
    assert abs(energy - e1) < 1e-12
    # the blocks ran the step program; the last partial block of one step
    # (stride 3: 3+3+3+2; stride 4: 4+4+3) ran none
    assert wf.engine.eager_steps == LVC_STEPS and wf.engine._programs


def test_lvc_rows_match_jax(lvc_dir, lvc_stride1, jax_lvc):
    os.chdir(lvc_dir)
    energy, _ = _lvc_port("q4", 4)
    j_energy, j_rows = jax_lvc
    assert abs(energy - j_energy) < 1e-10
    for name, want in j_rows.items():
        got = _rows(os.path.join("q4_prop", f"{name}.dat"))
        assert got.shape == want.shape == (LVC_STEPS, want.shape[1])
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0,
                                   err_msg=name)


def test_lvc_energy_literal(lvc_stride1):
    assert abs(lvc_stride1[0] - LVC_ENERGY) <= 5e-7


def test_blocks_never_span_a_backup_step(lvc_dir, lvc_stride1, monkeypatch):
    """backup_interval=5, stride 4: blocks of steps 0-3 and 5-8; steps 4,
    9 (each checkpointed before it) and 10 run inline."""
    os.chdir(lvc_dir)
    blocks = []
    run = Properties.run_fused_block

    def spy(self, dt_au, nsteps, **kw):
        blocks.append((self.nstep, nsteps))
        return run(self, dt_au, nsteps, **kw)

    monkeypatch.setattr(Properties, "run_fused_block", spy)
    energy, _ = _lvc_port("b4", 4, backup_interval=5)
    assert blocks == [(0, 4), (5, 4)]
    assert _texts("b4") == lvc_stride1[1]
    assert abs(energy - lvc_stride1[0]) < 1e-12


# ------------------------------------------------ the capture decision
def _past_fits(monkeypatch):
    # a working set below every site's: no Lanczos call takes the kernel
    monkeypatch.setattr(CL, "MAX_BYTES", 1024)
    return {}


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"fused_site": True}, True),
    ({"integrator": "arnoldi"}, True),
    ({"integrator": "arnoldi", "krylov_relaxed": True}, True),
    ({"krylov_relaxed": True}, True),
    ({"matvec_precision": "high"}, True),
    ({"env_precision": "high"}, True),
    (_past_fits, True),
    ({"max_krylov": 65}, False),
])
def test_capturable(monkeypatch, change, want):
    engine = _chain()
    if callable(change):
        change = change(monkeypatch)
    # set after construction: the engine refuses some of these outright
    engine.config = engine.config.replace(**change)
    assert engine.capturable() is want


def _radical_pair(preset="balanced"):
    from pytdscf_torch.models.radical_pair import (
        radical_pair_liouvillian,
        singlet_product_state,
    )
    from pytdscf_torch.mps.lattice import bond_dims_for_site

    hfc = [0.15, 0.22]
    basis, mpo, ele = radical_pair_liouvillian(
        hfcs_1=[(2, a) for a in hfc], hfcs_2=[(2, a) for a in hfc],
        split_electron=True)
    phys = [b.nstate for b in basis]
    vecs = singlet_product_state(basis, ele, split_electron=True)
    cores = alloc_hartree_product(phys, 4, vecs, space="liouville")
    rng = np.random.default_rng(42)
    full = []
    for p, c in enumerate(cores):
        m_l, m_r = bond_dims_for_site(phys, p, 16)
        x = np.zeros((m_l, phys[p], m_r), dtype=np.complex128)
        x[: c.shape[0], :, : c.shape[2]] = c
        x += 1e-4 * max(np.abs(c).max(), 1e-30) * (
            rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
        full.append(x)
    model = Model(basis, {"hamiltonian": mpo}, space="liouville",
                  bond_dim=16)
    config = Config(integrator="arnoldi", max_krylov=7, thresh_exp=1e-6,
                    conserve_norm=False, space="liouville")
    engine = TDVPEngine([full], model.hamiltonian,
                        config.with_precision_preset(preset), "cpu")
    engine.right_canonicalize()
    return engine


def test_radical_pair_steps_bit_for_bit():
    """The Arnoldi radical pair ("balanced": relaxed Krylov) runs the step
    program (its Krylov control on the device; uncaptured on the CPU): bit
    for bit with ``propagate``, with its trace as the norm."""
    ref, blk = _radical_pair(), _radical_pair()
    assert blk.capturable()
    for _ in range(2):
        ref.propagate(0.5)
    items, plan = blk.propagate_steps_collect(0.5, 2)
    assert all(torch.equal(a, b) for a, b in zip(ref.cores[0], blk.cores[0]))
    assert ref.krylov_stats() == blk.krylov_stats()
    assert (blk.eager_steps, blk.graph_steps, len(blk._programs)) == (2, 0, 1)
    vals = fetch_many(items, blk.fetch_real_dtype())
    assert dict(plan)["trace"] == 1
    first = blk.properties_resolve([v[0] for v in vals], plan)
    start = _radical_pair()
    assert abs(first["norm"] - abs(start.trace())) < 1e-12


@pytest.mark.parametrize("preset", ["throughput", "exact"])
def test_radical_pair_program_bit_for_bit(preset):
    """The radical pair's blocks at "throughput" (bf16x3 prefix and
    transfers, relaxed tail) and "exact" (float32 Arnoldi) run the step
    program on the CPU: 1 + 2 steps bit for bit with ``propagate``, the
    same Krylov telemetry, the relaxed matvecs counted on the device."""
    ref, blk = _radical_pair(preset), _radical_pair(preset)
    for _ in range(3):
        ref.propagate(0.5)
    blk.propagate_steps(0.5, 1)
    blk.propagate_steps(0.5, 2)
    assert all(torch.equal(a, b) for a, b in zip(ref.cores[0], blk.cores[0]))
    stats = ref.krylov_stats()
    assert stats == blk.krylov_stats()
    assert (stats[3] > 0) == (preset == "throughput")
    assert (blk.eager_steps, blk.graph_steps) == (3, 0)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph replays CUDA kernels")
    return torch.device("cuda")


def _launches() -> tuple:
    return (CL.lanczos_expm.launches, dict(CL.lanczos_expm.route_launches),
            dict(CL.lanczos_expm.cluster_launches), CQ.mgs_qr.launches,
            dict(CQ.mgs_qr.route_launches), CS.site_step_fused.launches,
            dict(CS.site_step_fused.route_launches))


def _delta(after: tuple, before: tuple) -> tuple:
    return tuple(
        {k: v - b.get(k, 0) for k, v in a.items()} if isinstance(a, dict)
        else a - b for a, b in zip(after, before))


def _rel_gap(a, b) -> float:
    return _gap(a, b) / float(np.linalg.norm(_dense(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_site", [False, True])
def test_graph_replay_matches_eager_on_card(cuda, fused_site):
    k = 5
    ref = _chain(cuda, "complex64", fused_site=fused_site)
    blk = _chain(cuda, "complex64", fused_site=fused_site)
    assert blk.capturable()
    before = _launches()
    for _ in range(k):
        ref.propagate(DT)
    eager = _delta(_launches(), before)
    before = _launches()
    items, plan = blk.propagate_steps_collect(DT, k)
    torch.cuda.synchronize()
    graph = _delta(_launches(), before)
    assert graph == eager
    assert (blk.eager_steps, blk.graph_steps) == (1, k - 1)
    assert ref.krylov_stats() == blk.krylov_stats()
    assert _rel_gap(blk, ref) < 1e-6
    assert all(torch.equal(a, b) for a, b in zip(ref.cores[0], blk.cores[0]))
    vals = fetch_many(items, blk.fetch_real_dtype())
    last = blk.properties_resolve([v[k - 1] for v in vals], plan)
    assert abs(last["norm"] - 1.0) < 1e-5


@pytest.mark.cuda
def test_new_dt_captures_a_new_graph(cuda):
    ref = _chain(cuda, "complex64")
    blk = _chain(cuda, "complex64")
    for _ in range(3):
        ref.propagate(DT)
    for _ in range(3):
        ref.propagate(0.5 * DT)
    blk.propagate_steps(DT, 3)
    first = dict(blk._programs)
    blk.propagate_steps(0.5 * DT, 3)
    assert len(blk._programs) == 2
    (old,) = first.values()
    (new,) = (p for p in blk._programs.values() if p is not old)
    assert new.graph is not None and new.graph is not old.graph
    # the new dt ran one host step, then replays of ITS graph: a replay of
    # the old graph would have stepped by DT
    assert (blk.eager_steps, blk.graph_steps) == (2, 4)
    assert _rel_gap(blk, ref) < 1e-6


@pytest.mark.cuda
def test_host_read_in_a_step_raises_at_capture(cuda, monkeypatch):
    """A step that reads the device inside the graph fails its capture;
    the block does not go on eagerly."""
    real = CL.lanczos_expm

    @functools.wraps(real)  # with its counters, which the wrapper updates
    def reads_back(*args, **kwargs):
        out, status = real(*args, **kwargs)
        int(status[0].item())
        return out, status

    monkeypatch.setattr(CL, "lanczos_expm", reads_back)
    engine = _chain(cuda, "complex64")
    assert engine.capturable()
    with pytest.raises(RuntimeError):
        engine.propagate_steps(DT, 3)
    assert (engine.eager_steps, engine.graph_steps) == (1, 0)
    assert not engine._programs
