#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytdscf_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and check that TF32 is off for matmuls and cuDNN;
2. build the kernels from ``pytdscf_torch/csrc`` with nvcc;
3. the 184-site singlet-fission chain at D=30 (``bench.py``'s main path),
   complex64, thresh_exp 1e-6, max_krylov 10, dt 0.2 fs:
   a. each kernel of the path against its plain PyTorch version on the
      chain's operands after one step: the Lanczos exponential (H step at
      a bulk and at the exciton site, K step at a bulk bond: same k_used,
      ‖Δψ‖ < 5e-6) and the MGS QR at (240, 30), full rank and rank
      deficient (orthogonality, reconstruction, agreement);
   b. five counted steps through ``TDVPEngine.propagate``: ⟨H⟩ within 5e-6
      of 0.0182253410, norm within 1e-5 of 1, and exactly 734 Lanczos and
      366 QR kernel launches per step;
   c. one more step under ``torch.profiler`` (lines ``profile:``);
4. the χ=1024 radical-pair Liouville MPDO (``bench_chi.py``'s defaults at
   the "balanced" precision rung: Arnoldi, relaxed Krylov from iteration
   1 through the bf16 matvec kernels):
   a. build, ``right_canonicalize`` on the card, and each matvec kernel
      against its plain version on the chain's operands (bulk and edge
      sites; relative error < 1e-4, which the plain output rounded to bf16
      must fail; a second launch bit-identical; kernel and plain times at
      the bulk); the MGS QR against its plain version on the chain's own
      gauge operands at every shape it takes there, (1024, 64) down to
      (4, 4);
   b. one warm-up and ten timed steps, counted: bench_chi.py's invariants,
      the electron populations within 6e-5 of its gold entry
      (``bench_expected.json``), heff_lo + keff_lo launches equal to the
      relaxed matvecs ``krylov_stats`` counts, no plain-version call;
   c. one more step under ``torch.profiler``.

The second-to-last line of stdout is a JSON object with each kernel's
launches, error and times; the last line is the result
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

E_REF = 0.0182253410  # ⟨H⟩ of the chain (bench.py); energy is conserved
E_TOL = 5.0e-06  # complex64 tolerance of bench.py
NORM_TOL = 1.0e-05
LANCZOS_TOL = 5.0e-06  # ‖Δψ‖, tests/test_pallas_lanczos.py
BOND = 30
DT_FS = 0.2
TIMED_STEPS = 5
BULK_SITE = 30
EXCITON_SITE = 61  # n_left of singlet_fission_chain()
# bench_chi.py's defaults (its lines 100-189) and its gold populations
CHI = 1024
RP_NUC = 8  # nuclei per radical: 18 sites with the split electron layout
RP_KRYLOV = 7
RP_THRESH = 1.0e-06
RP_DT = 0.5
RP_STEPS = 10  # timed steps after one warm-up step, as in bench_chi.py
RP_KEY = "chi1024_nuc8_split1_lt2_dt1_steps10_complex64"
RP_BULK_SITE = 8  # a (1024, 4, 1024) site
# relaxed matvec kernel vs its plain version, relative to the output norm:
# the same bf16 rounding points, float32 sums in another order.  On the
# chain's operands the kernel reads 1.6e-7 to 5e-7 and one bf16 rounding
# more (the output rounded to bf16) 1.4e-3 to 1.7e-3, so the bar sits
# between (random operands read more: tests/test_torch_matvec.py)
MATVEC_TOL = 1.0e-04


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    two warm-up runs (CUDA events around the whole batch)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    import torch

    import pytdscf_torch  # noqa: F401  (the package turns TF32 off)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    log(f"allow_tf32: matmul {tf32[0]}, cudnn {tf32[1]}")
    require(tf32 == (False, False), "TF32 must be off for the port")


def phase_build():
    from pytdscf_torch import _cuda

    path, ptxas, seconds = _cuda.build()
    log(f"build: {path.name} in {seconds:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    _cuda.load()


def build_engine(device):
    from pytdscf_torch.config import Config
    from pytdscf_torch.models.holstein import singlet_fission_chain
    from pytdscf_torch.mps.lattice import alloc_hartree_product
    from pytdscf_torch.mps.tdvp import TDVPEngine

    basis, ham = singlet_fission_chain()
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == EXCITON_SITE else 0] = 1.0
        vecs.append(v)
    cores = [alloc_hartree_product(phys, BOND, vecs)]
    config = Config(thresh_exp=1.0e-06, max_krylov=10, dtype="complex64")
    return TDVPEngine(cores, ham, config, device)


def site_operands(engine, p: int):
    """(L, lL), W, (R, lR) and the left block past site p, from the
    engine's current cores."""
    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    return left[p], engine.W[p], right[engine.nsite - 1 - p], left[p + 1]


def check_lanczos(engine, dt_au, results):
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import kernels as K

    cfg = engine.config
    checks = []
    for p in (BULK_SITE, EXCITON_SITE):
        (L, lL), W, (R, lR), (L1, lL1) = site_operands(engine, p)
        psi = engine.cores[0][p]
        l, d, r = psi.shape
        ch = CL.heff_channels(L, W, R, torch.exp(lL + lR))
        checks.append((f"H step, site {p}", ch, psi.reshape(l * d, r).contiguous(),
                       -0.5j * dt_au))
        if p == BULK_SITE:
            _, sig = K.qr_right(psi)
            kch = CL.keff_channels(L1, R, torch.exp(lL1 + lR))
            checks.append((f"K step, bond {p}", kch, sig.contiguous(),
                           0.5j * dt_au))
    worst = 0.0
    for name, ch, v, scale in checks:
        args = (v, scale, cfg.thresh_exp, cfg.max_krylov, cfg.conserve_norm)
        out_k, st_k = CL.lanczos_expm(ch, *args)
        kmax = min(cfg.max_krylov, v.numel())
        out_p, st_p = CL.lanczos_expm_plain(*ch, v, scale, cfg.thresh_exp,
                                            kmax, cfg.conserve_norm)
        torch.cuda.synchronize()
        st_k, st_p = st_k.tolist(), st_p.tolist()
        dpsi = float(torch.linalg.vector_norm(out_k - out_p))
        err = float(torch.max(torch.abs(out_k - out_p)))
        require(bool(torch.isfinite(out_k).all()), f"lanczos {name}: not finite")
        require(st_k == st_p, f"lanczos {name}: kernel status {st_k} "
                f"vs plain {st_p}")
        require(dpsi < LANCZOS_TOL, f"lanczos {name}: ‖Δψ‖ {dpsi:.3e}")
        ms = cuda_ms(lambda: CL.lanczos_expm(ch, *args), 50)
        plain_ms = cuda_ms(lambda: CL.lanczos_expm_plain(
            *ch, v, scale, cfg.thresh_exp, kmax, cfg.conserve_norm), 5)
        log(f"lanczos {name}: M={v.shape[0]} r={v.shape[1]} "
            f"nc={ch[0].shape[0]} k_used={st_k[0]} ‖Δψ‖={dpsi:.3e} "
            f"max|Δ|={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        worst = max(worst, err)
        results.setdefault("lanczos_expm", (ms, plain_ms))
    return worst


def check_mgs(name: str, m, timed: bool = False):
    """The MGS kernel against its plain version on the card, on one
    complex64 (N, r) matrix, with the _check criteria of
    tests/test_pallas_qr.py: (max |Δ| of Q and R, R, kernel ms, plain ms);
    the times are None unless ``timed``."""
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    q, rm = CQ.mgs_qr(m)
    q_p, r_p = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    n, r = m.shape
    eye = torch.eye(r, dtype=m.dtype, device=m.device)
    mnorm = float(torch.linalg.vector_norm(m))
    orth = float(torch.linalg.matrix_norm(eye - q.conj().T @ q))
    rec = float(torch.linalg.matrix_norm(q @ rm - m))
    dq = float(torch.linalg.matrix_norm(q - q_p))
    dr = float(torch.linalg.matrix_norm(rm - r_p))
    require(orth < 1e-5 * r, f"mgs_qr {name}: orthogonality {orth:.3e}")
    require(rec < 1e-5 * mnorm + 1e-7, f"mgs_qr {name}: Q·R−m {rec:.3e}")
    require(dq < 5e-6 * math.sqrt(n * r), f"mgs_qr {name}: ‖ΔQ‖ {dq:.3e}")
    require(dr < 5e-6 * r * mnorm + 1e-6, f"mgs_qr {name}: ‖ΔR‖ {dr:.3e}")
    err = max(float(torch.max(torch.abs(q - q_p))),
              float(torch.max(torch.abs(rm - r_p))))
    line = (f"mgs_qr {name} ({n}, {r}): orth {orth:.3e} rec {rec:.3e} "
            f"‖ΔQ‖ {dq:.3e} ‖ΔR‖ {dr:.3e} max|Δ| {err:.3e}")
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: CQ.mgs_qr(m), 200)
        plain_ms = cuda_ms(lambda: CQ.mgs_qr_plain(m), 10)
        line += f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    log(line)
    return err, rm, ms, plain_ms


def check_qr(results):
    import torch

    rng = np.random.default_rng(0)
    a = rng.standard_normal((240, 30)) + 1j * rng.standard_normal((240, 30))
    full = a / np.linalg.norm(a)
    deficient = full.copy()
    deficient[:, [3, 7, 29]] = 0.0
    worst = 0.0
    for name, m_np in (("full rank", full), ("rank deficient", deficient)):
        m = torch.as_tensor(m_np, dtype=torch.complex64, device="cuda")
        err, rm, ms, plain_ms = check_mgs(name, m, timed=True)
        if name == "rank deficient":
            for k in (3, 7, 29):
                require(abs(complex(rm[k, k])) < 1e-6,
                        f"mgs_qr: dead column {k} has a nonzero R diagonal")
        worst = max(worst, err)
        results.setdefault("mgs_qr", (ms, plain_ms))
    return worst


def profile_step(engine, dt_au) -> None:
    """One TDVP step under ``torch.profiler``: its wall time, the summed
    device time of every kernel (busy share of the wall time), each kernel
    of the port, and the torch ops that launch kernels most often."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.propagate(dt_au)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    require(busy_ms > 0.0, "profile: no device time was traced")
    log(f"profile: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f} % of the wall time)")
    for e in on_device[:8]:
        ms = e.self_device_time_total / 1e3
        log(f"profile: device {ms:9.2f} ms {e.count:6d}x "
            f"{100 * ms / wall_ms:5.1f} %  {e.key[:70]}")
    ops = sorted((e for e in events if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda e: -e.count)
    for e in ops[:5]:
        log(f"profile: op {e.key} {e.count}x, device "
            f"{e.self_device_time_total / 1e3:.2f} ms")


def reset_counts() -> None:
    """Zero every kernel wrapper's launch and plain-call counts."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ

    for fn in (CL.lanczos_expm, CQ.mgs_qr, CM.heff_lo, CM.keff_lo):
        fn.launches = 0
        fn.plain_calls = 0


def phase_chain(times) -> dict:
    """The 184-site singlet-fission chain (PR 1's main path)."""
    import torch

    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ

    dt_au = DT_FS / units.au_in_fs
    t0 = time.perf_counter()
    engine = build_engine("cuda")
    log(f"engine: {engine.nsite} sites, D={BOND}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.propagate(dt_au)
    torch.cuda.synchronize()
    log(f"warm-up step: {time.perf_counter() - t0:.3f} s")

    err_lz = check_lanczos(engine, dt_au, times)
    err_qr = check_qr(times)

    # ---- the main path, counted
    engine.krylov_stats()
    reset_counts()
    torch.cuda.synchronize()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        engine.propagate(dt_au)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    n_lz, n_qr = CL.lanczos_expm.launches, CQ.mgs_qr.launches
    avg_k, calls, capped, _ = engine.krylov_stats()
    energy = engine.expectation().real
    norm = engine.norm()
    finite = all(bool(torch.isfinite(c).all()) for c in engine.cores[0])
    log(f"main path: s/step {[round(s, 4) for s in step_s]} "
        f"(median {float(np.median(step_s)):.4f}); energy {energy:.10f} "
        f"(|Δ| {abs(energy - E_REF):.2e}); norm {norm:.8f}; "
        f"avg Krylov {avg_k:.3f} over {calls} calls, cap hits {capped}; "
        f"launches: lanczos {n_lz}, qr {n_qr}")
    require(finite, "main path: cores not finite")
    require(abs(energy - E_REF) <= E_TOL,
            f"energy {energy:.10f} vs {E_REF} (tol {E_TOL})")
    require(abs(norm - 1.0) <= NORM_TOL, f"norm {norm:.8f}")
    per_step = 2 * (2 * engine.nsite - 1)
    require(n_lz == TIMED_STEPS * per_step,
            f"lanczos launches {n_lz} != {TIMED_STEPS} × {per_step}")
    require(n_qr == TIMED_STEPS * 2 * (engine.nsite - 1),
            f"qr launches {n_qr} != {TIMED_STEPS} × {2 * (engine.nsite - 1)}")
    require(CL.lanczos_expm.plain_calls == CQ.mgs_qr.plain_calls == 0,
            "main path: a plain version ran on the card")
    profile_step(engine, dt_au)
    return {"lanczos_expm": (n_lz, err_lz), "mgs_qr": (n_qr, err_qr)}


# ------------------------------------------------- χ=1024 radical pair
def build_rp_engine(device):
    """bench_chi.py's defaults (its lines 100-189) on the port, at the
    "balanced" precision rung: the 8+8-nucleus split-electron radical-pair
    Liouvillian, χ=1024, the singlet product state plus ε=1e-4 noise from
    ``default_rng(42)``, Arnoldi with relaxed Krylov from iteration 1."""
    from pytdscf_torch.config import Config
    from pytdscf_torch.model import Model
    from pytdscf_torch.models.radical_pair import (
        radical_pair_liouvillian,
        singlet_product_state,
    )
    from pytdscf_torch.mps.lattice import (
        alloc_hartree_product,
        bond_dims_for_site,
    )
    from pytdscf_torch.mps.tdvp import TDVPEngine

    hfc = [round(0.15 + 0.07 * k, 4) for k in range(RP_NUC)]
    basis, mpo, ele = radical_pair_liouvillian(
        hfcs_1=[(2, a) for a in hfc], hfcs_2=[(2, a) for a in hfc],
        split_electron=True,
    )
    model = Model(basis, {"hamiltonian": mpo}, space="liouville",
                  bond_dim=CHI)
    phys = [b.nstate for b in basis]
    vecs = singlet_product_state(basis, ele, split_electron=True)
    cores = alloc_hartree_product(phys, 4, vecs, space="liouville")
    rng = np.random.default_rng(42)
    noisy = []
    for p, c in enumerate(cores):
        m_l, m_r = bond_dims_for_site(phys, p, CHI)
        full = np.zeros((m_l, phys[p], m_r), dtype=np.complex128)
        full[: c.shape[0], :, : c.shape[2]] = c
        scale = 1.0e-04 * max(np.abs(c).max(), 1e-30)
        full += scale * (rng.normal(size=full.shape)
                         + 1j * rng.normal(size=full.shape))
        noisy.append(full)
    config = Config(
        space="liouville", integrator="arnoldi", thresh_exp=RP_THRESH,
        max_krylov=RP_KRYLOV, dtype="complex64", conserve_norm=False,
    ).with_precision_preset("balanced")
    return TDVPEngine([noisy], model.hamiltonian, config, device), ele


def mgs_moves(engine) -> list[tuple[int, str, tuple[int, int]]]:
    """Gauge moves of one step that take the MGS kernel, as (site, "QR" or
    "LQ", operand shape); the others are CholeskyQR³ (r >=
    CHOLESKY_QR_MIN_R and N >= r)."""
    from pytdscf_torch.mps.kernels import CHOLESKY_QR_MIN_R

    moves = []
    for p in range(engine.nsite):
        l, d, r = engine.cores[0][p].shape
        if p < engine.nsite - 1:
            moves.append((p, "QR", (l * d, r)))  # forward half-sweep
        if p > 0:
            moves.append((p, "LQ", (r * d, l)))  # backward half-sweep
    return [(p, kind, (n, k)) for p, kind, (n, k) in moves
            if not (k >= CHOLESKY_QR_MIN_R and n >= k)]


def check_qr_gauge(engine) -> float:
    """The MGS kernel against its plain version on the radical pair's own
    gauge operands after ``right_canonicalize``, at every shape the kernel
    takes on this chain: the backward half-sweep's LQ operand (r·d, l) of
    the first site of each shape (a right-orthogonal core: orthonormal
    columns), and the forward QR operand (l·d, r) of a right-orthogonal
    site at the largest shape, whose Q sits in device memory (timed)."""
    moves = mgs_moves(engine)
    big = max((shape for _, _, shape in moves), key=lambda s: s[0] * s[1])
    picks: dict[tuple[str, tuple[int, int]], int] = {}
    for p, kind, shape in moves:
        if kind == "LQ" or (p > 0 and shape == big):
            picks.setdefault((kind, shape), p)
    worst = 0.0
    for (kind, shape), p in sorted(picks.items(), key=lambda kv: kv[0][1]):
        psi = engine.cores[0][p]
        l, d, r = psi.shape
        m = (psi.reshape(l * d, r) if kind == "QR"
             else psi.permute(2, 1, 0).reshape(r * d, l)).contiguous()
        err, _, _, _ = check_mgs(f"{kind} operand of site {p}", m,
                                 timed=shape == big and kind == "QR")
        worst = max(worst, err)
    return worst


def check_matvec(engine, results) -> dict:
    """Each relaxed matvec kernel against its plain version on the card,
    on the chain's own operands: the bulk site (timed) and two edge sites
    (ragged tiles)."""
    import torch

    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import kernels as K

    left = engine.build_left_env_stack()
    right = engine.build_right_env_stack()
    cases = []
    for p in (RP_BULK_SITE, 3, 0):
        (L, _), (R, _) = left[p], right[engine.nsite - 1 - p]
        psi = engine.cores[0][p].contiguous()
        cases.append(("heff_lo", p, CM.heff_operands(L, engine.W[p], R), psi))
        _, sig = K.qr_right(psi)
        cases.append(("keff_lo", p, CM.keff_operands(left[p + 1][0], R),
                      sig.contiguous()))
    del left, right
    worst: dict[str, float] = {}
    for name, p, ops, v in cases:
        kernel = getattr(CM, name)
        plain = K.heff_apply_lo if name == "heff_lo" else K.keff_apply_lo
        planes = [t.unbind(-1) for t in ops]
        got = kernel(ops, v)
        again = kernel(ops, v)
        want = plain(*planes, v)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"{name} site {p}: not finite")
        require(torch.equal(got, again), f"{name} site {p}: a second launch "
                "gave another result")
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        err = float(torch.max(torch.abs(got - want)))
        require(rel < MATVEC_TOL, f"{name} site {p}: rel {rel:.3e} vs plain")
        line = (f"{name} site {p}: v {tuple(v.shape)} out {tuple(got.shape)} "
                f"rel {rel:.3e} max|Δ| {err:.3e}")
        if p == RP_BULK_SITE:
            # the bar catches one bf16 rounding more: the plain output
            # rounded to bf16 must fail it
            coarse = torch.complex(want.real.to(torch.bfloat16).float(),
                                   want.imag.to(torch.bfloat16).float())
            rel_coarse = float(torch.linalg.vector_norm(coarse - want)
                               / torch.linalg.vector_norm(want))
            require(rel_coarse > MATVEC_TOL, f"{name}: the bf16-rounded "
                    f"output reads {rel_coarse:.3e}, inside the bar")
            line += f" (bf16-rounded output: rel {rel_coarse:.3e})"
            ms = cuda_ms(lambda: kernel(ops, v), 20)
            plain_ms = cuda_ms(lambda: plain(*planes, v), 5)
            results[name] = (ms, plain_ms)
            line += f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def phase_radical_pair(times) -> dict:
    """The χ=1024 radical-pair Liouville MPDO of bench_chi.py: 1 warm-up
    and 10 timed steps, then bench_chi.py's invariants and its gold
    populations."""
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ

    t0 = time.perf_counter()
    engine, ele = build_rp_engine("cuda")
    log(f"radical pair: {engine.nsite} sites, χ={CHI}, MPO widths "
        f"{sorted({int(w.shape[0]) for w in engine.W[1:]})}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.right_canonicalize()
    tr0 = engine.trace()
    log(f"radical pair: right_canonicalize + trace {tr0.real:.6f}"
        f"{tr0.imag:+.2e}j in {time.perf_counter() - t0:.2f} s")
    err = check_matvec(engine, times)
    err_qr = check_qr_gauge(engine)

    # ---- the main path, counted: 1 warm-up + RP_STEPS timed steps
    engine.krylov_stats()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.propagate(RP_DT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step_s = []
    for _ in range(RP_STEPS):
        t0 = time.perf_counter()
        engine.propagate(RP_DT)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    n_h, n_k = CM.heff_lo.launches, CM.keff_lo.launches
    n_qr, n_lz = CQ.mgs_qr.launches, CL.lanczos_expm.launches
    plain = (CM.heff_lo.plain_calls + CM.keff_lo.plain_calls
             + CQ.mgs_qr.plain_calls)
    avg_k, calls, capped, relaxed = engine.krylov_stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr = engine.trace()
    rdm = engine.reduced_density_liouville((0,) * ele + (2, 2))
    pops = np.real(np.einsum("aabb->ab", rdm)).reshape(-1)
    median = float(np.median(step_s))
    tflops = engine.flops_estimate(max(avg_k, 1.0)) / median / 1e12
    with open(Path(__file__).resolve().parent / "bench_expected.json") as fh:
        gold = json.load(fh)[RP_KEY]
    drift = float(np.max(np.abs(pops - np.asarray(gold["pops"]))))
    log(f"radical pair: warm-up {warm_s:.3f} s; s/step "
        f"{[round(s, 4) for s in step_s]} (median {median:.4f}); "
        f"~{tflops:.1f} algorithmic TFLOP/s; avg Krylov {avg_k:.3f} over "
        f"{calls} calls, cap hits {capped}; relaxed matvecs {relaxed}; "
        f"launches: heff_lo {n_h}, keff_lo {n_k}, qr {n_qr}, lanczos {n_lz}; "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"radical pair: trace {tr.real:.6f}{tr.imag:+.2e}j; populations "
        f"{np.round(pops, 6).tolist()}; drift from gold [{RP_KEY}] "
        f"{drift:.2e} (tol {gold['tol']:g})")
    # bench_chi.py's invariants and its blessed-population check
    require(np.isfinite(tr.real) and bool(np.all(np.isfinite(pops))),
            f"non-finite trace/populations: {tr}, {pops}")
    require(0.90 <= tr.real <= 1.0001, f"trace {tr.real:.6f} outside "
            "the Haberkorn-decay window [0.90, 1.0001]")
    require(abs(tr.imag) <= 1e-3, f"trace imaginary part {tr.imag:.2e}")
    require(bool(np.all(pops >= -1e-4)), f"negative population {pops}")
    require(abs(float(np.sum(pops)) - tr.real) <= 2e-3,
            f"Σpops {float(np.sum(pops)):.6f} != trace {tr.real:.6f}")
    require(drift <= float(gold["tol"]),
            f"populations drift {drift:.2e} > {gold['tol']} from gold")
    # every relaxed matvec went through a kernel, nothing through a plain one
    require(relaxed > 0, "no relaxed matvec ran")
    require(n_h + n_k == relaxed,
            f"heff_lo + keff_lo launches {n_h} + {n_k} != {relaxed} "
            "relaxed matvecs")
    require(n_h > 0 and n_k > 0, "a matvec kernel was never launched")
    require(plain == 0, f"{plain} plain-version calls on the card")
    require(n_lz == 0, "the Lanczos kernel ran on the Arnoldi path")
    steps, per_step = 1 + RP_STEPS, len(mgs_moves(engine))
    require(n_qr == steps * per_step,
            f"qr launches {n_qr} != {steps} × {per_step}")
    profile_step(engine, RP_DT)
    return {"heff_lo": (n_h, err["heff_lo"]), "keff_lo": (n_k, err["keff_lo"]),
            "mgs_qr": (n_qr, err_qr)}


KERNELS = [
    ("lanczos_expm", "pytdscf_torch/csrc/lanczos_expm.cu",
     "pytdscf_tpu/mps/pallas_lanczos.py:296"),
    ("mgs_qr", "pytdscf_torch/csrc/mgs_qr.cu",
     "pytdscf_tpu/mps/pallas_qr.py:153"),
    ("heff_lo", "pytdscf_torch/csrc/matvec_lo.cu",
     "pytdscf_tpu/mps/pallas_matvec.py:175"),
    ("keff_lo", "pytdscf_torch/csrc/matvec_lo.cu",
     "pytdscf_tpu/mps/pallas_matvec.py:244"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    phase_device()
    phase_build()

    times: dict[str, tuple[float, float]] = {}
    chain = phase_chain(times)
    torch.cuda.empty_cache()
    rp = phase_radical_pair(times)

    kernels = []
    for name, source, replaces in KERNELS:
        # launches: summed over the main paths that run the kernel
        runs = [path[name] for path in (chain, rp) if name in path]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n for n, _ in runs),
            "max_abs_err": max(e for _, e in runs),
            "ms": times[name][0], "plain_ms": times[name][1],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
