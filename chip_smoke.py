#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytdscf_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and check that TF32 is off for matmuls and cuDNN;
2. build the kernels from ``pytdscf_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes and on the operands of the real 184-site chain after one step:
   the Lanczos exponential (H step at a bulk and at the exciton site, K
   step at a bulk bond: same k_used, ‖Δψ‖ < 5e-6) and the MGS QR at
   (240, 30), full rank and rank deficient (orthogonality, reconstruction
   and agreement with the plain version);
4. the main path: the 184-site singlet-fission chain at D=30, complex64,
   thresh_exp 1e-6, max_krylov 10, dt 0.2 fs, through
   ``TDVPEngine.propagate``: ⟨H⟩ within 5e-6 of 0.0182253410, norm within
   1e-5 of 1, and exactly 734 Lanczos and 366 QR kernel launches per step;
5. one more step under ``torch.profiler``: its wall time, the device time
   of each kernel and in all (the device's busy share), and the torch ops
   that launch kernels most often (lines starting ``profile:``).

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


def check_qr(results):
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    rng = np.random.default_rng(0)
    a = rng.standard_normal((240, 30)) + 1j * rng.standard_normal((240, 30))
    full = a / np.linalg.norm(a)
    deficient = full.copy()
    deficient[:, [3, 7, 29]] = 0.0
    worst = 0.0
    for name, m_np in (("full rank", full), ("rank deficient", deficient)):
        m = torch.as_tensor(m_np, dtype=torch.complex64, device="cuda")
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
        # the _check criteria of tests/test_pallas_qr.py
        require(orth < 1e-5 * r, f"mgs_qr {name}: orthogonality {orth:.3e}")
        require(rec < 1e-5 * mnorm + 1e-7, f"mgs_qr {name}: Q·R−m {rec:.3e}")
        require(dq < 5e-6 * math.sqrt(n * r), f"mgs_qr {name}: ‖ΔQ‖ {dq:.3e}")
        require(dr < 5e-6 * r * mnorm + 1e-6, f"mgs_qr {name}: ‖ΔR‖ {dr:.3e}")
        if name == "rank deficient":
            for k in (3, 7, 29):
                require(abs(complex(rm[k, k])) < 1e-6,
                        f"mgs_qr: dead column {k} has a nonzero R diagonal")
        err = max(float(torch.max(torch.abs(q - q_p))),
                  float(torch.max(torch.abs(rm - r_p))))
        ms = cuda_ms(lambda: CQ.mgs_qr(m), 200)
        plain_ms = cuda_ms(lambda: CQ.mgs_qr_plain(m), 10)
        log(f"mgs_qr {name} ({n}, {r}): orth {orth:.3e} rec {rec:.3e} "
            f"‖ΔQ‖ {dq:.3e} ‖ΔR‖ {dr:.3e} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    from pytdscf_torch import units
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ

    phase_device()
    phase_build()

    dt_au = DT_FS / units.au_in_fs
    t0 = time.perf_counter()
    engine = build_engine("cuda")
    log(f"engine: {engine.nsite} sites, D={BOND}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.propagate(dt_au)
    torch.cuda.synchronize()
    log(f"warm-up step: {time.perf_counter() - t0:.3f} s")

    times: dict[str, tuple[float, float]] = {}
    err_lz = check_lanczos(engine, dt_au, times)
    err_qr = check_qr(times)

    # ---- the main path, counted
    engine.krylov_stats()
    CL.lanczos_expm.launches = 0
    CQ.mgs_qr.launches = 0
    torch.cuda.synchronize()
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        engine.propagate(dt_au)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    n_lz, n_qr = CL.lanczos_expm.launches, CQ.mgs_qr.launches
    avg_k, calls, capped = engine.krylov_stats()
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
    profile_step(engine, dt_au)

    kernels = [
        {"name": "lanczos_expm", "route": "cuda",
         "source": "pytdscf_torch/csrc/lanczos_expm.cu",
         "replaces": "pytdscf_tpu/mps/pallas_lanczos.py:296",
         "launches": n_lz, "max_abs_err": err_lz,
         "ms": times["lanczos_expm"][0],
         "plain_ms": times["lanczos_expm"][1]},
        {"name": "mgs_qr", "route": "cuda",
         "source": "pytdscf_torch/csrc/mgs_qr.cu",
         "replaces": "pytdscf_tpu/mps/pallas_qr.py:153",
         "launches": n_qr, "max_abs_err": err_qr,
         "ms": times["mgs_qr"][0], "plain_ms": times["mgs_qr"][1]},
    ]
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
