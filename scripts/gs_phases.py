#!/usr/bin/env python3
"""What bounds the ground-state kernel on the card: the cycles of each of
its phases.

    python3 scripts/gs_phases.py

Builds ``scripts/gs_phases.cu`` with nvcc (``sm_90a``) into a temporary
directory and, at a butadiene bulk shape ((M, r) = (72, 12), 30 channels),
at two H2O shapes ((81, 9) with 3 channels, (9, 9) with 5) and at (300,
30) with 4 channels (the wide layout), on seeded random Hermitian
channels:

* runs the ground state as it stood before its redesign
  (``reference_gs_kernel``: the Lanczos exponential's cluster layer, 1024
  threads, 16 CTAs for M > 9 else one) with every phase's cycles counted
  on every CTA: the matvec's cluster barrier, the gather of the peers'
  rows, the two products, the alpha and beta sums, the writes, and per
  pass the start's norm, T's eigenpair, the Ritz vector, the energy;
* runs the kernel of the tree (``lanczos_gs.cu``) on the cluster size and
  block size that ``cuda_lanczos.gs_plan`` gives each shape, through its
  counting hook (``GsProbe``), phase by phase: the first product, the
  second with its pushes and alpha's partial, the exchange's cluster
  barrier, the whole-vector update, the next vector, and per pass the
  start, T's eigenpair, the Ritz vector, the energy;
* times both with CUDA events over repeated launches (ms a call, ms a
  matvec-iteration: ms / (iterations + passes)), the tree's kernel also
  as the package launches it (no counting), and holds each result's
  energy to the plain version's (1e-6 relative); the multisection rounds
  a pass of T's eigensolve;
* times the first product (H_c x on a CTA's rows) alone on one CTA of
  512 threads at the relax stages' shapes, tdvp_device.cuh's
  ``rows_times_x`` against the ground state's ``gs_rows_times_x`` with
  each tile of rows by columns.

A phase's cycles are the mean over its occurrences on rank 0, beside the
largest mean over the ranks; the counting adds one block barrier a phase.
Prints the card, one line per shape and kernel and one JSON object last.
Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: (nc, M, r) of each probed shape: the butadiene bulk, two H2O shapes,
#: and a random site that takes the wide layout (chip_smoke.GS_WIDE)
SHAPES = ((30, 72, 12), (3, 81, 9), (5, 9, 9), (4, 300, 30))
REF_PHASES = ("barrier", "gather", "H x", "x Rt", "alpha", "beta", "write",
              "start", "eigenpair", "Ritz", "energy")
#: the tree kernel's phases (lanczos_gs.cu: GsPhase)
TREE_PHASES = ("H x", "x Rt + push", "alpha partial", "exchange", "update",
               "next", "start", "eigenpair", "Ritz", "energy")
REPS = 10
#: the first product's variants (gs_phases.cu: gs_phases_hx), and the CTA
#: shapes (nc, M, r, rows a CTA) they are timed at: the relax stages'
#: shapes on the CTAs the ground state's rule gives them
HX_VARIANTS = ("rows_times_x 2x2", "2x2", "2x4", "4x2", "4x4", "1x4", "2x3",
               "2x6")
HX_SHAPES = ((30, 72, 12, 5), (20, 72, 12, 5), (11, 72, 12, 5),
             (3, 81, 9, 6), (11, 36, 12, 3), (5, 72, 6, 5))
HX_REPS = 50


def _lib(tmp: str):
    out = Path(tmp) / "gs_phases.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(out),
                    str(ROOT / "scripts" / "gs_phases.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gs_phases_reference.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        p]
    lib.gs_phases_tree.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                   i, p]
    lib.gs_phases_hx.argtypes = [i, p, p, i, i, i, i, i, p]
    return lib


def _checked(code: int) -> None:
    if code:
        raise RuntimeError(f"gs_phases: CUDA error {code}")


def _channels(rng, nc, M, r):
    import torch

    H = rng.normal(size=(nc, M, M)) + 1j * rng.normal(size=(nc, M, M))
    H = (H + H.conj().transpose(0, 2, 1)) / (2 * M)
    Rt = rng.normal(size=(nc, r, r)) + 1j * rng.normal(size=(nc, r, r))
    Rt = (Rt + Rt.conj().transpose(0, 2, 1)) / (2 * r)
    v = rng.normal(size=(M, r)) + 1j * rng.normal(size=(M, r))
    return [torch.tensor(x, dtype=torch.complex64, device="cuda")
            for x in (H, Rt, v)]


def _phases(cyc, names) -> tuple[dict, int]:
    """({phase: (mean cycles on rank 0, largest mean over the ranks,
    occurrences on rank 0)}, multisection rounds on rank 0)."""
    P = len(names)
    a = cyc.cpu().numpy().reshape(-1, 2 * P + 1)
    out = {}
    for p, name in enumerate(names):
        cnt = a[:, P + p]
        means = np.where(cnt > 0, a[:, p] / np.maximum(cnt, 1), 0)
        out[name] = (float(means[0]), float(means.max()), int(cnt[0]))
    return out, int(a[0, 2 * P])


def _energy(H, Rt, x) -> float:
    from pytdscf_torch.mps import cuda_lanczos as CL

    return float(np.vdot(x.reshape(-1).cpu().numpy(),
                         CL._matvec(H, Rt, x).reshape(-1).cpu().numpy()).real)


def _report(tag, ms, status, phases, rounds) -> dict:
    passes, iters, _ = status
    per_it = ms / (iters + passes)
    print(f"{tag}: {ms:.4f} ms a call, {passes} passes, {iters} iterations, "
          f"{1e3 * per_it:.2f} µs an iteration; multisection "
          f"{rounds / passes:.1f} rounds a pass")
    for name, (c0, cmax, n) in phases.items():
        if n:
            print(f"  {name:12s} {c0:10.0f} cycles (largest rank "
                  f"{cmax:10.0f}) x {n}")
    return {"ms": ms, "passes": passes, "iterations": iters,
            "ms_per_iteration": per_it, "rounds_per_pass": rounds / passes,
            "phases": {k: {"rank0": v[0], "max": v[1], "count": v[2]}
                       for k, v in phases.items()}}


def _timed(launch, ev) -> float:
    import torch

    launch()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(REPS):
        launch()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / REPS


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import integrator

    if not torch.cuda.is_available():
        print("gs_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "shapes": {}}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _lib(tmp)
        for nc, M, r in SHAPES:
            H, Rt, v = _channels(np.random.default_rng(M * 100 + r), nc, M,
                                 r)
            want, _ = CL.ground_state_plain(H, Rt, v)
            e_want = _energy(H, Rt, want)
            kmax = min(integrator.GS_BLOCK_DIM, M * r)
            shape = f"({M}, {r}), {nc} channels"
            entry = result["shapes"][shape] = {}
            out = torch.empty_like(v)
            status = torch.empty(3, dtype=torch.int32, device="cuda")

            def check(tag):
                e = _energy(H, Rt, out)
                if abs(e - e_want) > 1e-6 * abs(e_want):
                    raise RuntimeError(f"gs_phases: {tag} ({M}, {r}) E {e} "
                                       f"vs plain {e_want}")

            # the kernel before its redesign
            C = 16 if M > 9 else 1
            Mc = -(-M // C)
            resident = CL.smem_bytes(nc, M, r, C, resident=True) <= CL.MAX_SMEM
            scratch = torch.empty(C * (kmax + 1) * Mc * r,
                                  dtype=torch.complex64, device="cuda")
            cyc = torch.zeros(C * (2 * len(REF_PHASES) + 1),
                              dtype=torch.int64, device="cuda")

            def ref():
                _checked(lib.gs_phases_reference(
                    H.data_ptr(), Rt.data_ptr(), v.data_ptr(), out.data_ptr(),
                    status.data_ptr(), scratch.data_ptr(), nc, M, r, kmax, C,
                    int(resident), cyc.data_ptr()))

            ref()
            torch.cuda.synchronize()
            check("reference")
            phases, rounds = _phases(cyc, REF_PHASES)
            entry["reference"] = _report(
                f"{shape}, reference on {C} CTA(s) of 1024", _timed(ref, ev),
                status.tolist(), phases, rounds)
            entry["reference"]["ctas"] = C
            # the tree's kernel on its plan, counted (and, on a cluster, on
            # each other block size it takes), then as the package launches
            # it
            way, C, threads = CL.gs_plan(M, r, nc)[:3]
            others = [t for size, t in CL.gs_candidates(M, r, nc)
                      if size == C and t != threads and C > 1]
            for t in [threads, *others]:
                wide, res, vsh, nscratch = CL._gs_launch_plan(M, r, nc, C,
                                                              t)[3:]
                scratch = torch.empty(max(nscratch, 1),
                                      dtype=torch.complex64, device="cuda")
                cyc = torch.zeros(C * (2 * len(TREE_PHASES) + 1),
                                  dtype=torch.int64, device="cuda")

                def tree():
                    _checked(lib.gs_phases_tree(
                        H.data_ptr(), Rt.data_ptr(), v.data_ptr(),
                        out.data_ptr(), status.data_ptr(), scratch.data_ptr(),
                        nc, M, r, kmax, C, t, int(wide), int(res), int(vsh),
                        cyc.data_ptr()))

                tree()
                torch.cuda.synchronize()
                check("tree")
                phases, rounds = _phases(cyc, TREE_PHASES)
                key = "tree" if t == threads else f"tree_{t}_threads"
                entry[key] = _report(
                    f"{shape}, the tree's kernel counted on {C} CTA(s) of "
                    f"{t}", _timed(tree, ev), status.tolist(), phases,
                    rounds)
                entry[key].update(ctas=C, threads=t)
            ms = _timed(lambda: CL.ground_state((H, Rt), v), ev)
            got, st = CL.ground_state((H, Rt), v)
            passes, iters, _ = st.tolist()
            entry["tree_uncounted"] = {
                "ms": ms, "passes": passes, "iterations": iters,
                "ms_per_iteration": ms / (iters + passes)}
            print(f"{shape}, the tree's kernel as launched: {ms:.4f} ms a "
                  f"call, {passes} passes, "
                  f"{1e3 * ms / (iters + passes):.2f} µs an iteration")
        result["hx_cycles"] = _hx(lib)
    print(json.dumps(result))
    return 0


def _hx(lib) -> dict:
    """Cycles of one first product on one CTA, by variant and shape."""
    import torch

    out = {}
    rng = np.random.default_rng(5)
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    for nc, M, r, nh in HX_SHAPES:
        H, _, x = _channels(rng, nc, M, r)
        row = {}
        for i, name in enumerate(HX_VARIANTS):
            _checked(lib.gs_phases_hx(i, H.data_ptr(), x.data_ptr(), nc, M,
                                      r, nh, HX_REPS, cyc.data_ptr()))
            torch.cuda.synchronize()
            row[name] = int(cyc.item())
        tag = f"({M}, {r}), {nc} channels, {nh} rows"
        out[tag] = row
        print(f"H x {tag}: " + ", ".join(f"{k} {v}" for k, v in row.items()))
    return out


if __name__ == "__main__":
    sys.exit(main())
