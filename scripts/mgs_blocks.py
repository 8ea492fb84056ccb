#!/usr/bin/env python3
"""What bounds the one-block MGS factor on the card, and why its shape.

    python3 scripts/mgs_blocks.py

Builds ``scripts/mgs_blocks.cu`` with nvcc (``sm_90a``) into a temporary
directory and, at the one-block shapes of the paths ((240, 30), (560, 20),
(200, 20), (72, 12), seeded random complex64 operands; full rank, and with
every other column from the tenth on zero):

* times ``tdvp_device.cuh``'s ``mgs_factor`` in one block of 256, 512 and
  1024 threads (CUDA events over 200 launches; each result held to
  ``cuda_qr.mgs_qr_plain``);
* times the factor on 1024 threads with m staged by plain loads
  (``mgs_stage``) and by one 8-byte ``cp.async`` an entry, in the order
  async, plain, plain, async: warm (200 launches back to back, m in L2)
  and cold (L2 overwritten by a 128 MiB write before each of 50 launches,
  each timed alone);
* counts the cycles (``clock64``) of each phase at the last column and at
  column 8: the dot products as the factor takes them (two columns a warp)
  against one and four columns a warp, the update as the factor takes it
  (a row a thread, unrolled) against a loop not unrolled and against 2, 4
  and 8 lanes a row combined by shuffles (each at a column stride free of
  bank conflicts for it, ld = 16 / lanes mod 16), a block barrier and the
  factor's block sum.

Prints the card, one line per measurement and one JSON object last.  Needs
a GPU; imports no JAX.
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
SHAPES = ((240, 30), (560, 20), (200, 20), (72, 12))
THREADS = (256, 512, 1024)
PHASES = ("dots", "dots 1 column a warp", "dots 4 columns a warp", "update",
          "update not unrolled", "update 2 lanes a row",
          "update 4 lanes a row", "update 8 lanes a row", "barrier",
          "block sum")
SPLITS = (2, 4, 8)
REPS = 200
COLD_REPS = 50


def padded(n: int, lanes: int) -> int:
    """The least column stride >= n that is 16 / lanes mod 16: a half-warp
    of ``lanes`` columns and 16 / lanes rows then reads 32 distinct banks."""
    return n + (16 // lanes - n) % 16


def _lib(tmp: str):
    nvcc = "/usr/local/cuda/bin/nvcc"
    out = Path(tmp) / "mgs_blocks.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", str(out), str(ROOT / "scripts" / "mgs_blocks.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mgs_blocks_factor.argtypes = [p, p, p, i, i, i]
    lib.mgs_blocks_stage.argtypes = [p, p, p, i, i, i]
    lib.mgs_blocks_phases.argtypes = [p, i, i, i, i, i, i, p]
    return lib


def _checked(code: int) -> None:
    if code:
        raise RuntimeError(f"mgs_blocks: CUDA error {code}")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from pytdscf_torch.mps import cuda_qr as CQ

    if not torch.cuda.is_available():
        print("mgs_blocks: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(card)
    result = {"card": card, "factor_ms": {}, "stage_ms": {},
              "phase_cycles": {}}
    with tempfile.TemporaryDirectory() as tmp:
        lib = _lib(tmp)
        rng = np.random.default_rng(0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for shape in SHAPES:
            a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            for dead in (False, True):
                b = a.copy()
                if dead:
                    b[:, 10::2] = 0.0
                m = torch.as_tensor(b / np.linalg.norm(b),
                                    dtype=torch.complex64, device="cuda")
                q_ref, r_ref = CQ.mgs_qr_plain(m)
                times = {}
                for threads in THREADS:
                    q = torch.empty_like(m)
                    r = torch.empty((shape[1],) * 2, dtype=m.dtype,
                                    device="cuda")

                    def launch():
                        _checked(lib.mgs_blocks_factor(
                            m.data_ptr(), q.data_ptr(), r.data_ptr(),
                            *shape, threads))

                    for _ in range(3):
                        launch()
                    torch.cuda.synchronize()
                    ev[0].record()
                    for _ in range(REPS):
                        launch()
                    ev[1].record()
                    torch.cuda.synchronize()
                    err = max(float((q - q_ref).abs().max()),
                              float((r - r_ref).abs().max()))
                    if err > 1e-5:
                        raise RuntimeError(f"mgs_blocks: {shape} on {threads} "
                                           f"threads |Δ| {err:.2e}")
                    times[threads] = ev[0].elapsed_time(ev[1]) / REPS
                tag = f"{shape}{' dead' if dead else ''}"
                result["factor_ms"][tag] = times
                print(f"factor {tag}: " + ", ".join(
                    f"{t} threads {ms:.4f} ms" for t, ms in times.items()))
                result["stage_ms"][tag] = stage_ms(lib, m, q_ref, r_ref,
                                                   shape, ev)
                print(f"staging {tag}, 1024 threads: " + ", ".join(
                    f"{way} {ms:.4f} ms"
                    for way, ms in result["stage_ms"][tag].items()))
            mm = torch.as_tensor(a / np.linalg.norm(a), dtype=torch.complex64,
                                 device="cuda")
            for threads in (256, 1024):
                for k in (shape[1] - 1, 8):
                    cyc = phase_cycles(lib, mm, shape, k, threads)
                    result["phase_cycles"][f"{shape} {threads} k={k}"] = cyc
                    print(f"phases {shape} {threads} threads k={k}: " + ", ".join(
                        f"{n} {c}" for n, c in cyc.items()))
    print(json.dumps(result))
    return 0


def stage_ms(lib, m, q_ref, r_ref, shape, ev) -> dict[str, float]:
    """The factor's ms on 1024 threads with m staged by cp.async and by
    plain loads, warm and cold, measured async, plain, plain, async and
    averaged over the two runs of each."""
    import torch

    q = torch.empty_like(m)
    r = torch.empty((shape[1],) * 2, dtype=m.dtype, device="cuda")
    flush = torch.empty(2**27, dtype=torch.uint8, device="cuda")

    def launch(way):
        _checked(lib.mgs_blocks_stage(m.data_ptr(), q.data_ptr(),
                                      r.data_ptr(), *shape,
                                      int(way == "async")))

    out: dict[str, list[float]] = {}
    for way in ("async", "plain", "plain", "async"):
        for _ in range(3):
            launch(way)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(REPS):
            launch(way)
        ev[1].record()
        torch.cuda.synchronize()
        out.setdefault(f"{way} warm", []).append(
            ev[0].elapsed_time(ev[1]) / REPS)
        cold = 0.0
        for _ in range(COLD_REPS):
            flush.fill_(1)
            ev[0].record()
            launch(way)
            ev[1].record()
            torch.cuda.synchronize()
            cold += ev[0].elapsed_time(ev[1])
        out.setdefault(f"{way} cold", []).append(cold / COLD_REPS)
        err = max(float((q - q_ref).abs().max()),
                  float((r - r_ref).abs().max()))
        if err > 1e-5:
            raise RuntimeError(f"mgs_blocks: {shape} staged {way} |Δ| "
                               f"{err:.2e}")
    return {key: sum(v) / len(v) for key, v in sorted(out.items())}


def phase_cycles(lib, m, shape, k: int, threads: int) -> dict[str, int]:
    """Each phase's cycles at column k: the update split over lanes from a
    run at its own padded column stride, every other phase from a run at
    stride N."""
    import torch

    def run(ld: int) -> dict[str, int]:
        out = torch.zeros(11, dtype=torch.int64, device="cuda")
        code = lib.mgs_blocks_phases(m.data_ptr(), *shape, ld, k, 50,
                                     threads, out.data_ptr())
        torch.cuda.synchronize()
        _checked(code)
        return dict(zip(PHASES, out.cpu().tolist()))

    cyc = run(shape[0])
    for lanes in SPLITS:
        name = f"update {lanes} lanes a row"
        cyc[name] = run(padded(shape[0], lanes))[name]
    return cyc


if __name__ == "__main__":
    sys.exit(main())
