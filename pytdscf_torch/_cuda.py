"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library is built at first use into ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import: the CPU-only installation imports this module and never calls it.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; :func:`check` turns a nonzero
code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: (argtypes) of each entry point; all return an int error code
SIGNATURES = {
    # device, m, q, r_out, qwork (or NULL), N, r, stream
    "pytdscf_mgs_qr_c64": [_I, _P, _P, _P, _P, _I, _I, _P],
    # device, H, Rt, v, out, status, scratch, nc, M, r, kmax,
    # scale_re, scale_im, thresh, conserve, stream
    "pytdscf_lanczos_expm_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P,
    ],
    # device, psi, L, W, R, part, out, B, K, X, Rd, d, wl, wr, Tk, Tx, stream
    "pytdscf_heff_lo_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # device, sig, L, R, part, out, B, K, X, Rd, w, Tk, Tx, stream
    "pytdscf_keff_lo_c64": [
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from pytdscf_torch/csrc "
        "with the CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)"
    )


def build() -> tuple[Path, str, float]:
    """Compile the kernels if needed: (library path, ptxas log, seconds)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in sources)
    ).hexdigest()[:12]
    out = BUILD_DIR / f"libpytdscf_kernels-{digest}.so"
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    t0 = time.perf_counter()
    # one nvcc per source, all started together (one nvcc call given
    # several sources compiles them one after the other)
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        failed = [f"{src.name} ({proc.returncode}):\n{text}"
                  for src, proc, text in zip(sources, procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}"
            )
        os.replace(tmp, out)  # atomic: no process loads a half-written file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(logs), time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pytdscf_error_string.argtypes = [ctypes.c_int]
    lib.pytdscf_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().pytdscf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch ({msg})")
