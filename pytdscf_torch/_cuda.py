"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library is built at first use into ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of the sources and the headers they share
(``csrc/*.cuh``), so an edited source or header is rebuilt and an unchanged
tree is loaded as it is.  Nothing here runs at
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
_D = ctypes.c_double
_U = ctypes.c_uint64
#: C signatures: (argtypes) of each entry point; all return an int error code
SIGNATURES = {
    # device, m, q, r_out, qwork (or NULL), N, r, stream
    "pytdscf_mgs_qr_c64": [_I, _P, _P, _P, _P, _I, _I, _P],
    # device, m, q, r_out, N, r, stream
    "pytdscf_mgs_qr_cluster_c64": [_I, _P, _P, _P, _I, _I, _P],
    # device, H, Rt, v, out, status, scratch, nc, M, r, kmax,
    # scale_re, scale_im, thresh, conserve, stream
    "pytdscf_lanczos_expm_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P,
    ],
    # ... the same, then the cluster size C, resident, stream
    "pytdscf_lanczos_expm_cluster_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I,
        _P,
    ],
    # device, psi, L, W, R, psip, t1, t2, out, B, K, X, Rd, din, dout, wl,
    # wr, count (or NULL), stream
    "pytdscf_heff_tc_c64": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P,
    ],
    # device, sig, L, R, sigp, t1, out, B, K, X, Rd, w, count (or NULL),
    # stream
    "pytdscf_keff_tc_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
    ],
    # device, psi, L, W (or NULL), R, psip, t1 (or NULL), t2, out, B, K, X,
    # Rd, din, dout, wl, wr, count (or NULL), stream
    "pytdscf_chain3_c64": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ],
    # device, H, Rt, v, out, status, scratch (or NULL), nc, M, r, kmax, the
    # cluster size C (1: one CTA), threads, wide, resident, v_shared, stream
    "pytdscf_lanczos_gs_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # device, H, Rt, psi, next, logs, site_out, psi_next, blocks, log_new,
    # status, scratch, nc, M, r, P2, kmaxH, kmaxK, scale_re, scale_im,
    # thresh, conserve, stream
    "pytdscf_site_step_c64": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P,
    ],
    # ... the same, then the cluster size C, stream
    "pytdscf_site_step_cluster_c64": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P,
    ],
    # device, T, G (or NULL), c, flags, status, count (or NULL), k, kmax,
    # scale_re, scale_im, thresh, exact, relax_after, the IF-node handles
    # of the next iteration and of the gather, which of them to set,
    # stream
    "pytdscf_krylov_ctl_c64": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _D, _I, _I, _U, _U, _I,
        _P,
    ],
    # device, parent stream, n, out (n handles)
    "pytdscf_cond_handles": [_I, _P, _I, _P],
    # device, parent stream, handle, child stream, relaxed
    "pytdscf_if_begin": [_I, _P, _U, _P, _I],
    # device, child stream
    "pytdscf_if_end": [_I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from pytdscf_torch/csrc "
        "with the CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)"
    )


def source_digest(csrc: Path = CSRC) -> str:
    """Hash of every kernel source and shared header (``*.cu``, ``*.cuh``)
    under ``csrc``, names included: the build's name."""
    files = sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])
    return hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in files)
    ).hexdigest()[:12]


def build() -> tuple[Path, str, float]:
    """Compile the kernels if needed: (library path, ptxas log, seconds)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = source_digest()
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


def replay_count(fn, device):
    """The address of ``fn``'s launch count on ``device`` (an int32 on the
    card, in ``fn.replayed``) while the current stream records a CUDA
    graph, else None.  A launch given the address adds one to it on the
    device, so the replays of a graph count the launches they ran, those
    inside IF nodes included (``step_graph.StepProgram.settle``)."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        return None
    count = fn.replayed.get(device.index)
    if count is None:
        raise RuntimeError(
            "a kernel was launched in a capture with no device launch count "
            "on its device (step_graph.StepProgram makes them first)")
    return count.data_ptr()


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().pytdscf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch ({msg})")
