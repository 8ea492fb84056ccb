"""The Krylov control step as a CUDA kernel, and the CUDA-graph IF nodes
that guard each Krylov iteration of a captured step.

No Pallas kernel has a counterpart: the JAX package runs its Arnoldi and
Lanczos loops as XLA ``while_loop`` programs, whose stopping test the
device evaluates (``mps/integrator.py:_arnoldi_loop`` / ``_lanczos_loop``).
The port's loop (``integrator._program``) is unrolled to ``k_max``
iterations, and each iteration ends with one call of :func:`krylov_ctl`:
from the reduced matrix it forms the coefficients ``c = exp(scale·T)[:, 0]``
(order-12 Taylor with scaling and squaring, :func:`expm_taylor_small`),
tests convergence, breakdown and the cap, and writes, on the device, the
flag that says whether the next iteration runs, the flag of the gather that
forms ψ, and the status ``[k_used, bad, relaxed matvecs]``.  The kernel is
``csrc/krylov_ctl.cu``; its plain version :func:`krylov_ctl_plain` serves
every CPU tensor.

Two ways to honour the decision.  From the host (a step launched op by op,
and every CPU run) the program reads the flag once per iteration and stops.
Inside a captured step (``step_graph.StepProgram``) every iteration after
the first and every gather is the body of a CUDA-graph IF node
(:class:`GraphBranches`) whose condition the control kernel sets itself,
so the replay runs only the iterations the decisions call for: the step
holds no host read and no launch but the control step's own, and an
iteration that does not run launches no matvec.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from pytdscf_torch import _cuda

#: Breakdown threshold on the new Krylov vector's norm.
EPS = 1.0e-14
#: Largest Krylov dimension the control kernel takes.
MAX_KRYLOV = 64
#: Largest k_used that one warp runs (``krylov_ctl.cu:kWarpM``); above it,
#: one block of 256 threads.
WARP_M = 8

#: the capture of a step program in progress (:func:`capturing`), or None
_ACTIVE: "GraphBranches | None" = None


def expm_taylor_small(A: torch.Tensor) -> torch.Tensor:
    """exp(A) of a tiny (k×k) matrix by scaling-and-squaring Taylor.

    Order 12 after scaling ‖A‖₁ below 1/8: truncation ~(1/8)¹³/13! ≈ 4e-22,
    far under float32/float64 round-off.  The number of squarings is
    clamped to 64 and forced to 0 on a non-finite ‖A‖₁, so a NaN or Inf
    in H_eff comes out at once instead of spinning the squaring loop.  The
    norm is read to the host: this is the plain version, for CPU tensors
    and for checking the kernel.
    """
    k = A.shape[0]
    norm1 = float(torch.max(torch.sum(torch.abs(A), dim=0)))
    if math.isfinite(norm1):
        s = int(min(max(math.ceil(math.log2(max(norm1, 1e-30))) + 3, 0), 64))
    else:
        s = 0
    As = A / (2.0 ** s)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    # reverse Horner: p ← I + As·p/c for c = 12, 11, …, 1
    p = eye
    for c in range(12, 0, -1):
        p = eye + (As @ p) / c
    for _ in range(s):
        p = p @ p
    return p


def _check(T, G, c, flags, status, k):
    kmax = c.shape[0]
    if (T.shape != (kmax + 1, kmax + 1) or flags.shape != (kmax + 1,)
            or status.shape != (3,) or not 0 <= k < kmax
            or (G is not None and G.shape != T.shape)):
        raise ValueError(
            f"krylov_ctl: T {tuple(T.shape)}, c {tuple(c.shape)}, flags "
            f"{tuple(flags.shape)}, status {tuple(status.shape)} at k={k} do "
            "not fit")
    if flags.dtype != torch.bool or status.dtype != torch.int32:
        raise TypeError("krylov_ctl: flags are bool, status int32")


def krylov_ctl_plain(T, G, c, flags, status, *, k: int, scale: complex,
                     thresh: float, exact: bool,
                     relax_after: int | None) -> None:
    """One control step of the Krylov program at iteration ``k``, in place.

    ``T`` (k_max+1, k_max+1): the reduced matrix, whose leading (k+1)×(k+1)
    block is active and whose entry ``T[k+1, k]`` is the new vector's norm
    (the breakdown test); ``G``: None (Arnoldi, an orthonormal basis) or the
    Krylov vectors' Gram matrix (Lanczos, whose oblique recurrence is not
    orthogonal); ``c`` (k_max): the previous coefficients, replaced by
    ``exp(scale·T_k)[:, 0]`` (zero past k); ``flags`` (k_max+1) bool:
    ``flags[0]`` whether iteration k+1 runs, ``flags[1+k]`` whether the
    program stopped here; ``status`` (3) int32: ``[k+1, capped without
    convergence or breakdown (never when exact), relaxed matvecs so far]``."""
    _check(T, G, c, flags, status, k)
    m, kmax = k + 1, c.shape[0]
    c_new = torch.zeros_like(c)
    c_new[:m] = expm_taylor_small(scale * T[:m, :m])[:, 0]
    d = c_new - c
    if G is None:
        err = torch.linalg.vector_norm(d)
    else:
        dm = d[:m]
        err = torch.sqrt(torch.clamp_min(
            (dm.conj() @ (G[:m, :m] @ dm)).real, 0.0))
    conv = (err.double() < thresh) & (k > 0)
    breakdown = T[k + 1, k].real < EPS
    capped = m >= kmax
    done = conv | breakdown | capped
    bad = ~conv & ~breakdown & (capped and not exact)
    c.copy_(c_new)
    flags[0] = ~done
    flags[1 + k] = done
    status[0] = m
    status[1] = bad.to(torch.int32)
    status[2] = 0 if relax_after is None else max(m - relax_after, 0)


def krylov_ctl(T, G, c, flags, status, *, k: int, scale: complex,
               thresh: float, exact: bool, relax_after: int | None,
               handles: tuple | None = None) -> None:
    """:func:`krylov_ctl_plain`'s step: on a CUDA tensor one launch of the
    ``csrc/krylov_ctl.cu`` kernel (one warp for k + 1 <= 8, else one block;
    complex64, contiguous, k_max at most :data:`MAX_KRYLOV`, or this
    raises), on a CPU tensor the plain version.  Inside a captured step,
    ``handles = (loops, gathers)`` are the IF-node handles of the Krylov
    program (:meth:`GraphBranches.handles`): the kernel also sets
    ``loops[k + 1]`` (the next iteration's node, where there is one) to
    whether the next iteration runs and ``gathers[k]`` to whether the
    program stopped here.  ``krylov_ctl.launches`` counts kernel launches,
    ``krylov_ctl.plain_calls`` the CPU calls, ``krylov_ctl.replayed`` the
    launches of replayed graphs, on the device (``_cuda.replay_count``)."""
    if T.device.type == "cpu":
        krylov_ctl.plain_calls += 1
        return krylov_ctl_plain(T, G, c, flags, status, k=k, scale=scale,
                                thresh=thresh, exact=exact,
                                relax_after=relax_after)
    if T.device.type != "cuda":
        raise ValueError(f"krylov_ctl: no kernel for device {T.device}")
    _check(T, G, c, flags, status, k)
    kmax = c.shape[0]
    if kmax > MAX_KRYLOV:
        raise ValueError(f"krylov_ctl: k_max={kmax} > {MAX_KRYLOV}")
    for name, t, dtype in (("T", T, torch.complex64), ("G", G, torch.complex64),
                           ("c", c, torch.complex64), ("flags", flags, torch.bool),
                           ("status", status, torch.int32)):
        if t is None:
            continue
        if t.device != T.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"krylov_ctl: {name} must be a contiguous "
                             f"{dtype} tensor on {T.device}")
    nxt, gather, conds = 0, 0, 0
    if handles is not None:
        loops, gathers = handles
        if k + 1 < kmax:
            nxt, conds = loops[k + 1], 1
        gather, conds = gathers[k], conds | 2
    dev = T.device
    scale = complex(scale)
    code = _cuda.load().pytdscf_krylov_ctl_c64(
        dev.index, T.data_ptr(), None if G is None else G.data_ptr(),
        c.data_ptr(), flags.data_ptr(), status.data_ptr(),
        _cuda.replay_count(krylov_ctl, dev), k, kmax,
        scale.real, scale.imag, float(thresh), int(exact),
        -1 if relax_after is None else relax_after, nxt, gather, conds,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(code, "krylov_ctl")
    krylov_ctl.launches += 1


krylov_ctl.launches = 0
krylov_ctl.plain_calls = 0
krylov_ctl.replayed = {}


class GraphBranches:
    """The IF nodes of one step capture.

    :meth:`handles` makes conditional handles in the graph the current
    stream is capturing; :meth:`branch` makes the work queued inside it
    the body of an IF node of that graph on one of them, which runs where
    the handle holds 1 when a replay reaches the node.  The Krylov control
    kernel sets the handles (:func:`krylov_ctl`); every replay starts them
    at 0.  The bodies are captured on a stream of their own, and what they
    allocate comes from a memory pool of their own (:attr:`pool`, kept
    alive with the graph): the step graph's pool takes only its own
    stream's allocations, and memory a body used must never return to the
    general pool while the graph can replay.

    ``delta[i]`` is what body i added to the Python counters when it was
    captured (``snap`` takes the step program's snapshot of them,
    ``diff(after, before)`` what they gained).  A replay may skip a body,
    so only kernels that count their own launches on the device may run
    in one (``step_graph.StepProgram.capture`` checks)."""

    def __init__(self, device, relaxed: bool, snap, diff):
        device = torch.device(device)
        self.device = torch.device(
            "cuda", torch.cuda.current_device() if device.index is None
            else device.index)
        self.relaxed = relaxed
        self.snap, self.diff = snap, diff
        #: the bodies' capture stream and memory pool, made at the first
        #: body (a step without IF nodes makes neither)
        self.stream = self.pool = None
        self.delta: list = []

    def handles(self, n: int) -> list[int]:
        """``n`` new conditional handles of the graph being captured on
        the current stream, each 0 at the start of every replay."""
        out = (ctypes.c_uint64 * n)()
        _cuda.check(_cuda.load().pytdscf_cond_handles(
            self.device.index, torch.cuda.current_stream(self.device).cuda_stream,
            n, out), "cond_handles")
        return list(out)

    @contextlib.contextmanager
    def branch(self, handle: int):
        """Capture the block's work as an IF node's body on ``handle``."""
        lib = _cuda.load()
        dev = self.device.index
        if self.pool is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.MemPool()
        parent = torch.cuda.current_stream(self.device)
        before = self.snap()
        _cuda.check(lib.pytdscf_if_begin(dev, parent.cuda_stream, handle,
                                         self.stream.cuda_stream,
                                         int(self.relaxed)), "if_begin")
        try:
            with torch.cuda.stream(self.stream):
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev,
                                                                self.pool.id)
                try:
                    yield
                finally:
                    torch._C._cuda_endAllocateToPool(dev, self.pool.id)
        finally:
            code = lib.pytdscf_if_end(dev, self.stream.cuda_stream)
        _cuda.check(code, "if_end")
        self.delta.append(self.diff(self.snap(), before))


def active(device) -> GraphBranches | None:
    """The IF nodes of the step capture in progress on ``device``, or None
    when its current stream is not capturing.  A capture that no step
    program began cannot run the Krylov program: it raises."""
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return None
    if _ACTIVE is None:
        raise RuntimeError(
            "a Krylov program is being captured outside a step program: its "
            "iterations need the IF nodes of step_graph.StepProgram.capture")
    return _ACTIVE


@contextlib.contextmanager
def capturing(branches: GraphBranches):
    """Make ``branches`` the IF nodes of the capture in progress."""
    global _ACTIVE
    _ACTIVE = branches
    try:
        yield branches
    finally:
        _ACTIVE = None
