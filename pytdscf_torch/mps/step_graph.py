"""One TDVP step as a program over fixed buffers, replayed as a CUDA graph.

The counterpart of the compiled loop of the JAX package's fused driver
(``TDVPEngine.propagate_steps``): there XLA compiles a block of steps into
one device program; here one whole step (both half-sweeps, and with
``collect`` the pre-step observables) is recorded once as a
``torch.cuda.CUDAGraph`` and replayed, so a step costs one graph launch
instead of the host's launch of each of its kernels and torch operations.

The carry, the state one step maps onto the next, lives in fixed buffers:
the cores of every electronic state, the right environment stack (blocks
and log-scales, one of each a pair group with several states), the
device-side Krylov and ground-state telemetry and, in ``pytest_enabled``
runs, the gauge deviation.  A recorded step reads the buffers and ends by copying its new
carry into them (:func:`copy_all`), since a replay writes to
the addresses of the capture.  The buffers take the shapes and strides of
the carry after one real step, so the uncaptured program on the CPU runs
the same operations on the same layouts as :meth:`TDVPEngine.propagate`.

Capture records and does not execute, so everything a step works out on
the host must exist before it: the engine runs one step from the host
first (a real step of its block), which fills the per-shape route plans
(``cuda_lanczos.plan``, ``cuda_site.plan``), the cluster launch set-up of
the C library and the library itself.  A plan worked out during capture
raises.  The capture keeps ``torch.cuda.graph``'s global error mode: a
host read inside a step (``.item()``, ``float()``, ``.cpu()`` on a CUDA
tensor) raises there, and nothing catches it.

A step that runs the Krylov program over the einsums (Arnoldi, the
einsum Lanczos) holds IF nodes: each Krylov iteration after the first, and
each gather of ψ, is the body of a conditional node that a replay runs
only where the device control step (``cuda_krylov.krylov_ctl``) left its
flag set (``cuda_krylov.GraphBranches``).  The host step before capture
may stop a Krylov call before its last iteration, so those bodies are
warmed first by a throwaway capture in relaxed mode, whose graph is
dropped.

Python-side counters advance once, at capture: the kernel wrappers'
launch counters and the engine's Krylov call counts.  The program records
what one captured step added to each, takes it back (the capture ran no
kernel), and adds at every replay what the step added.  The kernels a
Krylov iteration launches (``heff_lo``, ``keff_lo``, ``matvec_hi``,
``krylov_ctl``, and the transfers ``renorm_hi``, ``renorm_lo``) count
their own launches instead: launched in a capture, each adds one to an
int32 on the device (``_cuda.replay_count``) every time a replay runs it,
so a body that a replay skips adds nothing, and :meth:`StepProgram.settle`
reads those counts after a block (one host read) into the wrappers'
``launches``.  An IF node's body may launch no other counted kernel.  So
the counters read the same whichever way a step ran.
"""

from __future__ import annotations

import copy
import gc
import time

import torch

from pytdscf_torch.mps import cuda_krylov as CK

#: the per-wrapper counters that a step may advance
_COUNTS = ("launches", "plain_calls", "route_launches", "cluster_launches")
#: the engine's host-side count of a step's Krylov calls (``krylov_stats``)
_ENGINE_COUNTS = ("_kry_calls",)


def _wrappers() -> tuple:
    """Every kernel wrapper with launch counters."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import cuda_site as CS

    return (CL.lanczos_expm, CL.ground_state, CQ.mgs_qr, CS.site_step_fused,
            CM.heff_lo,
            CM.keff_lo, CR.renorm_hi, CR.renorm_lo, CR.matvec_hi,
            CK.krylov_ctl)


def _device_counted() -> tuple:
    """The wrappers whose kernels count their launches on the device."""
    return tuple(fn for fn in _wrappers() if hasattr(fn, "replayed"))


def _plans() -> tuple:
    """The per-shape plan caches a launch reads."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_site as CS

    return CL.plan, CL.gs_plan, CS.plan, CS.route


def _plan_misses() -> tuple:
    return tuple(fn.cache_info().misses for fn in _plans())


def _counts(engine) -> list:
    """A copy of every counter a step advances."""
    out = []
    for fn in _wrappers():
        for name in _COUNTS:
            if hasattr(fn, name):
                out.append((fn, name, copy.copy(getattr(fn, name))))
    out += [(engine, name, getattr(engine, name)) for name in _ENGINE_COUNTS]
    return out


def _diff(after: list, before: list) -> list:
    """What the counters gained between two :func:`_counts`."""
    out = []
    for (obj, name, new), (_, _, old) in zip(after, before):
        if isinstance(new, dict):
            new = {k: v - old.get(k, 0) for k, v in new.items()}
        else:
            new = new - old
        out.append((obj, name, new))
    return out


def _host_counted(delta: list) -> list:
    """``delta`` without the launches of :func:`_device_counted` wrappers
    (a replay counts those on the device)."""
    device = _device_counted()
    return [(obj, name, 0 if name == "launches" and obj in device else value)
            for obj, name, value in delta]


def _nonzero(delta: list) -> bool:
    return any(any(value.values()) if isinstance(value, dict) else value
               for _, _, value in delta)


def _restore(saved: list) -> None:
    for obj, name, value in saved:
        setattr(obj, name, copy.copy(value))


def _add(delta: list) -> None:
    for obj, name, value in delta:
        if isinstance(value, dict):
            counts = getattr(obj, name)
            for k, v in value.items():
                counts[k] = counts.get(k, 0) + v
        else:
            setattr(obj, name, getattr(obj, name) + value)


def pack(items, real) -> torch.Tensor:
    """Device tensors as one real vector of dtype ``real``: each flattened,
    a complex one as its (re, im) pairs."""
    return torch.cat([
        (torch.view_as_real(x) if x.is_complex() else x).reshape(-1).to(real)
        for x in items
    ])


def copy_all(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` for every i, one ``torch._foreach_copy_``
    per dtype: the multi-tensor route takes lists of one dtype, and the
    carry mixes complex cores and blocks, real log-scales and the int32
    telemetry."""
    groups: dict = {}
    for d, t in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(t)
    for d, t in groups.values():
        torch._foreach_copy_(d, t)


def _env_parts(entry) -> tuple[list, list]:
    """An environment-stack entry's blocks and log-scales as lists: one of
    each for one electronic state, one a pair group for several."""
    blocks, logs = entry
    if isinstance(blocks, torch.Tensor):
        return [blocks], [logs]
    return list(blocks), list(logs)


def _carry(engine) -> list:
    """The engine's step carry as a flat list: cores (state by state),
    environment blocks, their log-scales, the Krylov and ground-state
    telemetry and, in ``pytest_enabled`` runs, the gauge deviation (None
    where the engine holds none yet)."""
    out = [c for state in engine.cores for c in state]
    parts = [_env_parts(entry) for entry in engine.env_stack]
    out += [b for blocks, _ in parts for b in blocks]
    out += [lg for _, logs in parts for lg in logs]
    out.append(engine._kry_sum)
    out.append(engine._gs_tally)
    if engine.config.pytest_enabled:
        out.append(engine._gauge_dev)
    return out


class StepProgram:
    """One step of ``engine`` at the step scale ``scale`` over fixed
    buffers, made right after a step that ran from the host.

    ``collect``: None, or the keywords of ``TDVPEngine.properties_submit``
    whose packed items (``row``, with its ``plan`` and ``layout``, from the
    host step) each step writes into :attr:`slot` before it propagates.
    """

    def __init__(self, engine, scale: complex, collect, row, plan, layout):
        self.scale = scale
        self.collect = collect
        self.plan = plan
        self.layout = layout
        self.slot = None if row is None else torch.empty_like(row)
        real = engine.fetch_real_dtype()
        self.buffers = [
            torch.zeros((), dtype=real, device=engine.device) if t is None
            else torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                     device=t.device)
            for t in _carry(engine)
        ]
        self.graph: torch.cuda.CUDAGraph | None = None
        #: the IF nodes of the graph (their stream and pool)
        self.branches: CK.GraphBranches | None = None
        #: what one step adds to each counter (at each replay)
        self.delta: list = []
        #: seconds to record and instantiate the graph
        self.capture_s: float | None = None
        self.load(engine)
        self.install(engine)

    def load(self, engine) -> None:
        """Copy the engine's state into the buffers (a no-op where the
        engine already holds them); absent telemetry starts at zero."""
        dst, src = [], []
        for buf, t in zip(self.buffers, _carry(engine)):
            if t is None:
                buf.zero_()
            elif t is not buf:
                dst.append(buf)
                src.append(t)
        copy_all(dst, src)

    def install(self, engine) -> None:
        """Make the buffers the engine's state."""
        n, ns = engine.nsite, engine.nstate
        b = self.buffers
        engine.cores = [list(b[s * n:(s + 1) * n]) for s in range(ns)]
        k = ns * n
        if engine.pairset is None:
            engine.env_stack = list(zip(b[k:k + n], b[k + n:k + 2 * n]))
            k += 2 * n
        else:
            g = len(engine.pairset.groups)
            blocks, logs = b[k:k + g * n], b[k + g * n:k + 2 * g * n]
            engine.env_stack = [
                (tuple(blocks[e * g:(e + 1) * g]),
                 tuple(logs[e * g:(e + 1) * g])) for e in range(n)]
            k += 2 * g * n
        engine._env_side = "right"
        engine._kry_sum = b[k]
        engine._gs_tally = b[k + 1]
        engine._gauge_dev = b[k + 2] if engine.config.pytest_enabled \
            else None

    def _body(self, engine) -> None:
        """The recorded step: observables into the slot, both
        half-sweeps, the new carry into the buffers."""
        self.install(engine)
        if self.collect is not None:
            items, _ = engine.properties_submit(**self.collect)
            self.slot.copy_(pack(items, self.slot.dtype))
        engine._step(self.scale)
        new = _carry(engine)
        held = {buf.untyped_storage().data_ptr() for buf in self.buffers}
        for buf, t in zip(self.buffers, new):
            if t.shape != buf.shape:
                raise RuntimeError(
                    f"step program: the carry changed shape ({tuple(buf.shape)}"
                    f" → {tuple(t.shape)}); a step must map the state onto "
                    "the same shapes")
            if t is not buf and t.untyped_storage().data_ptr() in held:
                raise RuntimeError(
                    "step program: a new carry tensor shares a buffer's "
                    "storage, which the copy-back would overwrite")
        copy_all(self.buffers, new)

    def _record(self, engine, graph, branches, mode: str) -> float:
        """Record one step into ``graph`` with ``branches`` as its IF nodes:
        the seconds it took.  The engine's state and every counter are as
        before it."""
        before = _counts(engine)
        t0 = time.perf_counter()
        # no garbage collection inside the capture: collecting an old
        # graph there destroys it, an API call that invalidates a capture
        # in progress
        collecting = gc.isenabled()
        gc.disable()
        try:
            with CK.capturing(branches), torch.cuda.graph(
                    graph, capture_error_mode=mode):
                self._body(engine)
            return time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
            # the capture ran no kernel: no count advanced, and the state
            # is the buffers' as before it
            self._captured = _diff(_counts(engine), before)
            _restore(before)
            self.install(engine)
            # the bodies' snapshot functions hold the engine, which holds
            # this program: drop them, so that no cycle keeps a graph alive
            # until a collection runs
            branches.snap = branches.diff = None

    def capture(self, engine, warm: bool = False) -> None:
        """Record one step as a CUDA graph in a private memory pool.  With
        ``warm`` (the step has IF nodes) a throwaway capture in relaxed
        mode first records every body once."""
        misses = _plan_misses()
        self.device = torch.device(engine.device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for fn in _device_counted():
            if self.device.index not in fn.replayed:
                fn.replayed[self.device.index] = torch.zeros(
                    1, dtype=torch.int32, device=self.device)

        def branches(relaxed):
            return CK.GraphBranches(engine.device, relaxed,
                                    lambda: _counts(engine), _diff)

        if warm:
            self._record(engine, torch.cuda.CUDAGraph(), branches(True),
                         "relaxed")
        graph = torch.cuda.CUDAGraph()
        ifs = branches(False)
        self.capture_s = self._record(engine, graph, ifs, "global")
        if _plan_misses() != misses:
            raise RuntimeError(
                "step program: a route plan was worked out during capture; "
                "the step before it must have filled every plan")
        if any(_nonzero(_host_counted(d)) for d in ifs.delta):
            raise RuntimeError(
                "step program: an IF-node body launched a kernel that does "
                "not count its launches on the device")
        self.delta = _host_counted(self._captured)
        self.branches = ifs if ifs.delta else None
        self.graph = graph

    def settle(self) -> None:
        """Add to the wrappers' ``launches`` what the replays since the
        last settle launched of the kernels that count on the device (one
        host read), and zero those counts."""
        if self.graph is None:
            return
        fns = _device_counted()
        counts = [fn.replayed[self.device.index] for fn in fns]
        for fn, n in zip(fns, torch.cat(counts).tolist()):
            fn.launches += n
        torch._foreach_zero_(counts)

    def run(self, engine) -> None:
        """One step: a replay of the graph on the card (counted in
        ``engine.graph_steps``), else the step uncaptured on the buffers
        (``engine.eager_steps``)."""
        if self.graph is None:
            self._body(engine)
            self.install(engine)
            engine.eager_steps += 1
            return
        self.graph.replay()
        _add(self.delta)
        engine.graph_steps += 1
