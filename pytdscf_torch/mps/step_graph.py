"""One TDVP step as a program over fixed buffers, replayed as a CUDA graph.

The counterpart of the compiled loop of the JAX package's fused driver
(``TDVPEngine.propagate_steps``): there XLA compiles a block of steps into
one device program; here one whole step (both half-sweeps, and with
``collect`` the pre-step observables) is recorded once as a
``torch.cuda.CUDAGraph`` and replayed, so a step costs one graph launch
instead of the host's launch of each of its kernels and torch operations.

The carry, the state one step maps onto the next, lives in fixed buffers:
the cores, the right environment stack (blocks and log-scales), the
device-side Krylov telemetry and, in ``pytest_enabled`` runs, the gauge
deviation.  A recorded step reads the buffers and ends by copying its new
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

Python-side counters advance once, at capture: the kernel wrappers'
launch counters and the engine's Krylov call counts.  The program records
what one captured step added to each, takes it back (the capture ran no
kernel), and adds it at every replay, so the counters read the same
whichever way a step ran.
"""

from __future__ import annotations

import copy
import time

import torch

#: the per-wrapper counters that a step may advance
_COUNTS = ("launches", "plain_calls", "route_launches", "cluster_launches")
#: the engine's host-side counts of a step (``krylov_stats``)
_ENGINE_COUNTS = ("_kry_calls", "_kry_relaxed")


def _wrappers() -> tuple:
    """Every kernel wrapper with launch counters."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import cuda_site as CS

    return (CL.lanczos_expm, CQ.mgs_qr, CS.site_step_fused, CM.heff_lo,
            CM.keff_lo, CR.renorm_hi, CR.matvec_hi)


def _plans() -> tuple:
    """The per-shape plan caches a launch reads."""
    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_site as CS

    return CL.plan, CS.plan, CS.route


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


def _carry(engine) -> list:
    """The engine's step carry as a flat list: cores, environment blocks,
    their log-scales, the Krylov telemetry and, in ``pytest_enabled``
    runs, the gauge deviation (None where the engine holds none yet)."""
    out = [*engine.cores[0]]
    out += [block for block, _ in engine.env_stack]
    out += [log for _, log in engine.env_stack]
    out.append(engine._kry_sum)
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
        n = engine.nsite
        b = self.buffers
        engine.cores = [list(b[:n])]
        engine.env_stack = list(zip(b[n:2 * n], b[2 * n:3 * n]))
        engine._env_side = "right"
        engine._kry_sum = b[3 * n]
        engine._gauge_dev = b[3 * n + 1] if engine.config.pytest_enabled \
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

    def capture(self, engine) -> None:
        """Record one step as a CUDA graph in a private memory pool."""
        before = _counts(engine)
        misses = _plan_misses()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self._body(engine)
            self.capture_s = time.perf_counter() - t0
            after = _counts(engine)
        finally:
            # the capture ran no kernel: no count advanced, and the state
            # is the buffers' as before it
            _restore(before)
            self.install(engine)
        if _plan_misses() != misses:
            raise RuntimeError(
                "step program: a route plan was worked out during capture; "
                "the step before it must have filled every plan")
        self.delta = _diff(after, before)
        self.graph = graph

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
