"""Run a JAX test's own body against the port.

:func:`ported` rebinds a test function of the JAX package's suite (or one
of its helpers) so that every name its module imported from
``pytdscf_tpu`` (a module, class or function) refers to the port's
object of the same module path and name, and ``Simulator`` to the port's
on the CPU.  The body, its literals and its tolerances stay the JAX
test's own; helpers it calls that are not rebound (the dense references
assembled from published constants) stay the JAX suite's.
:func:`ported_source` does the same for a body that imports its names
inside itself, by recompiling its source.  Importing a JAX test module
imports JAX: call these inside a test, never at import.
"""

from __future__ import annotations

import functools
import importlib
import types

JAX_PKG, PORT_PKG = "pytdscf_tpu", "pytdscf_torch"


def port_object(value):
    """The port's counterpart of a ``pytdscf_tpu`` module, class or
    function, or ``value`` itself if it is none of these."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
        if name == JAX_PKG or name.startswith(JAX_PKG + "."):
            return importlib.import_module(PORT_PKG + name[len(JAX_PKG):])
        return value
    module = getattr(value, "__module__", None) or ""
    if module == JAX_PKG or module.startswith(JAX_PKG + "."):
        port = importlib.import_module(PORT_PKG + module[len(JAX_PKG):])
        return getattr(port, value.__qualname__)
    return value


def ported(fn, **names):
    """``fn`` with its module's ``pytdscf_tpu`` names rebound to the
    port's, ``Simulator`` on the CPU, and ``names`` on top."""
    from pytdscf_torch.simulator import Simulator

    scope = {key: port_object(val) for key, val in fn.__globals__.items()}
    if "Simulator" in scope:
        scope["Simulator"] = functools.partial(Simulator, device="cpu")
    scope.update(names)
    return types.FunctionType(fn.__code__, scope, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def ported_source(fn):
    """``fn`` recompiled from its source with the package name replaced
    by the port's: :func:`ported` for a body that imports its
    ``pytdscf_tpu`` names inside itself."""
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(fn)).replace(JAX_PKG, PORT_PKG)
    scope = {key: port_object(val) for key, val in fn.__globals__.items()}
    exec(compile(src, inspect.getsourcefile(fn), "exec"), scope)
    return scope[fn.__name__]


def fused_digest(package: str, builder: str, kwargs: dict) -> list:
    """Build a model with ``pytdscf_{package}.models.{builder}(**kwargs)``
    and return each fused MPO core's (shape, dtype, SHA-256 of its bytes):
    a bit-for-bit fingerprint of a model too large to ship between
    processes.  Runs in a worker process."""
    import hashlib

    import numpy as np

    module, name = builder.rsplit(".", 1)
    built = getattr(importlib.import_module(
        f"pytdscf_{package}.models.{module}"), name)(**kwargs)
    basis, ham = built[0], built[1]
    return [(tuple(c.shape), str(c.dtype),
             hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest())
            for c in ham.fused_mpo([b.nprim for b in basis])[0][0]]


def one_blas_thread():
    """A context in which numpy's and scipy's BLAS run one thread: the
    suite's workers share the machine's cores, and a multi-threaded
    BLAS under that contention turns a model builder's thousands of
    small SVDs from seconds into minutes.  Without threadpoolctl (the GPU
    machine) it leaves the threads as they are."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        import contextlib

        return contextlib.nullcontext()
    return threadpool_limits(limits=1)
