"""Build the JAX package's native primitive-integral library once, up front.

``pytdscf_tpu/native`` compiles ``libprimints.so`` with g++ at first use and
writes it in place.  Under pytest-xdist every worker imports
``tests/test_native_primints.py`` at collection, and that module decides
whether to skip itself from ``native.available()``; on a fresh checkout the
workers would all compile at once, and a worker that loads the library
while another is still writing it gets "file too short", records the
failure and skips the whole module.  The controller process (or a run
without xdist) builds the library here, before any worker starts, so every
worker finds a finished file.

The module is loaded by path: importing ``pytdscf_tpu`` would import JAX.
"""

from __future__ import annotations

import importlib.util
import subprocess
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent / "pytdscf_tpu" / "native" / "__init__.py"


def pytest_configure(config):
    if hasattr(config, "workerinput") or not _NATIVE.exists():
        return  # an xdist worker: the controller has built the library
    spec = importlib.util.spec_from_file_location("_pytdscf_native_build", _NATIVE)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    try:
        native.build()
    except (OSError, subprocess.CalledProcessError):
        # no compiler: the module's own available() reports it and skips
        pass
