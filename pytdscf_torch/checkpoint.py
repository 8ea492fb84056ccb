"""Wavefunction checkpoint / resume.

Replaces the reference's dill-pickle wavefunction backups
(``/root/reference/pytdscf/simulator_cls.py:577-589``).  The port writes
and reads the pickle format of the JAX package's checkpoints (a payload of
numpy arrays, e.g. ``{"cores": ...}``), so either package resumes the
other's ``.pkl`` files.  The JAX package's orbax pytree checkpointer is not
ported (ROADMAP A14).
"""

from __future__ import annotations

import os
import pickle
from typing import Any


def _orbax_not_ported(what: str):
    return NotImplementedError(
        f"{what}: orbax checkpoints are not ported yet (ROADMAP A14); the "
        "port writes and reads the pickle format"
    )


def save_wavefunction(
    payload: dict[str, Any], path: str, backend: str = "pickle"
) -> str:
    """Save a wavefunction payload; returns the path actually written.

    ``payload`` is a pytree of numpy arrays (e.g. ``{"cores": ...}``).
    ``backend``: "pickle" ("auto" means pickle here; "orbax" raises).
    """
    if backend == "orbax":
        raise _orbax_not_ported("backend='orbax'")
    if backend not in ("auto", "pickle"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def load_wavefunction(path: str) -> dict[str, Any]:
    """Load a payload written by :func:`save_wavefunction`."""
    if path.endswith(".ckpt") or os.path.isdir(path):
        raise _orbax_not_ported(f"reading {path}")
    with open(path, "rb") as f:
        return pickle.load(f)


def resolve_checkpoint(path_base: str) -> str | None:
    """Find an existing checkpoint for a base path (either format)."""
    for cand in (path_base, path_base.removesuffix(".pkl") + ".ckpt"):
        if os.path.exists(cand):
            return cand
    return None
