"""Per-job logging (stdlib logging; replaces the reference's loguru sinks)."""

from __future__ import annotations

import logging
import os

_LOGGERS: dict[str, logging.Logger] = {}


def _process_index() -> int:
    """Multi-host process index (the reference's MPI rank analogue): the
    port runs one process (the multi-device engines are ROADMAP A13)."""
    return 0


def get_logger(jobname: str, verbose: int = 2) -> logging.Logger:
    """Logger writing to ``{jobname}/main.log`` (and stderr at high verbose).

    Under multi-host SPMD each process writes its own sink
    ``main.r{process_index}.log`` — the reference's per-MPI-rank log files
    (``/root/reference/pytdscf/_helper.py`` rank-aware sinks) re-expressed
    for a multi-process runtime."""
    if jobname in _LOGGERS:
        return _LOGGERS[jobname]
    logger = logging.getLogger(f"pytdscf_torch.{jobname}")
    logger.setLevel(logging.DEBUG if verbose > 2 else logging.INFO)
    logger.propagate = False
    os.makedirs(jobname, exist_ok=True)
    rank = _process_index()
    fname = "main.log" if rank == 0 else f"main.r{rank}.log"
    handler = logging.FileHandler(os.path.join(jobname, fname), mode="w")
    handler.setFormatter(
        logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
    )
    logger.addHandler(handler)
    if verbose > 3:
        logger.addHandler(logging.StreamHandler())
    _LOGGERS[jobname] = logger
    return logger
