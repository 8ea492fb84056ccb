"""PES mesh generation and parallel ab-initio execution.

Functional parity with ``PyTDSCF:pytdscf/ase_handler.py`` (``DVR_Mesh``
building nMR displacement meshes from DVR grids + displacement vectors,
storing geometries, and running electronic-structure jobs concurrently with
timeout/retry).  Differences by design:

* storage is a plain SQLite table ``grid_pes`` (no ASE dependency); the
  reader (:func:`pytdscf_torch.operators.dvr.database_to_dataframe`) also
  understands ASE SQLite files for interoperability;
* the calculator is any callable ``f(coords) -> float | (float, dipole)``
  (an ASE calculator can be wrapped in one line); jobs run in a
  ``ProcessPoolExecutor`` with per-job timeout and bounded retries.
"""

from __future__ import annotations

import itertools
import json
import sqlite3
import time
from concurrent.futures import ProcessPoolExecutor, TimeoutError as _Timeout
from typing import Callable

import numpy as np

import logging

from pytdscf_torch.basis.abc import DVRPrimitivesMixin
from pytdscf_torch.operators.dvr import to_dbkey

logger = logging.getLogger("pytdscf_torch.ase_handler")


class DVR_Mesh:
    """nMR displacement mesh over DVR grids.

    Args:
        dvr_prims: DVR primitive per DOF (grids in mass-weighted a.u.).
        reference_geometry: (natom, 3) Cartesian reference, any unit.
        displacement_vectors: ``disp[idof]`` is the (natom, 3) Cartesian
            displacement per unit mass-weighted coordinate of that DOF.
    """

    def __init__(
        self,
        dvr_prims: list[DVRPrimitivesMixin],
        reference_geometry: np.ndarray | None = None,
        displacement_vectors: np.ndarray | None = None,
    ):
        self.dvr_prims = dvr_prims
        self.ndof = len(dvr_prims)
        self.grids = [np.asarray(p.get_grids()) for p in dvr_prims]
        self.reference_geometry = (
            np.asarray(reference_geometry)
            if reference_geometry is not None
            else None
        )
        self.displacement_vectors = (
            np.asarray(displacement_vectors)
            if displacement_vectors is not None
            else None
        )
        self.zero_indices = [
            int(np.argmin(np.abs(g))) for g in self.grids
        ]
        for idof, g in enumerate(self.grids):
            if abs(g[self.zero_indices[idof]]) > 1.0e-08:
                logger.warning(
                    f"DOF {idof}: nearest grid to 0 is "
                    f"{g[self.zero_indices[idof]]:.2e} (nMR reference point)"
                )

    # ------------------------------------------------------------------
    def mesh_points(self, nMR: int = 3) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
        """All (dofs, grid-index tuple) pairs of the ≤nMR displacement mesh.

        The full index tuple has every undisplaced DOF at its zero index.
        """
        points: list[tuple[tuple[int, ...], tuple[int, ...]]] = []
        seen: set[tuple[int, ...]] = set()
        zero = tuple(self.zero_indices)
        points.append(((), zero))
        seen.add(zero)
        for order in range(1, nMR + 1):
            for dofs in itertools.combinations(range(self.ndof), order):
                ranges = [range(len(self.grids[d])) for d in dofs]
                for combo in itertools.product(*ranges):
                    full = list(zero)
                    for d, i in zip(dofs, combo):
                        full[d] = i
                    key = tuple(full)
                    if key in seen:
                        continue
                    seen.add(key)
                    points.append((dofs, key))
        return points

    def coordinates(self, grid_idx: tuple[int, ...]) -> np.ndarray:
        """Cartesian geometry of one mesh point (needs ref + disp vectors)."""
        if self.reference_geometry is None or self.displacement_vectors is None:
            raise ValueError("reference geometry / displacement vectors unset")
        geo = np.array(self.reference_geometry, dtype=float)
        for d, i in enumerate(grid_idx):
            geo = geo + self.grids[d][i] * self.displacement_vectors[d]
        return geo

    def save_geoms(self, db: str, nMR: int = 3) -> int:
        """Create the database and insert all pending mesh geometries."""
        con = _open_db(db)
        n_new = 0
        with con:
            for dofs, grid_idx in self.mesh_points(nMR):
                q = tuple(
                    float(self.grids[d][i]) for d, i in enumerate(grid_idx)
                )
                cur = con.execute(
                    "INSERT OR IGNORE INTO grid_pes "
                    "(grids, dofs, coords, energy, dipole, status) "
                    "VALUES (?, ?, ?, NULL, NULL, 'pending')",
                    (to_dbkey(grid_idx), to_dbkey(dofs), json.dumps(q)),
                )
                n_new += cur.rowcount
        con.close()
        logger.info(f"saved {n_new} new mesh geometries to {db}")
        return n_new

    # ------------------------------------------------------------------
    def execute_multiproc(
        self,
        calculator: Callable,
        db: str,
        max_workers: int = 4,
        timeout: float = 3600.0,
        max_retry: int = 2,
        judge_func: Callable[[float], bool] | None = None,
    ) -> int:
        """Evaluate every pending mesh point with ``calculator`` in parallel.

        ``calculator(q_tuple)`` receives the mass-weighted displacement
        coordinates and returns an energy [Hartree] or ``(energy, dipole)``.
        Failed / timed-out jobs are retried up to ``max_retry`` times and
        left 'failed' after that; ``judge_func(energy)`` can reject results
        (e.g. SCF non-convergence sentinels).
        """
        con = _open_db(db)
        pending = [
            (key, json.loads(coords))
            for key, coords in con.execute(
                "SELECT grids, coords FROM grid_pes WHERE status != 'done'"
            )
        ]
        con.close()
        logger.info(f"{len(pending)} pending grid points")
        ndone = 0
        with ProcessPoolExecutor(max_workers=max_workers) as pool:
            queue = {
                key: (pool.submit(calculator, tuple(q)), tuple(q), 0)
                for key, q in pending
            }
            while queue:
                finished: list[str] = []
                retry: list[str] = []
                for key, (fut, q, nfail) in queue.items():
                    try:
                        result = fut.result(timeout=timeout if fut.done() else 0.01)
                    except _Timeout:
                        continue
                    except Exception as exc:  # job crashed
                        logger.warning(f"grid {key}: {exc!r}")
                        retry.append(key)
                        continue
                    energy, dipole = (
                        result if isinstance(result, tuple) else (result, None)
                    )
                    if judge_func is not None and not judge_func(energy):
                        retry.append(key)
                        continue
                    _write_result(db, key, energy, dipole)
                    ndone += 1
                    finished.append(key)
                for key in finished:
                    del queue[key]
                for key in retry:
                    fut, q, nfail = queue.pop(key)
                    if nfail + 1 <= max_retry:
                        queue[key] = (pool.submit(calculator, q), q, nfail + 1)
                    else:
                        logger.warning(f"grid {key}: giving up after {nfail + 1} tries")
                        _mark_failed(db, key)
                if queue:
                    time.sleep(0.02)
        logger.info(f"completed {ndone} grid points")
        return ndone


def _open_db(db: str) -> sqlite3.Connection:
    con = sqlite3.connect(db, timeout=60.0)
    con.execute(
        "CREATE TABLE IF NOT EXISTS grid_pes ("
        " grids TEXT PRIMARY KEY, dofs TEXT, coords TEXT,"
        " energy REAL, dipole TEXT, status TEXT)"
    )
    return con


def _write_result(db: str, key: str, energy: float, dipole) -> None:
    con = _open_db(db)
    with con:
        con.execute(
            "UPDATE grid_pes SET energy=?, dipole=?, status='done' "
            "WHERE grids=?",
            (
                float(energy),
                json.dumps(np.asarray(dipole).tolist())
                if dipole is not None
                else None,
                key,
            ),
        )
    con.close()


def _mark_failed(db: str, key: str) -> None:
    con = _open_db(db)
    with con:
        con.execute(
            "UPDATE grid_pes SET status='failed' WHERE grids=?", (key,)
        )
    con.close()
