"""Per-step property evaluation and export.

Mirrors the reference ``Properties`` engine
(``/root/reference/pytdscf/properties.py``): autocorrelation via the T/2
trick, energy, norm, populations, arbitrary observables, reduced densities;
exports ``autocorr.dat`` / ``populations.dat`` / ``expectations.dat`` in the
same text format.  Reduced densities go to a genuinely netCDF4-compatible
file (``util/nc4.py`` writes the netcdf-c HDF5 layout) with the reference's
schema: dims ``step``/``state``/``Q{idof}``, ``time`` variable, compound
``complex128`` ``rho_{key}_{istate}`` variables
(``/root/reference/pytdscf/properties.py:156-209``).

With ``Config.fetch_stride`` > 1 a step's observables stay device tensors
(``TDVPEngine.properties_submit``) until up to ``fetch_stride`` steps are
queued, and :meth:`Properties.flush` reads them all with one packed
device→host copy (``tdvp.fetch_many``) and writes their rows in step
order; :meth:`Properties.run_fused_block` runs a block of steps through
``TDVPEngine.propagate_steps_collect`` and writes its rows after one such
read.  At stride 1 each step's observables are read with one packed copy
(``properties_bundle``).  The rows are the same either way.  An adaptive
run (``Config.adaptive``) also writes ``bonddim.dat``, the bond dimensions
of state 0 before each step, and reads its observables step by step.
"""

from __future__ import annotations

import math
import os
import time as _time
import warnings

import numpy as np

from pytdscf_torch import units
from pytdscf_torch.config import Config
from pytdscf_torch.mps.tdvp import fetch_many
from pytdscf_torch.util.nc4 import NC4Writer


def remain_nleg_from_key(key: tuple[int, ...]) -> tuple[int, ...]:
    """RDM key (sites, repeats=keep both legs) → per-site open-leg counts.

    e.g. (3, 3) → (0, 0, 0, 2); (0, 1) → (1, 1).
    """
    pts = sorted(key, reverse=True)
    legs = [0] * (pts[0] + 1)
    isite = 0
    while pts:
        if isite == pts[-1]:
            legs[isite] += 1
            pts.pop()
        else:
            isite += 1
    if any(not 0 <= leg <= 2 for leg in legs):
        raise ValueError(f"invalid reduced-density key {key}")
    return tuple(legs)


class Properties:
    """Evaluates and exports observables each step."""

    def __init__(
        self,
        engine,
        model,
        config: Config,
        time: float = 0.0,
        t2_trick: bool = True,
        reduced_density=None,
        initial_cores=None,
    ):
        self.engine = engine
        self.model = model
        self.config = config
        self.time = time
        self.nstep = 0
        self.t2_trick = t2_trick
        self.autocorr: complex | None = None
        self.energy: float | None = None
        self.norm: float | None = None
        self.pops: list[float] | None = None
        self.bonddim: list[int] | None = None
        self.expectations: dict[str, complex] = {}
        self._norm_warned = False
        self._t_wall = _time.time()
        #: bra state for the explicit ⟨Ψ(0)|Ψ(t)⟩ autocorrelation.  On
        #: restart runs the caller MUST pass the persisted t=0 cores via
        #: ``initial_cores`` — snapshotting ``engine.cores`` here would
        #: silently continue autocorr.dat against the restart-time state.
        if t2_trick or not hasattr(engine, "cores"):
            self._initial_cores = None
        elif initial_cores is not None:
            self._initial_cores = [
                [engine._put(c) for c in state] for state in initial_cores
            ]
        else:
            self._initial_cores = [
                [c for c in state] for state in engine.cores
            ]
        self.jobdir = config.jobname
        os.makedirs(self.jobdir, exist_ok=True)
        self._files: dict[str, object] = {}
        #: deferred-fetch queue (``Config.fetch_stride`` > 1): per-step
        #: device futures + export intents, flushed in one packed fetch
        self._pending: list[dict] = []
        self._pending_step: dict | None = None

        if reduced_density is not None:
            self.rd_keys = list(reduced_density[0])
            self.rd_step = reduced_density[1]
            self.remain_legs = [remain_nleg_from_key(k) for k in self.rd_keys]
            self.rd_path = os.path.join(self.jobdir, "reduced_density.nc")
            if os.path.exists(self.rd_path):
                os.remove(self.rd_path)
            self._nc_row = 0
            self._nc = w = NC4Writer(self.rd_path)
            nstate = getattr(model, "nstate", 1)
            w.create_dimension("step", None)
            w.create_dimension("state", max(nstate, 1))
            for key in self.rd_keys:
                if key != tuple(sorted(key)):
                    raise ValueError(
                        f"reduced-density key {key} must be ascending"
                    )
                for idof in key:
                    dim = f"Q{idof}"
                    if dim in w._dim_order:
                        continue
                    # rho_{key}_{istate} is exported for EVERY state on the
                    # same Q{idof} dimension, so all states must share the
                    # primitive grid size for exported DOFs
                    grids = {
                        model.basinfo.get_ngrid(ist, idof)
                        for ist in range(max(nstate, 1))
                    }
                    if len(grids) != 1:
                        raise ValueError(
                            f"reduced-density DOF {idof} has state-dependent"
                            f" grid sizes {sorted(grids)}; netCDF export "
                            "requires a shared grid across states"
                        )
                    ngrid = grids.pop()
                    if config.space == "liouville":
                        ngrid = math.isqrt(ngrid)
                    w.create_dimension(dim, ngrid)
            w.create_variable("time", "f8", ("step",))
            for key in self.rd_keys:
                dims = ("step",) + tuple(f"Q{idof}" for idof in key)
                for istate in range(nstate):
                    w.create_variable(
                        f"rho_{key}_{istate}", np.complex128, dims
                    )
        else:
            self.rd_keys = None
            self.rd_step = None
            self.remain_legs = None

    # ------------------------------------------------------------------
    def get_time_display(self) -> float:
        unit = self.config.display_time_unit
        if unit == "au":
            return self.time
        if unit == "fs":
            return self.time * units.au_in_fs
        if unit == "ps":
            return self.time * units.au_in_fs * 1e-3
        raise ValueError(unit)

    def get_properties(
        self,
        *,
        autocorr=True,
        energy=True,
        norm=True,
        populations=True,
        observables=True,
        autocorr_per_step=1,
        energy_per_step=1,
        norm_per_step=1,
        populations_per_step=1,
        observables_per_step=1,
    ) -> None:
        want_ac = autocorr and self.nstep % autocorr_per_step == 0
        want_e = energy and self.nstep % energy_per_step == 0
        want_n = norm and self.nstep % norm_per_step == 0
        want_p = populations and self.nstep % populations_per_step == 0
        want_obs = (
            observables
            and self.nstep % observables_per_step == 0
            and bool(self.model.observables)
        )
        want_rd = (
            self.rd_keys is not None and self.nstep % self.rd_step == 0
        )
        if (
            self.config.fetch_stride > 1
            and hasattr(self.engine, "properties_submit")
            and (not want_ac or self.t2_trick)
            and (want_ac or want_e or want_n or want_p)
            # observables-dict / reduced-density / adaptive-bonddim
            # evaluations sync the device anyway — run those steps inline
            and not want_obs
            and not want_rd
            and not self.config.adaptive
        ):
            items, plan = self.engine.properties_submit(
                self.model.hamiltonian,
                autocorr=want_ac, energy=want_e,
                norm=want_n, populations=want_p,
            )
            self.bonddim = (
                self.engine.bond_dims()
                if hasattr(self.engine, "bond_dims")
                else None
            )
            self._pending_step = {
                "nstep": self.nstep,
                "t": self.get_time_display(),
                "items": items,
                "plan": plan,
                "wants": (want_ac, want_e, want_n, want_p),
                "bonddim": self.bonddim,
            }
            return
        self.flush()
        bundled = False
        if (
            hasattr(self.engine, "properties_bundle")
            and (not want_ac or self.t2_trick)
            and (want_ac or want_e or want_n or want_p)
        ):
            # one packed device→host read instead of one per property
            out = self.engine.properties_bundle(
                self.model.hamiltonian,
                autocorr=want_ac, energy=want_e,
                norm=want_n, populations=want_p,
            )
            if want_ac:
                self.autocorr = out["autocorr"]
            if want_e:
                self.energy = out["energy"].real
            if want_n:
                self.norm = out["norm"]
            if want_p:
                self.pops = out["populations"]
            bundled = True
        if want_ac and not bundled:
            if self.t2_trick:
                self.autocorr = self.engine.autocorr()
            elif self._initial_cores is not None and hasattr(
                self.engine, "overlap_conj"
            ):
                # explicit ⟨Ψ(0)|Ψ(t)⟩ (reference's non-T/2 path,
                # properties.py:212-230)
                save = self.engine.cores
                self.engine.cores = self._initial_cores
                try:
                    self.autocorr = self.engine.overlap_conj(save)
                finally:
                    self.engine.cores = save
            else:
                self.autocorr = None
        if want_e and not bundled:
            self.energy = self.engine.expectation(self.model.hamiltonian).real
        if want_n:
            if not bundled:
                self.norm = self.engine.norm()
            self._check_norm_drift(self.nstep)
        if want_p and not bundled:
            self.pops = self.engine.pop_states()
        if observables and self.nstep % observables_per_step == 0:
            for name, op in self.model.observables.items():
                self.expectations[name] = self.engine.expectation(op)
        if self.rd_keys is not None and self.nstep % self.rd_step == 0:
            self._export_reduced_density()
        if hasattr(self.engine, "bond_dims"):
            self.bonddim = self.engine.bond_dims()

    # ------------------------------------------------------------------
    def _dat(self, name: str, header: str):
        if name not in self._files:
            f = open(os.path.join(self.jobdir, f"{name}.dat"), "w")
            f.write(header + "\n")
            self._files[name] = f
        return self._files[name]

    def export_properties(
        self,
        *,
        autocorr_per_step=1,
        populations_per_step=1,
        observables_per_step=1,
    ) -> None:
        if self._pending_step is not None:
            # this step's values are still device futures — record the
            # export intent; rows are written (in step order) at flush
            rec = self._pending_step
            self._pending_step = None
            rec["export"] = (
                autocorr_per_step, populations_per_step, observables_per_step
            )
            self._pending.append(rec)
            if len(self._pending) >= self.config.fetch_stride:
                self.flush()
            return
        self._write_rows(
            self.get_time_display(),
            self.nstep,
            self.autocorr,
            self.pops,
            self.bonddim,
            self.expectations,
            autocorr_per_step,
            populations_per_step,
            observables_per_step,
        )

    def flush(self) -> None:
        """Resolve all deferred steps with ONE packed device fetch and
        write their .dat rows in step order."""
        if self._pending_step is not None:
            # get_properties deferred but export was never called (final
            # partial step) — export everything due
            rec = self._pending_step
            self._pending_step = None
            rec["export"] = (1, 1, 1)
            self._pending.append(rec)
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        items = [it for rec in pending for it in rec["items"]]
        vals = fetch_many(items, self.engine.fetch_real_dtype())
        k = 0
        for rec in pending:
            n = len(rec["items"])
            want_ac, want_e, want_n, want_p = rec["wants"]
            out = self.engine.properties_resolve(
                vals[k:k + n], rec["plan"],
                norm=want_n, populations=want_p,
            )
            k += n
            if want_ac:
                self.autocorr = out["autocorr"]
            if want_e:
                self.energy = out["energy"].real
            if want_n:
                self.norm = out["norm"]
                self._check_norm_drift(rec["nstep"])
            if want_p:
                self.pops = out["populations"]
            self._write_rows(
                rec["t"], rec["nstep"],
                self.autocorr if want_ac else None,
                self.pops if want_p else None,
                rec["bonddim"], {}, *rec["export"],
            )

    def run_fused_block(
        self,
        dt_au: float,
        nsteps: int,
        *,
        autocorr: bool,
        energy: bool,
        norm: bool,
        populations: bool,
        export: tuple[int, int, int] = (1, 1, 1),
    ) -> None:
        """Propagate ``nsteps`` as ONE block and write the per-step .dat
        rows.

        Wraps ``TDVPEngine.propagate_steps_collect``: each step collects
        its PRE-step observables on the device (on the card inside the
        replayed step graph), then the block is resolved with one packed
        fetch — rows are identical to the per-step driver, and the host
        reads the device once per block instead of once per step."""
        self.flush()
        items, plan = self.engine.propagate_steps_collect(
            dt_au, nsteps,
            operator=self.model.hamiltonian,
            autocorr=autocorr, energy=energy,
            norm=norm, populations=populations,
        )
        bonddim = (
            self.engine.bond_dims()
            if hasattr(self.engine, "bond_dims")
            else None
        )
        vals = fetch_many(items, self.engine.fetch_real_dtype())
        for t in range(nsteps):
            out = self.engine.properties_resolve(
                [v[t] for v in vals], plan,
                norm=norm, populations=populations,
            )
            if autocorr:
                self.autocorr = out["autocorr"]
            if energy:
                self.energy = out["energy"].real
            if norm:
                self.norm = out["norm"]
                self._check_norm_drift(self.nstep)
            if populations:
                self.pops = out["populations"]
            self.bonddim = bonddim
            self._write_rows(
                self.get_time_display(), self.nstep,
                self.autocorr if autocorr else None,
                self.pops if populations else None,
                bonddim, {}, *export,
            )
            self.update(dt_au)

    def _check_norm_drift(self, nstep: int) -> None:
        if (
            self.config.conserve_norm
            and self.config.space == "hilbert"
            and not self._norm_warned
            and abs(self.norm - 1.0) > 1.0e-05
        ):
            warnings.warn(
                f"norm drift detected: |Psi| = {self.norm:.10f} at step "
                f"{nstep} (reference warns likewise, "
                "properties.py:366-373)"
            )
            self._norm_warned = True

    def _write_rows(
        self,
        t: float,
        nstep: int,
        autocorr,
        pops,
        bonddim,
        expectations,
        autocorr_per_step=1,
        populations_per_step=1,
        observables_per_step=1,
    ) -> None:
        unit = self.config.display_time_unit
        if autocorr is not None and nstep % autocorr_per_step == 0:
            f = self._dat("autocorr", f"# time [{unit}]\t auto-correlation")
            td = t * 2 if self.t2_trick else t
            a = autocorr
            f.write(f"{td:6.9f}\t{a.real: 6.9f}{a.imag:+6.9f}j\n")
            f.flush()
        if pops is not None and nstep % populations_per_step == 0:
            f = self._dat(
                "populations",
                f"# time [{unit}]\t"
                + "\t".join(f"pop_{i}" for i in range(len(pops))),
            )
            f.write(
                f"{t:6.9f}\t" + "\t".join(f"{p:6.9f}" for p in pops) + "\n"
            )
            f.flush()
        if bonddim is not None and self.config.adaptive:
            f = self._dat(
                "bonddim",
                f"# time [{unit}]\t" + "\t".join(
                    f"bond_{i}" for i in range(len(bonddim))
                ),
            )
            f.write(
                f"{t:6.9f}\t"
                + "\t".join(str(b) for b in bonddim) + "\n"
            )
            f.flush()
        if expectations and nstep % observables_per_step == 0:
            f = self._dat(
                "expectations",
                f"# time [{unit}]\t"
                + "\t".join(expectations.keys()),
            )
            f.write(
                f"{t:6.9f}\t"
                + "\t".join(f"{v.real:6.9f}" for v in expectations.values())
                + "\n"
            )
            f.flush()

    def _export_reduced_density(self) -> None:
        row = self._nc_row
        self._nc.append_row("time", row, self.get_time_display())
        nstate = getattr(self.model, "nstate", 1)
        for key, legs in zip(self.rd_keys, self.remain_legs):
            for istate in range(nstate):
                rho = self.engine.reduced_density(legs, istate=istate)
                self._nc.append_row(f"rho_{key}_{istate}", row, rho)
        self._nc_row += 1

    def update(self, dt_au: float) -> None:
        self.time += dt_au
        self.nstep += 1

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
