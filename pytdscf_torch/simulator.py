"""Simulator: the user-facing entry point (relax / operate / propagate), in PyTorch.

The counterpart of the JAX package's ``simulator.py`` for the MPS of the
ported engine, of one or several electronic states (one MPS per state, a
fused MPO per coupled state pair): ``Simulator(jobname, model).relax(...)``,
``.operate(...)`` and ``.propagate(...)`` with the same signatures, time
units (fs), jobname conventions (``{jobname}_relax``, ``_operate``,
``_prop``), wavefunction backup files (``wf_{jobname}_gs.pkl`` after
``relax``, ``wf_{jobname}_operate.pkl`` after ``operate``, which
``propagate(restart=True)`` reads), ``.dat`` outputs and return values
(``(energy, wavefunction)``, ``operate``: ``(norm, wavefunction)``).  It
takes ``device``, the card unless the caller asks for the CPU, and
computes in complex64 on the card and complex128 on the CPU unless
``dtype`` says otherwise.  The IR-spectrum workflow (relax, apply the
dipole μ·E, propagate, Fourier-transform the autocorrelation with
``spectra``) runs whole.  ``proj_gs`` starts each vibration from the
ground state of ``model.primbas_gs`` projected onto the state's own
primitives, and ``model.ints_prim_file`` caches the primitive-integral
tables (``basis.primints.PrimInts``) as a pickle.

What is not ported raises ``NotImplementedError`` naming its ROADMAP item:
adaptive bond dimension (A9), the 4th-order splittings, one-site gates,
Kraus maps and time-dependent Hamiltonians (A10), MCTDH, the MPS-MCTDH
hybrid and CMF (A12), and the multi-device engines (A13).  The JAX package's advisory about small models
on a TPU is not carried over.

``fetch_stride`` (default 16 in complex64, 1 in complex128) runs the
JAX package's fused block driver: each ``fetch_stride``-long block of steps
goes through ``TDVPEngine.propagate_steps_collect`` (on the card, replays
of one step recorded as a CUDA graph) and its rows are written after one
packed device→host read (``Properties.run_fused_block``).  A block never
spans a backup step, and a block of one step runs inline with its
observables deferred to the next flush.
"""

from __future__ import annotations

import os
from typing import Any, Literal

import numpy as np
import torch

from pytdscf_torch import units
from pytdscf_torch._logging import get_logger
from pytdscf_torch.checkpoint import (
    load_wavefunction,
    resolve_checkpoint,
    save_wavefunction,
)
from pytdscf_torch.config import Config
from pytdscf_torch.diagnostics import Diagnostics
from pytdscf_torch.model import Model
from pytdscf_torch.mps.lattice import alloc_hartree_product
from pytdscf_torch.mps.tdvp import TDVPEngine
from pytdscf_torch.properties import Properties


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class WaveFunction:
    """Thin user-facing wrapper around the TDVP engine state."""

    def __init__(self, engine: TDVPEngine, model: Model):
        self.engine = engine
        self.model = model

    def expectation(self, op=None) -> float:
        return self.engine.expectation(op).real

    def autocorr(self) -> complex:
        return self.engine.autocorr()

    def norm(self) -> float:
        return self.engine.norm()

    def pop_states(self) -> list[float]:
        return self.engine.pop_states()

    def bonddim(self) -> list[int]:
        return self.engine.bond_dims()

    def get_reduced_densities(self, remain_nleg) -> np.ndarray:
        return self.engine.reduced_density(remain_nleg)


class Simulator:
    """Drive MPS quantum dynamics built from a :class:`Model`.

    ``device``: where the engine runs, the card unless the caller asks for
    the CPU (without a card, ``propagate`` raises)."""

    def __init__(
        self,
        jobname: str,
        model: Model,
        ci_type: str = "mps",
        backend: Literal["jax", "numpy"] = "numpy",
        proj_gs: bool = False,
        t2_trick: bool = True,
        verbose: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.jobname = jobname
        self.model = model
        self.t2_trick = t2_trick
        self.verbose = verbose
        self.checkpoint_backend = "pickle"
        self.backend = backend  # accepted for API parity
        self.device = torch.device(device)
        self.ci_type = ci_type.lower()
        if self.ci_type in ("standard-method", "sm"):
            self.ci_type = "mps"
        if self.ci_type not in ("mps", "mctdh"):
            raise NotImplementedError(f"unknown ci_type {ci_type}")
        self.proj_gs = proj_gs

    # ------------------------------------------------------------------
    def propagate(
        self,
        stepsize: float = 0.1,
        maxstep: int = 5000,
        restart: bool = False,
        savefile_ext: str = "",
        loadfile_ext: str = "_operate",
        backup_interval: int = 1000,
        autocorr: bool = True,
        energy: bool = True,
        norm: bool = True,
        populations: bool = True,
        observables: bool = False,
        reduced_density=None,
        Δt: float | None = None,
        thresh_sil: float = 1.0e-09,
        autocorr_per_step: int = 1,
        observables_per_step: int = 1,
        energy_per_step: int = 1,
        norm_per_step: int = 1,
        populations_per_step: int = 1,
        parallel_split_indices=None,
        bond_tp_devices: int | None = None,
        adaptive: bool = False,
        adaptive_Dmax: int = 20,
        adaptive_dD: int = 5,
        adaptive_p_proj: float = 1.0e-04,
        adaptive_p_svd: float = 1.0e-07,
        adaptive_masked: bool = False,
        integrator: Literal["lanczos", "arnoldi"] = "lanczos",
        matvec_precision: Literal["highest", "high", "default"] = "highest",
        display_time_unit: Literal["fs", "ps", "au"] = "fs",
        conserve_norm: bool = True,
        cmf: bool = False,
        tol_cmf: float = 1.0e-14,
        max_stepsize: float = 0.010,
        dtype: str | None = None,
        fetch_stride: int | None = None,
        splitting: Literal["lt2", "suzuki4", "yoshida4"] = "lt2",
        precision_preset: str | None = None,
    ) -> tuple[Any, WaveFunction]:
        if parallel_split_indices is not None or bond_tp_devices is not None:
            raise _not_ported(
                "parallel_split_indices / bond_tp_devices (the multi-device "
                "engines)", "A13")
        if adaptive:
            raise _not_ported("adaptive bond dimension", "A9")
        if cmf:
            raise _not_ported("CMF propagation (MCTDH)", "A12")
        if splitting != "lt2":
            raise _not_ported(f"splitting={splitting!r}", "A10")
        dt_au = (Δt if Δt is not None else stepsize) / units.au_in_fs
        dtype_eff = dtype or self._auto_dtype()
        if fetch_stride is None:
            # one packed read per 16 steps on the card; the CPU reads its
            # own memory, and complex128 runs keep the per-step loop
            fetch_stride = 1 if dtype_eff == "complex128" else 16
        if dtype_eff == "complex64" and thresh_sil < 1.0e-07:
            # f32 cannot resolve the default 1e-9 Krylov convergence test;
            # leaving it saturates every local update at max_krylov
            thresh_sil = 1.0e-07
        config = Config(
            jobname=self.jobname + "_prop",
            dtype=dtype_eff,
            relax="none",
            integrator=integrator,
            thresh_exp=thresh_sil,
            space=self.model.space,
            conserve_norm=conserve_norm,
            matvec_precision=matvec_precision,
            display_time_unit=display_time_unit,
            splitting=splitting,
            fetch_stride=fetch_stride,
        )
        if precision_preset is not None:
            # accuracy/throughput rungs (Config.with_precision_preset);
            # applied last so it overrides matvec_precision
            config = config.with_precision_preset(precision_preset)
        return self._execute(
            config,
            dt_au,
            maxstep,
            restart=restart,
            savefile_ext=savefile_ext,
            loadfile_ext=loadfile_ext,
            backup_interval=backup_interval,
            autocorr=autocorr,
            energy=energy,
            norm=norm,
            populations=populations,
            observables=observables,
            reduced_density=reduced_density,
            autocorr_per_step=autocorr_per_step,
            observables_per_step=observables_per_step,
            energy_per_step=energy_per_step,
            norm_per_step=norm_per_step,
            populations_per_step=populations_per_step,
        )

    def relax(
        self,
        stepsize: float = 0.1,
        maxstep: int = 20,
        improved: bool = True,
        restart: bool = False,
        savefile_ext: str = "_gs",
        loadfile_ext: str = "",
        backup_interval: int = 10,
        norm: bool = True,
        populations: bool = True,
        observables: bool = False,
        integrator: Literal["lanczos", "arnoldi"] = "lanczos",
        matvec_precision: Literal["highest", "high", "default"] = "highest",
        display_time_unit: Literal["fs", "ps", "au"] = "fs",
    ) -> tuple[Any, WaveFunction]:
        """Relax to the ground state: improved relaxation (each site the
        lowest eigenvector of H_eff, ``Config.relax="improved"``) or
        imaginary time (``"imaginary"``), ``maxstep`` sweeps of
        ``stepsize`` fs, one host-driven step at a time (``fetch_stride``
        1, as in the JAX package).  Saves ``wf_{jobname}{savefile_ext}.pkl``
        and returns the last ⟨H⟩ with the wavefunction."""
        dt_au = stepsize / units.au_in_fs
        config = Config(
            jobname=self.jobname + "_relax",
            dtype=self._auto_dtype(),
            relax="improved" if improved else "imaginary",
            integrator=integrator,
            matvec_precision=matvec_precision,
            space=self.model.space,
            display_time_unit=display_time_unit,
        )
        return self._execute(
            config,
            dt_au,
            maxstep,
            restart=restart,
            savefile_ext=savefile_ext,
            loadfile_ext=loadfile_ext,
            backup_interval=backup_interval,
            autocorr=False,
            energy=True,
            norm=norm,
            populations=populations,
            observables=observables,
        )

    def operate(
        self,
        maxstep: int = 10,
        restart: bool = False,
        savefile_ext: str = "_operate",
        loadfile_ext: str = "_gs",
        verbose: int = 2,
    ) -> tuple[float, WaveFunction]:
        """Apply the model's operator (the dipole μ·E of an IR spectrum) to
        the wavefunction by variational fitting (``TDVPEngine.
        apply_operator_fit``, at most ``maxstep`` pairs of sweeps).  Saves
        ``wf_{jobname}{savefile_ext}.pkl`` and returns ‖O|Ψ⟩‖ with the
        (normalised) fitted wavefunction."""
        config = Config(
            jobname=self.jobname + "_operate",
            dtype=self._auto_dtype(),
            apply_dipole=True,
            space=self.model.space,
        )
        logger = get_logger(config.jobname, verbose)
        engine = self._initial_engine(config, restart, loadfile_ext)
        logger.info("Start: apply operator to wave function")
        norm = engine.apply_operator_fit(self.model.hamiltonian, maxiter=maxstep)
        wf = WaveFunction(engine, self.model)
        self._save(engine, config.jobname, savefile_ext)
        logger.info("End  : apply operator to wave function")
        return norm, wf

    # ------------------------------------------------------------------
    def _auto_dtype(self) -> str:
        """complex128 on the CPU, complex64 on the card (the kernels take
        complex64)."""
        return "complex128" if self.device.type == "cpu" else "complex64"

    def _initial_engine(
        self,
        config: Config,
        restart: bool,
        loadfile_ext: str,
    ):
        def _restart_payload():
            path = resolve_checkpoint(f"wf_{self.jobname}{loadfile_ext}.pkl")
            if path is None:
                raise FileNotFoundError(
                    f"no wavefunction checkpoint wf_{self.jobname}"
                    f"{loadfile_ext}.pkl/.ckpt"
                )
            return load_wavefunction(path)

        if self.ci_type == "mctdh":
            raise _not_ported("ci_type='mctdh'", "A12")
        if not self.model.basinfo.is_standard_method:
            raise _not_ported(
                "the non-standard method (the MPS-MCTDH hybrid, nspf < nprim)",
                "A12")
        if restart:
            cores = _restart_payload()["cores"]
        else:
            cores = self._alloc_initial_cores()
        return TDVPEngine(cores, self.model.hamiltonian, config, self.device)

    def _alloc_initial_cores(self) -> list[list[np.ndarray]]:
        model = self.model
        nstate = model.get_nstate()
        ndof = model.get_ndof()
        m_max = model.m_aux_max or 1
        if model.init_weight_ESTATE is not None:
            w = np.asarray(model.init_weight_ESTATE, dtype=float)
            weights = (w / w.sum()).tolist()
        else:
            weights = [1.0] + [0.0] * (nstate - 1)
        cores = []
        for istate in range(nstate):
            phys_dims = [
                model.basinfo.get_nprim(istate, d) for d in range(ndof)
            ]
            if model.subspace_inds:
                for site, inds in model.subspace_inds.items():
                    phys_dims[site] = len(inds)
            if model.init_HartreeProduct is not None:
                vecs = [
                    np.asarray(v, dtype=complex)
                    for v in model.init_HartreeProduct[istate]
                ]
            else:
                vecs = []
                for d in range(ndof):
                    prim = model.get_primbas(istate, d)
                    if model.init_weight_VIBSTATE is not None:
                        vec = np.asarray(
                            model.init_weight_VIBSTATE[istate][d], dtype=complex
                        )
                    elif self.proj_gs and model.primbas_gs is not None:
                        # vib functions projected from the ground-state basis
                        # (reference SPFCoef.alloc_proj_gs semantics)
                        from pytdscf_torch.basis.op_matrix import op_matrix

                        ov = op_matrix(
                            prim, model.primbas_gs[d], "ovlp"
                        )
                        vec = np.asarray(ov[:, 0], dtype=complex)
                    else:
                        vec = np.zeros(phys_dims[d], dtype=complex)
                        vec[0] = 1.0
                    # HO FBR weight vectors rotate into the DVR grid basis
                    # (reference: _mps_mpo.py:96-110 rotates only HO bases).
                    from pytdscf_torch.basis.ho import HarmonicOscillator

                    if isinstance(prim, HarmonicOscillator):
                        vec = vec @ prim.get_unitary()
                    vecs.append(vec)
            cores.append(
                alloc_hartree_product(
                    phys_dims,
                    m_max,
                    vecs,
                    weight=weights[istate],
                    space=model.space,
                )
            )
        return cores

    def _prepare_primints(self):
        """Build / cache primitive-integral tables (reference
        ``get_primitive_integrals``, ``simulator_cls.py:469-489``)."""
        if getattr(self.model, "ints_prim_file", None) is None:
            return None
        import os as _os

        from pytdscf_torch.basis.primints import PrimInts

        path = self.model.ints_prim_file
        if _os.path.exists(path):
            return PrimInts.load(path)
        ints = PrimInts(self.model)
        ints.save(path)
        return ints

    def _save(self, engine, jobname: str, ext: str) -> None:
        path = f"wf_{self.jobname}{ext}.pkl"
        payload = engine.to_numpy()
        if not isinstance(payload, dict):
            payload = {"cores": payload}
        save_wavefunction(payload, path, backend=self.checkpoint_backend)

    def _execute(
        self,
        config: Config,
        dt_au: float,
        maxstep: int,
        *,
        restart: bool,
        savefile_ext: str,
        loadfile_ext: str,
        backup_interval: int,
        autocorr: bool,
        energy: bool,
        norm: bool,
        populations: bool,
        observables: bool,
        reduced_density=None,
        autocorr_per_step: int = 1,
        observables_per_step: int = 1,
        energy_per_step: int = 1,
        norm_per_step: int = 1,
        populations_per_step: int = 1,
    ) -> tuple[Any, WaveFunction]:
        if self.model.one_gate_to_apply is not None:
            raise _not_ported("one_gate_to_apply", "A10")
        if self.model.kraus_op is not None:
            raise _not_ported("kraus_op", "A10")
        if self.model.build_td_hamiltonian is not None:
            raise _not_ported("build_td_hamiltonian", "A10")
        if (
            os.environ.get("PYTDSCF_TPU_SELFCHECK")
            and not config.pytest_enabled
        ):
            # numerical self-checks inside the sweep when running THIS
            # repo's suite (tests/conftest.py sets the opt-in variable)
            config = config.replace(pytest_enabled=True)
        logger = get_logger(config.jobname, self.verbose)
        self._prepare_primints()
        #: wall time of the driver's phases ("props", "sweep") and the
        #: step count of the last run
        self.diagnostics = diag = Diagnostics()
        engine = self._initial_engine(config, restart, loadfile_ext)
        # Explicit-autocorr bra: persist the t=0 state once so restarted
        # runs keep computing ⟨Ψ(0)|Ψ(t)⟩ against the TRUE initial state
        # (reference continues autocorr.dat seamlessly across restarts).
        initial_cores = None
        if not self.t2_trick and autocorr:
            bra_path = f"wf_{self.jobname}_t0.pkl"
            if restart:
                found = resolve_checkpoint(bra_path)
                if found is not None:
                    initial_cores = load_wavefunction(found)["cores"]
            else:
                save_wavefunction(
                    {"cores": engine.to_numpy()},
                    bra_path,
                    backend=self.checkpoint_backend,
                )
        props = Properties(
            engine,
            self.model,
            config,
            t2_trick=self.t2_trick,
            reduced_density=reduced_density,
            initial_cores=initial_cores,
        )
        self._save(engine, config.jobname, savefile_ext)
        logger.info(f"Start initial step  0.000 [{config.display_time_unit}]")
        # Fused block driver: when per-step observability allows it, a
        # fetch_stride-long block of steps runs through
        # propagate_steps_collect with the per-step properties collected on
        # the device — rows identical to the per-step loop, one host read
        # per block.  Gated on fetch_stride > 1, so complex128 CPU runs
        # (stride 1) keep the per-step loop.
        fused_blocks = (
            config.fetch_stride > 1
            and not (observables and bool(self.model.observables))
            and reduced_density is None
            and (self.t2_trick or not autocorr)
            and autocorr_per_step == 1
            and energy_per_step == 1
            and norm_per_step == 1
            and populations_per_step == 1
            and (autocorr or energy or norm or populations)
        )
        istep = 0
        while istep < maxstep:
            # distance to the next backup step (its pre-step state must be
            # checkpointed inline, so fused blocks never span it)
            till_backup = (
                backup_interval - 1 - (istep % backup_interval)
            ) % backup_interval
            nblock = min(
                config.fetch_stride,
                maxstep - istep,
                till_backup if till_backup > 0 else 1,
            )
            if fused_blocks and nblock > 1:
                with diag.timer("sweep"):
                    props.run_fused_block(
                        dt_au, nblock,
                        autocorr=autocorr, energy=energy,
                        norm=norm, populations=populations,
                    )
                for _ in range(nblock):
                    diag.count("steps")
                istep += nblock
                if istep % 100 < nblock and self.verbose > 1:
                    kry, _, _, _ = engine.krylov_stats(reset=False)
                    logger.info(
                        f"End {istep - 1:5d} step; propagated "
                        f"{props.get_time_display():8.3f} "
                        f"[{config.display_time_unit}]  | {diag.report()}"
                        f"  AVG Krylov = {kry:.2f}"
                    )
                continue
            self._step_inline(
                engine, props, diag, config, dt_au, istep, logger,
                savefile_ext=savefile_ext,
                backup_interval=backup_interval,
                autocorr=autocorr, energy=energy, norm=norm,
                populations=populations, observables=observables,
                autocorr_per_step=autocorr_per_step,
                energy_per_step=energy_per_step,
                norm_per_step=norm_per_step,
                populations_per_step=populations_per_step,
                observables_per_step=observables_per_step,
            )
            istep += 1
        logger.info(f"End simulation and save wavefunction | {diag.report()}")
        props.flush()
        self._save(engine, config.jobname, savefile_ext)
        props.close()
        return props.energy, WaveFunction(engine, self.model)

    def _step_inline(
        self,
        engine,
        props,
        diag,
        config: Config,
        dt_au: float,
        istep: int,
        logger,
        *,
        savefile_ext: str,
        backup_interval: int,
        autocorr: bool,
        energy: bool,
        norm: bool,
        populations: bool,
        observables: bool,
        autocorr_per_step: int,
        energy_per_step: int,
        norm_per_step: int,
        populations_per_step: int,
        observables_per_step: int,
    ) -> None:
        """One per-step driver iteration (the original reference ordering:
        properties → export → backup → propagate → update)."""
        with diag.timer("props"):
            props.get_properties(
                autocorr=autocorr,
                energy=energy,
                norm=norm,
                populations=populations,
                observables=observables,
                autocorr_per_step=autocorr_per_step,
                energy_per_step=energy_per_step,
                norm_per_step=norm_per_step,
                populations_per_step=populations_per_step,
                observables_per_step=observables_per_step,
            )
        props.export_properties(
            autocorr_per_step=autocorr_per_step,
            populations_per_step=populations_per_step,
            observables_per_step=observables_per_step,
        )
        if istep % backup_interval == backup_interval - 1:
            # keep .dat rows consistent with the checkpoint on restart
            props.flush()
            self._save(engine, config.jobname, savefile_ext)
        with diag.timer("sweep"):
            engine.propagate(dt_au)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
        diag.count("steps")
        props.update(dt_au)
        if istep % 100 == 1 and self.verbose > 1:
            kry, calls, _, _ = engine.krylov_stats(reset=False)
            logger.info(
                f"End {istep - 1:5d} step; propagated "
                f"{props.get_time_display():8.3f} "
                f"[{config.display_time_unit}]  | {diag.report()}"
                f"  AVG Krylov = {kry:.2f}"
            )
