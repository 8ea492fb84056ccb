#!/usr/bin/env python3
"""Gold values of ``chip_smoke.py``'s one-state model phases.

Runs the JAX package (``pytdscf_tpu``) on the CPU in complex128, pinned to
its MGS(×2) gauge (the port's, and the JAX package's accelerator
convention, instead of LAPACK's), through the settings of the smoke's
phases, and prints one JSON line of full-precision values a model:

* ``pyrazine``: ``examples/pyrazine_s2_dynamics.py``'s own (24 modes,
  nprim 10, D=20, dt 0.1 fs, S2 ⊗ vacuum, energy and the t/2-trick
  autocorrelation, 1500 steps): ⟨H⟩ at the end, the largest |norm² − 1|
  of ``populations.dat``, the autocorrelation's rows ``PYRAZINE_AC_ROWS``
  (those of the first 40 fs, before the rounding-seeded S2 → S1
  transfer sets the trajectory apart), the S1/S2 populations of the final
  state (its electronic reduced density), the absorption maximum in the
  220-280 nm window of the example's spectrum (damping 150 fs, its
  E_shift, the cos window) and the frequency grid's spacing;
* ``model_b``: ``examples/donor_acceptor_model_b.py``'s own (13 fragments,
  8 F and 8 OT modes, nfock 28, D=20, dt 0.2 fs, the 26 electron-level
  projectors as observables every 10 steps), 20 steps: the 26 populations
  at step 10 (``expectations.dat``, 9 decimals) and after step 20 (the
  final state), ⟨H⟩ at the end;
* ``dvr``: the Hénon–Heiles energies of ``tests/test_henon_heiles.py`` and
  H2CO's e0 and e10 of ``tests/test_h2co.py``.

``--gauge lapack`` leaves the JAX package on LAPACK's QR, its CPU
default.  ``--port DTYPE`` runs the port (``pytdscf_torch``) on the CPU instead, in
``complex128`` (it meets the JAX package's values to ~1e-12) or
``complex64`` at the card's settings (thresh 1e-7, ``fetch_stride`` 16,
the kernels' plain versions): the run from which the smoke's bars were
set.  ``--steps`` cuts a run.  Each run writes its files into the current
directory, on two BLAS threads unless ``OMP_NUM_THREADS`` says otherwise
(below).

    JAX_PLATFORMS=cpu python scripts/a4_gold.py pyrazine [--port complex64]

A pyrazine run takes minutes on a CPU, a model B run of 20 steps about
half an hour (JAX) or ten minutes (port, complex64).
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time

# A Hartree-product start under the MGS gauge has dead columns whose
# completions rounding decides, so the BLAS thread count moves the
# trajectory: pyrazine's early autocorrelation by 6.6e-6 between 2 and 4
# threads, in complex128 in either package.  The gold is the 2-thread run
# (the default here; OMP_NUM_THREADS=4 gives the other).
os.environ.setdefault("OMP_NUM_THREADS", "2")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the smoke's settings and its spectrum, so that the gold is what it reads
from chip_smoke import (  # noqa: E402
    HENON_HEILES,
    MODEL_B_BOND,
    MODEL_B_DT,
    MODEL_B_EVERY,
    MODEL_B_GOLD_STEPS,
    MODEL_B_NFOCK,
    PYRAZINE_AC_ROWS,
    PYRAZINE_BOND,
    PYRAZINE_DT,
    PYRAZINE_NPRIM,
    PYRAZINE_STEPS,
    absorption_peak,
    dat_rows,
    henon_heiles_terms,
)


class Package:
    """The package a run goes through: the JAX package ("tpu", pinned to
    its MGS gauge) or the port ("torch", on the CPU in ``dtype``)."""

    def __init__(self, port_dtype: str | None, gauge: str = "mgs"):
        self.port = port_dtype is not None
        self.dtype = port_dtype or "complex128"
        name = "pytdscf_torch" if self.port else "pytdscf_tpu"
        if not self.port:
            import jax

            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_enable_x64", True)
            import pytdscf_tpu.mps.kernels as JK

            JK._PALLAS_QR_FORCE = gauge == "mgs"
            JK._PALLAS_QR_OFF = True
        self.name = name

    def mod(self, path: str):
        return importlib.import_module(f"{self.name}.{path}")

    def simulator(self, job: str, model):
        Simulator = self.mod("simulator").Simulator
        if self.port:
            return Simulator(job, model, verbose=0, device="cpu")
        return Simulator(job, model, verbose=0)

    def propagate_kw(self) -> dict:
        """The card's settings for a complex64 port run; none otherwise."""
        if self.port and self.dtype == "complex64":
            return {"dtype": "complex64", "fetch_stride": 16}
        return {}


def run_pyrazine(pkg: Package, steps: int) -> dict:
    pyr = pkg.mod("models.pyrazine")
    Model = pkg.mod("model").Model
    basis, ham = pyr.pyrazine_qvc(nprim=PYRAZINE_NPRIM)
    model = Model(basis, {"hamiltonian": ham}, bond_dim=PYRAZINE_BOND)
    vac = [1.0] + [0.0] * (PYRAZINE_NPRIM - 1)
    model.init_HartreeProduct = [[[0.0, 1.0]] + [vac] * (len(basis) - 1)]
    t0 = time.time()
    energy, wf = pkg.simulator("pyrazine", model).propagate(
        maxstep=steps, stepsize=PYRAZINE_DT, energy=True, autocorr=True,
        **pkg.propagate_kw())
    wall = time.time() - t0
    rho = np.asarray(wf.get_reduced_densities((2,)))
    rows = np.loadtxt("pyrazine_prop/populations.dat", ndmin=2)
    _, auto = dat_rows("pyrazine_prop/autocorr.dat")
    out = {
        "model": "pyrazine", "package": pkg.name, "dtype": pkg.dtype,
        "steps": steps, "seconds": wall, "e_end": float(energy),
        "norm2_drift": float(np.max(np.abs(rows[:, 1] - 1.0))),
        "autocorr_rows": {str(k): [float(auto[k, 1]), float(auto[k, 2])]
                          for k in PYRAZINE_AC_ROWS if k < len(auto)},
        "pops": [float(rho[0, 0].real), float(rho[1, 1].real)],
        "rho": [[float(x.real), float(x.imag)] for x in rho.reshape(-1)],
    }
    nm, peak, res = absorption_peak("pyrazine", pyr.OMEGA_EV,
                                    pkg.mod("spectra"))
    out.update(peak_nm=nm, peak_cm1=peak, bin_cm1=res)
    return out


def run_model_b(pkg: Package, steps: int) -> dict:
    da = pkg.mod("models.donor_acceptor")
    Model = pkg.mod("model").Model
    t0 = time.time()
    basis, ham = da.donor_acceptor_b(nfock=MODEL_B_NFOCK)
    built = time.time() - t0
    ops = da.electron_level_projectors(basis)
    model = Model(basis, {"hamiltonian": ham, **ops}, bond_dim=MODEL_B_BOND)
    n_frag = basis[0].nprim // 2
    ele0 = [0.0] * n_frag + [1.0] + [0.0] * (n_frag - 1)
    vac = [1.0] + [0.0] * (MODEL_B_NFOCK - 1)
    model.init_HartreeProduct = [[ele0] + [vac] * (len(basis) - 1)]
    t0 = time.time()
    energy, wf = pkg.simulator("model_b", model).propagate(
        maxstep=steps, stepsize=MODEL_B_DT, energy=True, autocorr=False,
        observables=True, observables_per_step=MODEL_B_EVERY,
        **pkg.propagate_kw())
    wall = time.time() - t0
    rows = np.loadtxt("model_b_prop/expectations.dat", ndmin=2)
    final = [float(wf.expectation(ops[f"N{k}"])) for k in range(len(ops))]
    return {
        "model": "model_b", "package": pkg.name, "dtype": pkg.dtype,
        "steps": steps, "seconds": wall, "build_seconds": built,
        "e_end": float(energy),
        "rows": {str(int(round(t / MODEL_B_DT))): [float(x) for x in r[1:]]
                 for t, r in zip(rows[:, 0], rows)},
        "final": final,
    }


def run_dvr(pkg: Package) -> dict:
    units = pkg.mod("units")
    HO = pkg.mod("basis").HarmonicOscillator
    PrimBas_HO = pkg.mod("basis").PrimBas_HO
    Model = pkg.mod("model").Model
    BasInfo = pkg.mod("model").BasInfo
    dvr = pkg.mod("operators.dvr")
    out: dict = {"model": "dvr", "package": pkg.name, "dtype": pkg.dtype}
    for tag, (omega, lam, f, ngrid, bond, dt, _) in HENON_HEILES.items():
        prims = [HO(ngrid, omega) for _ in range(f)]
        pot = dvr.construct_nMR_recursive(
            prims, nMR=2, rate=0.99999999999,
            func=henon_heiles_terms(omega / units.au_in_cm1, lam, f))
        model = Model(prims, {"potential": pot,
                              "kinetic": dvr.construct_kinetic_mpo(prims)},
                      bond_dim=bond)
        gs = [1.0] + [0.0] * (ngrid - 1)
        es = [0.0, 1.0] + [0.0] * (ngrid - 2)
        model.init_weight_VIBSTATE = [[es] + [gs] * (f - 1)]
        energy, _ = pkg.simulator(f"hh_{tag}", model).propagate(
            maxstep=3, stepsize=dt, **pkg.propagate_kw())
        out[f"henon_heiles_{tag}"] = float(energy)
    k_orig = pkg.mod("potentials").ch2o_k_orig
    prim = [[PrimBas_HO(0.0, math.sqrt(k_orig[(i, i)]) * units.au_in_cm1, 6)
             for i in range(1, 7)]]
    model = Model(BasInfo(prim), {"hamiltonian": pkg.mod(
        "operators.sop").read_potential_nMR(k_orig)}, bond_dim=6)
    sim = pkg.simulator("h2co", model)
    out["h2co_e0"] = float(sim.propagate(maxstep=1, stepsize=0.1,
                                         **pkg.propagate_kw())[0])
    out["h2co_e10"] = float(sim.propagate(maxstep=10, stepsize=0.1,
                                          **pkg.propagate_kw())[0])
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", choices=("pyrazine", "model_b", "dvr"))
    parser.add_argument("--port", choices=("complex128", "complex64"))
    parser.add_argument("--steps", type=int)
    parser.add_argument("--gauge", choices=("mgs", "lapack"), default="mgs",
                        help="the JAX package's gauge (default: MGS, the "
                        "port's)")
    args = parser.parse_args()
    pkg = Package(args.port, args.gauge)
    if args.model == "pyrazine":
        out = run_pyrazine(pkg, args.steps or PYRAZINE_STEPS)
    elif args.model == "model_b":
        out = run_model_b(pkg, args.steps or MODEL_B_GOLD_STEPS)
    else:
        out = run_dvr(pkg)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
