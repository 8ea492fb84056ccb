#!/usr/bin/env python3
"""Gold values of ``chip_smoke.py``'s several-state phase.

``lh2``: the 27-state LH2 exciton model of the smoke (``matJ_LH2_exciton``
with 8 HO primitives a pigment, ``PolynomialHamiltonian(27, 27)`` with the
couplings and ``set_HO_potential``, D=8, the whole weight on state 0,
``LH2_STEPS`` steps of ``LH2_DT`` fs) through the JAX package
(``pytdscf_tpu``) on the CPU in complex128, pinned to its MGS(×2) gauge
(the port's), as its ``Simulator.propagate`` runs it (thresh 1e-9): the
27 populations and ⟨H⟩ of the state after each of 0..N steps, written
with ``--write`` to ``scripts/a3_gold.json``, which the smoke reads.

``ambrosek``: the five cases of ``tests/test_relax_operate.py`` (the
two-molecule aggregate: imaginary relaxation, propagation, both with
``proj_gs``, and improved relaxation to the ZPE), each value beside its
literal.

``--port DTYPE`` runs the port (``pytdscf_torch``) on the CPU instead, in
``complex128`` or, at the card's settings, ``complex64`` (the Simulator's
thresh 1e-7 and ``fetch_stride`` 16 in propagation, the kernels' plain
versions; the LH2 run host-driven, at ``fetch_stride`` 1, as the smoke
runs it): the run from which the smoke's bars are set, three times its
distance from the gold (``lh2``: from the file).  Runs write their files
into the current directory, on two BLAS threads unless
``OMP_NUM_THREADS`` says otherwise.

    JAX_PLATFORMS=cpu python scripts/a3_gold.py lh2 --write
    python scripts/a3_gold.py lh2 --port complex64

A JAX run of 20 LH2 steps takes several minutes on a CPU, compile
included; the port's complex64 run about as long.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "2")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    AMBROSEK,
    LH2_BOND,
    LH2_DT,
    LH2_GOLD,
    LH2_NPRIM,
    LH2_STEPS,
    ambrosek_literal,
    ambrosek_model,
    lh2_model,
)


class Package:
    """The package a run goes through: the JAX package ("tpu", pinned to
    its MGS gauge) or the port ("torch", on the CPU in ``dtype``)."""

    def __init__(self, port_dtype: str | None):
        self.port = port_dtype is not None
        self.dtype = port_dtype or "complex128"
        self.name = "pytdscf_torch" if self.port else "pytdscf_tpu"
        if not self.port:
            import jax

            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_enable_x64", True)
            import pytdscf_tpu.mps.kernels as JK

            JK._PALLAS_QR_FORCE = True
            JK._PALLAS_QR_OFF = True

    def mod(self, path: str):
        return importlib.import_module(f"{self.name}.{path}")

    def simulator(self, job: str, model, **kw):
        """The package's Simulator, the port's on the CPU computing in
        ``dtype`` (its relaxation too)."""
        Simulator = self.mod("simulator").Simulator
        if not self.port:
            return Simulator(job, model, verbose=0, **kw)
        dtype = self.dtype

        class OnCpu(Simulator):
            def _auto_dtype(self):
                return dtype

        return OnCpu(job, model, verbose=0, device="cpu", **kw)


def run_ambrosek(pkg: Package) -> dict:
    out = {"model": "ambrosek", "package": pkg.name, "dtype": pkg.dtype}
    for case, (kind, coupled, bond, proj_gs, steps, dt, _) in (
            AMBROSEK.items()):
        literal = ambrosek_literal(case)
        model = ambrosek_model(pkg.name, coupled, bond, proj_gs,
                               excited=kind == "improved")
        sim = pkg.simulator(f"amb_{case}", model, proj_gs=proj_gs)
        if kind == "propagate":
            energy, _ = sim.propagate(maxstep=steps, stepsize=dt)
        else:
            energy, _ = sim.relax(maxstep=steps, stepsize=dt,
                                  improved=kind == "improved")
        out[case] = {"energy": float(energy), "literal": literal,
                     "gap": abs(float(energy) - literal)}
    return out


def run_lh2(pkg: Package, steps: int) -> dict:
    """``steps`` steps of the LH2 model from its Hartree product: the
    populations and ⟨H⟩ of the state after each of 0..steps steps, driven
    step by step through the package's engine as its Simulator sets it up
    (the port's complex64 run through ``Simulator.propagate`` at the
    card's settings instead, its rows read from ``populations.dat``)."""
    t0 = time.time()
    model = lh2_model(pkg.name)
    built = time.time() - t0
    dt = LH2_DT / pkg.mod("units").au_in_fs
    sim = pkg.simulator("lh2", model)
    t0 = time.time()
    if pkg.port and pkg.dtype == "complex64":
        energy, wf = sim.propagate(maxstep=steps, stepsize=LH2_DT,
                                   dtype="complex64", fetch_stride=1)
        rows = np.loadtxt("lh2_prop/populations.dat", ndmin=2)[:, 1:]
        pops = [list(map(float, r)) for r in rows] + [wf.pop_states()]
        energies = [None] * steps + [float(wf.expectation())]
    else:
        Config = pkg.mod("config").Config
        TDVPEngine = pkg.mod("mps.tdvp").TDVPEngine
        cfg = Config(dtype="complex128", thresh_exp=1.0e-9)
        cores = sim._alloc_initial_cores()
        engine = (TDVPEngine(cores, model.hamiltonian, cfg, "cpu") if pkg.port
                  else TDVPEngine(cores, model.hamiltonian, cfg))
        pops, energies = [], []
        for k in range(steps + 1):
            pops.append([float(p) for p in engine.pop_states()])
            energies.append(float(engine.expectation().real))
            if k < steps:
                engine.propagate(dt)
            print(f"step {k}: pop_0 {pops[-1][0]!r}, ⟨H⟩ {energies[-1]!r}, "
                  f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return {"model": "lh2", "package": pkg.name, "dtype": pkg.dtype,
            "steps": steps, "dt_fs": LH2_DT, "bond": LH2_BOND,
            "nprim": LH2_NPRIM, "build_seconds": built,
            "seconds": time.time() - t0, "pops": pops, "energies": energies}


def gap_from_gold(out: dict) -> dict:
    """The largest |Δ| of a run's populations from the gold file's, by
    step, and of its last ⟨H⟩."""
    with open(os.path.join(ROOT, LH2_GOLD)) as fh:
        gold = json.load(fh)
    n = min(len(out["pops"]), len(gold["pops"]))
    gaps = [float(np.max(np.abs(np.subtract(out["pops"][k], gold["pops"][k]))))
            for k in range(n)]
    return {"pops_gap_by_step": gaps, "pops_gap": max(gaps),
            "energy_gap": abs(out["energies"][n - 1]
                              - gold["energies"][n - 1])}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", choices=("ambrosek", "lh2"))
    parser.add_argument("--port", choices=("complex128", "complex64"))
    parser.add_argument("--steps", type=int, default=LH2_STEPS)
    parser.add_argument("--write", action="store_true",
                        help=f"write the JAX run's values to {LH2_GOLD}")
    args = parser.parse_args()
    pkg = Package(args.port)
    if args.model == "ambrosek":
        out = run_ambrosek(pkg)
    else:
        out = run_lh2(pkg, args.steps)
        if args.write:
            if pkg.port:
                parser.error("--write takes the JAX package's run")
            with open(os.path.join(ROOT, LH2_GOLD), "w") as fh:
                json.dump(out, fh, indent=1)
                fh.write("\n")
        elif os.path.exists(os.path.join(ROOT, LH2_GOLD)):
            out.update(gap_from_gold(out))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
