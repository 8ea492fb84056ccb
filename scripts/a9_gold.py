#!/usr/bin/env python3
"""Gold values of ``chip_smoke.py``'s adaptive phase, and the JAX side of
``tests/test_torch_adaptive.py``.

``chain``: the 81-site LH2 chain of ``examples/lh2_exciton_transfer.py``
(``chip_smoke.lh2_chain_model``: ``lh2_chain(nmol=9, nfock=10)``, D=40, the
γ excitons of the first and last molecule excited) through the JAX package
(``pytdscf_tpu``) on the CPU in complex128, on its own CPU gauge (LAPACK's
QR), as its ``Simulator.propagate`` runs the example (``adaptive=True``,
``adaptive_Dmax`` 40, ``adaptive_p_svd`` 1e-20, ``adaptive_p_proj`` 1e-9,
thresh 1e-9): 1 + ``CHAIN_STEPS`` steps of ``CHAIN_DT`` fs, then the 27
chromophore populations (the example's projector observables), ⟨H⟩, the
norm and the bond dimensions of the end state, and the bond dimensions
before each step (``bonddim.dat``).  ``--write`` stores it as
``scripts/a9_gold.json``, which the smoke reads.

``--port complex64`` runs the port (``pytdscf_torch``) on the CPU instead,
at the card's settings (complex64, the Simulator's thresh 1e-7, its MGS
gauge, the kernels' plain versions): the run from which the smoke's bars
are set, three times its distance from the gold.

``tests``: every run of ``tests/torch_adaptive_cases.py`` through the JAX
package; ``--write`` stores them as ``tests/fixtures/a9_jax.npz``.

Runs write their files into a temporary directory, on two BLAS threads
unless ``OMP_NUM_THREADS`` says otherwise.

    python scripts/a9_gold.py chain --write
    python scripts/a9_gold.py chain --port complex64
    python scripts/a9_gold.py tests --write

The JAX chain takes tens of minutes on a CPU (one adaptive step recompiles
its Krylov programs at every bond), the port's complex64 run a few.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("OMP_NUM_THREADS", "2")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import (  # noqa: E402
    CHAIN_BOND,
    CHAIN_DT,
    CHAIN_GOLD,
    CHAIN_NFOCK,
    CHAIN_NMOL,
    CHAIN_P_PROJ,
    CHAIN_P_SVD,
    CHAIN_STEPS,
    lh2_chain_model,
)


def use_jax() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def clear_between_half_sweeps() -> None:
    """Clear JAX's compilation caches after every adaptive half-sweep of the
    JAX engine: each one compiles its Krylov programs anew at every bond,
    and XLA:CPU's in-process JIT runs out of code memory after a few
    thousand compilations (``tests/conftest.py``)."""
    import jax

    from pytdscf_tpu.mps.tdvp import TDVPEngine

    sweep = TDVPEngine._half_sweep_adaptive

    def half_sweep(self, *args, **kwargs):
        try:
            return sweep(self, *args, **kwargs)
        finally:
            jax.clear_caches()

    TDVPEngine._half_sweep_adaptive = half_sweep


def log_steps(engine_cls) -> None:
    """Print each step's bond dimensions and time to stderr."""
    step = engine_cls.propagate
    t0 = time.time()

    def propagate(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        print(f"step: bonds {self.bond_dims()}, {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
        return out

    engine_cls.propagate = propagate


def run_chain(port_dtype: str | None) -> dict:
    """The chain's 1 + CHAIN_STEPS steps through the package's Simulator,
    then its end state's observables."""
    pkg = "pytdscf_torch" if port_dtype else "pytdscf_tpu"
    if not port_dtype:
        use_jax()
        clear_between_half_sweeps()
    from importlib import import_module

    log_steps(import_module(f"{pkg}.mps.tdvp").TDVPEngine)
    t0 = time.time()
    model, ops = lh2_chain_model(pkg)
    built = time.time() - t0
    Simulator = import_module(f"{pkg}.simulator").Simulator
    kw = dict(verbose=0, device="cpu") if port_dtype else dict(verbose=0)
    steps = 1 + CHAIN_STEPS
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            sim = Simulator("lh2c", model, **kw)
            extra = dict(dtype=port_dtype) if port_dtype else {}
            _, wf = sim.propagate(
                maxstep=steps, stepsize=CHAIN_DT, energy=True,
                autocorr=False, adaptive=True, adaptive_Dmax=CHAIN_BOND,
                adaptive_p_svd=CHAIN_P_SVD, adaptive_p_proj=CHAIN_P_PROJ,
                **extra)
            rows = np.loadtxt("lh2c_prop/bonddim.dat", ndmin=2)[:, 1:]
        finally:
            os.chdir(cwd)
    seconds = time.time() - t0
    engine = wf.engine
    ham = model.hamiltonian
    pops = {name: float(np.real(engine.expectation(op)))
            for name, op in ops.items()}
    return {"model": "lh2_chain", "package": pkg,
            "dtype": port_dtype or "complex128", "nmol": CHAIN_NMOL,
            "nfock": CHAIN_NFOCK, "bond": CHAIN_BOND, "dt_fs": CHAIN_DT,
            "p_svd": CHAIN_P_SVD, "p_proj": CHAIN_P_PROJ, "steps": steps,
            "build_seconds": built, "seconds": seconds, "pops": pops,
            "energy": float(np.real(engine.expectation(ham))),
            "norm": float(engine.norm()),
            "bonds": [int(b) for b in engine.bond_dims()],
            "bonds_by_step": rows.astype(int).tolist()}


def gap_from_gold(out: dict) -> dict:
    """A run's distance from the gold file: the largest |Δ| of its
    populations, its ⟨H⟩ relative and its norm."""
    with open(os.path.join(ROOT, CHAIN_GOLD)) as fh:
        gold = json.load(fh)
    pops = max(abs(out["pops"][k] - gold["pops"][k]) for k in gold["pops"])
    return {"pops_gap": pops,
            "energy_gap": abs(out["energy"] - gold["energy"])
            / abs(gold["energy"]),
            "norm_gap": abs(out["norm"] - gold["norm"])}


def run_tests() -> dict:
    use_jax()
    import torch_adaptive_cases as cases

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = cases.all_runs("tpu")
        finally:
            os.chdir(cwd)
    print(f"tests: {time.time() - t0:.1f} s", file=sys.stderr)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("chain", "tests"))
    parser.add_argument("--port", choices=("complex128", "complex64"))
    parser.add_argument("--write", action="store_true",
                        help="store the JAX package's runs")
    args = parser.parse_args()
    if args.what == "tests":
        if args.port:
            parser.error("tests: the JAX package's runs only")
        out = run_tests()
        if args.write:
            import torch_adaptive_cases as cases

            np.savez_compressed(cases.FIXTURE, **out)
        print(json.dumps({k: v.tolist() for k, v in out.items()
                          if v.dtype.kind in "fi" and v.size < 32}))
        return
    out = run_chain(args.port)
    if args.write:
        if args.port:
            parser.error("--write takes the JAX package's run")
        with open(os.path.join(ROOT, CHAIN_GOLD), "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")
    elif os.path.exists(os.path.join(ROOT, CHAIN_GOLD)):
        out.update(gap_from_gold(out))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
