#!/usr/bin/env python3
"""Gold values of the butadiene IR workflow from the JAX package.

Runs ``examples/butadiene_ir_spectrum.py``'s workflow through the JAX
package (``pytdscf_tpu``) on the CPU in complex128, with the example's own
settings (14 active modes, 6 primitives, D=12; 8 improved relaxation
steps of 0.1 fs, operate μ·E at efield 1e-2 each way, propagate 0.2 fs),
and prints, with full precision, E_gs, ‖μ|0⟩‖, and, after the propagation,
the strongest line in 600-3500 cm⁻¹ and the frequency grid's spacing:
the literals of ``tests/test_torch_workflow.py`` and ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python scripts/ir_gold.py [--steps 400] [--mgs]

``--mgs`` pins the JAX package to its MGS(×2) gauge (the port's, and the
JAX package's accelerator convention) instead of LAPACK's; ``--steps 0``
stops after operate.  The run writes its files into the current
directory; 400 steps take a few minutes on a CPU.
"""

from __future__ import annotations

import argparse
import math
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pytdscf_tpu import spectra, units  # noqa: E402
from pytdscf_tpu.basis import PrimBas_HO  # noqa: E402
from pytdscf_tpu.model import BasInfo, Model  # noqa: E402
from pytdscf_tpu.operators.sop import read_potential_nMR  # noqa: E402
from pytdscf_tpu.potentials import load  # noqa: E402
from pytdscf_tpu.simulator import Simulator  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--mgs", action="store_true")
    args = parser.parse_args()
    if args.mgs:
        import pytdscf_tpu.mps.kernels as JK

        JK._PALLAS_QR_FORCE = True
        JK._PALLAS_QR_OFF = True
    k_orig = load("c4h6_local_potential")["k_orig"]
    mu = load("c4h6_local_dipole")["mu"]
    modes = sorted({i for key in k_orig for i in key})
    basinfo = BasInfo([[
        PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1, 6)
        for m in modes
    ]])
    model = Model(basinfo, {"hamiltonian": read_potential_nMR(k_orig)},
                  bond_dim=12)
    t0 = time.time()
    e_gs, _ = Simulator("c4h6", model, verbose=0).relax(
        maxstep=8, stepsize=0.1, improved=True)
    print(f"E_gs {e_gs!r} ({time.time() - t0:.1f} s)", flush=True)
    harm = sum(math.sqrt(k_orig[(m, m)]) for m in modes) / 2
    print(f"harmonic ZPE {harm!r}", flush=True)
    mu_ham = read_potential_nMR(None, dipole_emu=mu,
                                efield=(1e-2, 1e-2, 1e-2),
                                active_modes=modes)
    model_mu = Model(basinfo, {"hamiltonian": mu_ham}, bond_dim=12)
    norm, _ = Simulator("c4h6", model_mu, verbose=0).operate(
        maxstep=10, restart=True, loadfile_ext="_gs")
    print(f"norm {norm!r}", flush=True)
    if args.steps < 2:
        return
    t0 = time.time()
    Simulator("c4h6", model, verbose=0).propagate(
        maxstep=args.steps, stepsize=0.2, restart=True,
        loadfile_ext="_operate")
    print(f"propagate {args.steps} steps ({time.time() - t0:.1f} s)")
    t_fs, ac = spectra.load_autocorr("c4h6_prop/autocorr.dat")
    freq, inten = spectra.ifft_autocorr(
        t_fs, ac, E_shift=e_gs * units.au_in_eV)
    sel = (freq > 600) & (freq < 3500)
    i = int(np.argmax(inten[sel]))
    print(f"peak {freq[sel][i]!r} intensity {inten[sel][i]!r} "
          f"resolution {abs(freq[1] - freq[0])!r}")


if __name__ == "__main__":
    main()
