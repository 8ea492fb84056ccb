"""Drift from gold of the χ=1024 radical pair after host-driven steps on an
NVIDIA GPU, with the Krylov control step run three ways: a witness that
separates the control kernel from the rest of the Krylov program.

    PYTHONPATH=. python tests/torch_rp_drift.py [--ctl kernel plain plain128]
        [--preset balanced throughput] [--steps 11]

``--ctl``: ``kernel`` the ``csrc/krylov_ctl.cu`` control step (the
engine's own route); ``plain`` its plain version on the card's complex64
tensors (the order-12 Taylor series of ``cuda_krylov.expm_taylor_small``
through cuBLAS, as the host loop of the Krylov dimension before the control
kernel computed it); ``plain128`` the plain version on complex128 copies of
the reduced matrix, its coefficients rounded back to complex64.  The
model is ``chip_smoke.py``'s (``build_rp_engine``: bench_chi.py's
defaults), run for ``--steps`` steps of ``TDVPEngine.propagate`` (1 + 10,
bench_chi.py's count), and held to the ``bench_expected.json`` entry of
``chip_smoke.RP_KEY``.  With ``PYTHONPATH`` naming another checkout of the
repo the same model runs on that checkout's package, whose engine may have
no control step; there only ``--ctl kernel`` (its own route) applies.

Prints one JSON line per run: the checkout, control route, rung, drift,
populations, Krylov statistics and seconds; before them the card's name
and power limit.  Not collected by pytest (a helper, like
``torch_energy_c64.py``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def control(ctl: str):
    """The ``krylov_ctl`` that the Krylov program calls for route ``ctl``."""
    import torch

    from pytdscf_torch.mps import cuda_krylov as CK

    if ctl == "plain":
        return CK.krylov_ctl_plain

    def plain128(T, G, c, flags, status, **kw):
        wide = torch.complex128
        c128 = c.to(wide)
        CK.krylov_ctl_plain(T.to(wide), None if G is None else G.to(wide),
                            c128, flags, status, **kw)
        c.copy_(c128)

    return plain128


def run(preset: str, ctl: str, steps: int) -> dict:
    import chip_smoke as S
    import torch

    engine, ele = S.build_rp_engine("cuda", preset)
    engine.right_canonicalize()
    engine.krylov_stats()
    swapped = None
    if ctl != "kernel":
        from pytdscf_torch.mps import cuda_krylov as CK
        from pytdscf_torch.mps import integrator

        swapped = integrator.CK
        integrator.CK = SimpleNamespace(active=CK.active,
                                        krylov_ctl=control(ctl))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.propagate(S.RP_DT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        if swapped is not None:
            integrator.CK = swapped
    rdm = engine.reduced_density_liouville((0,) * ele + (2, 2))
    pops = np.real(np.einsum("aabb->ab", rdm)).reshape(-1)
    with open(Path(S.__file__).resolve().parent / "bench_expected.json") as fh:
        gold = np.asarray(json.load(fh)[S.RP_KEY]["pops"])
    return {"checkout": str(Path(S.__file__).resolve().parent),
            "ctl": ctl, "preset": preset, "steps": steps,
            "drift": float(np.max(np.abs(pops - gold))),
            "pops": pops.tolist(), "krylov": list(engine.krylov_stats()),
            "seconds": seconds}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ctl", nargs="+", default=["kernel", "plain",
                                                     "plain128"],
                        choices=["kernel", "plain", "plain128"])
    parser.add_argument("--preset", nargs="+",
                        default=["balanced", "throughput"])
    parser.add_argument("--steps", type=int, default=11)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for preset in args.preset:
        for ctl in args.ctl:
            print(json.dumps(run(preset, ctl, args.steps)), flush=True)


if __name__ == "__main__":
    main()
