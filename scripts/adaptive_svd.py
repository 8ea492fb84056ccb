#!/usr/bin/env python3
"""Where the SVDs of the adaptive (a1TDVP) sweep run, measured on the card.

``TDVPEngine._half_sweep_adaptive`` takes two SVDs a bond (the enrichment's
residual, the truncation's bond matrix) through ``tdvp._svd``: cuSOLVER on
the card in complex128.  This script holds that against cuSOLVER in
complex64 and against LAPACK on the host in complex128:

1. the orthonormality of each one's singular vectors on seeded random
   complex64 matrices of the sweep's shapes ((45, 40) of rank 20, (400, 40)
   of full rank), and its time a call;
2. ``STEPS`` steps of the 81-site LH2 chain of
   ``examples/lh2_exciton_transfer.py`` (``chip_smoke.lh2_chain_model``,
   D=40, the example's adaptive settings, complex64) with the sweep's
   SVDs taken each way: after each step ⟨H⟩ as the engine reports it,
   ⟨H⟩/⟨Ψ|Ψ⟩ contracted in complex128 (``chip_smoke.energy64``), the norm
   and the largest |B·Bᴴ − I| of the sites right of the centre.

    python3 scripts/adaptive_svd.py [STEPS]      # on a machine with a GPU
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pytdscf_torch import units  # noqa: E402
from pytdscf_torch.config import Config  # noqa: E402
from pytdscf_torch.mps import tdvp as TT  # noqa: E402
from pytdscf_torch.mps.lattice import alloc_hartree_product  # noqa: E402


def device_svd(a):
    """The sweep's SVD through cuSOLVER on the card in complex64."""
    u, s, vh = torch.linalg.svd(a.to(torch.complex64), full_matrices=False)
    return u.to(a.dtype), s.to(torch.float64), vh.to(a.dtype)


def host_svd(a):
    """The sweep's SVD through LAPACK on the host in complex128."""
    u, s, vh = torch.linalg.svd(a.to("cpu", torch.complex128),
                                full_matrices=False)
    return u.to(a.device, a.dtype), s, vh.to(a.device, a.dtype)


VARIANTS = {"card complex128 (the port's)": TT._svd,
            "card complex64": device_svd,
            "host complex128": host_svd}


def orthonormality() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (m, n), rank in (((45, 40), 20), ((400, 40), 40)):
        a = (torch.randn(m, rank, dtype=torch.complex64, device="cuda",
                         generator=gen)
             @ torch.randn(rank, n, dtype=torch.complex64, device="cuda",
                           generator=gen))
        eye = torch.eye(rank, dtype=a.dtype, device="cuda")
        for name, svd in VARIANTS.items():
            u, _, vh = svd(a)
            eu = float(torch.max(torch.abs(u[:, :rank].mH @ u[:, :rank] - eye)))
            ev = float(torch.max(torch.abs(vh[:rank] @ vh[:rank].mH - eye)))
            ms = cs.cuda_ms(lambda: svd(a), 20)
            print(f"svd {name} ({m}, {n}) of rank {rank}: max|UᴴU − I| "
                  f"{eu:.2e}, max|VVᴴ − I| {ev:.2e}, {ms:.3f} ms a call",
                  flush=True)


def right_orthonormality(engine) -> float:
    worst = 0.0
    for c in engine.cores[0][1:]:
        l, n, r = c.shape
        m = c.reshape(l, n * r)
        eye = torch.eye(l, dtype=m.dtype, device=m.device)
        worst = max(worst, float(torch.max(torch.abs(m @ m.mH - eye))))
    return worst


def chain(steps: int) -> None:
    model, _ = cs.lh2_chain_model("pytdscf_torch")
    phys = [b.nprim for b in model.basinfo.prim_info[0]]
    vecs = [np.asarray(v, complex) for v in model.init_HartreeProduct[0]]
    cfg = Config(dtype="complex64", thresh_exp=1.0e-7, adaptive=True,
                 adaptive_Dmax=cs.CHAIN_BOND, adaptive_p_svd=cs.CHAIN_P_SVD,
                 adaptive_p_proj=cs.CHAIN_P_PROJ)
    dt = cs.CHAIN_DT / units.au_in_fs
    port = TT._svd
    try:
        for name, svd in VARIANTS.items():
            TT._svd = svd
            engine = TT.TDVPEngine(
                [alloc_hartree_product(phys, cs.CHAIN_BOND, vecs)],
                model.hamiltonian, cfg, "cuda")
            t0 = time.perf_counter()
            for k in range(steps):
                engine.propagate(dt)
                torch.cuda.synchronize()
                print(f"{name}, step {k + 1}: {time.perf_counter() - t0:.1f} "
                      f"s, bonds sum {sum(engine.bond_dims())}, ⟨H⟩ "
                      f"{engine.expectation().real!r}, energy64 "
                      f"{cs.energy64(engine)!r}, norm {engine.norm()!r}, "
                      f"max|BBᴴ − I| {right_orthonormality(engine):.2e}",
                      flush=True)
    finally:
        TT._svd = port


def main() -> int:
    if not torch.cuda.is_available():
        print("adaptive_svd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.phase_device()
    cs.phase_build()
    orthonormality()
    chain(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
