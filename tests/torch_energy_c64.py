"""⟨H⟩ of a saved complex64 state of the 184-site chain, read by the port
on a given device and, on the CPU, by the JAX package, in complex64 and in
complex128.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_energy_c64.py STATE.npz [...]
    PYTHONPATH=. python tests/torch_energy_c64.py --device cuda --no-jax STATE.npz

``STATE.npz`` is written by ``chip_smoke.py --save-state DIR``: the cores
(``arr_0`` .. ``arr_183``, complex64, canonical at site 0), the card's own
readings of the port's complex64 ``expectation`` (``e32``) and of the
complex128 recontraction (``e64``), and the steps it ran (``nsteps``).

Both packages' complex64 ``expectation`` are one algorithm: the right
environment blocks recontracted over sites N-1..1 at unit norm (the JAX
package's ``einsum(optimize=True)`` takes the port's pairwise order), then
one H_eff at site 0.  Printed per state: each reading against the literal;
the port's complex64 reading with every block contracted in complex128 and
rounded to complex64; and the distance of each complex64 block from the
complex128 one (median, largest, and the site of the largest).  Not
collected by pytest (a helper, like ``torch_cluster_replay.py``); the card
has no JAX, hence ``--no-jax``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

E_REF = 0.0182253410  # ⟨H⟩ of the chain (bench.py)


def port_reading(cores, fused, device: str, dtype: str, wide: bool = False):
    """The port's ⟨H⟩ (no division by the norm, as ``expectation``) and
    its right blocks (site p ↦ the block after contracting site p), each
    contracted in ``dtype`` or, with ``wide``, in complex128 and rounded
    to ``dtype``."""
    import torch

    from pytdscf_torch import convert
    from pytdscf_torch.config import Config
    from pytdscf_torch.mps import kernels as K
    from pytdscf_torch.mps.tdvp import _normalize_block

    eng = convert.from_numpy([[c.astype(dtype) for c in cores]], fused,
                             Config(dtype=dtype), device)
    W, c = eng.W, eng.cores[0]
    block, log = eng._trivial()
    blocks = {}
    for p in range(eng.nsite - 1, 0, -1):
        if wide:
            c128 = torch.complex128
            raw = K.renorm_block_right(block.to(c128), c[p].to(c128),
                                       W[p].to(c128), c[p].to(c128))
            raw = raw.to(block.dtype)
        else:
            raw = K.renorm_block_right(block, c[p], W[p], c[p])
        block, dl = _normalize_block(raw)
        log = log + dl
        blocks[p] = block.cpu().to(torch.complex128)
    triv, _ = eng._trivial()
    sig = K.heff_apply(triv, W[0], block, c[0])
    energy = complex(torch.sum(c[0].conj() * sig)) * float(torch.exp(log))
    return energy.real, blocks


def jax_reading(cores, dtype: str) -> float:
    import jax

    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.models.holstein import singlet_fission_chain
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    _, ham = singlet_fission_chain()
    eng = JEngine([[c.astype(dtype) for c in cores]], ham,
                  JConfig(dtype=dtype))
    return complex(eng.expectation()).real


def report(path: str, device: str, with_jax: bool) -> None:
    import torch

    from pytdscf_torch.models.holstein import singlet_fission_chain

    data = np.load(path)
    n = sum(k.startswith("arr_") for k in data.files)
    cores = [data[f"arr_{i}"] for i in range(n)]
    basis, ham = singlet_fission_chain()
    assert len(basis) == n, (len(basis), n)
    fused = ham.fused_mpo([b.nprim for b in basis])
    e128, ref = port_reading(cores, fused, "cpu", "complex128")
    e64, blocks = port_reading(cores, fused, device, "complex64")
    e64w, _ = port_reading(cores, fused, device, "complex64", wide=True)
    rows = [("the card, complex64 (saved)", float(data["e32"])),
            ("the card, complex128 (saved)", float(data["e64"])),
            (f"port {device}, complex64", e64),
            (f"port {device}, complex64, blocks in c128", e64w),
            ("port cpu, complex128", e128)]
    if with_jax:
        rows += [("JAX cpu, complex64", jax_reading(cores, "complex64")),
                 ("JAX cpu, complex128", jax_reading(cores, "complex128"))]
    print(f"{path}: {int(data['nsteps'])} steps")
    for name, value in rows:
        print(f"  {name:40s} {value:.10f}  - literal {value - E_REF:+.3e}")
    err = {p: float(torch.linalg.vector_norm(blocks[p] - ref[p]))
           for p in blocks}
    worst = max(err, key=err.get)
    print(f"  complex64 blocks on {device} against complex128: median "
          f"{np.median(list(err.values())):.2e}, largest {err[worst]:.2e} "
          f"(site {worst})")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("states", nargs="+")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--no-jax", action="store_true")
    args = parser.parse_args(argv)
    for path in args.states:
        report(path, args.device, not args.no_jax)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
