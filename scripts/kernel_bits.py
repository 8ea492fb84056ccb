#!/usr/bin/env python3
"""Check that two builds of the port's kernels give the same bits.

Runs the Lanczos and MGS kernels of the ``pytdscf_torch`` package found
under ROOT on fixed inputs (seeded with numpy, at the 184-site chain's
shapes: the H step at (240, 30) with 4 channels, the K step at (30, 30),
the QR at (240, 30) full rank and rank deficient and at (1024, 64)) and
saves every output; ``compare`` exits 1 unless two such files are equal
bit for bit.  On a machine with an NVIDIA GPU and nvcc, e.g. for a
checkout of the parent commit unpacked under ``parent/``:

    python3 scripts/kernel_bits.py dump parent out/parent.npz
    python3 scripts/kernel_bits.py dump . out/this.npz
    python3 scripts/kernel_bits.py compare out/parent.npz out/this.npz
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def _cx(rng, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return a / np.linalg.norm(a)


def dump(root: str, path: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_qr as CQ

    def t(a):
        return torch.as_tensor(a).to("cuda", torch.complex64).contiguous()

    rng = np.random.default_rng(2024)
    res = {}
    L, R = _cx(rng, 30, 4, 30), _cx(rng, 30, 4, 30)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    W = _cx(rng, 4, 8, 8, 4)
    W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())
    psi = _cx(rng, 240, 30)
    ch = CL.heff_channels(t(L), t(W), t(R))
    out, st = CL.lanczos_expm(ch, t(psi), -0.1j, 1e-6, 10, True)
    res["h_out"], res["h_status"] = out.cpu().numpy(), st.cpu().numpy()
    kch = CL.keff_channels(t(L), t(R))
    out, st = CL.lanczos_expm(kch, t(_cx(rng, 30, 30)), 0.1j, 1e-6, 10, False)
    res["k_out"], res["k_status"] = out.cpu().numpy(), st.cpu().numpy()
    full = _cx(rng, 240, 30)
    deficient = full.copy()
    deficient[:, [3, 7, 29]] = 0.0
    for name, m in (("full", full), ("deficient", deficient),
                    ("large", _cx(rng, 1024, 64))):
        q, r = CQ.mgs_qr(t(m))
        res[f"qr_{name}_q"], res[f"qr_{name}_r"] = q.cpu().numpy(), r.cpu().numpy()
    torch.cuda.synchronize()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **res)
    print(f"kernel_bits: {len(res)} outputs of {root} in {path}")


def compare(a: str, b: str) -> int:
    fa, fb = np.load(a), np.load(b)
    bad = [k for k in fa.files
           if k not in fb.files or fa[k].tobytes() != fb[k].tobytes()]
    print(f"kernel_bits: {len(fa.files) - len(bad)}/{len(fa.files)} outputs "
          f"identical bit for bit; differ: {bad}")
    return 1 if bad or set(fa.files) != set(fb.files) else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
