#!/usr/bin/env python3
"""Check that two builds of the port's kernels give the same bits.

Runs the kernels of the ``pytdscf_torch`` package found under ROOT on
fixed inputs (seeded with numpy) through their wrappers and saves every
output: the Lanczos kernel at the 184-site chain's shapes (the H step at
(240, 30) with 4 channels, the K step at (30, 30)) through its own route
(``lanczos_*``) and through the one-block route (``lanczos_block_*``), the
fused site kernel at the chain's bulk shape in both directions, likewise
(``site_*``, ``site_block_*``; a package whose wrappers take no route runs
its only one in both), the one-block MGS QR (``mgs_*``) at (240, 30)
full rank and rank deficient and at the later paths' (560, 20), (200, 20)
and (72, 12), the cluster MGS QR at (1024, 64) (``qr_cluster_*``), the
relaxed matvecs
``heff_lo`` and ``keff_lo`` and the bf16x3 chain in its four mappings
(``chain_left``, ``chain_right``, ``chain_heff``, ``chain_keff``) at the
χ=1024 radical pair's bulk shape and a ragged one; the ground state at
the butadiene bulk, a one-CTA shape and a streamed one with its status
(``gs_*``); the
Krylov control step at k_used 5, 8 and 32 with and without a Gram
matrix (``ctl_*``); then the earlier main paths end to end (``path_*``: the chain's ⟨H⟩ and cores and the
radical pair's populations at both rungs after three steps, each built by
ROOT's own ``chip_smoke.py``).  ``compare`` exits 1
unless two such files are equal bit for bit, except for the outputs named
by ``--expect-differ`` (comma-separated prefixes of output names), which
may differ or be missing from one file.  On a machine with an NVIDIA
GPU and nvcc, e.g. for a checkout of the parent commit unpacked under
``parent/``:

    python3 scripts/kernel_bits.py dump parent out/parent.npz
    python3 scripts/kernel_bits.py dump . out/this.npz
    python3 scripts/kernel_bits.py compare out/parent.npz out/this.npz \
        --expect-differ gs,ctl,path

(one script, this one, dumps both trees, so their outputs have the same
names).
"""

from __future__ import annotations

import inspect
import sys
from pathlib import Path

import numpy as np


#: Steps of each earlier path that ``dump`` runs end to end
PATH_STEPS = 3


def _cx(rng, *shape):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return a / np.linalg.norm(a)


def _block(fn) -> dict:
    """The keyword that sends ``fn`` through its one-block route, or none
    for a package whose wrapper has no route to choose."""
    return {"way": "block"} if "way" in inspect.signature(fn).parameters else {}


def dump(root: str, path: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from pytdscf_torch.mps import cuda_lanczos as CL
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_qr as CQ
    from pytdscf_torch.mps import cuda_renorm as CR
    from pytdscf_torch.mps import cuda_site as CS

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
    kch = CL.keff_channels(t(L), t(R))
    sig = t(_cx(rng, 30, 30))
    for tag, kw in (("", {}), ("block_", _block(CL.lanczos_expm))):
        out, st = CL.lanczos_expm(ch, t(psi), -0.1j, 1e-6, 10, True, **kw)
        res[f"lanczos_{tag}h_out"] = out.cpu().numpy()
        res[f"lanczos_{tag}h_status"] = st.cpu().numpy()
        out, st = CL.lanczos_expm(kch, sig, 0.1j, 1e-6, 10, False, **kw)
        res[f"lanczos_{tag}k_out"] = out.cpu().numpy()
        res[f"lanczos_{tag}k_status"] = st.cpu().numpy()
    # the fused site update at the bulk, (30, 8, 30) with 4 channels
    site, nxt = t(_cx(rng, 30, 8, 30)), t(_cx(rng, 30, 8, 30))
    logs = (torch.tensor(0.37, device="cuda"),
            torch.tensor(-0.21, device="cuda"))
    for tag, kw in (("", {}), ("block_", _block(CS.site_step_fused))):
        for way in ("fwd", "bwd"):
            got = CS.site_step_fused(
                site, nxt, t(L), t(W), t(R), -0.1j, 1e-6, *logs,
                forward=way == "fwd", max_dim=10, conserve=True, **kw)
            for name, a in zip(("q", "next", "blocks", "log", "status"), got):
                res[f"site_{tag}{way}_{name}"] = a.cpu().numpy()
    full = _cx(rng, 240, 30)
    deficient = full.copy()
    deficient[:, [3, 7, 29]] = 0.0
    for name, m in (("mgs_full", full), ("mgs_deficient", deficient),
                    ("qr_cluster", _cx(rng, 1024, 64)),
                    ("mgs_560x20", _cx(rng, 560, 20)),
                    ("mgs_200x20", _cx(rng, 200, 20)),
                    ("mgs_72x12", _cx(rng, 72, 12))):
        q, r = CQ.mgs_qr(t(m))
        res[f"{name}_q"], res[f"{name}_r"] = q.cpu().numpy(), r.cpu().numpy()
    # (b, k, x, w, d): the χ=1024 bulk and a shape ragged in every tile
    for tag, (b, k, x, w, d) in (("bulk", (1024, 1024, 1024, 8, 4)),
                                 ("ragged", (130, 70, 33, 7, 4))):
        L, W, R = _cx(rng, b, w, k), _cx(rng, w, d, d, w), _cx(rng, x, w, x)
        out = CM.heff_lo(CM.heff_operands(t(L), t(W), t(R)),
                         t(_cx(rng, k, d, x)))
        res[f"heff_{tag}"] = out.cpu().numpy()
        out = CM.keff_lo(CM.keff_operands(t(L), t(R)), t(_cx(rng, k, x)))
        res[f"keff_{tag}"] = out.cpu().numpy()
    # (b, k, p, o, w, d): the bulk environment transfer, and ragged bonds
    for tag, (b, k, p, o, w, d) in (("bulk", (1024, 1024, 1024, 1024, 8, 4)),
                                    ("ragged", (130, 70, 33, 45, 7, 4))):
        blk, W = t(_cx(rng, b, w, k)), t(_cx(rng, w, d, d, w))
        out = CR.renorm_left_hi(blk, t(_cx(rng, b, d, o)), W,
                                t(_cx(rng, k, d, p)))
        res[f"chain_left_{tag}"] = out.cpu().numpy()
        out = CR.renorm_right_hi(blk, t(_cx(rng, o, d, b)), W,
                                 t(_cx(rng, p, d, k)))
        res[f"chain_right_{tag}"] = out.cpu().numpy()
        L, R = t(_cx(rng, b, w, k)), t(_cx(rng, p, w, o))
        out = CR.heff_hi(CR.heff_operands(L, W, R), t(_cx(rng, k, d, o)))
        res[f"chain_heff_{tag}"] = out.cpu().numpy()
        out = CR.keff_hi(CR.keff_operands(L, R), t(_cx(rng, k, o)))
        res[f"chain_keff_{tag}"] = out.cpu().numpy()
    res.update(_ground_states(rng, t))
    res.update(_control_steps(rng))
    res.update(_paths())
    torch.cuda.synchronize()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **res)
    print(f"kernel_bits: {len(res)} outputs of {root} in {path}")


def _ground_states(rng, t) -> dict:
    """The ground-state kernel (``gs_*``) on seeded Hermitian channels at
    the butadiene bulk shape ((72, 12), 30 channels, a cluster) and at a
    one-CTA H2O shape ((9, 9), 5 channels), each on its default route,
    and at (200, 20) with 10 channels, whose rows of H stream through
    slices (its inputs from a generator of its own): the vector and the
    status."""
    from pytdscf_torch.mps import cuda_lanczos as CL

    res = {}
    for tag, (nc, M, r), g in (("bulk", (30, 72, 12), rng),
                               ("small", (5, 9, 9), rng),
                               ("streamed", (10, 200, 20),
                                np.random.default_rng(7))):
        H, Rt = _cx(g, nc, M, M), _cx(g, nc, r, r)
        H = (H + H.transpose(0, 2, 1).conj()) / 2
        Rt = (Rt + Rt.transpose(0, 2, 1).conj()) / 2
        out, st = CL.ground_state((t(H), t(Rt)), t(_cx(g, M, r)))
        res[f"gs_{tag}_out"] = out.cpu().numpy()
        res[f"gs_{tag}_status"] = st.cpu().numpy()
    return res


def _control_steps(rng) -> dict:
    """The Krylov control kernel (``ctl_*``) at k_used 5, 8 and 32, each
    with an Arnoldi Hessenberg T and with a Lanczos T and its Gram matrix:
    the new coefficients, flags and status."""
    import torch

    from pytdscf_torch.mps import cuda_krylov as CK

    res = {}
    for m in (5, 8, 32):
        for gram in (False, True):
            kmax = max(m, 8)
            T = np.zeros((kmax + 1, kmax + 1), dtype=complex)
            if gram:
                a, b = rng.standard_normal(m), np.abs(rng.standard_normal(m))
                T[:m, :m] = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
                T[m, m - 1] = b[-1]
                A = _cx(rng, kmax + 1, kmax + 1)
                G = np.eye(kmax + 1) + 0.05 * (A @ A.conj().T)
            else:
                T[:m, :m] = np.triu(_cx(rng, m, m), -1) * 4.0
                T[m, m - 1] = 1.0
                G = None
            c = np.zeros(kmax, dtype=complex)
            c[:m - 1] = 0.1 * _cx(rng, m - 1)

            def dev(a):
                return torch.as_tensor(a, dtype=torch.complex64,
                                       device="cuda").contiguous()

            cc = dev(c)
            flags = torch.zeros(kmax + 1, dtype=torch.bool, device="cuda")
            status = torch.zeros(3, dtype=torch.int32, device="cuda")
            CK.krylov_ctl(dev(T), None if G is None else dev(G), cc, flags,
                          status, k=m - 1, scale=-0.25j, thresh=1e-6,
                          exact=False, relax_after=1)
            tag = f"ctl_m{m}_{'lanczos' if gram else 'arnoldi'}"
            res[f"{tag}_c"] = cc.cpu().numpy()
            res[f"{tag}_flags"] = flags.cpu().numpy()
            res[f"{tag}_status"] = status.cpu().numpy()
    return res


def _paths() -> dict:
    """The earlier main paths end to end, built by the tree's own
    ``chip_smoke.py``: the 184-site chain after PATH_STEPS host-driven
    steps (its ⟨H⟩ contracted in complex128, and its cores) and the χ=1024
    radical pair at each rung after PATH_STEPS (its electron
    populations, as ``tests/torch_rp_drift.py`` reads them)."""
    import chip_smoke as S
    import torch

    from pytdscf_torch import units

    res = {}
    engine = S.build_engine("cuda")
    for _ in range(PATH_STEPS):
        engine.propagate(S.DT_FS / units.au_in_fs)
    res["path_chain_energy"] = np.asarray(S.energy64(engine))
    res["path_chain_cores"] = np.concatenate(
        [c.reshape(-1).cpu().numpy() for c in engine.cores[0]])
    del engine
    for preset in ("balanced", "throughput"):
        torch.cuda.empty_cache()
        engine, ele = S.build_rp_engine("cuda", preset)
        engine.right_canonicalize()
        for _ in range(PATH_STEPS):
            engine.propagate(S.RP_DT)
        rdm = engine.reduced_density_liouville((0,) * ele + (2, 2))
        res[f"path_rp_{preset}_pops"] = np.real(
            np.einsum("aabb->ab", rdm)).reshape(-1)
        del engine
    return res


def compare(a: str, b: str, expect_differ: tuple[str, ...] = ()) -> int:
    fa, fb = np.load(a), np.load(b)
    names = sorted(set(fa.files) | set(fb.files))
    bad = [k for k in names if k not in fa.files or k not in fb.files
           or fa[k].tobytes() != fb[k].tobytes()]
    unexpected = [k for k in bad if not k.startswith(expect_differ)]
    print(f"kernel_bits: {len(names) - len(bad)}/{len(names)} outputs "
          f"identical bit for bit; differ: {bad} (expected to differ: "
          f"{list(expect_differ)}; unexpected: {unexpected})")
    for k in bad:
        if k in fa.files and k in fb.files and fa[k].shape == fb[k].shape:
            d = np.abs(fa[k] - fb[k]).max() / max(np.abs(fa[k]).max(), 1e-30)
            print(f"kernel_bits: {k}: max |Δ| / max |a| = {d:.3e}")
    return 1 if unexpected else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "dump":
        dump(args[1], args[2])
    elif len(args) in (3, 5) and args[0] == "compare" and (
            len(args) == 3 or args[3] == "--expect-differ"):
        names = tuple(args[4].split(",")) if len(args) == 5 else ()
        sys.exit(compare(args[1], args[2], names))
    else:
        sys.exit(__doc__)
