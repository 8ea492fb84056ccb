"""Host-side MPO algebra: extension, direct sum, compression.

This is the port's "MPO schedule compiler".  The reference keeps every
Hamiltonian term as a separately-keyed core list with implicit identities and
complementary "summed" blocks resolved per contraction
(``PyTDSCF:pytdscf/_mpo_cls.py:116-163``,
``PyTDSCF:pytdscf/_mps_mpo.py:421-696``).  Here everything is fused
*once*, at operator-construction time, into a single dense full-chain MPO per
state pair — identity skipping becomes plain bond-1 identity cores, and the
"summed" complementary-block optimisation becomes ordinary MPO compression.
The runtime contraction then needs exactly one (L, W, R) einsum chain that
maps onto dense matmuls.

All functions here run on host numpy (operator construction is tiny and
happens once); the fused cores are shipped to the device as constants.

Core convention: ``W[a, i, j, b]`` with ``a``/``b`` the left/right MPO bonds,
``i`` the bra (output) and ``j`` the ket (input) physical index.
Diagonal (grid) cores may be given as ``(a, n, b)`` and are densified.
"""

from __future__ import annotations

import numpy as np

Cores = list[np.ndarray]


def as_dense_core(core: np.ndarray) -> np.ndarray:
    """Densify a 3-rank diagonal core (a, n, b) → (a, n, n, b)."""
    if core.ndim == 4:
        return np.asarray(core, dtype=np.complex128)
    if core.ndim == 3:
        a, n, b = core.shape
        dense = np.zeros((a, n, n, b), dtype=np.complex128)
        idx = np.arange(n)
        dense[:, idx, idx, :] = core
        return dense
    raise ValueError(f"core must be 3- or 4-rank, got shape {core.shape}")


def identity_core(n: int, bond: int = 1) -> np.ndarray:
    """Identity core δ_aa' ⊗ δ_ij of physical dim n and bond dim ``bond``."""
    core = np.zeros((bond, n, n, bond), dtype=np.complex128)
    eye_n = np.eye(n)
    for a in range(bond):
        core[a, :, :, a] = eye_n
    return core


def identity_core_diag(n: int, bond: int = 1) -> np.ndarray:
    """Diagonal-representation identity core: (a, n, b) with δ_ab·1."""
    core = np.zeros((bond, n, bond), dtype=np.complex128)
    for a in range(bond):
        core[a, :, a] = 1.0
    return core


def extend_to_full_chain_diag(
    site_cores: dict[int, np.ndarray], nsite: int, phys_dims: list[int]
) -> Cores:
    """Like :func:`extend_to_full_chain` but keeps 3-rank diagonal cores."""
    lo = min(site_cores)
    hi = max(site_cores)
    full: Cores = []
    bond = 1
    for s in range(nsite):
        if s in site_cores:
            core = np.asarray(site_cores[s], dtype=np.complex128)
            if core.ndim != 3:
                raise ValueError(f"diag core must be 3-rank, got {core.shape}")
            full.append(core)
            bond = core.shape[-1]
        elif lo < s < hi:
            full.append(identity_core_diag(phys_dims[s], bond))
        else:
            full.append(identity_core_diag(phys_dims[s], 1))
    return full


def extend_to_full_chain(
    site_cores: dict[int, np.ndarray], nsite: int, phys_dims: list[int]
) -> Cores:
    """Insert identity cores so an MPO term covers sites 0..nsite−1.

    Outside the term's [min, max] site span the identities have bond 1;
    inside a gap they carry the running bond dimension through.
    """
    lo = min(site_cores)
    hi = max(site_cores)
    full: Cores = []
    bond = 1
    for s in range(nsite):
        if s in site_cores:
            core = as_dense_core(site_cores[s])
            if core.shape[0] != bond:
                raise ValueError(
                    f"bond mismatch at site {s}: expected {bond}, got {core.shape[0]}"
                )
            if core.shape[1] != phys_dims[s]:
                raise ValueError(
                    f"phys-dim mismatch at site {s}: expected {phys_dims[s]}, "
                    f"got {core.shape[1]}"
                )
            full.append(core)
            bond = core.shape[-1]
        elif lo < s < hi:
            full.append(identity_core(phys_dims[s], bond))
        else:
            full.append(identity_core(phys_dims[s], 1))
    return full


def mpo_scale(cores: Cores, scalar: complex) -> Cores:
    out = [np.asarray(c, dtype=np.complex128) for c in cores]
    out[0] = out[0] * scalar
    return out


def scalar_mpo(scalar: complex, phys_dims: list[int]) -> Cores:
    """scalar × identity as a bond-1 MPO over the whole chain."""
    cores = [identity_core(n, 1) for n in phys_dims]
    return mpo_scale(cores, scalar)


def mpo_direct_sum(a_cores: Cores, b_cores: Cores) -> Cores:
    """MPO representing A + B by bond-wise direct sum (edges concatenate).

    Works for both dense (a, n, n', b) and diagonal (a, n, b) cores; the
    middle (physical) axes must match site-wise.
    """
    if len(a_cores) != len(b_cores):
        raise ValueError("MPO length mismatch")
    nsite = len(a_cores)
    if nsite == 1:
        return [a_cores[0] + b_cores[0]]
    out: Cores = []
    for s, (ca, cb) in enumerate(zip(a_cores, b_cores, strict=True)):
        if ca.shape[1:-1] != cb.shape[1:-1]:
            raise ValueError(f"phys-dim mismatch at site {s}")
        al, ar = ca.shape[0], ca.shape[-1]
        bl, br = cb.shape[0], cb.shape[-1]
        mid = ca.shape[1:-1]
        if s == 0:
            new = np.concatenate([ca, cb], axis=-1)
        elif s == nsite - 1:
            new = np.concatenate([ca, cb], axis=0)
        else:
            new = np.zeros((al + bl, *mid, ar + br), dtype=np.complex128)
            new[:al, ..., :ar] = ca
            new[al:, ..., ar:] = cb
        out.append(new)
    return out


def mpo_compress(
    cores: Cores,
    cutoff: float = 1.0e-13,
    max_bond: int | None = None,
    rate: float | None = None,
    nsweep: int = 1,
) -> Cores:
    """QR→ / SVD← sweep compression of an MPO core train.

    Works for dense and diagonal cores (only the first/last axes are bond
    axes).  ``cutoff`` is relative to the largest singular value per bond;
    ``rate`` keeps the smallest set of singular values whose squared sum
    reaches ``rate`` of the total (the reference's contribution-rate control,
    ``PyTDSCF:pytdscf/_mpo_cls.py:290-313``); ``nsweep`` repeats the
    compression (variational sweeps converge at nsweep=1 for exact-rank
    truncation but extra sweeps help after aggressive rate cuts).
    """
    cores = [np.asarray(c, dtype=np.complex128) for c in cores]
    nsite = len(cores)
    if nsite == 1:
        return cores
    for _ in range(max(nsweep, 1)):
        # Left→right QR canonicalisation.
        for s in range(nsite - 1):
            sh = cores[s].shape
            mat = cores[s].reshape(-1, sh[-1])
            q, r = np.linalg.qr(mat)
            cores[s] = q.reshape(*sh[:-1], q.shape[1])
            cores[s + 1] = np.tensordot(r, cores[s + 1], axes=(1, 0))
        # Right→left SVD truncation.
        for s in range(nsite - 1, 0, -1):
            sh = cores[s].shape
            mat = cores[s].reshape(sh[0], -1)
            u, sig, vh = np.linalg.svd(mat, full_matrices=False)
            if sig.size and sig[0] > 0.0:
                keep = int(np.sum(sig > cutoff * sig[0]))
                if rate is not None and rate < 1.0:
                    csum = np.cumsum(sig**2)
                    keep_r = int(np.searchsorted(csum / csum[-1], rate) + 1)
                    keep = min(keep, keep_r)
            else:
                keep = 1
            keep = max(keep, 1)
            if max_bond is not None:
                keep = min(keep, max_bond)
            cores[s] = vh[:keep].reshape(keep, *sh[1:])
            cores[s - 1] = np.tensordot(
                cores[s - 1], u[:, :keep] * sig[:keep], axes=(-1, 0)
            )
    return cores


def mpo_balance(cores: Cores, nsweep: int = 3) -> Cores:
    """Per-bond-index (Sinkhorn-style) norm balancing of an MPO gauge.

    SVD-compressed MPOs concentrate the whole operator scale in one core
    (e.g. ‖W₀‖ ~ 1e4 with all other cores orthonormal); environment blocks
    built from such a gauge grow exponentially along the chain, which is
    harmless in float64 but overflows/denormalises the float32 path used on an
    accelerator.  Scaling bond index α by t and dividing the neighbour leaves the
    operator invariant; equalising the per-index norms of the two cores
    sharing each bond restores O(1) finite-state-automaton-like channels.
    """
    cores = [np.asarray(c, dtype=np.complex128) for c in cores]
    for _ in range(nsweep):
        for i in range(len(cores) - 1):
            a, b = cores[i], cores[i + 1]
            d = a.shape[-1]
            ra = np.sqrt(np.sum(np.abs(a.reshape(-1, d)) ** 2, axis=0))
            rb = np.sqrt(np.sum(np.abs(b.reshape(d, -1)) ** 2, axis=1))
            t = np.sqrt(np.where(ra > 0, rb, 1.0) / np.where(rb > 0, ra, 1.0))
            t = np.where((ra > 0) & (rb > 0), t, 1.0)
            cores[i] = a * t
            cores[i + 1] = b / t.reshape(d, *([1] * (b.ndim - 1)))
    # Global scalar equalisation: scale every core to the geometric-mean
    # Frobenius norm.  Per-core scalars a_i with Π a_i = 1 leave the
    # operator invariant, and a_i = g/‖W_i‖ telescopes exactly — without
    # it, hundreds-of-sites MPOs accumulate core norms beyond the float32
    # range.
    lognorms = np.array([
        np.log(max(np.linalg.norm(c), 1e-300)) for c in cores
    ])
    g = lognorms.mean()
    cores = [
        c * np.exp(g - ln) for c, ln in zip(cores, lognorms)
    ]
    return cores


def mpo_sum(all_cores: list[Cores], cutoff: float = 1.0e-13) -> Cores:
    """Sum many MPOs pairwise (balanced tree), compressing at each level."""
    if not all_cores:
        raise ValueError("empty MPO sum")
    level = list(all_cores)
    while len(level) > 1:
        nxt: list[Cores] = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(mpo_compress(mpo_direct_sum(level[i], level[i + 1]), cutoff))
        if len(level) % 2 == 1:
            nxt.append(level[-1])
        level = nxt
    return mpo_balance(mpo_compress(level[0], cutoff))


def mpo_to_dense(cores: Cores) -> np.ndarray:
    """Contract an MPO to the dense operator matrix (testing only)."""
    full = cores[0]  # (1, i0, j0, b)
    for core in cores[1:]:
        full = np.einsum("aijb,bklc->aikjlc", full, core)
        a, i0, k0, j0, l0, c = full.shape
        full = full.reshape(a, i0 * k0, j0 * l0, c)
    return full[0, :, :, 0]


def mpo_bond_dims(cores: Cores) -> list[int]:
    return [c.shape[0] for c in cores] + [cores[-1].shape[-1]]
