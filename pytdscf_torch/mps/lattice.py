"""MPS allocation: bond-dimension lattice and deterministic initial states.

Bond-dimension rule and Hartree-product initialisation follow the reference
(``PyTDSCF:pytdscf/_mps_cls.py:2573-2703``,
``_site_cls.py:409-476``): the initial product state is embedded in a
zero-padded MPS of the requested bond dimension and right-canonicalised by
QR, which is fully deterministic (no RNG needed for regression parity).
"""

from __future__ import annotations

import math

import numpy as np


def _capped_prod(dims, cap: int) -> int:
    out = 1
    for d in dims:
        out *= d
        if out >= cap:
            return cap
    return out


def bond_dims_for_site(
    phys_dims: list[int], isite: int, m_max: int
) -> tuple[int, int]:
    """(left, right) bond dims of site ``isite`` for max bond ``m_max``."""
    nsite = len(phys_dims)
    dim_c = phys_dims[isite]
    dim_l = 1 if isite == 0 else _capped_prod(phys_dims[:isite], m_max)
    dim_r = (
        1 if isite == nsite - 1 else _capped_prod(phys_dims[isite + 1 :], m_max)
    )
    m_l = min(dim_l, dim_c * dim_r, m_max)
    m_r = min(dim_l * dim_c, dim_r, m_max)
    if isite == 0:
        m_l = 1
    if isite == nsite - 1:
        m_r = 1
    return m_l, m_r


def right_canonicalize(cores: list[np.ndarray]) -> list[np.ndarray]:
    """C…C → C·B…B by LQ sweeps (site tensors (l, n, r), numpy, host)."""
    cores = [np.asarray(c, dtype=np.complex128) for c in cores]
    for p in range(len(cores) - 1, 0, -1):
        l, n, r = cores[p].shape
        q, rmat = np.linalg.qr(cores[p].transpose(2, 1, 0).reshape(r * n, l))
        sval = rmat.T
        cores[p] = q.reshape(r, n, -1).transpose(2, 1, 0)
        cores[p - 1] = np.tensordot(cores[p - 1], sval, axes=(2, 0))
    return cores


def alloc_hartree_product(
    phys_dims: list[int],
    m_max: int,
    hartree_vecs: list[np.ndarray] | None,
    weight: float = 1.0,
    space: str = "hilbert",
    rng: np.random.Generator | None = None,
) -> list[np.ndarray]:
    """Build a right-canonical MPS (…B B with Psi at site 0).

    With ``hartree_vecs`` the state is exactly the given product state padded
    to bond dimension ``m_max``; otherwise a deterministic-seed random state.
    """
    nsite = len(phys_dims)
    cores: list[np.ndarray] = []
    for p in range(nsite):
        m_l, m_r = bond_dims_for_site(phys_dims, p, m_max)
        data = np.zeros((m_l, phys_dims[p], m_r), dtype=np.complex128)
        if hartree_vecs is not None:
            vec = np.asarray(hartree_vecs[p], dtype=np.complex128)
            if vec.ndim == 3:
                # entangled (purified) initialisation: the caller provides
                # a full (l, n, r) core, e.g. an ancilla Bell pair
                # (reference purified-MPS workflow,
                # ``PyTDSCF:tests/test_mixedstate.py:629-646``).
                if vec.shape[1] != phys_dims[p]:
                    raise ValueError(
                        f"site {p}: physical dim {vec.shape[1]} != "
                        f"{phys_dims[p]}"
                    )
                if vec.shape[0] > m_l or vec.shape[2] > m_r:
                    raise ValueError(
                        f"site {p}: initial core bonds {vec.shape} exceed "
                        f"lattice bonds ({m_l}, {m_r}); raise m_aux_max"
                    )
                data[: vec.shape[0], :, : vec.shape[2]] = vec
                cores.append(data)
                continue
            if space == "hilbert":
                vec = vec / np.linalg.norm(vec)
            else:
                # liouville: normalise by the trace of the vectorised matrix;
                # for subspace-projected (non-square) legs the kept entries
                # of a diagonal subspace ARE the diagonal, so their sum is
                # the trace.
                nsq = math.isqrt(vec.size)
                if nsq * nsq == vec.size:
                    vec = vec / np.trace(vec.reshape(nsq, nsq))
                else:
                    vec = vec / np.sum(vec)
            data[0, :, 0] = vec
        else:
            if rng is None:
                rng = np.random.default_rng(0)
            data[:] = rng.normal(size=data.shape) + 1j * rng.normal(
                size=data.shape
            )
        cores.append(data)
    cores = right_canonicalize(cores)
    if space == "hilbert":
        cores[0] = cores[0] * (
            math.sqrt(weight) / np.linalg.norm(cores[0])
        )
    else:
        cores[0] = cores[0] * math.sqrt(weight)
    return cores
