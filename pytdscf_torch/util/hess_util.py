"""Normal-mode analysis from Cartesian Hessians.

Counterpart of ``PyTDSCF:pytdscf/util/hess_util.py`` as library
functions: mass-weight a Cartesian Hessian, project translations/rotations,
diagonalise to harmonic frequencies and mass-weighted displacement vectors —
the inputs for :class:`~pytdscf_torch.ase_handler.DVR_Mesh` and
polynomial-PES construction.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch import units

#: electron mass per unified atomic mass unit (CODATA 2018)
EMU_PER_AMU = 1822.888486209


def mass_weight_hessian(hess_cart: np.ndarray, masses_amu) -> np.ndarray:
    """H_mw[iα, jβ] = H[iα, jβ]/√(m_i m_j), masses in amu, H in a.u."""
    m = np.repeat(np.asarray(masses_amu, float) * EMU_PER_AMU, 3)
    return hess_cart / np.sqrt(np.outer(m, m))


def _tr_projector(masses_amu, coords_bohr) -> np.ndarray:
    """Projector removing rigid translations + rotations (Eckart)."""
    masses = np.asarray(masses_amu, float) * EMU_PER_AMU
    coords = np.asarray(coords_bohr, float).reshape(-1, 3)
    natom = coords.shape[0]
    com = (masses[:, None] * coords).sum(0) / masses.sum()
    x = coords - com
    vecs = []
    sq = np.sqrt(masses)
    for k in range(3):  # translations
        v = np.zeros((natom, 3))
        v[:, k] = sq
        vecs.append(v.ravel())
    for k in range(3):  # rotations
        axis = np.zeros(3)
        axis[k] = 1.0
        v = np.cross(np.broadcast_to(axis, (natom, 3)), x) * sq[:, None]
        if np.linalg.norm(v) > 1.0e-10:
            vecs.append(v.ravel())
    basis, _ = np.linalg.qr(np.array(vecs).T)
    eye = np.eye(3 * natom)
    return eye - basis @ basis.T


def normal_mode_analysis(
    hess_cart: np.ndarray,
    masses_amu,
    coords_bohr: np.ndarray | None = None,
    project_tr: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Harmonic analysis.

    Returns ``(freqs_cm1, disp_vectors)`` where ``disp_vectors[k]`` is the
    (natom, 3) Cartesian displacement per unit mass-weighted normal
    coordinate of mode k (ready for :class:`DVR_Mesh`); imaginary
    frequencies are returned negative.  Translations/rotations are
    projected out when reference ``coords_bohr`` are given.
    """
    hess_mw = mass_weight_hessian(hess_cart, masses_amu)
    if project_tr and coords_bohr is not None:
        P = _tr_projector(masses_amu, coords_bohr)
        hess_mw = P @ hess_mw @ P
    w2, vecs = np.linalg.eigh(hess_mw)
    freqs = np.sign(w2) * np.sqrt(np.abs(w2)) * units.au_in_cm1
    # keep vibrational modes (drop ~zero tr/rot)
    keep = np.abs(freqs) > 1.0
    freqs = freqs[keep]
    vecs = vecs[:, keep]
    masses = np.repeat(np.asarray(masses_amu, float) * EMU_PER_AMU, 3)
    disp = (vecs / np.sqrt(masses)[:, None]).T
    natom = len(masses_amu)
    return freqs, disp.reshape(-1, natom, 3)


def harmonic_korig(freqs_cm1) -> dict[tuple[int, int], float]:
    """Quadratic k_orig from harmonic frequencies (k_ii = ω_i² in a.u.)."""
    out = {}
    for i, f in enumerate(freqs_cm1, start=1):
        w = f / units.au_in_cm1
        out[(i, i)] = w * w
    return out
