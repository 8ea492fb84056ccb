"""Primitive operator matrices: ⟨bra-basis | op | ket-basis⟩ per DOF.

A copy of the JAX package's ``basis/op_matrix.py`` (pure numpy): the
integral engine behind the SOP/polynomial Hamiltonian layer
(``operators/sop.py``), the counterpart of upstream PyTDSCF's analytic
HO-FBR integrals (``pytdscf/basis/_primints_cls.py``):

* same-basis FBR matrices come from *margined ladder algebra* — q̂ and d/dq
  are exact (tridiagonal) in a (nprim+n)-dimensional HO basis, so the
  truncated product is the exact integral matrix (no Hermite summations);
* cross-basis overlaps ⟨HO(ω,a)|HO(ω′,a′)⟩ use Gauss–Hermite quadrature on
  the combined Gaussian, exact for polynomial integrands of bounded degree;
  every cross-basis operator matrix is then  ovlp @ (ladder algebra in the
  ket basis).

The JAX package's native C++ version of the two kernels and its
primitive-integral tables (``basis/primints.py``) serve the ground-state
projection only and are not copied (ROADMAP A3).
``tests/test_torch_host_model.py`` holds this copy to the original.

Supported op keys: ``ovlp``/``1``, ``q^n``, ``d^1``, ``d^2``, and for
Boson/Exciton bases ``b``/``bdag``/``num``/``q``/``p``/``q^2``/``p^2``.
"""

from __future__ import annotations

import math

import numpy as np

from pytdscf_torch.basis.abc import DVRPrimitivesMixin
from pytdscf_torch.basis.boson import Boson, Exciton
from pytdscf_torch.basis.ho import HarmonicOscillator, PrimBas_HO


# ------------------------------------------------------------ HO ladders
def _ladder(n: int) -> np.ndarray:
    """Annihilation operator a in an n-dimensional HO basis."""
    return np.diag(np.sqrt(np.arange(1, n)), 1)


def ho_q_matrix(omega: float, origin: float, n: int, power: int = 1) -> np.ndarray:
    """Exact ⟨m|q̂^power|k⟩ (n×n) via a margined ladder product."""
    dim = n + power
    a = _ladder(dim)
    q = origin * np.eye(dim) + (a + a.T) / math.sqrt(2.0 * omega)
    return np.linalg.matrix_power(q, power)[:n, :n]


def ho_d1_matrix(omega: float, n: int) -> np.ndarray:
    """Exact ⟨m|d/dq|k⟩ = √(ω/2)(a − a†)."""
    a = _ladder(n)
    return math.sqrt(omega / 2.0) * (a - a.T)


def ho_d2_matrix(omega: float, n: int) -> np.ndarray:
    """Exact ⟨m|d²/dq²|k⟩ via the margined ladder square."""
    dim = n + 2
    a = _ladder(dim)
    d = math.sqrt(omega / 2.0) * (a - a.T)
    return (d @ d)[:n, :n]


def _hermite_rows(nmax: int, x: np.ndarray) -> np.ndarray:
    """H_m(x) for m = 0..nmax−1 on a node vector, by upward recurrence."""
    H = np.empty((nmax, x.size))
    H[0] = 1.0
    if nmax > 1:
        H[1] = 2.0 * x
    for m in range(2, nmax):
        H[m] = 2.0 * x * H[m - 1] - 2.0 * (m - 1) * H[m - 2]
    return H


def ho_overlap(
    omega_l: float, origin_l: float, n_l: int,
    omega_r: float, origin_r: float, n_r: int,
) -> np.ndarray:
    """⟨HO_m(ω_l, a_l)|HO_k(ω_r, a_r)⟩ by exact Gauss–Hermite quadrature.

    The product of the two Gaussians is one Gaussian of width S = ω_l+ω_r
    centred at c; after substitution the integrand is e^{-x²}·poly(x) of
    degree < m+k+1, integrated exactly with ⌈(m+k)/2⌉+1 nodes.
    """
    S = omega_l + omega_r
    c = (omega_l * origin_l + omega_r * origin_r) / S
    D = omega_l * omega_r * (origin_l - origin_r) ** 2 / S
    npts = (n_l + n_r) // 2 + 2
    x, w = np.polynomial.hermite.hermgauss(npts)
    q = c + x * math.sqrt(2.0 / S)
    zl = math.sqrt(omega_l) * (q - origin_l)
    zr = math.sqrt(omega_r) * (q - origin_r)
    Hl = _hermite_rows(n_l, zl)
    Hr = _hermite_rows(n_r, zr)
    # node weights absorb the completed-square Gaussian and the Jacobian
    core = np.einsum("mg,kg,g->mk", Hl, Hr, w)
    lg = np.arange(max(n_l, n_r), dtype=float)
    lognorm = -0.5 * (
        lg * math.log(2.0) + np.cumsum(np.concatenate([[0.0], np.log(np.maximum(lg[1:], 1.0))]))
    )
    norm_l = (omega_l / math.pi) ** 0.25 * np.exp(lognorm[:n_l])
    norm_r = (omega_r / math.pi) ** 0.25 * np.exp(lognorm[:n_r])
    pref = math.sqrt(2.0 / S) * math.exp(-D / 2.0)
    return pref * norm_l[:, None] * norm_r[None, :] * core


# --------------------------------------------------------- key resolution
def _ho_params(bas) -> tuple[float, float, int]:
    if isinstance(bas, PrimBas_HO):
        return bas.freq_au, bas.origin_mwc, bas.nprim
    raise TypeError(f"not an FBR HO basis: {type(bas)}")


def _same_basis(bra, ket) -> bool:
    if bra is ket:
        return True
    if isinstance(bra, PrimBas_HO) and isinstance(ket, PrimBas_HO):
        return (
            bra.freq_au == ket.freq_au
            and bra.origin_mwc == ket.origin_mwc
            and bra.nprim == ket.nprim
        )
    return type(bra) is type(ket) and getattr(bra, "nprim", None) == getattr(
        ket, "nprim", None
    )


def _dvr_op(bas: DVRPrimitivesMixin, key: str) -> np.ndarray:
    grids = np.asarray(bas.get_grids())
    if key in ("ovlp", "1"):
        return np.eye(bas.ngrid)
    if key.startswith("q^"):
        return np.diag(grids ** int(key[2:]))
    if key == "d^1":
        return bas.get_1st_derivative_matrix_dvr()
    if key == "d^2":
        return bas.get_2nd_derivative_matrix_dvr()
    raise ValueError(f"unsupported DVR op key {key}")


def _number_basis_op(bas, key: str) -> np.ndarray:
    if key in ("ovlp", "1"):
        return np.eye(bas.nprim)
    if isinstance(bas, Boson):
        table = {
            "b": bas.get_annihilation_matrix,
            "bdag": bas.get_creation_matrix,
            "num": bas.get_number_matrix,
            "q": bas.get_q_matrix,
            "p": bas.get_p_matrix,
            "q^1": bas.get_q_matrix,
            "q^2": bas.get_q2_matrix,
            "p^2": bas.get_p2_matrix,
        }
        if key in table:
            return table[key]()
        if key == "d^2":
            # kinetic in the number basis: d²/dq² = −p²
            return -bas.get_p2_matrix()
        if key.startswith("q^"):
            return np.linalg.matrix_power(bas.get_q_matrix(), int(key[2:]))
    if isinstance(bas, Exciton):
        table = {
            "b": bas.get_annihilation_matrix,
            "bdag": bas.get_creation_matrix,
        }
        if key in table:
            return table[key]()
    raise ValueError(f"unsupported op key {key} for {type(bas).__name__}")


def op_matrix(bra, ket, key: str) -> np.ndarray:
    """Matrix ⟨bra_m|op|ket_k⟩ for one DOF (bra/ket may differ per state)."""
    if isinstance(key, np.ndarray):
        return key
    if isinstance(bra, DVRPrimitivesMixin) or isinstance(ket, DVRPrimitivesMixin):
        if not _same_basis(bra, ket) and not isinstance(bra, type(ket)):
            raise NotImplementedError("cross-basis DVR integrals")
        return _dvr_op(ket, key)
    if isinstance(bra, (Boson, Exciton)):
        return _number_basis_op(ket, key)

    wl, al, nl = _ho_params(bra)
    wr, ar, nr = _ho_params(ket)
    same = _same_basis(bra, ket)
    if key in ("ovlp", "1"):
        return np.eye(nl) if same else ho_overlap(wl, al, nl, wr, ar, nr)
    if key.startswith("q^"):
        p = int(key[2:])
        if same:
            return ho_q_matrix(wr, ar, nr, p)
        ov = ho_overlap(wl, al, nl, wr, ar, nr + p)
        dim = nr + p
        a = _ladder(dim)
        q = ar * np.eye(dim) + (a + a.T) / math.sqrt(2.0 * wr)
        return ov @ np.linalg.matrix_power(q, p)[:, :nr]
    if key == "d^1":
        if same:
            return ho_d1_matrix(wr, nr)
        ov = ho_overlap(wl, al, nl, wr, ar, nr + 1)
        a = _ladder(nr + 1)
        return ov @ (math.sqrt(wr / 2.0) * (a - a.T))[:, :nr]
    if key == "d^2":
        if same:
            return ho_d2_matrix(wr, nr)
        ov = ho_overlap(wl, al, nl, wr, ar, nr + 2)
        a = _ladder(nr + 2)
        d = math.sqrt(wr / 2.0) * (a - a.T)
        return ov @ (d @ d)[:, :nr]
    raise ValueError(f"unsupported op key {key}")
