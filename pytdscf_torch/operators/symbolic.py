"""Symbolic sum-of-products → MPO builder.

Native replacement for the reference's external ``pympo`` dependency
(`SumOfProducts`, `OpSite`, `AssignManager`, `get_eye_site` — used throughout
the reference's tests/notebooks, e.g.
``PyTDSCF:tests/test_mixedstate.py:11-16``): site-local operators are
composed with ``*`` and ``+`` into a symbolic sum of products (scalar
coefficients may be numbers or sympy expressions), and compiled to a single
numerical MPO core list by the package's tree-sum + SVD-compression algebra
instead of pympo's bipartite-graph assignment.
"""

from __future__ import annotations

import numbers
from typing import Any

import numpy as np

from pytdscf_torch.operators import mpo_algebra as alg


def _is_scalar(x) -> bool:
    if isinstance(x, numbers.Number):
        return True
    try:
        import sympy

        return isinstance(x, sympy.Expr)
    except ImportError:  # pragma: no cover
        return False


class OpProduct:
    """coef × Π_site op_site — one symbolic product term."""

    def __init__(self, coef: Any = 1.0, ops: dict[int, "OpSite"] | None = None):
        self.coef = coef
        self.ops: dict[int, OpSite] = dict(ops or {})

    def __mul__(self, other):
        if _is_scalar(other):
            return OpProduct(self.coef * other, self.ops)
        if isinstance(other, OpSite):
            other = other.as_product()
        if isinstance(other, OpProduct):
            ops = dict(self.ops)
            for site, op in other.ops.items():
                ops[site] = ops[site] @ op if site in ops else op
            return OpProduct(self.coef * other.coef, ops)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if _is_scalar(other):
            return OpProduct(self.coef / other, self.ops)
        return NotImplemented

    def __neg__(self):
        return OpProduct(-self.coef, self.ops)

    def __add__(self, other):
        return SumOfProducts([self]) + other

    def __radd__(self, other):
        return SumOfProducts([self]).__radd__(other)

    def __sub__(self, other):
        return SumOfProducts([self]) + (-other)

    def __repr__(self):
        names = "·".join(
            f"{op.name}[{s}]" for s, op in sorted(self.ops.items())
        )
        return f"({self.coef})·{names}"


class OpSite:
    """A named operator matrix acting on one site."""

    def __init__(self, name: str, isite: int, *, value: np.ndarray):
        self.name = name
        self.isite = isite
        self.value = np.asarray(value)

    def as_product(self) -> OpProduct:
        return OpProduct(1.0, {self.isite: self})

    def __matmul__(self, other: "OpSite") -> "OpSite":
        if other.isite != self.isite:
            raise ValueError("matrix product of ops on different sites")
        return OpSite(
            f"{self.name}@{other.name}", self.isite,
            value=self.value @ other.value,
        )

    def __mul__(self, other):
        return self.as_product() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.as_product() / other

    def __neg__(self):
        return -self.as_product()

    def __add__(self, other):
        return self.as_product() + other

    def __radd__(self, other):
        return SumOfProducts([self.as_product()]).__radd__(other)

    def __sub__(self, other):
        return self.as_product() - other

    def __rsub__(self, other):
        return (-self.as_product()) + other

    def __repr__(self):
        return f"OpSite({self.name}, site={self.isite})"


def get_eye_site(isite: int, n_basis: int) -> OpSite:
    return OpSite(f"I{isite}", isite, value=np.eye(n_basis))


class SumOfProducts:
    """Σ_k coef_k × Π op — a symbolic SOP operator."""

    def __init__(self, terms: list[OpProduct] | None = None):
        self.terms: list[OpProduct] = list(terms or [])

    def __iadd__(self, other):
        return self.__add__(other)

    def __add__(self, other):
        if isinstance(other, OpSite):
            other = other.as_product()
        if isinstance(other, OpProduct):
            return SumOfProducts(self.terms + [other])
        if isinstance(other, SumOfProducts):
            return SumOfProducts(self.terms + other.terms)
        if other == 0:
            return SumOfProducts(self.terms)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if _is_scalar(other):
            return SumOfProducts([t * other for t in self.terms])
        return NotImplemented

    __rmul__ = __mul__

    @property
    def symbol(self):
        import sympy

        return sympy.Add(
            *[
                sympy.Symbol(repr(t).replace(" ", "")) for t in self.terms
            ]
        )

    def simplify(self) -> "SumOfProducts":
        """Merge terms with identical operator content (sums coefficients)."""
        merged: dict[tuple, OpProduct] = {}
        for t in self.terms:
            key = tuple(
                (s, t.ops[s].value.shape, t.ops[s].value.tobytes())
                for s in sorted(t.ops)
            )
            if key in merged:
                merged[key] = OpProduct(
                    merged[key].coef + t.coef, merged[key].ops
                )
            else:
                merged[key] = OpProduct(t.coef, t.ops)
        # zero-coefficient terms are kept: they commonly carry spectator
        # identity sites (the reference's ``0.0 * eye`` idiom) that define
        # the chain length for AssignManager.
        return SumOfProducts(list(merged.values()))


class AssignManager:
    """Compile a :class:`SumOfProducts` into one numerical MPO."""

    def __init__(self, sop: SumOfProducts):
        self.sop = sop
        sites = sorted(
            {s for t in sop.terms for s in t.ops}
        )
        if not sites:
            raise ValueError("empty SumOfProducts")
        self.ndim = max(sites) + 1
        self._dims: list[int | None] = [None] * self.ndim
        for t in sop.terms:
            for s, op in t.ops.items():
                d = op.value.shape[0]
                if self._dims[s] is None:
                    self._dims[s] = d
                elif self._dims[s] != d:
                    raise ValueError(f"inconsistent dims at site {s}")
        if any(d is None for d in self._dims):
            raise ValueError(
                "every site in 0..max(site) must appear in some term "
                "(add get_eye_site terms for spectators)"
            )

    def assign(self) -> None:
        """API-parity no-op (compilation happens in numerical_mpo)."""

    @property
    def Wsym(self):  # pragma: no cover - display helper
        import sympy

        return [sympy.Symbol(f"W{i}") for i in range(self.ndim)]

    def numerical_mpo(
        self, subs: dict | None = None, cutoff: float = 1.0e-13
    ) -> list[np.ndarray]:
        """Evaluate coefficients (with sympy ``subs``) and fuse the MPO."""
        term_mpos = []
        for t in self.sop.terms:
            coef = t.coef
            if not isinstance(coef, numbers.Number):
                import sympy

                coef = complex(sympy.sympify(coef).subs(subs or {}))
            if coef == 0:
                continue
            site_cores = {
                s: np.asarray(op.value, complex)[None, :, :, None]
                for s, op in t.ops.items()
            }
            lo = min(site_cores)
            site_cores[lo] = site_cores[lo] * coef
            term_mpos.append(
                alg.extend_to_full_chain(site_cores, self.ndim, self._dims)
            )
        if not term_mpos:
            raise ValueError("all terms vanished")
        return alg.mpo_sum(term_mpos, cutoff)
