"""Runtime diagnostics: phase timers, Krylov telemetry, TN diagrams.

Counterpart of the reference's hand-rolled profiling globals
(``/root/reference/pytdscf/_helper.py:18-101`` — ``_ElpTime``/``_NFlops``/
``_Debug`` accumulators surfaced in the step log) without mutable module
globals: a :class:`Diagnostics` object is owned by the Simulator and passed
where needed.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Diagnostics:
    """Wall-time accumulators per phase + simple counters."""

    def __init__(self) -> None:
        self.elapsed: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def timer(self, phase: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.elapsed[phase] += time.time() - t0

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def report(self) -> str:
        parts = [
            f"{k}:{v:8.3f}s" for k, v in sorted(self.elapsed.items())
        ]
        parts += [f"{k}={v}" for k, v in sorted(self.counts.items())]
        return "  ".join(parts)


def mps_diagram(phys_dims: list[int], bond_dims: list[int]) -> str:
    """ASCII MPS diagram (reference ``_helper.py:294-414`` analog).

    ``bond_dims`` has nsite−1 entries.
    """
    top = []
    bot = []
    for p, n in enumerate(phys_dims):
        top.append(f"[{p}]")
        if p < len(bond_dims):
            top.append(f"--{bond_dims[p]}--")
        bot.append(f" |{n}")
        if p < len(bond_dims):
            bot.append(" " * len(f"--{bond_dims[p]}--"))
    return "".join(top) + "\n" + "".join(bot)


def mpo_diagram(phys_dims: list[int], bond_dims: list[int]) -> str:
    """ASCII MPO diagram with bra/ket legs."""
    top = []
    mid = []
    for p, n in enumerate(phys_dims):
        leg = f" |{n}"
        top.append(leg)
        if p < len(bond_dims):
            top.append(" " * len(f"--{bond_dims[p]}--"))
        mid.append(f"(W{p})")
        if p < len(bond_dims):
            mid.append(f"--{bond_dims[p]}--")
    return "".join(top) + "\n" + "".join(mid) + "\n" + "".join(top)
