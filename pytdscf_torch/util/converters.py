"""Polynomial-PES file-format converters.

Functional counterparts of the reference's conversion scripts
(``PyTDSCF:pytdscf/util/{mop2korig,korig2mop,korig2op}.py``), as
importable functions:

* MIDAS/SINDO ``.mop`` files store *frequency-scaled* Taylor coefficients
  with factorial division; ``k_orig`` dicts store raw mass-weighted
  derivatives (1-based mode tuples, factorial NOT divided).
* QUANTICS ``.op`` operator files list terms as ``coef |1 q^n ...`` blocks.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from math import factorial, sqrt


def mop_to_korig(
    path: str, n_frqs: int, cut_off: float = 1.0e-12
) -> dict[tuple[int, ...], float]:
    """Read a MIDAS ``.mop`` file into a k_orig force-constant dict."""
    k_orig: dict[tuple[int, ...], float] = defaultdict(float)
    scl = [1.0] * (n_frqs + 1)  # 1-indexed scaling frequencies
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        words = line.split()
        if i == 0 or i == n_frqs + 1:
            continue
        if i <= n_frqs:
            scl[i] = sqrt(float(words[-1]))
            continue
        if not words:
            continue
        coeff = float(words[0])
        index = tuple(sorted(int(w) for w in words[1:]))
        for order in Counter(index).values():
            coeff *= factorial(order)
        for k in index:
            coeff *= scl[k]
        if abs(coeff) > cut_off:
            k_orig[index] += coeff
    return dict(k_orig)


def korig_to_mop(
    k_orig: dict[tuple[int, ...], float],
    nmode: int,
    path: str,
    level: str = "unknown",
    cutoff: float = 1.0e-20,
) -> None:
    """Write k_orig to a MIDAS ``.mop`` file (frequency-scaled)."""
    scl = []
    for k in range(1, nmode + 1):
        w2 = k_orig.get((k, k), 0.0)
        scl.append(sqrt(w2) if abs(w2) > 1.0e-20 else 1.0)
    with open(path, "w") as f:
        f.write(f"SCALING FREQUENCIES N_FRQS={nmode}\n")
        for s in scl:
            f.write(f"{s:.22e}\n")
        f.write(f"DALTON_FOR_MIDAS  {level}\n")
        for key, val in sorted(k_orig.items()):
            if abs(val) < cutoff:
                continue
            for order in Counter(key).values():
                val /= factorial(order)
            for k in key:
                val /= sqrt(scl[k - 1])
            f.write(f"{val:>29.22e}")
            for k in key:
                f.write(f"{k:>5}")
            f.write("\n")


def korig_to_op(
    k_orig: dict[tuple[int, ...], float],
    path: str,
    title: str = "pytdscf_torch export",
    div_factorial: bool = True,
) -> None:
    """Write k_orig as a QUANTICS/MCTDH ``.op`` HAMILTONIAN-SECTION
    (reference ``korig2op.py:1-170`` behaviour: q^n products, factorial
    divided, kinetic ``dq^2`` terms added per mode)."""
    modes = sorted({m for key in k_orig for m in key})
    with open(path, "w") as f:
        f.write("OP_DEFINE-SECTION\ntitle\n")
        f.write(f"{title}\nend-title\nend-op_define-section\n\n")
        f.write("PARAMETER-SECTION\n")
        names = {}
        for i, (key, val) in enumerate(sorted(k_orig.items())):
            coef = val
            if div_factorial:
                for order in Counter(key).values():
                    coef /= factorial(order)
            name = f"k{i}"
            names[key] = name
            f.write(f"{name} = {coef:.16e} , au\n")
        f.write("end-parameter-section\n\n")
        f.write("HAMILTONIAN-SECTION\n")
        f.write(" modes | " + " | ".join(f"v{m}" for m in modes) + "\n")
        for m_i, m in enumerate(modes, start=1):
            f.write(f"-0.5 |{m_i} dq^2\n")
        for key, name in names.items():
            cnt = Counter(key)
            ops = " ".join(
                f"|{modes.index(m) + 1} q^{n}" for m, n in sorted(cnt.items())
            )
            f.write(f"{name} {ops}\n")
        f.write("end-hamiltonian-section\n\nEND-OPERATOR\n")


def op_to_korig(path: str) -> dict[tuple[int, ...], float]:
    """Read back a ``.op`` file written by :func:`korig_to_op`."""
    params: dict[str, float] = {}
    k_orig: dict[tuple[int, ...], float] = {}
    modes: list[int] = []
    with open(path) as f:
        lines = f.readlines()
    in_par = in_ham = False
    for line in lines:
        ls = line.strip()
        if ls.startswith("PARAMETER-SECTION"):
            in_par = True
            continue
        if ls.startswith("end-parameter-section"):
            in_par = False
            continue
        if ls.startswith("HAMILTONIAN-SECTION"):
            in_ham = True
            continue
        if ls.startswith("end-hamiltonian-section"):
            in_ham = False
            continue
        if in_par and "=" in ls:
            name, rest = ls.split("=", 1)
            params[name.strip()] = float(rest.split(",")[0])
        elif in_ham and ls.startswith("modes"):
            modes = [int(v) for v in re.findall(r"v(\d+)", ls)]
        elif in_ham and ls and ls.split()[0] in params:
            name = ls.split()[0]
            key: list[int] = []
            for mode_idx, power in re.findall(r"\|(\d+) q\^(\d+)", ls):
                key.extend([modes[int(mode_idx) - 1]] * int(power))
            cnt = Counter(key)
            coef = params[name]
            for order in cnt.values():
                coef *= factorial(order)
            k_orig[tuple(sorted(key))] = coef
    return k_orig
