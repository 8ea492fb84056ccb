"""Projector-splitting 1-site TDVP sweep engine (the hot path), in PyTorch.

The counterpart of the JAX package's ``mps/tdvp.py`` for the ported slice: one
electronic state under one fused MPO, real-time propagation with Lanczos
and the symmetric lt2 step.  One time step is a forward and a backward
half-sweep of dt/2; at each site:

1. exp(−i·dt/2·H_eff) on the site tensor (``cuda_lanczos.lanczos_expm``);
2. the QR gauge move (``kernels.qr_right`` / ``lq_left``, MGS);
3. the environment-block transfer, kept at unit norm with a log-scale;
4. exp(+i·dt/2·K_eff) on the bond matrix (``lanczos_expm`` again);
5. absorbing the bond matrix into the next core.

On a CUDA device every Krylov exponential runs the Lanczos kernel and every
gauge move the MGS kernel; on the CPU both run their plain versions.  No
step of a sweep reads a value back to the host: the Krylov telemetry stays
on the device until :meth:`TDVPEngine.krylov_stats`.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from pytdscf_torch.config import Config
from pytdscf_torch.mps import kernels as K
from pytdscf_torch.mps.cuda_lanczos import (
    heff_channels,
    keff_channels,
    lanczos_expm,
)

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _normalize_block(B):
    """(B̂, log‖B‖) — environment blocks are kept at unit Frobenius norm
    with the scale carried as a log (float32 chains of hundreds of sites
    overflow otherwise: per-core factors ~2 compound to 2^N ≫ 3.4e38)."""
    nrm = torch.linalg.vector_norm(B).clamp_min(1e-30)
    return B / nrm, torch.log(nrm)


def _site_step(psi, nxt, L, W, R, scale, lL, lR, *, cfg, forward, last):
    """One site update.  Returns (site_out, psi_next, (block, log), stats).

    ``L``/``R`` are the blocks left and right of the site and ``lL``/``lR``
    their log-scales; the block on the sweep's trailing side is the
    growing system block, the other the cached environment.  ``stats``
    holds the ``[k_used, bad]`` status of each Krylov call.
    """
    l, d, r = psi.shape
    conserve = cfg.conserve_norm
    ch = heff_channels(L, W, R, torch.exp(lL + lR))
    out, st_h = lanczos_expm(
        ch, psi.reshape(l * d, r).contiguous(), scale, cfg.thresh_exp, cfg.max_krylov,
        conserve,
    )
    psi_new = out.reshape(l, d, r)
    if last:
        return psi_new, None, None, [st_h]
    if forward:
        site_out, sig = K.qr_right(psi_new)
        raw = K.renorm_block_left(L, site_out, W, site_out)
        l_sys, l_env = lL, lR
    else:
        sig, site_out = K.lq_left(psi_new)
        raw = K.renorm_block_right(R, site_out, W, site_out)
        l_sys, l_env = lR, lL
    block, dl = _normalize_block(raw)
    log_new = l_sys + dl
    kL, kR = (block, R) if forward else (L, block)
    kch = keff_channels(kL, kR, torch.exp(log_new + l_env))
    sig_new, st_k = lanczos_expm(
        kch, sig.contiguous(), -scale, cfg.thresh_exp, cfg.max_krylov,
        conserve,
    )
    psi_next = (
        K.absorb_right(sig_new, nxt) if forward else K.absorb_left(nxt, sig_new)
    )
    return site_out, psi_next, (block, log_new), [st_h, st_k]


class TDVPEngine:
    """Holds the MPS cores, fused MPO and cached environments; sweeps.

    ``cores``: per-state lists of numpy site tensors (l, n, r), with the
    orthogonality centre at site 0; ``hamiltonian``: any object with
    ``fused_mpo(phys_dims)`` (a ``TensorHamiltonian``, or
    ``convert.FusedMPO``); ``device``: where the tensors live.
    """

    def __init__(self, cores, hamiltonian, config: Config, device="cpu"):
        if config.relax != "none":
            raise NotImplementedError(
                f"relax={config.relax!r}: relaxation is not ported yet "
                "(ROADMAP A7)"
            )
        if config.integrator != "lanczos":
            raise NotImplementedError(
                "Arnoldi Krylov exponential: not ported yet (ROADMAP A2)"
            )
        if config.splitting != "lt2":
            raise NotImplementedError(
                f"splitting={config.splitting!r}: 4th-order compositions "
                "are not ported yet (ROADMAP A10)"
            )
        if len(cores) != 1:
            raise NotImplementedError(
                f"nstate={len(cores)}: multi-state sweeps are not ported "
                "yet (ROADMAP A3)"
            )
        self.config = config
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.dtype]
        if self.device.type == "cuda" and self.dtype != torch.complex64:
            raise ValueError("the CUDA kernels take complex64: set dtype")
        self.nstate = 1
        self.nsite = len(cores[0])
        self.cores = [[self._put(c) for c in state] for state in cores]
        self.phys_dims = [int(c.shape[1]) for c in cores[0]]
        fused = hamiltonian.fused_mpo(self.phys_dims)
        if len(fused) != 1 or fused[0][0] is None:
            raise NotImplementedError(
                "multi-state Hamiltonians are not ported yet (ROADMAP A3)"
            )
        #: fused MPO cores W[p] (a, i, j, b) of the single state pair
        self.W = [self._put(c) for c in fused[0][0]]
        #: env stack of (block, log-scale): blocks accumulated by the
        #: previous half-sweep; popping yields the next site's environment
        self.env_stack: list | None = None
        #: device-side Krylov telemetry [Σ k_used, # cap hits] and the host
        #: count of Krylov calls since the last krylov_stats()
        self._kry_sum: torch.Tensor | None = None
        self._kry_calls = 0
        self._kry_warned = False
        #: running max gauge deviation (pytest_enabled self-checks)
        self._gauge_dev: torch.Tensor | None = None

    # ---------------------------------------------------------- helpers
    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, self.dtype)

    def _trivial(self):
        real = torch.float64 if self.dtype == torch.complex128 else torch.float32
        return (
            torch.ones((1, 1, 1), dtype=self.dtype, device=self.device),
            torch.zeros((), dtype=real, device=self.device),
        )

    def build_right_env_stack(self) -> list:
        """[trivial, R(N−1..), …, R(1..)] — pop order matches a → sweep.

        Entries are (normalised block, log-scale)."""
        stack = [self._trivial()]
        for p in range(self.nsite - 1, 0, -1):
            c = self.cores[0][p]
            B, lg = stack[-1]
            Bn, dl = _normalize_block(K.renorm_block_right(B, c, self.W[p], c))
            stack.append((Bn, lg + dl))
        return stack

    def build_left_env_stack(self) -> list:
        """[trivial, L(..0), …, L(..N−2)] — pop order matches a ← sweep."""
        stack = [self._trivial()]
        for p in range(self.nsite - 1):
            c = self.cores[0][p]
            B, lg = stack[-1]
            Bn, dl = _normalize_block(K.renorm_block_left(B, c, self.W[p], c))
            stack.append((Bn, lg + dl))
        return stack

    # ------------------------------------------------------------ sweeps
    def _half_sweep(self, scale: complex, forward: bool) -> None:
        cfg = self.config
        if self.env_stack is None:
            self.env_stack = (
                self.build_right_env_stack()
                if forward
                else self.build_left_env_stack()
            )
        env_stack = self.env_stack
        sys_block, sys_log = self._trivial()
        sys_stack = [(sys_block, sys_log)]
        cores = self.cores[0]
        order = range(self.nsite) if forward else range(self.nsite - 1, -1, -1)
        stats = []
        for pos, p in enumerate(order):
            last = pos == self.nsite - 1
            env_block, env_log = env_stack.pop()
            q = p + 1 if forward else p - 1
            L, lL = (sys_block, sys_log) if forward else (env_block, env_log)
            R, lR = (env_block, env_log) if forward else (sys_block, sys_log)
            site_out, psi_next, new, st = _site_step(
                cores[p], None if last else cores[q], L, self.W[p], R, scale,
                lL, lR, cfg=cfg, forward=forward, last=last,
            )
            stats += st
            cores[p] = site_out
            if last:
                break
            if cfg.pytest_enabled:
                dev = K.gauge_error(site_out, left=forward)
                self._gauge_dev = (
                    dev if self._gauge_dev is None
                    else torch.maximum(self._gauge_dev, dev)
                )
            cores[q] = psi_next
            sys_block, sys_log = new
            sys_stack.append(new)
        self.env_stack = sys_stack
        acc = torch.stack(stats).sum(0)
        self._kry_sum = acc if self._kry_sum is None else self._kry_sum + acc
        self._kry_calls += len(stats)

    def propagate(
        self, dt: float, one_gate_to_apply=None, kraus_op=None
    ) -> None:
        """One TDVP step: forward + backward half-sweeps of dt/2 each."""
        if one_gate_to_apply is not None or kraus_op is not None:
            raise NotImplementedError(
                "one-site gates and Kraus maps are not ported yet "
                "(ROADMAP A10)"
            )
        scale = -0.5j * dt
        self._half_sweep(scale, forward=True)
        self._half_sweep(scale, forward=False)
        if self.config.pytest_enabled and self._gauge_dev is not None:
            dev = float(self._gauge_dev)
            self._gauge_dev = None
            tol = 1e-05 if self.dtype == torch.complex64 else 1e-09
            if dev > tol:
                raise AssertionError(
                    f"gauge canonicality violated in sweep: max |Q†Q−I| "
                    f"= {dev:.3e} > {tol:.0e}"
                )

    # ------------------------------------------------------- observables
    def expectation(self) -> complex:
        """⟨Ψ|H|Ψ⟩ with Psi canonical at site 0."""
        block, log = self._trivial()
        for p in range(self.nsite - 1, 0, -1):
            c = self.cores[0][p]
            block, dl = _normalize_block(
                K.renorm_block_right(block, c, self.W[p], c)
            )
            log = log + dl
        triv, _ = self._trivial()
        psi = self.cores[0][0]
        sig = K.heff_apply(triv, self.W[0], block, psi)
        return complex(torch.sum(psi.conj() * sig) * torch.exp(log))

    def pop_states(self) -> list[float]:
        return [float(torch.sum(torch.abs(self.cores[0][0]) ** 2))]

    def norm(self) -> float:
        return math.sqrt(sum(self.pop_states()))

    def autocorr(self) -> complex:
        """T/2-trick autocorrelation ⟨Ψ*|Ψ⟩ (no conjugation)."""
        S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
        for c in self.cores[0]:
            S = K.ovlp_left_noconj(S, c, c)
        return complex(S[0, 0])

    def distance(self, other: "TDVPEngine") -> float:
        """‖Ψ−Φ‖ via overlaps (reference ``distance_MPS``)."""
        n1 = sum(self.pop_states())
        n2 = sum(other.pop_states())
        S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
        for a, b in zip(self.cores[0], other.cores[0]):
            S = K.ovlp_left_conj(S, a, b.to(self.device, self.dtype))
        ov = complex(S[0, 0])
        return math.sqrt(max(n1 + n2 - 2.0 * ov.real, 0.0))

    def krylov_stats(self, reset: bool = True) -> tuple[float, int, int]:
        """(mean Krylov dim per call, # calls, # max-dim cap hits) since the
        last call (the reference's AVG-SIL-iterations telemetry)."""
        if self._kry_sum is None:
            return 0.0, 0, 0
        total, capped = (int(x) for x in self._kry_sum.tolist())
        calls = self._kry_calls
        if reset:
            self._kry_sum = None
            self._kry_calls = 0
        if capped and not self._kry_warned:
            warnings.warn(
                f"Krylov exponential hit max_dim={self.config.max_krylov} "
                f"without reaching thresh_exp={self.config.thresh_exp} in "
                f"{capped}/{calls} local updates — shrink dt or raise "
                "max_krylov"
            )
            self._kry_warned = True
        return total / calls if calls else 0.0, calls, capped

    def to_numpy(self) -> list[list[np.ndarray]]:
        """Per-state lists of the site tensors as numpy arrays."""
        return [[c.cpu().numpy() for c in state] for state in self.cores]
