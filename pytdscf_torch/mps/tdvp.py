"""Projector-splitting 1-site TDVP sweep engine (the hot path), in PyTorch.

The counterpart of the JAX package's ``mps/tdvp.py`` for the ported slices:
one electronic state (an MPS, or a vectorised density matrix in Liouville
space) under one fused MPO, real-time propagation with the symmetric lt2
step.  One time step is a forward and a backward half-sweep of dt/2; at
each site:

1. exp(−i·dt/2·H_eff) on the site tensor;
2. the QR gauge move (``kernels.qr_right`` / ``lq_left``: MGS, or
   CholeskyQR³ for bonds of 192 and more);
3. the environment-block transfer, kept at unit norm with a log-scale;
4. exp(+i·dt/2·K_eff) on the bond matrix;
5. absorbing the bond matrix into the next core.

Two Krylov routes.  Lanczos (Hermitian H_eff, the small-bond chains): the
whole exponential is one ``cuda_lanczos.lanczos_expm`` call, the kernel on
CUDA.  Arnoldi (any H_eff, the Liouville MPDO): ``integrator.krylov_expm``
drives the exact float32 einsum matvecs and, with ``krylov_relaxed``, the
single-bf16-pass ``cuda_matvec`` kernels for iterations ``>= relax_after``.
The Lanczos route reads nothing back to the host inside a sweep; the
Arnoldi route reads one scalar per Krylov iteration (its stopping test).
The Krylov telemetry stays on the device until
:meth:`TDVPEngine.krylov_stats`.
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
from pytdscf_torch.mps.integrator import krylov_expm

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def _normalize_block(B):
    """(B̂, log‖B‖) — environment blocks are kept at unit Frobenius norm
    with the scale carried as a log (float32 chains of hundreds of sites
    overflow otherwise: per-core factors ~2 compound to 2^N ≫ 3.4e38)."""
    nrm = torch.linalg.vector_norm(B).clamp_min(1e-30)
    return B / nrm, torch.log(nrm)


def _arnoldi_expm(v, scale, fac, cfg, L, R, W=None):
    """exp(scale·H)·v by Arnoldi for H_eff (``W`` given) or K_eff.

    Returns ``(v', status, relaxed)``: ``status = [k_used, bad]`` (int32,
    on v's device) and the number of relaxed matvecs that ran.  The exact
    matvecs are float32 einsums (TF32 off); with ``krylov_relaxed`` the
    iterations ``k >= relax_after`` run the bf16 kernels."""
    shape = v.shape
    if W is not None:
        def mv(x):
            return (K.heff_apply(L, W, R, x.reshape(shape)) * fac).reshape(-1)

        mv_lo = (K.make_hmatvec_lo(L, W, R, shape, fac)
                 if cfg.krylov_relaxed else None)
    else:
        def mv(x):
            return (K.keff_apply(L, R, x.reshape(shape)) * fac).reshape(-1)

        mv_lo = (K.make_kmatvec_lo(L, R, shape, fac)
                 if cfg.krylov_relaxed else None)
    out, k_used, bad = krylov_expm(
        mv, v.reshape(-1), scale, cfg.thresh_exp, cfg.max_krylov,
        cfg.conserve_norm, arnoldi=True, return_iterations=True,
        matvec_lo=mv_lo, relax_after=cfg.relax_after,
    )
    status = torch.tensor([k_used, int(bad)], dtype=torch.int32,
                          device=v.device)
    relaxed = max(k_used - cfg.relax_after, 0) if cfg.krylov_relaxed else 0
    return out.reshape(shape), status, relaxed


def _site_step(psi, nxt, L, W, R, scale, lL, lR, *, cfg, forward, last):
    """One site update.  Returns (site_out, psi_next, (block, log), stats,
    relaxed).

    ``L``/``R`` are the blocks left and right of the site and ``lL``/``lR``
    their log-scales; the block on the sweep's trailing side is the
    growing system block, the other the cached environment.  ``stats``
    holds the ``[k_used, bad]`` status of each Krylov call, ``relaxed``
    the number of relaxed matvecs that ran.
    """
    l, d, r = psi.shape
    conserve = cfg.conserve_norm
    arnoldi = cfg.integrator == "arnoldi"
    hfac = torch.exp(lL + lR)
    relaxed = 0
    if arnoldi:
        psi_new, st_h, n = _arnoldi_expm(psi, scale, hfac, cfg, L, R, W)
        relaxed += n
    else:
        ch = heff_channels(L, W, R, hfac)
        out, st_h = lanczos_expm(
            ch, psi.reshape(l * d, r).contiguous(), scale, cfg.thresh_exp,
            cfg.max_krylov, conserve,
        )
        psi_new = out.reshape(l, d, r)
    if last:
        return psi_new, None, None, [st_h], relaxed
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
    kfac = torch.exp(log_new + l_env)
    if arnoldi:
        sig_new, st_k, n = _arnoldi_expm(sig, -scale, kfac, cfg, kL, kR)
        relaxed += n
    else:
        kch = keff_channels(kL, kR, kfac)
        sig_new, st_k = lanczos_expm(
            kch, sig.contiguous(), -scale, cfg.thresh_exp, cfg.max_krylov,
            conserve,
        )
    psi_next = (
        K.absorb_right(sig_new, nxt) if forward else K.absorb_left(nxt, sig_new)
    )
    return site_out, psi_next, (block, log_new), [st_h, st_k], relaxed


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
        if config.krylov_relaxed and config.integrator != "arnoldi":
            raise NotImplementedError(
                "relaxed Krylov with Lanczos: the port relaxes Arnoldi "
                "only (ROADMAP A2)"
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
        #: count of Krylov calls and of relaxed matvecs since the last
        #: krylov_stats()
        self._kry_sum: torch.Tensor | None = None
        self._kry_calls = 0
        self._kry_relaxed = 0
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
            site_out, psi_next, new, st, relaxed = _site_step(
                cores[p], None if last else cores[q], L, self.W[p], R, scale,
                lL, lR, cfg=cfg, forward=forward, last=last,
            )
            stats += st
            self._kry_relaxed += relaxed
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
        if self.config.space == "liouville":
            return abs(self.trace())
        return math.sqrt(sum(self.pop_states()))

    # ---------------------------------------------- Liouville space (MPDO)
    def right_canonicalize(self) -> None:
        """Psi·B…B with the centre at site 0 — the engine's between-step
        invariant — by LQ sweeps on the device (CholeskyQR³ at the large
        bonds)."""
        cores = self.cores[0]
        for p in range(self.nsite - 1, 0, -1):
            sig, b = K.lq_left(cores[p])
            cores[p] = b
            cores[p - 1] = K.absorb_left(cores[p - 1], sig)
        self.env_stack = None

    def _vec_eye(self, p: int) -> torch.Tensor:
        d = math.isqrt(self.phys_dims[p])
        return torch.eye(d, dtype=self.dtype, device=self.device).reshape(-1)

    def trace(self) -> complex:
        """Tr ρ of a vectorised-density-matrix MPS (Liouville space)."""
        S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
        for p in range(self.nsite):
            S = torch.einsum("lk,lnr,n->rk", S, self.cores[0][p],
                             self._vec_eye(p))
        return complex(S[0, 0])

    def reduced_density_liouville(
        self, remain_nleg: tuple[int, ...]
    ) -> np.ndarray:
        """Tr_rest ρ by vec(1) trace contraction over the untraced sites.

        ``remain_nleg[p] = 2`` keeps site p's density block (d×d), 1 keeps
        only its diagonal, 0 traces it out; sites beyond
        ``len(remain_nleg)`` are traced.  Kept legs come out site-major,
        each as (d, d) (or its diagonal)."""
        legs = list(remain_nleg) + [0] * (self.nsite - len(remain_nleg))
        acc = torch.ones((1,), dtype=self.dtype, device=self.device)
        kept = []
        for p in range(self.nsite):
            core = self.cores[0][p]
            if legs[p] == 0:
                m = torch.einsum("lnr,n->lr", core, self._vec_eye(p))
                acc = torch.einsum("l...,lr->r...", acc, m)
            else:
                acc = torch.einsum("l...,lnr->rn...", acc, core)
                kept.append((legs[p], math.isqrt(self.phys_dims[p])))
        out = acc[0].cpu().numpy()
        # kept legs were prepended: reverse to site order
        out = np.transpose(out, axes=tuple(range(out.ndim - 1, -1, -1)))
        shape = [dd for _, d in kept for dd in (d, d)]
        out = out.reshape(tuple(shape)) if shape else out
        ax = 0
        for nleg, _ in kept:
            if nleg == 1:
                out = np.moveaxis(np.diagonal(out, axis1=ax, axis2=ax + 1),
                                  -1, ax)
                ax += 1
            else:
                ax += 2
        return out

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

    def krylov_stats(self, reset: bool = True) -> tuple[float, int, int, int]:
        """(mean Krylov dim per call, # calls, # max-dim cap hits, # relaxed
        matvecs) since the last call (the reference's AVG-SIL-iterations
        telemetry).  The relaxed matvecs are Σ max(k_used − relax_after, 0)
        over the Krylov calls of a relaxed run: the launches the
        ``cuda_matvec`` kernels should have counted on a card."""
        if self._kry_sum is None:
            return 0.0, 0, 0, 0
        total, capped = (int(x) for x in self._kry_sum.tolist())
        calls, relaxed = self._kry_calls, self._kry_relaxed
        if reset:
            self._kry_sum = None
            self._kry_calls = 0
            self._kry_relaxed = 0
        if capped and not self._kry_warned:
            warnings.warn(
                f"Krylov exponential hit max_dim={self.config.max_krylov} "
                f"without reaching thresh_exp={self.config.thresh_exp} in "
                f"{capped}/{calls} local updates — shrink dt or raise "
                "max_krylov"
            )
            self._kry_warned = True
        return total / calls if calls else 0.0, calls, capped, relaxed

    def flops_estimate(self, avg_krylov: float = 1.0) -> float:
        """Algorithmic real FLOPs of one time step (two half-sweeps), from
        the core and MPO shapes (the JAX package's cost model): per site the
        (L·ψ·W·R) chain costs l·r·n·(w_l·l + w_r·r) + l·r·n²·w_l·w_r complex
        multiplications (8 real FLOPs each); each Krylov call runs
        ``avg_krylov`` matvecs (pass the measured :meth:`krylov_stats`
        mean), the environment transfer one more chain, and the K step is
        smaller by n."""
        total = 0.0
        for p in range(self.nsite):
            l, n, r = (int(x) for x in self.cores[0][p].shape)
            W = self.W[p]
            wl, wr = int(W.shape[0]), int(W.shape[3])
            hchain = 8.0 * (
                l * r * n * (wl * l + wr * r) + l * r * n * n * wl * wr
            )
            kchain = 8.0 * (l * r * (wl * l + wr * r))
            total += 2.0 * (
                (avg_krylov + 1.0) * hchain + hchain
                + (avg_krylov + 1.0) * kchain
            )
        return total

    def to_numpy(self) -> list[list[np.ndarray]]:
        """Per-state lists of the site tensors as numpy arrays."""
        return [[c.cpu().numpy() for c in state] for state in self.cores]
