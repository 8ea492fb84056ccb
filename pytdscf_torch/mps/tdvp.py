"""Projector-splitting 1-site TDVP sweep engine (the hot path), in PyTorch.

The counterpart of the JAX package's ``mps/tdvp.py`` for the ported slices:
one electronic state (an MPS, or a vectorised density matrix in Liouville
space) under one fused MPO, with the symmetric lt2 step, in the three
modes of ``Config.relax``.  One time step is a forward and a backward
half-sweep of dt/2; at each site:

1. exp(scale·H_eff) on the site tensor, scale = −i·dt/2 in real time and
   −dt/2 in imaginary time (the result renormalised);
2. the QR gauge move (``kernels.qr_right`` / ``lq_left``: MGS, or
   CholeskyQR³ for bonds of 192 and more);
3. the environment-block transfer, kept at unit norm with a log-scale;
4. exp(−scale·K_eff) on the bond matrix;
5. absorbing the bond matrix into the next core.

Improved relaxation (``relax="improved"``, the JAX package's ``mode ==
"improved"``) replaces step 1 by the lowest eigenvector of H_eff, restarted
Lanczos from the site itself (``cuda_lanczos.ground_state``: one kernel
launch a site on the card where ``gs_fits``, else
``integrator.ground_state_multi`` over the einsums), and skips step 4.
:meth:`TDVPEngine.apply_operator_fit` fits O|Ψ⟩ by alternating sweeps
(``Simulator.operate``).

Two Krylov routes.  Lanczos (Hermitian H_eff, the small-bond chains): the
whole exponential is one ``cuda_lanczos.lanczos_expm`` call, the kernel on
CUDA, where its channels fit (``cuda_lanczos.fits``) and the matvecs are
exact ("highest", not relaxed: the JAX package's ``use_plz`` rule); with
``Config.fused_site`` the five steps of a non-last site are one
``cuda_site.site_step_fused`` call where its shapes fit.  Every other site
(Arnoldi for any H_eff, the Liouville MPDO; Lanczos past the kernel, with
relaxed Krylov or with "high"/"default" matvecs) runs
``integrator.krylov_expm`` over the einsum matvecs: float32 (TF32 off) at
``matvec_precision="highest"``, the bf16x3 ``cuda_renorm.heff_hi``/
``keff_hi`` kernel at "high", the one-bf16-pass ``cuda_matvec`` kernels at
"default" and, with ``krylov_relaxed``, for iterations ``>= relax_after``.
At ``env_precision="high"`` the in-sweep environment transfers run the
bf16x3 kernel (``cuda_renorm.renorm_left_hi``/``renorm_right_hi``), at
"default" its one-pass form (``renorm_left_lo``/``renorm_right_lo``).
The Krylov control (the stopping tests, the small exponential, the
status) runs on the device (``cuda_krylov.krylov_ctl``): a step launched
from the host reads one flag per Krylov iteration of the einsum route and
nothing on the kernel routes.  The Krylov telemetry stays on the device
until :meth:`TDVPEngine.krylov_stats`.

Two drivers.  :meth:`TDVPEngine.propagate` runs one step, each kernel
launched from the host.  :meth:`TDVPEngine.propagate_steps` and
:meth:`~TDVPEngine.propagate_steps_collect` (the JAX package's fused
multi-step driver) run a block of steps, the latter collecting each step's
pre-step observables on the device (:meth:`~TDVPEngine.properties_submit`)
for one packed host read per block (:func:`fetch_many`).  The block's steps
run as a program over fixed buffers (``step_graph.StepProgram``, where
:meth:`~TDVPEngine.capturable` holds): on the card one step is recorded as
a CUDA graph, its Krylov iterations as IF nodes, and replayed; on the CPU
the same step runs uncaptured.
"""

from __future__ import annotations

import math
import warnings
from functools import partial

import numpy as np
import torch

from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_krylov as CK
from pytdscf_torch.mps import cuda_renorm as CR
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.mps import kernels as K
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import pairs as P
from pytdscf_torch.mps import step_graph
from pytdscf_torch.mps.integrator import (
    GS_MAX_RESTARTS,
    ground_state_multi,
    krylov_expm,
)

_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def fetch_many(items, real) -> list[np.ndarray]:
    """The values of the device tensors ``items`` through ONE
    device→host copy (a packed real vector of dtype ``real``), each as a
    numpy array of its own shape, complex where it was complex."""
    if not items:
        return []
    host = step_graph.pack(items, real).cpu().numpy()
    cplx = np.complex64 if host.dtype == np.float32 else np.complex128
    out, k = [], 0
    for x in items:
        n = x.numel() * (2 if x.is_complex() else 1)
        v = host[k:k + n].copy()
        k += n
        out.append((v.view(cplx) if x.is_complex() else v).reshape(x.shape))
    return out


def _unstack(rows: torch.Tensor, layout) -> list[torch.Tensor]:
    """Per-step packed rows (n, width) → one tensor per item of ``layout``
    ((shape, dtype) of each), with a leading step axis."""
    n, out, k = rows.shape[0], [], 0
    for shape, dtype in layout:
        numel = math.prod(shape)
        width = 2 * numel if dtype.is_complex else numel
        part = rows[:, k:k + width]
        k += width
        if dtype.is_complex:
            part = torch.view_as_complex(part.reshape(n, *shape, 2).contiguous())
        out.append(part.reshape(n, *shape))
    return out


def _takes_fused_site(cfg, psi_shape, W_shape, nxt_shape,
                      nstate: int = 1) -> bool:
    """Whether a non-last site update runs as one call of the fused site
    kernel (``cuda_site.site_step_fused``)."""
    return (
        cfg.fused_site
        and _takes_lanczos_kernel(cfg, nstate)
        and cfg.env_precision == "highest"
        and CS.site_fits(psi_shape, W_shape, nxt_shape, cfg.max_krylov)
    )


def _takes_lanczos_kernel(cfg, nstate: int = 1) -> bool:
    """Whether Lanczos sites may run the Lanczos kernel (where its channels
    fit): one electronic state, exact "highest" matvecs, no relaxed Krylov
    and no improved relaxation (which runs no exponential), the JAX
    package's ``use_plz`` rule; otherwise ``integrator.krylov_expm``
    runs."""
    return (nstate == 1 and cfg.integrator == "lanczos"
            and not cfg.krylov_relaxed
            and cfg.matvec_precision == "highest"
            and cfg.relax != "improved")


def _takes_gs_kernel(shape, width: int, nstate: int = 1) -> bool:
    """Whether an improved-relaxation site of ``shape`` (M, r) under an
    MPO of ``width`` channels runs the ground-state kernel
    (``cuda_lanczos.ground_state``): one electronic state where
    ``gs_fits`` takes it; otherwise ``integrator.ground_state_multi``
    over the einsum matvec."""
    return nstate == 1 and CL.gs_fits(shape, width)


def _conserve(cfg) -> bool:
    """Whether the exponentials renormalise their result: as configured,
    and always in imaginary time (the JAX package's ``conserve_norm or
    mode == "imag"``)."""
    return cfg.conserve_norm or cfg.relax == "imaginary"


def step_scale(cfg, dt: float) -> complex:
    """The half-sweep's exponent scale: ``−i·dt/2`` in real time, ``−dt/2``
    in both relaxation modes (``exp(−dt/2·H)``; improved relaxation runs no
    exponential and keys its step programs by it)."""
    return -0.5j * dt if cfg.relax == "none" else complex(-0.5 * dt)


def _normalize_block(B):
    """(B̂, log‖B‖) — environment blocks are kept at unit Frobenius norm
    with the scale carried as a log (float32 chains of hundreds of sites
    overflow otherwise: per-core factors ~2 compound to 2^N ≫ 3.4e38)."""
    nrm = torch.linalg.vector_norm(B).clamp_min(1e-30)
    return B / nrm, torch.log(nrm)


def _einsum_expm(v, scale, fac, cfg, L, R, W=None):
    """exp(scale·H)·v by ``integrator.krylov_expm`` for H_eff (``W``
    given) or K_eff: Arnoldi, or Lanczos with ``cfg.integrator ==
    "lanczos"`` (a site the Lanczos kernel does not take).

    Returns ``(v', status, relaxed)``: ``status = [k_used, bad]`` and the
    number of relaxed matvecs that ran (int32, on v's device).  The exact
    matvecs are float32 einsums (TF32 off), at ``matvec_precision="high"``
    the bf16x3 chain (``cuda_renorm``), at "default" the one-pass bf16
    kernels (``cuda_matvec``); with ``krylov_relaxed`` the iterations
    ``k >= relax_after`` run the one-pass kernels."""
    shape = v.shape
    prec = cfg.matvec_precision
    lo = None
    if W is not None:
        if cfg.krylov_relaxed or prec == "default":
            lo = K.make_hmatvec_lo(L, W, R, shape, fac)
        if prec == "high":
            apply = partial(CR.heff_hi, CR.heff_operands(L, W, R))
        else:
            apply = partial(K.heff_apply, L, W, R)
    else:
        if cfg.krylov_relaxed or prec == "default":
            lo = K.make_kmatvec_lo(L, R, shape, fac)
        if prec == "high":
            apply = partial(CR.keff_hi, CR.keff_operands(L, R))
        else:
            apply = partial(K.keff_apply, L, R)

    def mv(x):
        return (apply(x.reshape(shape)) * fac).reshape(-1)

    out, status = krylov_expm(
        lo if prec == "default" else mv, v.reshape(-1), scale, cfg.thresh_exp,
        cfg.max_krylov, _conserve(cfg),
        arnoldi=cfg.integrator == "arnoldi", return_status=True,
        matvec_lo=lo if cfg.krylov_relaxed else None,
        relax_after=cfg.relax_after,
    )
    return out.reshape(shape), status[:2], status[2]


def _site_step(psi, nxt, L, W, R, scale, lL, lR, *, cfg, forward, last):
    """One site update in real or imaginary time.  Returns (site_out,
    psi_next, (block, log), stats, relaxed).

    ``L``/``R`` are the blocks left and right of the site and ``lL``/``lR``
    their log-scales; the block on the sweep's trailing side is the
    growing system block, the other the cached environment.  ``stats``
    holds the ``[k_used, bad]`` status of each Krylov call, ``relaxed``
    the relaxed-matvec counts (device scalars) of its einsum-route calls.
    """
    l, d, r = psi.shape
    conserve = _conserve(cfg)
    if not last and _takes_fused_site(cfg, psi.shape, W.shape, nxt.shape):
        # the whole update as one call of the fused site kernel
        site_out, psi_next, block, log_new, st = CS.site_step_fused(
            psi, nxt, L, W, R, scale, cfg.thresh_exp, lL, lR,
            forward=forward, max_dim=cfg.max_krylov, conserve=conserve,
        )
        return site_out, psi_next, (block, log_new), [st[:2], st[2:]], []
    hfac = torch.exp(lL + lR)
    relaxed = []
    kernel = _takes_lanczos_kernel(cfg)
    if not kernel or not CL.fits((l * d, r), W.shape[-1], cfg.max_krylov):
        psi_new, st_h, n = _einsum_expm(psi, scale, hfac, cfg, L, R, W)
        relaxed.append(n)
    else:
        ch = CL.heff_channels(L, W, R, hfac)
        out, st_h = CL.lanczos_expm(
            ch, psi.reshape(l * d, r).contiguous(), scale, cfg.thresh_exp,
            cfg.max_krylov, conserve,
        )
        psi_new = out.reshape(l, d, r)
    if last:
        return psi_new, None, None, [st_h], relaxed
    site_out, sig, block, log_new, l_env = _gauge_move(
        psi_new, L, W, R, lL, lR, cfg=cfg, forward=forward)
    kL, kR = (block, R) if forward else (L, block)
    kfac = torch.exp(log_new + l_env)
    if not kernel or not CL.fits(sig.shape, kR.shape[1], cfg.max_krylov):
        sig_new, st_k, n = _einsum_expm(sig, -scale, kfac, cfg, kL, kR)
        relaxed.append(n)
    else:
        kch = CL.keff_channels(kL, kR, kfac)
        sig_new, st_k = CL.lanczos_expm(
            kch, sig.contiguous(), -scale, cfg.thresh_exp, cfg.max_krylov,
            conserve,
        )
    psi_next = (
        K.absorb_right(sig_new, nxt) if forward else K.absorb_left(nxt, sig_new)
    )
    return site_out, psi_next, (block, log_new), [st_h, st_k], relaxed


def _gauge_move(psi_new, L, W, R, lL, lR, *, cfg, forward):
    """The QR gauge move of an updated site and its environment transfer:
    ``(site_out, sig, block, log_new, l_env)``, the new block normalised
    with its log-scale, and the log-scale of the environment on the other
    side."""
    env = cfg.env_precision
    if forward:
        site_out, sig = K.qr_right(psi_new)
        renorm = {"high": CR.renorm_left_hi, "default": CR.renorm_left_lo
                  }.get(env, K.renorm_block_left)
        raw = renorm(L, site_out, W, site_out)
        l_sys, l_env = lL, lR
    else:
        sig, site_out = K.lq_left(psi_new)
        renorm = {"high": CR.renorm_right_hi, "default": CR.renorm_right_lo
                  }.get(env, K.renorm_block_right)
        raw = renorm(R, site_out, W, site_out)
        l_sys, l_env = lR, lL
    block, dl = _normalize_block(raw)
    return site_out, sig, block, l_sys + dl, l_env


def _improved_site_step(psi, nxt, L, W, R, lL, lR, *, cfg, forward, last):
    """One site of improved relaxation (the JAX package's ``mode ==
    "improved"``): the site becomes the lowest eigenvector of H_eff by
    restarted Lanczos from itself, then the gauge moves on with no K step
    (the bond matrix is absorbed as it is) and the norm is left alone.
    The ground state runs as one ``cuda_lanczos.ground_state`` call where
    ``gs_fits`` takes the site (the kernel on the card), else
    ``integrator.ground_state_multi`` over the einsum matvec.  Returns
    :func:`_site_step`'s tuple, ``stats`` holding ``[Lanczos iterations,
    0]``, and the ground state's ``[passes, iterations, breakdowns]``
    status."""
    l, d, r = psi.shape
    hfac = torch.exp(lL + lR)
    if _takes_gs_kernel((l * d, r), W.shape[-1]):
        ch = CL.heff_channels(L, W, R, hfac)
        out, gs = CL.ground_state(ch, psi.reshape(l * d, r).contiguous())
    else:
        def mv(x):
            return (K.heff_apply(L, W, R, x.reshape(l, d, r)) * hfac
                    ).reshape(-1)
        out, gs = ground_state_multi(mv, psi.reshape(-1))
    psi_new = out.reshape(l, d, r)
    stats = [torch.stack([gs[1], torch.zeros_like(gs[1])])]
    if last:
        return psi_new, None, None, stats, [], gs
    site_out, sig, block, log_new, _ = _gauge_move(
        psi_new, L, W, R, lL, lR, cfg=cfg, forward=forward)
    psi_next = K.absorb_right(sig, nxt) if forward else K.absorb_left(nxt, sig)
    return site_out, psi_next, (block, log_new), stats, [], gs


def _multi_expm(vec, shape, scale, facs, cfg, groups, Ls, Rs, Ws=None):
    """:func:`_einsum_expm` over several electronic states: exp(scale·H)
    on the stacked vector ``vec`` (sites of ``shape``) for the pair sums of
    H_eff (``Ws`` given) or K_eff (``pairs.matvec``: the batched einsums
    at "highest", the bf16x3 kernel at "high", the one-pass kernels at
    "default" and for the relaxed iterations)."""
    nstate = vec.numel() // math.prod(shape)
    prec = cfg.matvec_precision
    lo = None
    if cfg.krylov_relaxed or prec == "default":
        lo = P.matvec(groups, Ls, Ws, Rs, facs, nstate, shape, "lo")
    mv = lo if prec == "default" else P.matvec(
        groups, Ls, Ws, Rs, facs, nstate, shape, prec)
    out, status = krylov_expm(
        mv, vec, scale, cfg.thresh_exp, cfg.max_krylov, _conserve(cfg),
        arnoldi=cfg.integrator == "arnoldi", return_status=True,
        matvec_lo=lo if cfg.krylov_relaxed else None,
        relax_after=cfg.relax_after,
    )
    return out, status[:2], status[2]


def _multi_site_step(psis, nxts, env, W, scale, *, cfg, groups, forward,
                     last):
    """One site update of several electronic states (the JAX package's
    ``_site_step_impl`` with ``nstate > 1``): the states' cores ``psis``
    stack into one Krylov vector (``kernels.stack_states``'s order), on
    which H_eff sums its pair terms (:func:`_multi_expm`; in improved
    relaxation ``integrator.ground_state_multi``, since the Lanczos and
    ground-state kernels take one state); each state's core moves its
    gauge on its own (``kernels.qr_right``/``lq_left``: the MGS kernel on
    the card); each pair's block is renormalised with the bra and ket
    states' new cores; K_eff runs on the stacked bond matrices (skipped in
    improved relaxation, which absorbs them as they are); each state
    absorbs its own.  The norm is kept on the stacked vector, never state
    by state.

    ``env``: ``((Ls, lLs), (Rs, lRs))``, the blocks and log-scales left and
    right of the site, a tensor of each group's pairs; ``W``: the groups'
    stacked MPO cores at the site.  Returns ``(sites_out, psi_next, (blocks,
    logs), stats, relaxed, gs)`` with lists over states and tuples over
    groups; ``gs`` the ground-state status of improved relaxation, else
    None."""
    nstate = len(psis)
    (Ls, lLs), (Rs, lRs) = env
    x = torch.stack(psis)
    shape = x.shape[1:]
    hfacs = [torch.exp(a + b) for a, b in zip(lLs, lRs)]
    relaxed, gs = [], None
    if cfg.relax == "improved":
        mv = P.matvec(groups, Ls, W, Rs, hfacs, nstate, shape)
        out, gs = ground_state_multi(mv, x.reshape(-1))
        stats = [torch.stack([gs[1], torch.zeros_like(gs[1])])]
    else:
        out, st_h, n = _multi_expm(x.reshape(-1), shape, scale, hfacs, cfg,
                                   groups, Ls, Rs, W)
        stats = [st_h]
        relaxed.append(n)
    new = out.view(nstate, *shape)
    if last:
        return list(new.unbind(0)), None, None, stats, relaxed, gs
    if forward:
        moved = [K.qr_right(c) for c in new.unbind(0)]
        sites = [a for a, _ in moved]
        sigs = [m for _, m in moved]
        sys_blocks, sys_logs, env_blocks, l_env = Ls, lLs, Rs, lRs
    else:
        moved = [K.lq_left(c) for c in new.unbind(0)]
        sites = [b for _, b in moved]
        sigs = [m for m, _ in moved]
        sys_blocks, sys_logs, env_blocks, l_env = Rs, lRs, Ls, lLs
    site = torch.stack(sites)
    normed = [P.normalize(P.transfer(g, B, site, w, forward,
                                     cfg.env_precision), lg)
              for g, B, lg, w in zip(groups, sys_blocks, sys_logs, W)]
    blocks = tuple(b for b, _ in normed)
    logs = tuple(lg for _, lg in normed)
    sig = torch.stack(sigs)
    if cfg.relax != "improved":
        kfacs = [torch.exp(a + b) for a, b in zip(logs, l_env)]
        kLs, kRs = (blocks, env_blocks) if forward else (env_blocks, blocks)
        out, st_k, n = _multi_expm(sig.reshape(-1), sig.shape[1:], -scale,
                                   kfacs, cfg, groups, kLs, kRs)
        stats.append(st_k)
        relaxed.append(n)
        sig = out.view(sig.shape)
    nxt = torch.stack(nxts)
    if forward:
        psi_next = torch.einsum("zkr,zrns->zkns", sig, nxt)
    else:
        psi_next = torch.einsum("zlns,zsk->zlnk", nxt, sig)
    return sites, list(psi_next.unbind(0)), (blocks, logs), stats, relaxed, gs


class TDVPEngine:
    """Holds the MPS cores, fused MPO and cached environments; sweeps.

    ``cores``: per-state lists of numpy site tensors (l, n, r), with the
    orthogonality centre at site 0; ``hamiltonian``: any object with
    ``fused_mpo(phys_dims)`` (a ``TensorHamiltonian``, or
    ``convert.FusedMPO``); ``device``: where the tensors live, the card
    unless the caller asks for the CPU (without a card this raises).

    With several electronic states (``len(cores) > 1``) the engine holds
    one MPS per state, sharing their core shapes, and one fused MPO per
    state pair ``(i, j)`` that couples (``pairs``, ``W_pairs``), grouped
    for batched sums (``pairset``: ``pairs.PairSet``).  Each entry of an
    environment stack then holds a tuple of blocks and a tuple of
    log-scales, one tensor per group with a leading pair axis.  Every site
    takes the Krylov program over the einsums (the Lanczos, fused-site and
    ground-state kernels take one state, as in the JAX package).
    """

    def __init__(self, cores, hamiltonian, config: Config, device="cuda"):
        if config.splitting != "lt2":
            raise NotImplementedError(
                f"splitting={config.splitting!r}: 4th-order compositions "
                "are not ported yet (ROADMAP A10)"
            )
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TDVPEngine: no CUDA device; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        self.dtype = _DTYPES[config.dtype]
        if self.device.type == "cuda" and self.dtype != torch.complex64:
            raise ValueError("the CUDA kernels take complex64: set dtype")
        self.nstate = len(cores)
        self.nsite = len(cores[0])
        self.cores = [[self._put(c) for c in state] for state in cores]
        self.phys_dims = [int(c.shape[1]) for c in cores[0]]
        if any(tuple(a.shape) != tuple(b.shape)
               for state in cores[1:] for a, b in zip(state, cores[0])):
            raise ValueError("the electronic states' MPS must share their "
                             "core shapes")
        self.hamiltonian = hamiltonian
        fused = hamiltonian.fused_mpo(self.phys_dims)
        if len(fused) != self.nstate:
            raise ValueError(
                f"an operator of {len(fused)} states on {self.nstate}")
        #: the state pairs (i, j) of the Hamiltonian, and (several states)
        #: their groups for batched sums
        self.pairs = P.state_pairs(fused, self.nstate)
        self.pairset = None
        if self.nstate == 1:
            #: fused MPO cores W[p] (a, i, j, b) of the single state pair
            self.W = self._fused_cores(hamiltonian)
        else:
            self.pairset = self._pair_set(fused)
            self.W = None
        #: each pair's fused MPO cores, keyed by pair
        self.W_pairs = ({(0, 0): self.W} if self.pairset is None
                        else self.pairset.W)
        #: fused MPOs of other operators (``expectation``), by id, with the
        #: operator kept alive beside them
        self._op_W: dict[int, tuple] = {}
        #: complex128 copies of those MPOs (``_wide``), by id, with the list
        self._wide_W: dict[int, tuple] = {}
        #: env stack of (block, log-scale): blocks accumulated by the
        #: previous half-sweep; popping yields the next site's environment
        self.env_stack: list | None = None
        #: device-side Krylov telemetry [Σ k_used, # cap hits, # relaxed
        #: matvecs] and the host count of Krylov calls since the last
        #: krylov_stats()
        self._kry_sum: torch.Tensor | None = None
        self._kry_calls = 0
        self._kry_warned = False
        #: improved relaxation's ground-state telemetry on the device
        #: (int32): [Σ passes, Σ Lanczos iterations, Σ breakdowns], then
        #: the number of calls that ran each pass count 0..GS_MAX_RESTARTS
        #: (:meth:`ground_state_stats`)
        self._gs_tally = torch.zeros(GS_MAX_RESTARTS + 4, dtype=torch.int32,
                                     device=self.device)
        #: running max gauge deviation (pytest_enabled self-checks)
        self._gauge_dev: torch.Tensor | None = None
        #: which half-sweep built ``env_stack``: "right" after a backward
        #: one (the stack a forward sweep pops, whose top block gives ⟨H⟩
        #: in :meth:`properties_submit`), "left", or None
        self._env_side: str | None = None
        #: the step programs of :meth:`propagate_steps`, by (step scale,
        #: property set, config, core shapes); each holds its buffers and,
        #: on the card, its CUDA graph, and goes with the engine
        self._programs: dict = {}
        #: steps run as replays of a recorded graph, and steps run by
        #: launching every kernel from the host
        self.graph_steps = 0
        self.eager_steps = 0

    # ---------------------------------------------------------- helpers
    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, self.dtype)

    def _fused_cores(self, operator):
        """The fused MPO of ``operator`` on this device: the single pair's
        cores (one state), or its :class:`pairs.PairSet` (several)."""
        fused = operator.fused_mpo(self.phys_dims)
        if self.nstate > 1:
            return self._pair_set(fused)
        if len(fused) != 1 or fused[0][0] is None:
            raise ValueError(
                "a one-state engine takes an operator of one state"
            )
        return [self._put(c) for c in fused[0][0]]

    def _pair_set(self, fused) -> P.PairSet:
        if len(fused) != self.nstate:
            raise ValueError(
                f"an operator of {len(fused)} states on {self.nstate}")
        return P.PairSet(fused, self.nstate, self._put, self.device,
                         self.dtype)

    def _trivial_multi(self, ps: P.PairSet | None = None,
                       dtype=None) -> tuple:
        """The trivial environment entry of the pair groups of ``ps`` (the
        Hamiltonian's by default): ``(blocks, logs)``, each a tuple over
        groups."""
        ps = ps or self.pairset
        dtype = dtype or self.dtype
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        return (tuple(torch.ones((len(g), 1, 1, 1), dtype=dtype,
                                 device=self.device) for g in ps.groups),
                tuple(torch.zeros(len(g), dtype=real, device=self.device)
                      for g in ps.groups))

    def _site(self, p: int) -> torch.Tensor:
        """Site p of every state, stacked (nstate, l, d, r)."""
        return torch.stack([state[p] for state in self.cores])

    def _trivial(self):
        real = torch.float64 if self.dtype == torch.complex128 else torch.float32
        return (
            torch.ones((1, 1, 1), dtype=self.dtype, device=self.device),
            torch.zeros((), dtype=real, device=self.device),
        )

    def _wide(self, W) -> list[torch.Tensor]:
        """The complex128 copy of the MPO ``W`` (one of the engine's own
        lists), made once."""
        if id(W) not in self._wide_W:
            self._wide_W[id(W)] = (W, [w.to(torch.complex128) for w in W])
        return self._wide_W[id(W)][1]

    def _right_block(self, W, dtype=None):
        """The right environment of site 0 for the MPO ``W``, contracted
        over sites N−1..1 at unit norm: ``(block, log-scale)``.  With
        ``dtype`` complex128 the contraction runs on complex128 copies of
        the cores and of ``W`` (:meth:`_wide`), its log-scale in float64."""
        cores = self.cores[0]
        block, log = self._trivial()
        if dtype == torch.complex128:
            cores = [c.to(dtype) for c in cores]
            W = self._wide(W)
            block = block.to(dtype)
            log = log.to(torch.float64)
        for p in range(self.nsite - 1, 0, -1):
            raw = K.renorm_block_right(block, cores[p], W[p], cores[p])
            block, dl = _normalize_block(raw)
            log = log + dl
        return block, log

    def build_right_env_stack(self) -> list:
        """[trivial, R(N−1..), …, R(1..)] — pop order matches a → sweep.

        Entries are (normalised block, log-scale); with several states
        (blocks, logs), tuples over the pair groups."""
        if self.pairset is not None:
            return self._env_stack_multi(forward=False)
        stack = [self._trivial()]
        for p in range(self.nsite - 1, 0, -1):
            c = self.cores[0][p]
            B, lg = stack[-1]
            Bn, dl = _normalize_block(K.renorm_block_right(B, c, self.W[p], c))
            stack.append((Bn, lg + dl))
        return stack

    def build_left_env_stack(self) -> list:
        """[trivial, L(..0), …, L(..N−2)] — pop order matches a ← sweep."""
        if self.pairset is not None:
            return self._env_stack_multi(forward=True)
        stack = [self._trivial()]
        for p in range(self.nsite - 1):
            c = self.cores[0][p]
            B, lg = stack[-1]
            Bn, dl = _normalize_block(K.renorm_block_left(B, c, self.W[p], c))
            stack.append((Bn, lg + dl))
        return stack

    def _env_stack_multi(self, forward: bool) -> list:
        """The environment stack of several states: each pair group's
        blocks transferred through the sites (left to right with
        ``forward``) at "highest" precision, at unit norm per pair."""
        groups = self.pairset.groups
        stack = [self._trivial_multi()]
        rng = range(self.nsite - 1) if forward else range(
            self.nsite - 1, 0, -1)
        for p in rng:
            site = self._site(p)
            blocks, logs = stack[-1]
            new = [P.normalize(P.transfer(g, B, site, g.W[p], forward), lg)
                   for g, B, lg in zip(groups, blocks, logs)]
            stack.append((tuple(b for b, _ in new),
                          tuple(lg for _, lg in new)))
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
        if self.pairset is not None:
            self._telemetry(*self._sweep_multi(scale, forward))
            return
        env_stack = self.env_stack
        sys_block, sys_log = self._trivial()
        sys_stack = [(sys_block, sys_log)]
        cores = self.cores[0]
        order = range(self.nsite) if forward else range(self.nsite - 1, -1, -1)
        stats, relaxed, gs = [], [], []
        for pos, p in enumerate(order):
            last = pos == self.nsite - 1
            env_block, env_log = env_stack.pop()
            q = p + 1 if forward else p - 1
            L, lL = (sys_block, sys_log) if forward else (env_block, env_log)
            R, lR = (env_block, env_log) if forward else (sys_block, sys_log)
            if cfg.relax == "improved":
                site_out, psi_next, new, st, rel, g = _improved_site_step(
                    cores[p], None if last else cores[q], L, self.W[p], R,
                    lL, lR, cfg=cfg, forward=forward, last=last,
                )
                gs.append(g)
            else:
                site_out, psi_next, new, st, rel = _site_step(
                    cores[p], None if last else cores[q], L, self.W[p], R,
                    scale, lL, lR, cfg=cfg, forward=forward, last=last,
                )
            stats += st
            relaxed += rel
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
        self._env_side = "left" if forward else "right"
        self._telemetry(stats, relaxed, gs)

    def _sweep_multi(self, scale: complex, forward: bool) -> tuple:
        """The site loop of a half-sweep over several states
        (:func:`_multi_site_step` at each site): the stack it builds
        becomes the environment stack.  Returns the Krylov status, relaxed
        counts and ground-state status of its sites."""
        cfg = self.config
        env_stack = self.env_stack
        sys_blocks, sys_logs = self._trivial_multi()
        sys_stack = [(sys_blocks, sys_logs)]
        groups = self.pairset.groups
        order = range(self.nsite) if forward else range(self.nsite - 1, -1, -1)
        stats, relaxed, gs = [], [], []
        for pos, p in enumerate(order):
            last = pos == self.nsite - 1
            env_blocks, env_logs = env_stack.pop()
            q = p + 1 if forward else p - 1
            left = (sys_blocks, sys_logs) if forward else (env_blocks, env_logs)
            right = (env_blocks, env_logs) if forward else (sys_blocks, sys_logs)
            sites, nxt, new, st, rel, g = _multi_site_step(
                [state[p] for state in self.cores],
                None if last else [state[q] for state in self.cores],
                (left, right), [grp.W[p] for grp in groups], scale,
                cfg=cfg, groups=groups, forward=forward, last=last,
            )
            stats += st
            relaxed += rel
            if g is not None:
                gs.append(g)
            for state, site in zip(self.cores, sites):
                state[p] = site
            if last:
                break
            if cfg.pytest_enabled:
                for site in sites:
                    dev = K.gauge_error(site, left=forward)
                    self._gauge_dev = (
                        dev if self._gauge_dev is None
                        else torch.maximum(self._gauge_dev, dev)
                    )
            for state, core in zip(self.cores, nxt):
                state[q] = core
            sys_blocks, sys_logs = new
            sys_stack.append(new)
        self.env_stack = sys_stack
        self._env_side = "left" if forward else "right"
        return stats, relaxed, gs

    def _telemetry(self, stats, relaxed, gs) -> None:
        """Add a half-sweep's Krylov and ground-state status to the
        device-side telemetry."""
        rel = (torch.stack(relaxed).sum().reshape(1) if relaxed
               else torch.zeros(1, dtype=torch.int32, device=self.device))
        acc = torch.cat([torch.stack(stats).sum(0), rel.to(torch.int32)])
        self._kry_sum = acc if self._kry_sum is None else self._kry_sum + acc
        self._kry_calls += len(stats)
        if gs:
            g = torch.stack(gs)
            hist = torch.zeros(GS_MAX_RESTARTS + 1, dtype=torch.int32,
                               device=self.device)
            hist.index_add_(0, g[:, 0].long(), torch.ones_like(g[:, 0]))
            self._gs_tally = self._gs_tally + torch.cat([g.sum(0), hist])

    def propagate(
        self, dt: float, one_gate_to_apply=None, kraus_op=None
    ) -> None:
        """One TDVP step: forward + backward half-sweeps of dt/2 each."""
        if one_gate_to_apply is not None or kraus_op is not None:
            raise NotImplementedError(
                "one-site gates and Kraus maps are not ported yet "
                "(ROADMAP A10)"
            )
        self._step(step_scale(self.config, dt))
        self.eager_steps += 1
        self._check_gauge()

    def _step(self, scale: complex) -> None:
        """The two half-sweeps of one step, with nothing read back."""
        self._half_sweep(scale, forward=True)
        self._half_sweep(scale, forward=False)

    def _check_gauge(self) -> None:
        """Raise if the gauge deviation gathered since the last check
        exceeds the dtype's tolerance (``pytest_enabled`` runs only)."""
        if self.config.pytest_enabled and self._gauge_dev is not None:
            dev = float(self._gauge_dev)
            self._gauge_dev = None
            tol = 1e-05 if self.dtype == torch.complex64 else 1e-09
            if dev > tol:
                raise AssertionError(
                    f"gauge canonicality violated in sweep: max |Q†Q−I| "
                    f"= {dev:.3e} > {tol:.0e}"
                )

    # ------------------------------------------------ fused multi-step
    def capturable(self) -> bool:
        """Whether a whole step can be recorded as a CUDA graph.  Every
        route reads nothing back to the host inside a step: the Lanczos
        and fused site kernels, the Krylov program over the einsums (its
        control on the device, its iterations IF nodes of the graph), the
        MGS and CholeskyQR³ gauges.  The Krylov control kernel takes
        ``max_krylov`` up to ``cuda_krylov.MAX_KRYLOV``; beyond, a block runs
        step by step.  Imaginary time runs the same routes.  Improved
        relaxation is captured only where every site takes the ground-state
        kernel (:func:`_takes_gs_kernel`; never with several states): the
        einsum route reads one flag a restart.  The answer does not depend
        on the device: on the CPU it selects the same buffer program, run
        uncaptured."""
        if self.config.relax == "improved":
            return all(
                _takes_gs_kernel((c.shape[0] * c.shape[1], c.shape[2]),
                                 w[p].shape[-1], self.nstate)
                for p, c in enumerate(self.cores[0])
                for w in self.W_pairs.values())
        return self.config.max_krylov <= CK.MAX_KRYLOV

    def _ensure_right_stack(self) -> None:
        """Build the right environment stack unless a backward half-sweep
        left it (the carry of a step)."""
        if self.env_stack is None or self._env_side != "right":
            self.env_stack = self.build_right_env_stack()
            self._env_side = "right"

    def propagate_steps(self, dt: float, nsteps: int) -> None:
        """Run ``nsteps`` TDVP steps as one block (the JAX package's fused
        driver): the same steps as ``nsteps`` calls of :meth:`propagate`.

        Where :meth:`capturable` holds, the block runs a step program over
        fixed buffers (``step_graph.StepProgram``), one per step scale:
        the first step of a new program runs from the host and fills every
        per-shape cache, then on the card the step is recorded once as a
        CUDA graph and every later step of this and later blocks replays
        it (``graph_steps``); on the CPU the program's step runs uncaptured
        (``eager_steps``).  A failed capture or replay raises.  Elsewhere
        the block is :meth:`propagate` step by step.  After a block the
        engine's cores and environment stack ARE the program's buffers: a
        tensor a caller kept from them is overwritten by the next block.
        """
        self._run_block(dt, nsteps, None)

    def propagate_steps_collect(
        self,
        dt: float,
        nsteps: int,
        *,
        operator=None,
        autocorr: bool = True,
        energy: bool = True,
        norm: bool = True,
        populations: bool = True,
    ):
        """Run ``nsteps`` steps as :meth:`propagate_steps` does AND collect
        each step's observables of its PRE-step state (the driver's
        properties-then-propagate ordering) on the device; in a replayed
        step the collection is part of the graph.  Returns ``(items,
        plan)``: ``items[i]`` carries a leading ``nsteps`` axis (row ``t``
        is the observable before step ``t``), ``plan`` the decode plan for
        :meth:`properties_resolve`, applied row by row after one
        :func:`fetch_many`."""
        collect = {"operator": operator, "autocorr": autocorr,
                   "energy": energy, "norm": norm, "populations": populations}
        rows, plan, layout = self._run_block(dt, nsteps, collect)
        if not rows:
            return [], plan
        return _unstack(torch.stack(rows), layout), plan

    def _run_block(self, dt: float, nsteps: int, collect):
        """The block of :meth:`propagate_steps` (``collect`` None) or
        :meth:`propagate_steps_collect` (``collect``: its keywords).
        Returns each step's packed observables (device rows), the decode
        plan and the packing layout."""
        rows: list = []
        plan = layout = None
        if nsteps <= 0:
            return rows, plan, layout
        scale = step_scale(self.config, dt)
        self._ensure_right_stack()
        real = self.fetch_real_dtype()

        def submit():
            items, plan = self.properties_submit(**collect)
            return (step_graph.pack(items, real), plan,
                    [(x.shape, x.dtype) for x in items])

        if not self.capturable():
            for _ in range(nsteps):
                if collect is not None:
                    row, plan, layout = submit()
                    rows.append(row)
                self.propagate(dt)
            return rows, plan, layout
        props = None
        if collect is not None:
            op = collect["operator"]
            props = (None if op is None or op is self.hamiltonian else id(op),
                     *(collect[k] for k in ("autocorr", "energy", "norm",
                                            "populations")))
        key = (scale, props, self.config,
               tuple(tuple(c.shape) for c in self.cores[0]))
        prog = self._programs.get(key)
        done = 0
        if prog is None:
            # a real step of the block, from the host: it fills the route
            # plans, the launch set-up and the library before any capture
            if collect is not None:
                row, plan, layout = submit()
                rows.append(row)
            ctl = CK.krylov_ctl.launches + CK.krylov_ctl.plain_calls
            self._step(scale)
            self.eager_steps += 1
            done = 1
            prog = step_graph.StepProgram(self, scale, collect, rows[0] if rows
                                          else None, plan, layout)
            if self.device.type == "cuda":
                # a step that ran the Krylov program has IF-node bodies
                # that this host step may have left unrun: warm them first
                warm = CK.krylov_ctl.launches + CK.krylov_ctl.plain_calls > ctl
                prog.capture(self, warm=warm)
            self._programs[key] = prog
        prog.load(self)
        for _ in range(done, nsteps):
            prog.run(self)
            if collect is not None:
                rows.append(prog.slot.clone())
        prog.install(self)
        prog.settle()
        self._check_gauge()
        return rows, prog.plan, prog.layout

    # ------------------------------------------------ deferred properties
    def fetch_real_dtype(self) -> torch.dtype:
        """Real dtype of packed host fetches (:func:`fetch_many`)."""
        return torch.float32 if self.dtype == torch.complex64 else torch.float64

    def _mpo(self, operator):
        """The fused MPO of ``operator`` on this device (:meth:`_fused_cores`):
        the engine's own for its Hamiltonian (``None``), else built once and
        cached."""
        if operator is None or operator is self.hamiltonian:
            return self.W if self.pairset is None else self.pairset
        if id(operator) not in self._op_W:
            self._op_W[id(operator)] = (operator, self._fused_cores(operator))
        return self._op_W[id(operator)][1]

    def properties_submit(
        self,
        operator=None,
        *,
        autocorr: bool = True,
        energy: bool = True,
        norm: bool = True,
        populations: bool = True,
    ) -> tuple[list, list]:
        """The requested observables as device tensors, with no host read.

        Returns ``(items, plan)``: the tensors and the decode plan for
        :meth:`properties_resolve`.  Drivers fetch the items of one or many
        steps with one :func:`fetch_many` (``Config.fetch_stride``).

        ⟨H⟩ (or ⟨O⟩) is :meth:`expectation`'s: the right environment
        recontracted in complex128, then H_eff at site 0 in complex128, with
        the value rounded to the working precision.  The
        sweep's own complex64 blocks are not reused: their top block is
        where a complex64 run loses ⟨H⟩ (ROADMAP C3).

        With several states the plan is the JAX package's: ⟨H⟩ as each
        pair's (value, log-scale), the autocorrelation and the populations
        one item a state."""
        liouville = self.config.space == "liouville"
        items: list = []
        plan: list = []
        if self.pairset is not None:
            return self._submit_multi(operator, autocorr, energy,
                                      norm and liouville,
                                      populations or (norm and not liouville))
        triv, _ = self._trivial()
        if energy:
            items += self._energy(self._mpo(operator))
            plan.append(("energy", 1))
        if autocorr:
            S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
            for c in self.cores[0]:
                S = K.ovlp_left_noconj(S, c, c)
            items.append(S)
            plan.append(("autocorr", 1))
        if populations or (norm and not liouville):
            items.append(torch.sum(torch.abs(self.cores[0][0]) ** 2))
            plan.append(("pops", 1))
        if norm and liouville:
            S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
            for p in range(self.nsite):
                S = torch.einsum("lk,lnr,n->rk", S, self.cores[0][p],
                                 self._vec_eye(p))
            items.append(S)
            plan.append(("trace", 1))
        return items, plan

    def _submit_multi(self, operator, autocorr: bool, energy: bool,
                      trace: bool, pops: bool) -> tuple[list, list]:
        """:meth:`properties_submit` with several states."""
        items: list = []
        plan: list = []
        if energy:
            part = self._energy(self._mpo(operator))
            items += part
            plan.append(("energy", len(part) // 2))
        if autocorr:
            S = torch.ones((self.nstate, 1, 1), dtype=self.dtype,
                           device=self.device)
            for p in range(self.nsite):
                c = self._site(p)
                S = torch.einsum("zkno,zknp->zop",
                                 torch.einsum("zbk,zbno->zkno", S, c), c)
            items += list(S.unbind(0))
            plan.append(("autocorr", self.nstate))
        if pops:
            items += list(self._norms2().unbind(0))
            plan.append(("pops", self.nstate))
        if trace:
            S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
            for p in range(self.nsite):
                S = torch.einsum("lk,lnr,n->rk", S, self.cores[0][p],
                                 self._vec_eye(p))
            items.append(S)
            plan.append(("trace", 1))
        return items, plan

    def _norms2(self) -> torch.Tensor:
        """Each state's norm², from its centre core (site 0)."""
        return torch.sum(torch.abs(self._site(0)) ** 2, dim=(1, 2, 3))

    def properties_resolve(
        self,
        vals: list,
        plan: list,
        *,
        norm: bool = True,
        populations: bool = True,
    ) -> dict:
        """Decode host values (:func:`fetch_many`) of
        :meth:`properties_submit`'s items."""
        liouville = self.config.space == "liouville"
        out: dict = {}
        k = 0
        pops = None
        for kind, n in plan:
            if kind == "energy":
                tot = 0.0 + 0.0j
                for q in range(n):
                    v = complex(vals[k + 2 * q])
                    fac = float(vals[k + 2 * q + 1].real)
                    tot += v * math.exp(fac)
                out["energy"] = tot
                k += 2 * n
            elif kind == "autocorr":
                out["autocorr"] = complex(
                    sum(vals[k + i][0, 0] for i in range(n))
                )
                k += n
            elif kind == "pops":
                pops = [float(vals[k + i].real) for i in range(n)]
                k += n
            elif kind == "trace":
                out["trace"] = complex(vals[k][0, 0])
                k += 1
        if populations:
            out["populations"] = pops
        if norm:
            out["norm"] = (
                abs(out["trace"]) if liouville
                else float(math.sqrt(sum(pops)))
            )
        return out

    def properties_bundle(
        self,
        operator=None,
        *,
        autocorr: bool = True,
        energy: bool = True,
        norm: bool = True,
        populations: bool = True,
    ) -> dict:
        """The requested observables with ONE device→host read:
        :meth:`properties_submit`, :func:`fetch_many`,
        :meth:`properties_resolve`."""
        items, plan = self.properties_submit(
            operator,
            autocorr=autocorr,
            energy=energy,
            norm=norm,
            populations=populations,
        )
        vals = fetch_many(items, self.fetch_real_dtype())
        return self.properties_resolve(
            vals, plan, norm=norm, populations=populations
        )

    # ------------------------------------------------------- observables
    def expectation(self, operator=None) -> complex:
        """⟨Ψ|O|Ψ⟩ with Psi canonical at site 0: O is the engine's
        Hamiltonian (``None``) or any operator with ``fused_mpo`` (an
        observable), whose fused MPO is built once and cached.  With
        several states the sum over the operator's state pairs."""
        items = self._energy(self._mpo(operator))
        if self.pairset is None:
            value, log = items
            return complex(value * torch.exp(log))
        vals = fetch_many(items, self.fetch_real_dtype())
        return sum(complex(v) * math.exp(float(lg.real))
                   for v, lg in zip(vals[::2], vals[1::2]))

    def _energy(self, W) -> list[torch.Tensor]:
        """``[⟨Ψ|O|Ψ⟩ / e^log, log]`` for the MPO ``W``, as device tensors
        in the working dtypes: the whole contraction (:meth:`_right_block`,
        H_eff at site 0 and the dot product) in complex128, with only the
        value and its log-scale rounded to the working dtypes.  A complex64
        chain contracted in complex64 loses ~1e-5 in its top block (ROADMAP
        C3); for a complex128 engine this is the plain contraction.  With
        several states ``W`` is a :class:`pairs.PairSet` and the list holds
        each pair's value and log-scale (:meth:`_energy_multi`)."""
        if isinstance(W, P.PairSet):
            return self._energy_multi(W)
        wide = torch.complex128
        block, log = self._right_block(W, wide)
        triv, real = self._trivial()
        psi = self.cores[0][0].to(wide)
        sig = K.heff_apply(triv.to(wide), self._wide(W)[0], block, psi)
        return [torch.sum(psi.conj() * sig).to(self.dtype), log.to(real.dtype)]

    def _energy_multi(self, ps: P.PairSet) -> list[torch.Tensor]:
        """:meth:`_energy` of several states: each pair's right block
        contracted over sites N−1..1, then H_eff at site 0 and the dot
        product with the bra state, all in complex128 (a batched chain per
        pair group, on complex128 copies of the cores and of the MPO); the
        list holds ``[v_q, log_q]`` for each pair q in ``ps.pairs``' order,
        rounded to the working dtypes."""
        wide = torch.complex128
        if id(ps) not in self._wide_W:
            self._wide_W[id(ps)] = (ps, ps.wide())
        pw = self._wide_W[id(ps)][1]
        blocks, logs = self._trivial_multi(pw, wide)
        blocks, logs = list(blocks), list(logs)
        for p in range(self.nsite - 1, 0, -1):
            site = self._site(p).to(wide)
            for q, g in enumerate(pw.groups):
                blocks[q], logs[q] = P.normalize(P.renorm_right(
                    blocks[q], g.bras(site), g.W[p], g.kets(site)), logs[q])
        site = self._site(0).to(wide)
        vals = []
        for g, R in zip(pw.groups, blocks):
            one = torch.ones((len(g), 1, 1, 1), dtype=wide, device=self.device)
            sig = P.heff_terms(one, g.W[0], R, g.kets(site))
            vals.append(torch.sum(g.bras(site).conj() * sig, dim=(1, 2, 3)))
        _, real = self._trivial()
        v = torch.cat(vals)[pw.order].to(self.dtype)
        lg = torch.cat(logs)[pw.order].to(real.dtype)
        return [t for q in range(len(pw.pairs)) for t in (v[q], lg[q])]

    def pop_states(self) -> list[float]:
        if self.pairset is not None:
            return [float(x) for x in self._norms2().tolist()]
        return [float(torch.sum(torch.abs(self.cores[0][0]) ** 2))]

    def bond_dims(self, istate: int = 0) -> list[int]:
        return [int(c.shape[2]) for c in self.cores[istate][:-1]]

    def reduced_density(
        self, remain_nleg: tuple[int, ...], istate: int = 0
    ) -> np.ndarray:
        """ρ over kept sites; Tr over the rest.  Psi must sit at site 0.

        ``remain_nleg[p]`` ∈ {0,1,2}: 0 trace out, 1 keep diagonal,
        2 keep bra+ket.  Sites right of ``len(remain_nleg)−1`` are
        right-orthogonal ⇒ identity environment (reference
        ``_mps_cls.py:1208-1287``).  Output legs ordered site-major,
        ket before bra.
        """
        if self.config.space == "liouville":
            return self.reduced_density_liouville(remain_nleg)
        cores = [self.cores[istate][p] for p in range(len(remain_nleg))]
        core = cores.pop()
        nleg = remain_nleg[-1]
        if nleg == 1:
            dens = torch.einsum("ijk,ajk->iaj", core, core.conj())
        elif nleg == 2:
            dens = torch.einsum("ijk,alk->iajl", core, core.conj())
        else:
            raise ValueError("right-most kept site must have ≥1 open leg")
        p = len(remain_nleg) - 1
        while cores:
            p -= 1
            core = cores.pop()
            nleg = remain_nleg[p]
            if nleg == 2:
                sub = "lmi,bna,ia...->lbmn..."
            elif nleg == 1:
                sub = "lmi,bma,ia...->lbm..."
            else:
                sub = "lmi,bma,ia...->lb..."
            dens = torch.einsum(sub, core, core.conj(), dens)
        return dens[0, 0, ...].cpu().numpy()

    def overlap_conj(self, other_cores) -> complex:
        """⟨self|other⟩ summed over states (the explicit autocorrelation
        ⟨Ψ(0)|Ψ(t)⟩)."""
        total = 0.0 + 0.0j
        for mine, theirs in zip(self.cores, other_cores):
            S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
            for a, b in zip(mine, theirs):
                S = K.ovlp_left_conj(S, a, b)
            total += complex(S[0, 0])
        return total

    # ------------------------------------------------- operator fitting
    def apply_operator_fit(
        self, operator, maxiter: int = 10, conv_tol: float = 1.0e-08
    ) -> float:
        """Variationally fit |Φ⟩ ≈ O|Ψ⟩ by alternating sweeps (the JAX
        package's ``apply_operator_fit``; upstream PyTDSCF's
        ``apply_dipole``).

        The current MPS becomes the (normalised) fit, with its centre at
        site 0; the norm ‖O|Ψ⟩‖ in the fitted subspace is returned.  The
        operator's own fused MPO is built here, so its width is its own.
        Each site reads its norm back to the host, and each pair of sweeps
        the overlap with the previous fit (the convergence test), as in
        the JAX package: an operator is applied once per workflow.  With
        several states the operator's own state pairs are summed
        (:meth:`_fit_half_sweep_multi`), and the norm is the stacked
        states'."""
        W = (self._mpo(operator) if operator is self.hamiltonian
             else self._fused_cores(operator))
        sweep = (self._fit_half_sweep if self.pairset is None
                 else self._fit_half_sweep_multi)
        # Ψ0, gauge-moved along with the fit
        ket = [list(state) for state in self.cores]
        norm = 0.0
        for _ in range(maxiter):
            prev = [list(state) for state in self.cores]
            norm = sweep(W, ket, forward=True)
            norm = sweep(W, ket, forward=False)
            if abs(1.0 - abs(self.overlap_conj(prev))) < conv_tol:
                break
        self.invalidate_env()
        return norm

    def _fit_half_sweep(self, W, ket, forward: bool) -> float:
        """One half-sweep of :meth:`apply_operator_fit`: each site of the
        fit becomes ``O_eff`` applied to Ψ0's site (``heff_apply`` between
        the blocks of ⟨Φ|O|Ψ0⟩), normalised, and both chains move their
        gauge on (``qr_right``/``lq_left``: the MGS kernel on the card).
        Returns the last site's norm."""
        nsite = self.nsite
        phi, psi0 = self.cores[0], ket[0]
        one = torch.ones((1, 1, 1), dtype=self.dtype, device=self.device)
        env_stack = [one]
        env_rng = range(nsite - 1, 0, -1) if forward else range(nsite - 1)
        for p in env_rng:
            renorm = K.renorm_block_right if forward else K.renorm_block_left
            env_stack.append(renorm(env_stack[-1], phi[p], W[p], psi0[p]))
        sys_block = one
        order = range(nsite) if forward else range(nsite - 1, -1, -1)
        norm = 0.0
        for p in order:
            env_block = env_stack.pop()
            L, R = (sys_block, env_block) if forward else (env_block, sys_block)
            new = K.heff_apply(L, W[p], R, psi0[p])
            # the site's one host read
            norm = float(torch.linalg.vector_norm(new))
            phi[p] = new / norm
            if p == (nsite - 1 if forward else 0):
                break
            q = p + 1 if forward else p - 1
            for chain in (phi, psi0):
                if forward:
                    a, sig = K.qr_right(chain[p])
                    chain[p] = a
                    chain[q] = K.absorb_right(sig, chain[q])
                else:
                    sig, b = K.lq_left(chain[p])
                    chain[p] = b
                    chain[q] = K.absorb_left(chain[q], sig)
            renorm = K.renorm_block_left if forward else K.renorm_block_right
            sys_block = renorm(sys_block, phi[p], W[p], psi0[p])
        return norm

    def _fit_half_sweep_multi(self, ps: P.PairSet, ket,
                              forward: bool) -> float:
        """:meth:`_fit_half_sweep` over several states (the JAX package's
        ``_fit_half_sweep``): each state i of the fit becomes the sum over
        the operator's pairs (i, j) of ``O_eff`` applied to Ψ0's state j (a
        batched chain per pair group), the stacked fit is normalised, and
        every state of both chains moves its gauge on.  Returns the last
        site's norm."""
        nsite = self.nsite
        phi, groups = self.cores, ps.groups

        def stacked(chain, p):
            return torch.stack([state[p] for state in chain])

        def transfer(blocks, p, fwd):
            bra, kt = stacked(phi, p), stacked(ket, p)
            fn = P.renorm_left if fwd else P.renorm_right
            return [fn(B, g.bras(bra), g.W[p], g.kets(kt))
                    for g, B in zip(groups, blocks)]

        one, _ = self._trivial_multi(ps)
        env_stack = [list(one)]
        env_rng = range(nsite - 1, 0, -1) if forward else range(nsite - 1)
        for p in env_rng:
            env_stack.append(transfer(env_stack[-1], p, not forward))
        sys_blocks = list(one)
        order = range(nsite) if forward else range(nsite - 1, -1, -1)
        norm = 0.0
        for p in order:
            env_blocks = env_stack.pop()
            Ls, Rs = ((sys_blocks, env_blocks) if forward
                      else (env_blocks, sys_blocks))
            kt = stacked(ket, p)
            new = None
            for g, L, R in zip(groups, Ls, Rs):
                t = P.heff_terms(L, g.W[p], R, g.kets(kt))
                s = g.scatter(None) @ t.reshape(len(g), -1)
                new = s if new is None else new + s
            # the site's one host read
            norm = float(torch.linalg.vector_norm(new))
            new = (new / norm).reshape(self.nstate, *t.shape[1:])
            for state, core in zip(phi, new.unbind(0)):
                state[p] = core
            if p == (nsite - 1 if forward else 0):
                break
            q = p + 1 if forward else p - 1
            for chain in (phi, ket):
                for state in chain:
                    if forward:
                        a, sig = K.qr_right(state[p])
                        state[p] = a
                        state[q] = K.absorb_right(sig, state[q])
                    else:
                        sig, b = K.lq_left(state[p])
                        state[p] = b
                        state[q] = K.absorb_left(state[q], sig)
            sys_blocks = transfer(sys_blocks, p, forward)
        return norm

    def invalidate_env(self) -> None:
        """Drop the environment stack: the next sweep rebuilds it."""
        self.env_stack = None
        self._env_side = None

    def norm(self) -> float:
        if self.config.space == "liouville":
            return abs(self.trace())
        return math.sqrt(sum(self.pop_states()))

    def canonicalize(self) -> None:
        """Left-canonicalise every state, A…A·Psi with the centre at the
        last site, by QR sweeps on the device."""
        for cores in self.cores:
            for p in range(self.nsite - 1):
                a, sig = K.qr_right(cores[p])
                cores[p] = a
                cores[p + 1] = K.absorb_right(sig, cores[p + 1])
        self.invalidate_env()

    # ---------------------------------------------- Liouville space (MPDO)
    def right_canonicalize(self) -> None:
        """Psi·B…B with the centre at site 0 — the engine's between-step
        invariant — for every state, by LQ sweeps on the device
        (CholeskyQR³ at the large bonds)."""
        for cores in self.cores:
            for p in range(self.nsite - 1, 0, -1):
                sig, b = K.lq_left(cores[p])
                cores[p] = b
                cores[p - 1] = K.absorb_left(cores[p - 1], sig)
        self.env_stack = None
        self._env_side = None

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
        """T/2-trick autocorrelation ⟨Ψ*|Ψ⟩ (no conjugation), summed over
        states."""
        total = 0.0 + 0.0j
        for cores in self.cores:
            S = torch.ones((1, 1), dtype=self.dtype, device=self.device)
            for c in cores:
                S = K.ovlp_left_noconj(S, c, c)
            total += complex(S[0, 0])
        return total

    def distance(self, other: "TDVPEngine") -> float:
        """‖Ψ−Φ‖ via overlaps (reference ``distance_MPS``)."""
        n1 = sum(self.pop_states())
        n2 = sum(other.pop_states())
        ov = self.overlap_conj(
            [[c.to(self.device, self.dtype) for c in state]
             for state in other.cores])
        return math.sqrt(max(n1 + n2 - 2.0 * ov.real, 0.0))

    def ground_state_stats(self, reset: bool = True) -> dict:
        """Improved relaxation's ground-state telemetry since the last
        call (one host read): ``calls``, the ``passes``, Lanczos
        ``iterations`` and ``breakdowns`` summed over them, and
        ``passes_hist``, the number of calls that ran each pass count
        (index 0..``GS_MAX_RESTARTS``)."""
        t = self._gs_tally.tolist()
        if reset:
            self._gs_tally = torch.zeros_like(self._gs_tally)
        hist = t[3:]
        return {"calls": sum(hist), "passes": t[0], "iterations": t[1],
                "breakdowns": t[2], "passes_hist": hist}

    def krylov_stats(self, reset: bool = True) -> tuple[float, int, int, int]:
        """(mean Krylov dim per call, # calls, # max-dim cap hits, # relaxed
        matvecs) since the last call (the reference's AVG-SIL-iterations
        telemetry; in improved relaxation each ground state counts as one
        call of its Lanczos iterations).  The relaxed matvecs are
        Σ max(k_used − relax_after, 0) over the Krylov calls of a relaxed
        run, counted on the device by
        the Krylov control: the launches the ``cuda_matvec`` kernels should
        have counted on a card."""
        if self._kry_sum is None:
            return 0.0, 0, 0, 0
        total, capped, relaxed = (int(x) for x in self._kry_sum.tolist())
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
            # one chain a state pair
            for Wq in self.W_pairs.values():
                W = Wq[p]
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
