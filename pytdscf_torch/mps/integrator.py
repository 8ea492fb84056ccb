"""Krylov propagators: the short-iterative Lanczos and Arnoldi of the JAX
package.

The counterpart of the JAX package's ``mps/integrator.py:krylov_expm``.
Both run as one program (:func:`_program`) unrolled to ``k_max``
iterations over preallocated buffers: the Krylov vectors V (k_max+1, n),
the reduced matrix T, the coefficients c and the control flags.

* Arnoldi (:func:`_arnoldi_step`): classical Gram–Schmidt against the live
  rows of V; T is the Hessenberg matrix; convergence is tested in
  coefficient space (V is orthonormal).  The engine runs it for
  non-Hermitian H_eff (the Liouville MPDO).
* Lanczos (:func:`_lanczos_step`): the reference's oblique recurrence
  (α_k = ⟨v₀|H·v_k⟩); T is tridiagonal; the basis is not orthogonal, so the
  convergence test ‖ψ_k − ψ_{k−1}‖ runs through its Gram matrix.  The
  engine runs it for a Hermitian site that the Lanczos kernel does not
  take (too large, relaxed, or not "highest" precision).

Improved relaxation replaces the exponential by the restarted-Lanczos
ground state (:func:`ground_state_multi` over passes of
:func:`lanczos_ground_state`, the JAX package's ``_ground_state_multi`` and
``lanczos_ground_state``): the plain version of the ``cuda_lanczos``
ground-state kernel, and the route of a site past its ``gs_fits``.

Each iteration ends with the control step ``cuda_krylov.krylov_ctl`` (a
kernel on the card): ``exp(scale·T)[:, 0]`` by order-12 Taylor with scaling
and squaring, the breakdown, convergence and cap tests, and the flags and
status ``[k_used, bad, relaxed matvecs]``, all on the device.  Driven from
the host, the program reads one flag per iteration (whether the next one
runs); inside a captured step the iterations after the first are IF nodes
of the CUDA graph (``cuda_krylov.GraphBranches``), whose conditions the
control kernel sets, and nothing is read back.  Either way an iteration that does not run launches nothing, and ψ
is formed once, from the iterations that ran.  Matvecs take the iteration
index, so that iterations ``>= relax_after`` can run the relaxed matvec.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pytdscf_torch.mps import cuda_krylov as CK
from pytdscf_torch.mps.cuda_krylov import EPS
# the plain Taylor exponential, under the name the CPU tests use
from pytdscf_torch.mps.cuda_krylov import expm_taylor_small as _expm_taylor_small  # noqa: F401


def krylov_expm(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v_init: torch.Tensor,
    scale: complex,
    thresh: float,
    max_dim: int = 20,
    conserve_norm: bool = True,
    arnoldi: bool = False,
    return_iterations: bool = False,
    matvec_lo: Callable[[torch.Tensor], torch.Tensor] | None = None,
    relax_after: int = 2,
    return_status: bool = False,
):
    """Approximate ``exp(scale·H)·v_init`` in a Krylov subspace.

    ``v_init`` is a flat vector.  With ``return_status`` also returns the
    device status ``[k_used, bad, relaxed matvecs]`` (int32), ``bad`` set
    when the loop hit ``max_dim`` without meeting ``thresh`` and without a
    breakdown; with ``return_iterations`` ``k_used`` and ``bad`` as Python
    values (a host read).

    ``matvec_lo`` enables relaxed (inexact) Krylov: iterations
    ``k >= relax_after`` apply the cheaper low-precision matvec.  The error
    a perturbed matvec at iteration k injects into ``exp(T)e₀`` is weighted
    by the k-th expansion coefficient, which decays superlinearly (van den
    Eshof & Hochbruck, SISC 2005), so late iterations tolerate a
    ~1e-3-relative matvec.
    """
    n = v_init.shape[0]
    k_max = min(max_dim, n)
    beta0 = torch.linalg.vector_norm(v_init)

    def mv(k, v):
        if matvec_lo is not None and k >= relax_after:
            return matvec_lo(v)
        return matvec(v)

    psi_next, status = _program(
        mv, v_init / beta0, scale, thresh, k_max, arnoldi,
        # the Krylov space spans the whole vector space: exact, never capped
        exact=k_max >= n,
        relax_after=relax_after if matvec_lo is not None else None,
    )
    if conserve_norm:
        out = psi_next / torch.linalg.vector_norm(psi_next)
    else:
        out = psi_next * beta0
    if return_status:
        return out, status
    if return_iterations:
        k_used, bad, _ = status.tolist()
        return out, k_used, bool(bad)
    return out


def _program(mv, v0, scale, thresh, k_max, arnoldi, *, exact, relax_after):
    """The unrolled Krylov loop: ``(ψ_next, status)``.

    Iteration 0 always runs.  Iteration k ≥ 1 runs where the control step
    of iteration k−1 decided so: its ``flags[0]`` read from the host, or,
    inside a step capture, an IF node whose handle that control step set.
    ψ = c·V over the iterations that ran: formed at once from the host, or
    as the IF node of the gather over the first j+1 rows, whose handle the
    control step of iteration j set where the program stopped there."""
    n = v0.shape[0]
    dtype, dev = v0.dtype, v0.device
    V = torch.zeros((k_max + 1, n), dtype=dtype, device=dev)
    V[0] = v0
    T = torch.zeros((k_max + 1, k_max + 1), dtype=dtype, device=dev)
    c = torch.zeros(k_max, dtype=dtype, device=dev)
    flags = torch.zeros(k_max + 1, dtype=torch.bool, device=dev)
    flags[0].fill_(True)  # a kernel: a capture copies nothing from the host
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    ctl = dict(scale=scale, thresh=thresh, exact=exact,
               relax_after=relax_after)
    if arnoldi:
        step = _arnoldi_step
        state = (V, T, c, flags, status)
    else:
        step = _lanczos_step
        beta = torch.zeros(k_max, dtype=v0.real.dtype, device=dev)
        state = (V, T, c, flags, status, torch.zeros_like(T), beta)
    graph = CK.active(dev)
    if graph is None:
        k_used = k_max
        for k in range(k_max):
            if k > 0 and not bool(flags[0]):  # the iteration's one host read
                k_used = k
                break
            step(k, mv, state, ctl)
        return c[:k_used] @ V[:k_used], status
    # the IF nodes' handles, set by the control steps: loops[k] guards
    # iteration k ≥ 1, gathers[j] the gather over j+1 rows (a handle with
    # no node may fail the graph's instantiation: loops[0] is none)
    hs = graph.handles(2 * k_max - 1)
    loops, gathers = [None, *hs[:k_max - 1]], hs[k_max - 1:]
    ctl["handles"] = (loops, gathers)
    step(0, mv, state, ctl)
    for k in range(1, k_max):
        with graph.branch(loops[k]):
            step(k, mv, state, ctl)
    psi = torch.zeros(n, dtype=dtype, device=dev)
    for j in range(k_max):
        with graph.branch(gathers[j]):
            psi.copy_(c[:j + 1] @ V[:j + 1])
    return psi, status


def _arnoldi_step(k, mv, state, ctl):
    """Arnoldi iteration k with classical Gram–Schmidt (the JAX
    ``_arnoldi_loop``).

    The projections run against the k+1 live rows of the buffer only: its
    other rows are exact zeros, so the result is the padded form's.  A
    breakdown leaves row k+1 zero."""
    V, T, c, flags, status = state
    w = mv(k, V[k])
    live = V[: k + 1]
    # ⟨V|w⟩ = conj(V·conj(w)): conjugate the one new vector, not V
    h = (live @ w.conj()).conj()
    w = w - h @ live
    b = torch.linalg.vector_norm(w)
    V[k + 1] = torch.where(b < EPS, 0, w / b)
    T[: k + 1, k] = h
    T[k + 1, k] = b
    CK.krylov_ctl(T, None, c, flags, status, k=k, **ctl)


def _lanczos_step(k, mv, state, ctl):
    """Lanczos iteration k with the reference's recurrence.

    The reduced-matrix diagonal is ``α_k = ⟨v₀|H·v_k⟩`` (projection onto
    the initial vector, not ``v_k``): an oblique variant that is exact by
    construction, since ``β_k v_{k+1} ≝ H v_k − α_k v_k − β_{k−1} v_{k−1}``
    makes ``H·Vᵀ = Vᵀ·T`` hold in the generated basis.  The regression
    literals of the reference embed its stopping behaviour.  That basis is
    not orthogonal, so column k of its Gram matrix G is kept for the
    control step's ‖ψ_k − ψ_{k−1}‖."""
    V, T, c, flags, status, G, beta = state
    w = mv(k, V[k])
    a = torch.sum(V[0].conj() * w)
    w = w - a * V[k]
    if k > 0:
        w = w - beta[k - 1] * V[k - 1]
    b = torch.linalg.vector_norm(w)
    V[k + 1] = torch.where(b < EPS, 0, w / b)
    beta[k] = b
    T[k, k] = a.real
    T[k + 1, k] = b
    T[k, k + 1] = b
    g = (V[: k + 1] @ V[k].conj()).conj()  # ⟨V_i|V_k⟩
    G[: k + 1, k] = g
    G[k, : k + 1] = g.conj()
    CK.krylov_ctl(T, G, c, flags, status, k=k, **ctl)


#: Improved relaxation (the JAX package's ``lanczos_ground_state`` and
#: ``_ground_state_multi``): Krylov vectors of one restarted-Lanczos pass,
#: the restart test on the energy, the most passes, and the diagonal that
#: masks T's unused tail.
GS_BLOCK_DIM = 24
GS_TOL = 1.0e-12
GS_MAX_RESTARTS = 100
GS_MASK = 1.0e10


def lanczos_ground_state(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v_init: torch.Tensor,
    block_dim: int = GS_BLOCK_DIM,
):
    """One restarted-Lanczos pass: the normalised Ritz vector of the lowest
    eigenvalue of the Hermitian ``matvec`` in the Krylov space of
    ``v_init`` (a flat vector).  Returns ``(ground, k_fin, broke)``, the
    last two as device tensors: the iterations that ran and whether the
    pass broke down.

    The JAX package's semantics: ``k_max = min(block_dim, n)``; the
    three-term recurrence ``β_k v_{k+1} = H v_k − α_k v_k − β_{k−1}
    v_{k−1}`` with ``α_k = Re⟨v_k|H v_k⟩`` and no re-orthogonalisation; a
    breakdown (β < 1e-14) ends the pass; T is assembled in float64 with its
    inactive tail masked at 1e10 and solved by ``eigh``.  The loop runs
    all ``k_max`` iterations with nothing read back: after a breakdown the
    Krylov vectors are zero and their entries of T masked, so the result
    is the early-stopping loop's."""
    n = v_init.shape[0]
    k_max = min(block_dim, n)
    dtype, dev = v_init.dtype, v_init.device
    V = torch.zeros((k_max + 1, n), dtype=dtype, device=dev)
    V[0] = v_init / torch.linalg.vector_norm(v_init)
    alpha = torch.zeros(k_max, dtype=torch.float64, device=dev)
    beta = torch.zeros(k_max, dtype=torch.float64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    k_fin = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(k_max):
        w = matvec(V[k])
        a = torch.vdot(V[k], w).real
        w = w - a.to(dtype) * V[k]
        if k > 0:
            w = w - beta[k - 1].to(dtype) * V[k - 1]
        b = torch.linalg.vector_norm(w)
        V[k + 1] = torch.where(b > EPS, w / torch.where(b > EPS, b, 1.0), 0)
        alpha[k] = a
        beta[k] = b
        k_fin = k_fin + alive.to(torch.int64)
        alive = alive & ~(b < EPS)
    idx = torch.arange(k_max, device=dev)
    alpha_m = torch.where(idx < k_fin, alpha, GS_MASK)
    off = torch.where(idx[:-1] < k_fin - 1, beta[:-1], 0.0)
    T = torch.diag(alpha_m) + torch.diag(off, 1) + torch.diag(off, -1)
    _, evecs = torch.linalg.eigh(T)
    ground = evecs[:, 0].to(dtype) @ V[:k_max]
    return ground / torch.linalg.vector_norm(ground), k_fin, ~alive


def ground_state_multi(
    matvec: Callable[[torch.Tensor], torch.Tensor], v0: torch.Tensor,
):
    """Restarted Lanczos to the lowest eigenvector (improved relaxation):
    passes of :func:`lanczos_ground_state`, each from the last Ritz vector,
    while the energy ``Re⟨v|H v⟩`` moves by more than ``GS_TOL`` and fewer
    than ``GS_MAX_RESTARTS`` passes ran (at least two run).

    Returns ``(v, status)``, ``status = [passes, Lanczos iterations,
    breakdowns]`` (int32, on v's device).  The restart test reads one flag
    from the device per pass; the energy is compared in float64."""
    v = v0 / torch.linalg.vector_norm(v0)
    e_prev = torch.full((), math.inf, dtype=torch.float64, device=v.device)
    tally = torch.zeros(3, dtype=torch.int64, device=v.device)
    passes = 0
    while True:
        v, k_fin, broke = lanczos_ground_state(matvec, v)
        e = torch.vdot(v, matvec(v)).real.to(torch.float64)
        passes += 1
        tally = tally + torch.stack(
            [torch.ones_like(k_fin), k_fin, broke.to(torch.int64)])
        # the pass's one host read
        if not (bool(torch.abs(e - e_prev) > GS_TOL)
                and passes < GS_MAX_RESTARTS):
            break
        e_prev = e
    return v, tally.to(torch.int32)
