"""A replay, in plain torch on the CPU, of the cluster routes of the port's
Lanczos and fused-site kernels (``csrc/tdvp_device.cuh``'s cluster layer,
``csrc/lanczos_expm.cu``, ``csrc/site_step.cu``) and of the ground-state
kernel's schedule (``csrc/lanczos_gs.cu``, :func:`ground_state`).

It runs their algorithm as the CTAs of a cluster of C run it, rank by
rank: rank q owns rows [q·Mc, min(M, (q+1)·Mc)), Mc = ceil(M / C), of
every Krylov vector, of ψ and of Q (a rank may own none); every reduction
is a per-rank partial summed in rank order 0..C-1; each matvec gathers x
whole from the ranks' rows and computes only its own rows of
Σ_c (H_c x) Rt_c; the gauge is one MGS(×2) of ψ₁ gathered whole (which
every CTA runs alike); the renormalisation gathers Q whole, forms each rank's partial Qᴴ(H_c Q) over
its rows, and sums the partials by the kernel's reduce-scatter (rank q
adds slice q of the entries over the ranks in order) and gather.  The
tests hold it, in complex128, to ``lanczos_expm_plain`` and
``site_step_fused_plain``: the decomposition, not the float32 bits.
"""

from __future__ import annotations

import math

import torch

from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import integrator as TI
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps import cuda_site as CS


def row_split(M: int, C: int) -> list[slice]:
    """Each rank's rows; ranks past the end own an empty slice."""
    mc = -(-M // C)
    return [slice(min(M, q * mc), min(M, (q + 1) * mc)) for q in range(C)]


def rank_sum(parts):
    """The partials added in rank order, as every CTA adds its inbox."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def gather(rows):
    """x whole from each rank's rows (the DSMEM gather)."""
    return torch.cat(rows, dim=0)


def matvec(H, Rt, x_rows, splits, fac):
    """Each rank's rows of fac · Σ_c (H_c x) Rt_c, x gathered whole."""
    x = gather(x_rows)
    out = []
    for s in splits:
        t = torch.matmul(H[:, s, :], x)  # (nc, nh, r): row-local from here
        out.append(fac * torch.matmul(t, Rt).sum(0))
    return out


def dot(a_rows, b_rows):
    """<a|b> as the rank-ordered sum of the ranks' partials."""
    return rank_sum([torch.sum(a.conj() * b) for a, b in zip(a_rows, b_rows)])


def norm(rows):
    return torch.sqrt(rank_sum([torch.sum(torch.abs(a) ** 2) for a in rows]))


def lanczos(H, Rt, v, scale, thresh, kmax, conserve, C, fac=1.0):
    """The cluster Lanczos run: (ψ' as rows per rank, status)."""
    M = v.shape[0]
    splits = row_split(M, C)
    beta0 = norm([v[s] for s in splits])
    V = [[v[s] / beta0 for s in splits]]
    prev = [torch.zeros_like(v[s]) for s in splits]
    alpha, beta = [], []
    k_fin, bad = 0, False
    for k in range(kmax):
        w = matvec(H, Rt, V[k], splits, fac)
        al = dot(V[0], w)
        w = [wq - al * vq for wq, vq in zip(w, V[k])]
        if k > 0:
            w = [wq - beta[k - 1] * vq for wq, vq in zip(w, V[k - 1])]
        bk = float(norm(w))
        live = bk > CL.EPS_BREAKDOWN
        V.append([wq / bk if live else torch.zeros_like(wq) for wq in w])
        alpha.append(float(al.real))
        beta.append(bk if live else 0.0)
        c = CL.tridiag_expm_e0(torch.tensor(alpha, dtype=torch.float64),
                               torch.tensor(beta[:k], dtype=torch.float64),
                               scale)
        psi = [sum(c[j] * V[j][q] for j in range(k + 1))
               for q in range(len(splits))]
        err = float(norm([p - o for p, o in zip(psi, prev)]))
        prev = psi
        conv = k > 0 and err < thresh
        capped = k + 1 >= kmax
        k_fin = k + 1
        if conv or not live or capped:
            bad = capped and not conv and live
            break
    f = 1.0 / norm(prev) if conserve else beta0
    status = [k_fin, int(bad and kmax < v.numel())]
    return [p * f for p in prev], status


def blocks(H, Q_rows, splits, C):
    """B_c = Qᴴ H_c Q: Q gathered whole, each rank's partial over its rows,
    then the reduce-scatter (rank q sums slice q of the nc·r² entries over
    the ranks in order) and the gather of the slices."""
    Q = gather(Q_rows)
    parts = [(Qq.conj().T @ torch.matmul(H[:, s, :], Q)).reshape(-1)
             for Qq, s in zip(Q_rows, splits)]
    nb = parts[0].numel()
    sl = -(-nb // C)
    slices = [rank_sum([p[q * sl:(q + 1) * sl] for p in parts])
              for q in range(C)]
    return torch.cat(slices).reshape(H.shape[0], Q.shape[1], Q.shape[1])


def site_step(psi, next_core, L, W, R, scale, thresh, lL, lR, *, forward,
              max_dim, conserve, C):
    """The cluster route of the fused site kernel, with the return
    convention of ``cuda_site.site_step_fused_plain``: ψ₁ gathered whole
    and factored by one MGS (every CTA runs the same one)."""
    p, nxt, Lf, Wf, Rf, l_sys, l_env = CS.forward_form(
        psi, next_core, L, W, R, lL, lR, forward)
    l, d, r = p.shape
    M = l * d
    H, Rt = CL.heff_channels(Lf, Wf, Rf)
    splits = row_split(M, C)
    psi1, st_h = lanczos(H, Rt, p.reshape(M, r), scale, thresh,
                         min(max_dim, M * r), conserve, C,
                         fac=torch.exp(lL + lR))
    Q, sig = CQ.mgs_qr_plain(gather(psi1))
    Q_rows = [Q[s] for s in splits]
    blk = blocks(H, Q_rows, splits, C)
    nrm = torch.linalg.vector_norm(blk).clamp_min(1e-30)
    blk = blk / nrm
    log_new = l_sys + torch.log(nrm)
    kfac = torch.exp(log_new + l_env)
    # the K side: one CTA on the whole (r, r) sigma
    sig1, st_k = CL.lanczos_expm_plain(blk, Rt, sig, -scale, thresh,
                                       min(max_dim, r * r), conserve,
                                       fac=kfac)
    status = torch.tensor(st_h + st_k.tolist(), dtype=torch.int32)
    return CS._outputs(gather(Q_rows), sig1 @ nxt.reshape(r, -1),
                       blk.permute(1, 0, 2), log_new, status, p.shape,
                       nxt.shape, forward)


def ground_state(H, Rt, v, C):
    """The ground-state kernel's schedule on a cluster of C CTAs: every CTA
    holds each Krylov vector whole and does the vector work on all of it;
    rank q computes its rows of each matvec and contributes, per
    iteration, its rows of u = H v_k − β_{k−1} v_{k−1} and its partial of
    α_k = Re⟨v_k|H v_k⟩; α is the partials in rank order, then w = u −
    α v_k, β = ‖w‖ and v_{k+1} = w / β whole.  Per pass the Ritz vector's
    rows with their partial norms (summed in rank order), and the energy
    as the rank-ordered partials of Re⟨g|H g⟩.  T's lowest eigenpair by
    ``eigh`` over the iterations that ran.  Returns (v', [passes,
    iterations, breakdowns])."""
    M, r = v.shape
    splits = row_split(M, C)
    kmax = min(TI.GS_BLOCK_DIM, M * r)

    def rows_mv(x):
        return matvec(H, Rt, [x[s] for s in splits], splits, 1.0)

    def vnorm(x):
        return torch.sqrt(torch.sum(torch.abs(x) ** 2))

    g = v / vnorm(v)
    passes = iters = breaks = 0
    e_prev = math.inf
    while True:
        x = g / vnorm(g)
        V = [[x[s] for s in splits]]
        prev, alpha, beta = None, [], []
        broke = False
        for k in range(kmax):
            y = rows_mv(x)
            parts = [torch.sum(x[s].conj() * yq).real
                     for s, yq in zip(splits, y)]
            u = [yq - beta[k - 1] * prev[s] if k > 0 else yq
                 for s, yq in zip(splits, y)]
            al = rank_sum(parts)
            w = gather(u) - al * x
            bk = float(vnorm(w))
            live = bk > CL.EPS_BREAKDOWN
            prev, x = x, (w / bk if live else torch.zeros_like(w))
            alpha.append(float(al))
            beta.append(bk)
            V.append([x[s] for s in splits])
            broke = bk < CL.EPS_BREAKDOWN
            if broke:
                break
        k_fin = len(alpha)
        T = (torch.diag(torch.tensor(alpha, dtype=torch.float64))
             + torch.diag(torch.tensor(beta[:k_fin - 1], dtype=torch.float64), 1)
             + torch.diag(torch.tensor(beta[:k_fin - 1], dtype=torch.float64), -1))
        yv = torch.linalg.eigh(T)[1][:, 0].to(v.dtype)
        g_rows = [sum(yv[j] * V[j][q] for j in range(k_fin))
                  for q in range(len(splits))]
        nrm = torch.sqrt(rank_sum([torch.sum(torch.abs(gq) ** 2)
                                   for gq in g_rows]))
        g = gather(g_rows) / nrm
        e = float(rank_sum([torch.sum(g[s].conj() * hq).real
                            for s, hq in zip(splits, rows_mv(g))]))
        passes += 1
        iters += k_fin
        breaks += int(broke)
        if not (abs(e - e_prev) > TI.GS_TOL) or passes >= TI.GS_MAX_RESTARTS:
            break
        e_prev = e
    return g, [passes, iters, breaks]
