"""One whole non-last TDVP site update (Lanczos, one state) as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_site.py:site_step_fused`` (Pallas
body ``_site_kernel``, gate ``site_fits``).  The kernel is
``csrc/site_step.cu``; :func:`site_step_fused_plain` is its plain PyTorch
version, which serves every CPU tensor.  One launch runs, for the site ψ
(l, d, r):

1. H-Krylov: ``exp(scale·H_eff)ψ`` with the matvec ``hfac·Σ_c H_c(ψ·Rt_c)``,
   the channels ``H_c`` built WITHOUT the env factor ``hfac = exp(lL+lR)``
   (``cuda_lanczos.heff_channels``);
2. the MGS(×2) gauge ``ψ = Q·σ``;
3. the renormalisation ``B_c = Qᴴ·H_c·Q``, which reuses the unscaled
   channels, normalised by its Frobenius norm over all channels (floored at
   1e-30), ``log_new = l_sys + log‖B‖``;
4. K-Krylov: ``exp(−scale·K_eff)σ`` with the matvec ``kfac·Σ_c B_c(σ·Rt_c)``,
   ``kfac = exp(log_new + l_env)``;
5. the absorb ``ψ_next = σ·next``.

A backward update is the forward update of the mirror image of the site:
ψ permuted to (r, d, l), the blocks L and R swapped, the MPO core to (c,
i, j, a), the next core permuted likewise.  So the kernel has one
direction, and the backward gauge factors ψ in the order of the unfused
route's ``kernels.lq_left``, whose dead-column completions set the frame
of a rank-deficient (padded) bond.  The JAX kernel factors the backward ψ
in (l, d·r) order instead; the two agree wherever ψ has full rank.

The channel einsums and permutes are plain torch around the kernel, as
they are XLA glue in JAX.  What bounds the kernel on the H100 is its
matvecs, as in ``cuda_lanczos``: at the chain's bulk (nc = 4, M = 240,
r = 30) each H matvec and the renormalisation are 6.9 M complex
multiply-adds.  :func:`route` picks one of two routes by the forward-form
shape (see the source note in ``csrc/site_step.cu``):

* ``"cluster"``: one thread-block cluster of :data:`CLUSTER` CTAs runs
  all five phases, rank q owning the same ceil(M / C) rows of ψ, ψ₁ and Q
  throughout: the cluster Lanczos recurrence, the gauge (ψ₁ gathered
  whole and factored alike in every CTA), the renormalisation with its
  partial blocks summed in rank order over distributed shared memory,
  and the (r, r) K-Krylov on rank 0.  Every site of the chain that the
  gate takes runs here: the bulk site in 0.88 ms on an H100, against
  1.04 ms on 8 CTAs and 4.25 ms on one block (PERF.md §6).
* ``"block"``: one block of 1024 threads on one SM, for shapes below
  :data:`CLUSTER_MIN_M` rows or beyond the cluster's shared memory.
"""

from __future__ import annotations

import functools

import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps.cuda_lanczos import (
    CHUNK,
    MAX_KRYLOV,
    heff_channels,
    lanczos_expm_plain,
)
from pytdscf_torch.mps.cuda_qr import mgs_qr_plain

#: Dynamic shared memory one launch may ask for on Hopper (bytes): the
#: 227 KB a block can use, less the kernel's ~18 KB of static buffers.
MAX_SMEM = 232_448 - 18_432
#: The kernel's routes.
ROUTES = ("block", "cluster")
#: CTAs of the cluster route (PERF.md §6: the bulk site on 16 and on 8).
CLUSTER = 16
#: Fewest rows M that take the cluster route; every site of the chain
#: that the gate takes has 64 or more, in both directions.
CLUSTER_MIN_M = 64


def smem_bytes(nc: int, M: int, r: int, way: str = "block",
               cluster: int = CLUSTER) -> int:
    """Dynamic shared memory of one CTA on the forward-form shapes,
    complex64.  ``"block"``: the blocks and σ ((nc + 1)·r²) and three MGS
    coefficient columns of r (``site_step.cu:site_step_smem``; the gauge's
    Q is in the device scratch).  ``"cluster"``, Mc = ceil(M / C):
    a work area of max(M·r, 2·nc·r²) (x, ψ₁ and Q gathered whole, then the
    partial blocks and their slice sums), the matvec's intermediate
    (nc·Mc·r), w and prev (Mc·r each), Q's rows (Mc·(r | 1)), three
    coefficient columns, two inboxes of C·r, σ (r²), a slice of
    ``CHUNK`` columns of the CTA's rows of H (rows padded by one) and Q
    whole (M·r; ``site_step.cu:site_step_cluster_smem``)."""
    if way == "block":
        return 8 * ((nc + 1) * r * r + 3 * r)
    if way == "cluster":
        mc = -(-M // cluster)
        return 8 * (max(M * r, 2 * nc * r * r) + (nc + 2) * mc * r
                    + mc * (r | 1) + (3 + 2 * cluster) * r + r * r
                    + nc * mc * (CHUNK + 1) + M * r)
    raise ValueError(f"unknown site_step route {way!r}")


@functools.lru_cache(maxsize=256)
def route(nc: int, M: int, r: int) -> str | None:
    """The route of a forward-form site (M, r) over ``nc`` channels:
    ``"cluster"`` from ``CLUSTER_MIN_M`` rows up where its shared memory
    fits, else ``"block"`` where that fits, else None (cached per shape:
    the engine asks at every site step)."""
    if M >= CLUSTER_MIN_M and smem_bytes(nc, M, r, "cluster") <= MAX_SMEM:
        return "cluster"
    if smem_bytes(nc, M, r) <= MAX_SMEM:
        return "block"
    return None


@functools.lru_cache(maxsize=256)
def plan(nc: int, M: int, r: int, kmax_h: int, kmax_k: int,
         way: str | None = None, cluster: int = CLUSTER) -> tuple[str, int]:
    """What one launch needs, worked out once per shape: ``(way,
    scratch)``, the route (the shape's :func:`route` unless ``way``) and
    the complex64 entries of device scratch.  Raises ValueError where the
    route does not take the shape."""
    if way is None:
        way = route(nc, M, r)
    if way not in ROUTES or smem_bytes(nc, M, r, way, cluster) > MAX_SMEM:
        raise ValueError(f"site_step_fused: route {way!r} does not take "
                         f"({M}, {r}) with {nc} channels")
    k_scratch = (kmax_k + 3 + nc) * r * r
    if way == "block":
        return way, (kmax_h + 5 + nc) * M * r + k_scratch
    return way, cluster * (kmax_h + 1) * -(-M // cluster) * r + k_scratch


def site_fits(shape, W_shape, next_shape, max_dim: int) -> bool:
    """Shape gate of the fused site kernel, in both directions.

    The JAX package's conditions: a square MPO bond (the renormalised
    blocks reuse the H channels' index), M = l·d ≥ 8, r ≥ 2, M ≥ r, d·r ≥ l
    (thin QR both ways), l ≥ 2, and ``max_dim`` at most the kernel's
    Krylov cap.  The TPU's VMEM gate is replaced by the card's shared
    memory: one of the two routes fits each direction (``next_shape`` is
    not needed: the next core stays in device memory)."""
    l, d, r = shape
    M = l * d
    if W_shape[0] != W_shape[-1]:
        return False
    if max_dim > MAX_KRYLOV:
        return False
    if M < 8 or r < 2 or M < r or d * r < l or l < 2:
        return False
    nc = W_shape[-1]
    return route(nc, M, r) is not None and route(nc, d * r, l) is not None


def forward_form(psi, next_core, L, W, R, lL, lR, forward: bool):
    """The operands of the update as a forward step: ψ, next core, L, W, R,
    l_sys, l_env (a backward step as the forward step of its mirror)."""
    if forward:
        return psi, next_core, L, W, R, lL, lR
    return (psi.permute(2, 1, 0), next_core.permute(2, 1, 0), R,
            W.permute(3, 1, 2, 0), L, lR, lL)


def _site_plain(H, Rt, v, nxt, hfac, l_sys, l_env, scale, thresh, kmax_h,
                kmax_k, conserve):
    """The five phases on forward-form operands: v (M, r), nxt (r, P2).
    Returns (Q (M, r), ψ_next (r, P2), blocks (r, nc, r), log_new, status
    (kH, badH, kK, badK))."""
    psi1, st_h = lanczos_expm_plain(H, Rt, v, scale, thresh, kmax_h,
                                    conserve, fac=hfac)
    q, sig = mgs_qr_plain(psi1)
    blocks = q.mH @ (H @ q)
    nrm = torch.linalg.vector_norm(blocks).clamp_min(1e-30)
    blocks = blocks / nrm
    log_new = l_sys + torch.log(nrm)
    kfac = torch.exp(log_new + l_env)
    sig1, st_k = lanczos_expm_plain(blocks, Rt, sig, -scale, thresh, kmax_k,
                                    conserve, fac=kfac)
    return (q, sig1 @ nxt, blocks.permute(1, 0, 2), log_new,
            torch.cat([st_h, st_k]))


def site_step_fused_plain(psi, next_core, L, W, R, scale, thresh, lL, lR, *,
                          forward: bool, max_dim: int, conserve: bool):
    """Plain PyTorch version of the kernel, any complex dtype and device.

    Returns ``(site_out, psi_next, blocks_new, log_new, status)``:
    ``site_out`` is the left- (forward) or right-orthonormal (backward)
    core, ``blocks_new`` the new environment block (keep, nc, keep) at unit
    norm, ``log_new`` its log-scale, ``status`` the int32 (kH, badH, kK,
    badK) of the two Krylov calls, which the JAX function sums into its
    Krylov count (kH + kK, 2, badH + badK).
    """
    p, nxt, Lf, Wf, Rf, l_sys, l_env = forward_form(
        psi, next_core, L, W, R, lL, lR, forward)
    l, d, r = p.shape
    H, Rt = heff_channels(Lf, Wf, Rf)
    q, pn, blocks, log_new, status = _site_plain(
        H, Rt, p.reshape(l * d, r), nxt.reshape(r, -1), torch.exp(lL + lR),
        l_sys, l_env, scale, thresh, min(max_dim, l * d * r),
        min(max_dim, r * r), conserve)
    return _outputs(q, pn, blocks, log_new, status, p.shape, nxt.shape,
                    forward)


def _outputs(q, pn, blocks, log_new, status, shape, next_shape, forward):
    """The forward-form results (Q, ψ_next as matrices) as cores, mirrored
    back for a backward step."""
    site_out = q.reshape(shape)
    psi_next = pn.reshape(shape[2], *next_shape[1:])
    if not forward:
        site_out = site_out.permute(2, 1, 0)
        psi_next = psi_next.permute(2, 1, 0)
    return site_out, psi_next, blocks, log_new, status


def site_step_fused(psi, next_core, L, W, R, scale, thresh, lL, lR, *,
                    forward: bool, max_dim: int, conserve: bool,
                    way: str | None = None, cluster: int = CLUSTER):
    """One non-last site update (see the module docstring), with the
    return convention of :func:`site_step_fused_plain`.

    A CUDA tensor goes through the kernel of its :func:`route` (or of
    ``way``, ``"block"`` or ``"cluster"`` of ``cluster`` CTAs, to compare
    them): complex64, shapes that :func:`site_fits` takes, or this raises,
    as it does when the card cannot schedule the cluster.  A CPU tensor
    goes through :func:`site_step_fused_plain`.
    ``site_step_fused.launches`` counts kernel launches
    (``site_step_fused.route_launches`` by route),
    ``site_step_fused.plain_calls`` the CPU calls.
    """
    if psi.device.type == "cpu":
        site_step_fused.plain_calls += 1
        return site_step_fused_plain(
            psi, next_core, L, W, R, scale, thresh, lL, lR, forward=forward,
            max_dim=max_dim, conserve=conserve)
    if psi.device.type != "cuda":
        raise ValueError(f"site_step_fused: no kernel for device {psi.device}")
    for name, t in (("psi", psi), ("next_core", next_core), ("L", L),
                    ("W", W), ("R", R)):
        if t.dtype != torch.complex64:
            raise TypeError(
                f"the CUDA site_step_fused takes complex64 {name}, got {t.dtype}")
        if t.device != psi.device:
            raise ValueError(f"{name} is on {t.device}, psi on {psi.device}")
    if not site_fits(psi.shape, W.shape, next_core.shape, max_dim):
        raise ValueError(
            f"the CUDA site_step_fused does not take psi {tuple(psi.shape)}, "
            f"W {tuple(W.shape)}, max_dim {max_dim} (see site_fits)")
    p, nxt, Lf, Wf, Rf, l_sys, l_env = forward_form(
        psi, next_core, L, W, R, lL, lR, forward)
    l, d, r = p.shape
    M, nc = l * d, Wf.shape[-1]
    kmax_h, kmax_k = min(max_dim, M * r), min(max_dim, r * r)
    way, nscratch = plan(nc, M, r, kmax_h, kmax_k, way, cluster)
    H, Rt = heff_channels(Lf, Wf, Rf)
    v = p.reshape(M, r).contiguous()
    nxt_mat = nxt.reshape(r, -1).contiguous()
    P2 = nxt_mat.shape[1]
    logs = torch.stack([torch.exp(lL + lR), l_sys, l_env]).to(torch.float32)
    dev = psi.device
    q = torch.empty((M, r), dtype=torch.complex64, device=dev)
    pn = torch.empty((r, P2), dtype=torch.complex64, device=dev)
    blocks = torch.empty((r, nc, r), dtype=torch.complex64, device=dev)
    log_new = torch.empty(1, dtype=torch.float32, device=dev)
    status = torch.empty(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(nscratch, dtype=torch.complex64, device=dev)
    scale = complex(scale)
    args = (dev.index, H.data_ptr(), Rt.data_ptr(), v.data_ptr(),
            nxt_mat.data_ptr(), logs.contiguous().data_ptr(), q.data_ptr(),
            pn.data_ptr(), blocks.data_ptr(), log_new.data_ptr(),
            status.data_ptr(), scratch.data_ptr(), nc, M, r, P2, kmax_h,
            kmax_k, scale.real, scale.imag, float(thresh),
            int(bool(conserve)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _cuda.load()
    if way == "cluster":
        code = lib.pytdscf_site_step_cluster_c64(*args, cluster, stream)
    else:
        code = lib.pytdscf_site_step_c64(*args, stream)
    _cuda.check(code, f"site_step_fused ({way} route)")
    site_step_fused.launches += 1
    site_step_fused.route_launches[way] += 1
    return _outputs(q, pn, blocks, log_new[0], status, p.shape, nxt.shape,
                    forward)


site_step_fused.launches = 0
site_step_fused.route_launches = dict.fromkeys(ROUTES, 0)
site_step_fused.plain_calls = 0
