"""Short-iterative Lanczos exponential as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_lanczos.py:lanczos_expm_fused`` (Pallas
body ``_lanczos_kernel`` / ``_lanczos_phase``).  The kernel is
``csrc/lanczos_expm.cu``; :func:`lanczos_expm_plain` is its plain PyTorch
version, which serves every CPU tensor.

The effective operator is pre-contracted once per site into channels
(:func:`heff_channels`, :func:`keff_channels`, plain einsums):

    H_c[(b,i), (k,j)] = Σ_a L[b,a,k] · W[a,i,j,c],   Rt_c[r, x] = R[x, c, r]

so that one matvec is ``Σ_c H_c · (ψ · Rt_c)`` on ψ as an (M, r) matrix; the
K_eff step takes ``H_a = L[:, a, :]`` and no MPO core.  The real factor
``exp(lL + lR)`` that restores the log-normalised environment blocks is
folded into ``H_c``, so the float32 range holds along a 184-site chain.

Lanczos semantics (the JAX package's ``mps/integrator.py:_lanczos_loop``): oblique
``α_k = ⟨v₀|H v_k⟩`` with Re(α) on the diagonal, breakdown at β < 1e-14,
convergence when ``k > 0`` and ``‖ψ(k) − ψ(k−1)‖ < thresh``, ``k_max =
min(max_dim, n)``, ``bad`` never set when ``k_max ≥ n``; ``conserve``
renormalises the result, otherwise it is scaled by ``‖v‖``.  The
coefficients ``exp(scale·T)e₀`` come from order-10 Taylor substeps of norm
≤ 0.5 (Gershgorin count), as in the Pallas kernel; they agree with the
JAX package's ``eigh`` form to ~1e-11 relative in complex128.

What bounds the kernel on the H100 is the matvec: 7.8 M complex
multiply-adds at the chain's bulk site (nc = 4, M = 240, r = 30), a few
times per call, in sequence, about 120 µs each at one SM's fp32 peak.
:func:`route` picks one of two routes by shape (see the source note in
``csrc/lanczos_expm.cu``):

* ``"cluster"``: one thread-block cluster of C CTAs runs the whole
  recurrence, rank q owning ceil(M / C) rows of every H_c, Krylov vector
  and ψ; each matvec gathers x over distributed shared memory, and every
  reduction is summed in rank order, so all CTAs take the same
  convergence and breakdown branch.  C is 16 or 8 by shape
  (:func:`cluster_size`): the largest that leaves each CTA at least
  :data:`MIN_ROWS_PER_CTA` rows.
* ``"block"``: one block of 1024 threads on one SM, for the shapes that
  leave too few rows to any cluster (the chain's edge sites).

On an H100 the bulk H step takes 0.23 ms on 16 CTAs against 3.17 ms on one
block, the (30, 30) K step 0.100 ms on 8 against 0.134 (PERF.md §6).

Both hold the Krylov vectors in device-memory scratch that the wrapper
allocates.  Neither falls back to the other: a cluster that the card
cannot schedule raises.

Improved relaxation's restarted Lanczos ground state (the JAX package's
``_ground_state_multi`` over ``lanczos_ground_state``: XLA's
``while_loop`` and ``eigh``, no ``pl.pallas_call``) is a second kernel over
the same channels, ``csrc/lanczos_gs.cu``: :func:`ground_state` runs every
pass of a site in one launch, on the route of its own rule
(:func:`gs_rule`: 16 CTAs of 512 threads, or one CTA of 128 for a small
site), and :func:`ground_state_plain` is its plain version
(``integrator.ground_state_multi`` over the channel matvec).
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps import integrator

EPS_BREAKDOWN = 1.0e-14
#: Taylor order per substep: with ‖scale·T‖ ≤ 0.5 per substep the
#: truncation error is 0.5^11/11! ≈ 1e-11.
TAYLOR_ORDER = 10
SUBSTEP_NORM = 0.5
MAX_SUBSTEPS = 65536
#: Largest Krylov dimension the kernel takes (one warp holds the
#: coefficient vector).
MAX_KRYLOV = 32
#: Largest working set the engine sends to the kernel (:func:`fits`): its
#: channels and Krylov vectors, complex64, in bytes.  Every site of the
#: 184-site chain takes about 3 MB; a site of M = l·d = 1024 with 8
#: channels holds 67 MB of H_c alone and runs the einsum route instead (the
#: JAX package's 60 MB gate, ``pallas_lanczos.fits``).
MAX_BYTES = 60 * 2**20


#: Cluster sizes of the cluster route, largest first (16 is a
#: non-portable size, which the H100 schedules).
CLUSTERS = (16, 8)
#: The largest, which the fused site kernel takes (``cuda_site``).
CLUSTER = CLUSTERS[0]
#: Fewest rows each CTA of a cluster must own: :func:`cluster_size` takes
#: the largest size of :data:`CLUSTERS` that leaves every CTA this many,
#: and a shape that no size does runs on one block.  Set from
#: ``chip_smoke.py``'s route sweep over every Lanczos shape of a chain step
#: (H100 80GB HBM3, 700 W; PERF.md §6): the bulk H step (240, 30) 0.232 ms
#: on 16 CTAs, 0.437 on 8, 3.17 on one block; the (30, 30) K step 0.100
#: on 8, 0.112 on 16, 0.134 on one block; the edge (8, 8) steps fastest on
#: one block.  A step's Lanczos calls so routed took 120.78 ms of device
#: time, against 120.74 with each shape on its fastest route.
MIN_ROWS_PER_CTA = 4
#: The kernel's routes.
ROUTES = ("block", "cluster")
#: Columns of H's rows that the cluster route stages in shared memory at a
#: time where the rows do not fit whole (``tdvp_device.cuh:kChunk``).
CHUNK = 32
#: Dynamic shared memory one CTA may ask for on Hopper (bytes): the 227 KB
#: a block can use, less a margin for the static buffers.
MAX_SMEM = 232_448 - 1024


def smem_bytes(nc: int, M: int, r: int, cluster: int = CLUSTER,
               resident: bool = False) -> int:
    """Dynamic shared memory of one CTA of the cluster route: x gathered
    whole (M·r complex64), the matvec's intermediate (nc·Mc·r), w and prev
    (Mc·r each), the CTA's nc·Mc rows of H (all M columns when
    ``resident``, else a slice of :data:`CHUNK`; rows padded by one) and
    two inboxes of ``cluster`` partials, Mc = ceil(M / C)
    (``lanczos_expm.cu:pytdscf_lanczos_expm_cluster_c64``)."""
    mc = -(-M // cluster)
    cols = (M if resident else CHUNK) + 1
    return 8 * (M * r + (nc + 2) * mc * r + nc * mc * cols + 2 * cluster)


def cluster_size(M: int, r: int, nc: int) -> int | None:
    """The cluster size of an (M, r) Krylov vector over ``nc`` channels:
    the largest of :data:`CLUSTERS` whose CTAs each own at least
    :data:`MIN_ROWS_PER_CTA` rows and whose shared memory fits, else None
    (the one-block route)."""
    for size in CLUSTERS:
        if (-(-M // size) >= MIN_ROWS_PER_CTA
                and smem_bytes(nc, M, r, size) <= MAX_SMEM):
            return size
    return None


def route(M: int, r: int, nc: int) -> str:
    """The route of an (M, r) Krylov vector over ``nc`` channels:
    ``"cluster"`` where :func:`cluster_size` finds a size, else
    ``"block"`` (whose buffers are static)."""
    return "block" if cluster_size(M, r, nc) is None else "cluster"


@functools.lru_cache(maxsize=256)
def plan(M: int, r: int, nc: int, kmax: int, way: str | None = None,
         cluster: int | None = None) -> tuple[str, int, bool, int]:
    """What one launch needs, worked out once per shape: ``(way, C,
    resident, scratch)``.  ``way`` and ``cluster`` default to the
    shape's :func:`route` and :func:`cluster_size`; ``resident``: the
    CTA's rows of H stay in its shared memory; ``scratch``: complex64
    entries of device scratch.  Raises ValueError where the route does not
    take the shape."""
    if way is None:
        way = route(M, r, nc)
    if way not in ROUTES:
        raise ValueError(f"unknown lanczos_expm route {way!r}")
    if way == "block":
        return way, 1, False, (kmax + 3 + nc) * M * r
    size = cluster or cluster_size(M, r, nc) or CLUSTER
    if smem_bytes(nc, M, r, size) > MAX_SMEM:
        raise ValueError(f"lanczos_expm: ({M}, {r}) with {nc} channels "
                         f"does not fit a cluster of {size} CTAs")
    resident = smem_bytes(nc, M, r, size, resident=True) <= MAX_SMEM
    return way, size, resident, size * (kmax + 1) * -(-M // size) * r


def heff_channels(L, W, R, fac=None):
    """(H_c, Rt_c) of the H_eff matvec; ``fac`` (a real scalar tensor, the
    env log-scale factor) is folded into H_c.  Both come out contiguous."""
    Lf = L if fac is None else L * fac.to(L.dtype)
    H = torch.einsum("bak,aijc->cbikj", Lf, W)
    nc, b, i, k, j = H.shape
    H = H.reshape(nc, b * i, k * j).contiguous()
    return H, R.permute(1, 2, 0).contiguous()


def keff_channels(L, R, fac=None):
    """(H_a, Rt_a) of the K_eff matvec: H_a = L[:, a, :] (no MPO core)."""
    Lf = L if fac is None else L * fac.to(L.dtype)
    return Lf.permute(1, 0, 2).contiguous(), R.permute(1, 2, 0).contiguous()


def fits(shape: tuple, nc: int, max_dim: int) -> bool:
    """Whether the engine runs a Krylov vector of ``shape`` (M, r) over
    ``nc`` channels through the kernel: the complex64 channels H_c
    (nc, M, M) and Rt_c (nc, r, r), and the kernel's Krylov vectors and
    scratch ((k_max + 3 + nc) of (M, r)), within :data:`MAX_BYTES`.  A
    larger site runs ``integrator.krylov_expm`` over the chain einsums
    (``tdvp._site_step``), and its channels are never built."""
    M, r = shape
    kmax = min(max_dim, M * r)
    return 8 * (nc * (M * M + r * r) + (kmax + 3 + nc) * M * r) <= MAX_BYTES


def substeps(bound: float) -> int:
    """Taylor substeps for a Gershgorin bound of ‖scale·T‖ (1 if the bound
    is not finite, so a NaN propagates instead of looping)."""
    if not math.isfinite(bound):
        return 1
    return min(max(math.ceil(bound / SUBSTEP_NORM), 1), MAX_SUBSTEPS)


def tridiag_expm_e0(diag, off, scale: complex) -> torch.Tensor:
    """exp(scale·T)e₀ for the symmetric tridiagonal T = tridiag(off, diag,
    off) (real 1-D tensors), by order-10 Taylor substeps.  The recurrence
    runs in numpy on the host (a tridiagonal of at most 32 entries, a few
    hundred scalar-sized steps: torch launches cost more than the work) in
    the tensors' precision, and the result comes back to their device."""
    n = diag.shape[0]
    d = diag.detach().cpu().numpy()
    o = off.detach().cpu().numpy()
    bound = abs(scale) * (
        float(np.abs(d).max()) + 2.0 * (float(o.max()) if n > 1 else 0.0)
    )
    m = substeps(bound)
    cdtype = np.complex128 if d.dtype == np.float64 else np.complex64
    s = cdtype(scale / m)
    y = np.zeros(n, dtype=cdtype)
    y[0] = 1.0
    for _ in range(m):
        t = y
        for order in range(1, TAYLOR_ORDER + 1):
            z = d * t
            if n > 1:
                z[1:] += o * t[:-1]
                z[:-1] += o * t[1:]
            t = (z * s) * cdtype(1.0 / order)
            y = y + t
    return torch.from_numpy(y).to(diag.device)


def _matvec(H, Rt, x):
    return torch.matmul(H, torch.matmul(x, Rt)).sum(0)


def lanczos_expm_plain(H, Rt, v, scale: complex, thresh: float, kmax: int,
                       conserve: bool, fac=None):
    """Plain PyTorch version of the kernel, any complex dtype and device.

    Returns ``(ψ (M, r), status)`` with ``status = [k_used, bad]`` (int32).
    ``fac`` (a real scalar tensor, or None for 1) scales each matvec's
    output, as the fused site kernel applies the env factor
    (``cuda_site``); ``lanczos_expm`` folds it into H instead.  The loop
    control reads α, β and the error on the host.
    """
    M, r = v.shape
    n = M * r
    real = v.real.dtype
    beta0 = torch.linalg.vector_norm(v)
    V = torch.zeros((kmax + 1, M, r), dtype=v.dtype, device=v.device)
    V[0] = v / beta0
    alpha = torch.zeros(kmax, dtype=real, device=v.device)  # Re(α)
    beta = torch.zeros(kmax, dtype=real, device=v.device)
    prev = torch.zeros_like(v)
    k_fin, bad = 0, False
    for k in range(kmax):
        w = _matvec(H, Rt, V[k])
        if fac is not None:
            w = w * fac
        a = torch.sum(V[0].conj() * w)
        w = w - a * V[k]
        if k > 0:
            w = w - beta[k - 1] * V[k - 1]
        b = torch.linalg.vector_norm(w)
        live = bool(b > EPS_BREAKDOWN)
        if live:
            V[k + 1] = w / b
            beta[k] = b
        alpha[k] = a.real
        c = tridiag_expm_e0(alpha[: k + 1], beta[:k], scale)
        psi = torch.tensordot(c.to(v.dtype), V[: k + 1], dims=1)
        err = float(torch.linalg.vector_norm(psi - prev))
        prev = psi
        conv = k > 0 and err < thresh
        capped = k + 1 >= kmax
        k_fin = k + 1
        if conv or not live or capped:
            bad = capped and not conv and live
            break
    fac = 1.0 / torch.linalg.vector_norm(prev) if conserve else beta0
    status = torch.tensor(
        [k_fin, int(bad and kmax < n)], dtype=torch.int32, device=v.device
    )
    return prev * fac, status


def lanczos_expm(ch, v, scale: complex, thresh: float, max_dim: int,
                 conserve: bool, *, way: str | None = None,
                 cluster: int | None = None):
    """``exp(scale·H)·v`` for the channels ``ch = (H, Rt)`` and ψ ``v``
    (M, r); returns ``(ψ', status)``, ``status = [k_used, bad]`` (int32).

    A CUDA tensor goes through the kernel of its :func:`route` and
    :func:`cluster_size` (or of ``way``, ``"block"`` or ``"cluster"`` of
    ``cluster`` CTAs, to compare them): complex64, contiguous, k_max ≤ 32,
    or this raises, as it does when the card cannot schedule the cluster.
    A CPU tensor goes through :func:`lanczos_expm_plain`.
    ``lanczos_expm.launches`` counts kernel launches
    (``lanczos_expm.route_launches`` by route,
    ``lanczos_expm.cluster_launches`` the cluster route's by size),
    ``lanczos_expm.plain_calls`` the CPU calls.
    """
    H, Rt = ch
    if v.ndim != 2 or H.ndim != 3 or Rt.ndim != 3:
        raise ValueError("lanczos_expm takes v (M, r), H (nc, M, M), Rt (nc, r, r)")
    M, r = v.shape
    nc = H.shape[0]
    if H.shape != (nc, M, M) or Rt.shape != (nc, r, r):
        raise ValueError(
            f"channel shapes {tuple(H.shape)}, {tuple(Rt.shape)} do not fit "
            f"v {tuple(v.shape)}"
        )
    kmax = min(max_dim, M * r)
    if kmax < 1:
        raise ValueError(f"max_dim must be positive, got {max_dim}")
    if v.device.type == "cpu":
        lanczos_expm.plain_calls += 1
        return lanczos_expm_plain(H, Rt, v, scale, thresh, kmax, conserve)
    if v.device.type != "cuda":
        raise ValueError(f"lanczos_expm: no kernel for device {v.device}")
    for name, t in (("v", v), ("H", H), ("Rt", Rt)):
        if t.dtype != torch.complex64:
            raise TypeError(f"the CUDA lanczos_expm takes complex64 {name}, got {t.dtype}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA lanczos_expm takes a contiguous {name}")
    if kmax > MAX_KRYLOV:
        raise ValueError(f"the CUDA lanczos_expm takes max_dim <= {MAX_KRYLOV}")
    way, size, resident, nscratch = plan(M, r, nc, kmax, way, cluster)
    out = torch.empty_like(v)
    status = torch.empty(2, dtype=torch.int32, device=v.device)
    scratch = torch.empty(nscratch, dtype=torch.complex64, device=v.device)
    scale = complex(scale)
    lib = _cuda.load()
    args = (v.device.index, H.data_ptr(), Rt.data_ptr(), v.data_ptr(),
            out.data_ptr(), status.data_ptr(), scratch.data_ptr(), nc, M, r,
            kmax, scale.real, scale.imag, float(thresh), int(bool(conserve)))
    stream = torch.cuda.current_stream(v.device).cuda_stream
    if way == "cluster":
        code = lib.pytdscf_lanczos_expm_cluster_c64(*args, size, int(resident),
                                                    stream)
    else:
        code = lib.pytdscf_lanczos_expm_c64(*args, stream)
    _cuda.check(code, f"lanczos_expm ({way} route)")
    lanczos_expm.launches += 1
    lanczos_expm.route_launches[way] += 1
    if way == "cluster":
        lanczos_expm.cluster_launches[size] = (
            lanczos_expm.cluster_launches.get(size, 0) + 1)
    return out, status


lanczos_expm.launches = 0
lanczos_expm.route_launches = dict.fromkeys(ROUTES, 0)
lanczos_expm.cluster_launches = {}
lanczos_expm.plain_calls = 0


# ------------------------------------------------ improved relaxation


#: Block sizes the ground-state kernel is built for (``lanczos_gs.cu``:
#: ``gs_dispatch``; 1024 threads spill registers, and 32 and 256 measured
#: no faster than 128 on one CTA and slower than 512 on a cluster, PERF.md
#: §6), and the cluster sizes it takes (C = 1: one CTA).
GS_THREADS = (128, 512)
GS_CLUSTERS = (1, 2, 4, 8, 16)
#: Dynamic shared memory a ground-state CTA may ask for: :data:`MAX_SMEM`
#: less its static buffers (partials, T's diagonals, the eigenvector).
GS_MAX_SMEM = MAX_SMEM - 1024
#: The ground state's own route rule (:func:`gs_rule`), set from
#: ``scripts/relax_step.py --sweep`` over the relax stages' 11 shapes (H100
#: 80GB HBM3, 700 W; PERF.md §6): a site whose matvec has at least
#: GS_CLUSTER_WORK complex multiply-adds runs on the largest cluster, 512
#: threads a CTA (1024 spill registers); a smaller one on one CTA of 128.
GS_CLUSTER_WORK = 50_000
GS_CLUSTER_THREADS = 512
GS_BLOCK_THREADS = 128


def gs_smem_bytes(nc: int, M: int, r: int, cluster: int, kmax: int,
                  wide: bool, resident: bool, v_shared: bool) -> int:
    """Dynamic shared memory of one ground-state CTA
    (``lanczos_gs.cu:gs_smem``): three whole Krylov vectors (3·M·r
    complex64) and Rt (nc·r²), or where ``wide`` only a copy of one vector
    (M·r: the three live in device scratch, Rt is read from device
    memory); the matvec's intermediate (nc·Mc·r), the CTA's rows of the
    ``kmax`` Krylov vectors where ``v_shared``, the CTA's nc·Mc rows of H
    (all M columns when ``resident``, else a slice of :data:`CHUNK`; rows
    padded by one), Mc = ceil(M / C)."""
    mc = -(-M // cluster)
    cols = (M if resident else CHUNK) + 1
    vectors = M * r if wide else 3 * M * r + nc * r * r
    return 8 * (vectors + nc * mc * r + (kmax * mc * r if v_shared else 0)
                + nc * mc * cols)


def gs_layout(M: int, r: int, nc: int, cluster: int
              ) -> tuple[bool, bool, bool] | None:
    """``(wide, resident, v_shared)`` of a ground-state CTA: the most that
    fits in its shared memory.  H's rows first (read whole by every
    matvec; streamed, each matvec waits on device memory once a slice),
    then the three whole vectors and Rt (the wide layout keeps them in
    device memory), then its rows of the Krylov vectors (written once an
    iteration, read once a pass); None where not even a slice of H's rows
    fits beside one vector."""
    kmax = min(integrator.GS_BLOCK_DIM, M * r)
    for resident, wide, v_shared in itertools.product(
            (True, False), (False, True), (True, False)):
        if gs_smem_bytes(nc, M, r, cluster, kmax, wide, resident,
                         v_shared) <= GS_MAX_SMEM:
            return wide, resident, v_shared
    return None


def gs_candidates(M: int, r: int, nc: int) -> list[tuple[int, int]]:
    """Every ``(cluster, threads)`` the ground-state kernel takes for an
    (M, r) site over ``nc`` channels: one CTA of any of
    :data:`GS_THREADS`, or a cluster of :data:`GS_CLUSTER_THREADS` a CTA,
    as long as the cluster has no more CTAs than rows and a layout
    fits."""
    out = []
    for size in GS_CLUSTERS:
        if size > M or gs_layout(M, r, nc, size) is None:
            continue
        for threads in GS_THREADS if size == 1 else (GS_CLUSTER_THREADS,):
            out.append((size, threads))
    return out


def gs_rule(M: int, r: int, nc: int) -> tuple[int, int] | None:
    """The ground state's ``(cluster, threads)`` for an (M, r) site over
    ``nc`` channels: a matvec of nc·M·r·(M + r) complex multiply-adds
    below :data:`GS_CLUSTER_WORK` runs on one CTA of
    :data:`GS_BLOCK_THREADS`; a larger one on the largest cluster of
    :data:`GS_CLUSTERS` with no more CTAs than rows, of
    :data:`GS_CLUSTER_THREADS` a CTA.  Where no layout of that route fits
    (``gs_layout``: one CTA's share of H's rows too large), the next
    larger cluster that fits; None where none does."""
    size, threads = 1, GS_BLOCK_THREADS
    if nc * M * r * (M + r) >= GS_CLUSTER_WORK:
        size = max(c for c in GS_CLUSTERS if c <= M)
        threads = GS_CLUSTER_THREADS
    for c in GS_CLUSTERS:
        if c >= size and c <= M and gs_layout(M, r, nc, c):
            return c, threads if c == size else GS_CLUSTER_THREADS
    return None


def gs_fits(shape: tuple, nc: int) -> bool:
    """Whether the engine runs the ground state of an (M, r) site over
    ``nc`` channels through the kernel: the complex64 channels and the
    kernel's ``k_max + 1`` Krylov vectors (k_max = min(24, M·r)) within
    :data:`MAX_BYTES`, as :func:`fits` counts them, and a layout of
    :func:`gs_rule`'s route that fits a CTA's shared memory.  A larger
    site runs ``integrator.ground_state_multi`` over the chain einsums."""
    M, r = shape
    kmax = min(integrator.GS_BLOCK_DIM, M * r)
    return (8 * (nc * (M * M + r * r) + (kmax + 1) * M * r) <= MAX_BYTES
            and gs_rule(M, r, nc) is not None)


@functools.lru_cache(maxsize=256)
def gs_plan(M: int, r: int, nc: int, way: str | None = None
            ) -> tuple[str, int, int, bool, bool, bool, int]:
    """``(way, C, threads, wide, resident, v_shared, scratch)`` of a
    ground-state launch: C CTAs of ``threads`` threads (:func:`gs_rule`,
    or one CTA where ``way`` is ``"block"``), as :func:`_gs_launch_plan`
    lays them out.  ``way`` is ``"block"`` for one CTA, else
    ``"cluster"``.  Raises ValueError where the shape has no such
    route."""
    if way not in (None, *ROUTES):
        raise ValueError(f"unknown ground_state route {way!r}")
    rule = gs_rule(M, r, nc)
    if rule is None:
        raise ValueError(f"ground_state: ({M}, {r}) with {nc} channels fits "
                         "no route")
    size, threads = rule
    if way == "block" and size != 1:
        size, threads = 1, GS_CLUSTER_THREADS
    if way == "cluster" and size == 1:
        raise ValueError(f"ground_state: ({M}, {r}) with {nc} channels has "
                         "no cluster route")
    return _gs_launch_plan(M, r, nc, size, threads)


@functools.lru_cache(maxsize=256)
def _gs_launch_plan(M: int, r: int, nc: int, size: int, threads: int
                    ) -> tuple[str, int, int, bool, bool, bool, int]:
    """:func:`gs_plan`'s tuple for C = ``size`` CTAs of ``threads``
    threads, any of :func:`gs_candidates` (ValueError otherwise): the
    layout of :func:`gs_layout`, and the complex64 entries of device
    scratch for the Krylov vectors' rows where they do not fit in shared
    memory, then for the wide layout's whole vectors (three a CTA, and the
    two that carry the exchanges' rows)."""
    if (size, threads) not in gs_candidates(M, r, nc):
        raise ValueError(f"ground_state: ({M}, {r}) with {nc} channels has "
                         f"no route of {size} CTAs of {threads} threads")
    wide, resident, v_shared = gs_layout(M, r, nc, size)
    kmax = min(integrator.GS_BLOCK_DIM, M * r)
    scratch = ((0 if v_shared else size * kmax * -(-M // size) * r)
               + ((3 * size + 2) * M * r if wide else 0))
    return ("block" if size == 1 else "cluster", size, threads, wide,
            resident, v_shared, scratch)


def ground_state_plain(H, Rt, v):
    """Plain PyTorch version of the ground-state kernel, any complex dtype
    and device: ``integrator.ground_state_multi`` over the channel matvec
    ``Σ_c H_c (v Rt_c)``.  Returns ``(v' (M, r), status)``, ``status =
    [passes, Lanczos iterations, breakdowns]`` (int32)."""
    M, r = v.shape

    def mv(x):
        return _matvec(H, Rt, x.reshape(M, r)).reshape(-1)

    out, status = integrator.ground_state_multi(mv, v.reshape(-1))
    return out.reshape(M, r), status


def ground_state(ch, v, *, way: str | None = None):
    """The lowest eigenvector of H = Σ_c H_c (· Rt_c) by restarted Lanczos
    from ``v`` (M, r) (improved relaxation), for the channels ``ch = (H,
    Rt)``; returns ``(v', status)``, ``status = [passes, Lanczos
    iterations, breakdowns]`` (int32), v' normalised.

    A CUDA tensor goes through the kernel, every pass in one launch, on
    the route of :func:`gs_plan` (``way`` ``"block"``: one CTA):
    complex64 and contiguous, or this raises.  A CPU tensor goes through
    :func:`ground_state_plain`.  ``ground_state.launches`` counts kernel
    launches (``route_launches`` by route, ``cluster_launches`` the
    cluster route's by size), ``ground_state.plain_calls`` the CPU
    calls."""
    H, Rt = ch
    if v.ndim != 2 or H.ndim != 3 or Rt.ndim != 3:
        raise ValueError("ground_state takes v (M, r), H (nc, M, M), Rt (nc, r, r)")
    M, r = v.shape
    nc = H.shape[0]
    if H.shape != (nc, M, M) or Rt.shape != (nc, r, r):
        raise ValueError(
            f"channel shapes {tuple(H.shape)}, {tuple(Rt.shape)} do not fit "
            f"v {tuple(v.shape)}"
        )
    if v.device.type == "cpu":
        ground_state.plain_calls += 1
        return ground_state_plain(H, Rt, v)
    return _ground_state_launch(ch, v, gs_plan(M, r, nc, way))


def _ground_state_on(ch, v, cluster: int, threads: int):
    """:func:`ground_state` on the card on C = ``cluster`` CTAs of
    ``threads`` threads, any of :func:`gs_candidates`, to compare the
    routes (``scripts/relax_step.py --sweep``, the card tests)."""
    M, r = v.shape
    return _ground_state_launch(
        ch, v, _gs_launch_plan(M, r, ch[0].shape[0], cluster, threads))


def _ground_state_launch(ch, v, plan):
    """One launch of the ground-state kernel on ``plan``
    (:func:`_gs_launch_plan`'s tuple), counted."""
    H, Rt = ch
    M, r = v.shape
    if v.device.type != "cuda":
        raise ValueError(f"ground_state: no kernel for device {v.device}")
    for name, t in (("v", v), ("H", H), ("Rt", Rt)):
        if t.dtype != torch.complex64:
            raise TypeError(f"the CUDA ground_state takes complex64 {name}, got {t.dtype}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA ground_state takes a contiguous {name}")
    way, size, nthreads, wide, resident, v_shared, nscratch = plan
    kmax = min(integrator.GS_BLOCK_DIM, M * r)
    out = torch.empty_like(v)
    status = torch.empty(3, dtype=torch.int32, device=v.device)
    scratch = (torch.empty(nscratch, dtype=torch.complex64, device=v.device)
               if nscratch else None)
    code = _cuda.load().pytdscf_lanczos_gs_c64(
        v.device.index, H.data_ptr(), Rt.data_ptr(), v.data_ptr(),
        out.data_ptr(), status.data_ptr(),
        None if scratch is None else scratch.data_ptr(), H.shape[0], M, r,
        kmax, size, nthreads, int(wide), int(resident), int(v_shared),
        torch.cuda.current_stream(v.device).cuda_stream)
    _cuda.check(code, f"ground_state ({way} route)")
    ground_state.launches += 1
    ground_state.route_launches[way] += 1
    if way == "cluster":
        ground_state.cluster_launches[size] = (
            ground_state.cluster_launches.get(size, 0) + 1)
    return out, status


ground_state.launches = 0
ground_state.route_launches = dict.fromkeys(ROUTES, 0)
ground_state.cluster_launches = {}
ground_state.plain_calls = 0
