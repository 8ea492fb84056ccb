"""Sums over electronic-state pairs, batched by MPO shape.

A model with several electronic states keeps one MPS per state and one
fused MPO per state pair ``(i, j)`` (``fused[i][j]``, None where the pair
does not couple).  Every contraction of a site step is a sum over pairs:
the H_eff matvec adds ``fac_q · H_eff_q(ψ_j)`` into ``σ_i``, K_eff the same
on the bond matrices, and each pair keeps its own environment blocks, built
from the bra state's and the ket state's cores, at unit norm with their
own log-scales (``fac_q`` restores them).

The JAX package loops over pairs inside one jitted program, where XLA fuses
the loop.  Here pairs whose MPO cores have the same shape at every site
form a :class:`PairGroup`, and each group's contraction is ONE batched
einsum chain over a leading pair axis: gather ``ψ_j`` of every pair,
contract, then a GEMM with the group's scatter matrix (``fac_q`` at row
``i_q`` of column ``q``) sums the terms into their states, deterministically
(no atomics).  The 27-state LH2 exciton model's 189 pairs are two groups
(the diagonal pairs, MPO width 2; the couplings, width 1), so a matvec is a
few tens of launches, not three einsums a pair.  The sums run in another
order than the JAX package's, equal to rounding.

The ``"high"`` and ``"default"`` matvecs and transfers (bf16x3 and one
bf16 pass) go through the one-pair kernel wrappers (``cuda_renorm``,
``cuda_matvec``) pair by pair, as the JAX package's ``make_hmatvec_lo``
does: one launch a pair.

All states share their physical dimensions (the fused MPO is built for
state 0's) and, but under adaptive bond dimension, their bonds, so a
site's states stack into one ``(nstate, l, d, r)`` tensor, flattened the
Krylov vector (``kernels.stack_states``); an adaptive sweep pads the
narrower states' bonds with zero channels (``tdvp._pad_stack``).
"""

from __future__ import annotations

import torch

from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps import cuda_renorm as CR

Pair = tuple[int, int]


def state_pairs(fused, nstate: int) -> tuple[Pair, ...]:
    """The pairs ``(i, j)`` with a fused MPO, row by row (the JAX package's
    ``TDVPEngine.pairs``)."""
    return tuple((i, j) for i in range(nstate) for j in range(nstate)
                 if fused[i][j] is not None)


class PairGroup:
    """Pairs whose fused MPO cores share their shape at every site.

    ``members``: their positions in the pair list; ``i``/``j``: bra and
    ket states (long tensors, and ``js`` as ints); ``W[p]``: the site's MPO
    cores stacked ``(P, a, i, j, b)``; ``onehot``: the ``(nstate, P)``
    incidence of the bra states, from which :meth:`scatter` makes the
    summing matrix; ``gather``: False where ``ψ_j`` of the pairs in order
    is the stacked site itself (``j = 0..nstate−1``)."""

    def __init__(self, members, pairs, cores, nstate: int, device, dtype):
        self.members = list(members)
        self.js = [pairs[q][1] for q in self.members]
        self.i = torch.tensor([pairs[q][0] for q in self.members],
                              dtype=torch.long, device=device)
        self.j = torch.tensor(self.js, dtype=torch.long, device=device)
        nsite = len(cores[self.members[0]])
        self.W = [torch.stack([cores[q][p] for q in self.members])
                  for p in range(nsite)]
        self.onehot = (torch.arange(nstate, device=device)[:, None]
                       == self.i[None, :]).to(dtype)
        self.gather = self.js != list(range(nstate))
        self.gather_i = [pairs[q][0] for q in self.members] != list(
            range(nstate))

    def __len__(self) -> int:
        return len(self.members)

    def kets(self, x: torch.Tensor) -> torch.Tensor:
        """``x[j_q]`` of each pair from the stacked ``x`` (nstate, ...)."""
        return x.index_select(0, self.j) if self.gather else x

    def bras(self, x: torch.Tensor) -> torch.Tensor:
        """``x[i_q]`` of each pair."""
        return x.index_select(0, self.i) if self.gather_i else x

    def scatter(self, fac: torch.Tensor | None) -> torch.Tensor:
        """The ``(nstate, P)`` matrix that sums the pairs' terms into their
        bra states, each scaled by its ``fac`` (None: 1)."""
        if fac is None:
            return self.onehot
        return self.onehot * fac.to(self.onehot.dtype)[None, :]


class PairSet:
    """The state pairs of an operator's fused MPO (``fused[i][j]``, lists of
    numpy cores or None) on one device, grouped for batched sums.

    ``pairs``: the pairs in the JAX package's order; ``W``: each pair's
    site cores, keyed by pair; ``groups``: :class:`PairGroup` s; ``order``:
    for each pair, its position in the groups' concatenation (a long
    tensor on the device)."""

    def __init__(self, fused, nstate: int, put, device, dtype):
        self.nstate = nstate
        self.pairs = state_pairs(fused, nstate)
        self.W = {pair: [put(c) for c in fused[pair[0]][pair[1]]]
                  for pair in self.pairs}
        keyed: dict = {}
        for q, pair in enumerate(self.pairs):
            key = tuple(tuple(w.shape) for w in self.W[pair])
            keyed.setdefault(key, []).append(q)
        cores = [self.W[pair] for pair in self.pairs]
        self.groups = [PairGroup(members, self.pairs, cores, nstate, device,
                                 dtype) for members in keyed.values()]
        flat = [q for g in self.groups for q in g.members]
        self.order = torch.tensor([flat.index(q)
                                   for q in range(len(self.pairs))],
                                  dtype=torch.long, device=device)

    def wide(self) -> "PairSet":
        """A complex128 copy (the groups' stacked cores and incidence)."""
        out = object.__new__(PairSet)
        out.__dict__.update(self.__dict__)
        out.W = {k: [w.to(torch.complex128) for w in v]
                 for k, v in self.W.items()}
        groups = []
        for g in self.groups:
            h = object.__new__(PairGroup)
            h.__dict__.update(g.__dict__)
            h.W = [w.to(torch.complex128) for w in g.W]
            h.onehot = g.onehot.to(torch.complex128)
            groups.append(h)
        out.groups = groups
        return out


# ------------------------------------------------------ batched chains
def heff_terms(L, W, R, psi) -> torch.Tensor:
    """Each pair's ``σ[b, i, x] = Σ L[b,a,k]·W[a,i,j,c]·R[x,c,r]·ψ[k,j,r]``
    over a leading pair axis (``kernels.heff_apply``'s order)."""
    t1 = torch.einsum("zkjr,zxcr->zkjxc", psi, R)
    t2 = torch.einsum("zkjxc,zaijc->zkiax", t1, W)
    return torch.einsum("zkiax,zbak->zbix", t2, L)


def keff_terms(L, R, sig) -> torch.Tensor:
    """Each pair's ``σ'[b, x] = Σ L[b,a,k]·R[x,a,r]·σ[k,r]``."""
    t1 = torch.einsum("zkr,zxar->zkxa", sig, R)
    return torch.einsum("zkxa,zbak->zbx", t1, L)


def renorm_left(L, bra, W, ket) -> torch.Tensor:
    """Each pair's ``L'[o,c,p] = Σ Ā_bra[b,i,o]·W[a,i,j,c]·A_ket[k,j,p]·
    L[b,a,k]`` (``kernels.renorm_block_left``'s order)."""
    t1 = torch.einsum("zbak,zbio->zkaio", L, bra.conj())
    t2 = torch.einsum("zkaio,zaijc->zkojc", t1, W)
    return torch.einsum("zkojc,zkjp->zocp", t2, ket)


def renorm_right(R, bra, W, ket) -> torch.Tensor:
    """Each pair's ``R'[o,c,p] = Σ B̄_bra[o,i,b]·W[c,i,j,a]·B_ket[p,j,k]·
    R[b,a,k]``."""
    t1 = torch.einsum("zbak,zoib->zkaoi", R, bra.conj())
    t2 = torch.einsum("zkaoi,zcija->zkocj", t1, W)
    return torch.einsum("zkocj,zpjk->zocp", t2, ket)


def normalize(raw: torch.Tensor, log: torch.Tensor):
    """Each pair's block at unit Frobenius norm, its log-scale advanced by
    the log of the norm (``tdvp._normalize_block`` a pair at a time)."""
    nrm = torch.linalg.vector_norm(raw.reshape(raw.shape[0], -1),
                                   dim=1).clamp_min(1e-30)
    return raw / nrm.reshape(-1, *([1] * (raw.dim() - 1))), log + torch.log(nrm)


def transfer(g: PairGroup, block, site, W, forward: bool,
             prec: str = "highest") -> torch.Tensor:
    """The group's environment transfer through one site: ``block`` (P,
    ...) the blocks, ``site`` the stacked cores (nstate, l, d, r) as bra
    and ket, ``W`` the stacked MPO cores; ``prec`` as
    ``Config.env_precision`` ("high" and "default": the one-pair kernel
    wrappers pair by pair)."""
    bra, ket = g.bras(site), g.kets(site)
    if prec == "highest":
        fn = renorm_left if forward else renorm_right
        return fn(block, bra, W, ket)
    fn = {("high", True): CR.renorm_left_hi, ("high", False): CR.renorm_right_hi,
          ("default", True): CR.renorm_left_lo,
          ("default", False): CR.renorm_right_lo}[prec, forward]
    return torch.stack([fn(block[z], bra[z], W[z], ket[z])
                        for z in range(len(g))])


# ------------------------------------------------------------- matvecs
def matvec(groups, Ls, Ws, Rs, facs, nstate: int, shape,
           prec: str = "highest"):
    """The multi-state H_eff (``Ws`` given) or K_eff (``Ws`` None) matvec
    on flat stacked vectors of sites of ``shape``: ``σ_i = Σ_q fac_q ·
    term_q(ψ_j)`` over each group's pairs (``Ls``, ``Ws``, ``Rs``, ``facs``:
    one entry per group).  ``prec``: "highest" the batched einsum chains
    (float32 with TF32 off, or complex128); "high" the bf16x3 chain
    (``cuda_renorm.heff_hi``/``keff_hi``) and "lo" the one-pass bf16
    kernels (``cuda_matvec.heff_lo``/``keff_lo``), a launch a pair, their
    operands built here, once, outside the Krylov loop."""
    heff = Ws is not None
    scat = [g.scatter(f) for g, f in zip(groups, facs)]
    if prec == "highest":
        def terms(g, q, x):
            if heff:
                return heff_terms(Ls[q], Ws[q], Rs[q], g.kets(x))
            return keff_terms(Ls[q], Rs[q], g.kets(x))
    else:
        if prec == "high":
            build = CR.heff_operands if heff else CR.keff_operands
            apply = CR.heff_hi if heff else CR.keff_hi
        else:
            build = CM.heff_operands if heff else CM.keff_operands
            apply = CM.heff_lo if heff else CM.keff_lo
        ops = [[build(Ls[q][z], Ws[q][z], Rs[q][z]) if heff
                else build(Ls[q][z], Rs[q][z]) for z in range(len(g))]
               for q, g in enumerate(groups)]

        def terms(g, q, x):
            return torch.stack([apply(op, x[j])
                                for op, j in zip(ops[q], g.js)])

    def mv(vec):
        x = vec.view(nstate, *shape)
        out = None
        for q, g in enumerate(groups):
            t = terms(g, q, x)
            s = scat[q] @ t.reshape(len(g), -1)
            out = s if out is None else out + s
        return out.reshape(-1)

    return mv
