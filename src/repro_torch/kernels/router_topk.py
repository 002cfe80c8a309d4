"""MoE routing: hand-written CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/router_topk.py``.  For router logits
``(T, E)`` :func:`router_topk` returns

* ``probs (T, E)`` float32: the softmax over experts;
* ``vals (T, k)`` float32: the top-k probabilities, renormalised to sum
  1 (the sum clamped at 1e-9);
* ``idx (T, k)`` int32: their experts, by iterated masked argmax, so a
  tie goes to the lower index, as ``jax.lax.top_k`` and the TPU kernel
  choose.

:func:`moe_route` is the whole routing stage of an MoE layer
(``repro/models/moe.py:90-119``) in one launch: from the tokens ``x (T,
d)`` and the router weight ``w (d, E)`` it returns a :class:`Route`,
the router product, the top-k above, and the capacity dispatch of the
``T * k`` assignments in flat order ``t * k + j``, first come first
served per expert (the JAX package's stable ``argsort``).

Both launch ``csrc/router_topk.cu`` on the current CUDA stream and count
their launches (``router_topk.launches``, ``moe_route.launches``).
:func:`router_topk_plain` (``repro/kernels/ref.py:91-98`` with the
kernel's tie order) and :func:`moe_route_plain` are what ``kernels.ops``
runs for a CPU tensor.

:class:`RouteFn` is the routing stage's ``torch.autograd.Function``
(over the kernel or the plain version): ``vals`` and ``aux`` are its
differentiable outputs, and its backward (:func:`route_backward`) is
torch ops on the ``(T, E)`` tensors and two matrix products, as JAX
differentiates the same lines in XLA.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

MAX_EXPERTS = 256  # 32 lanes × 8 logits a lane in the kernel
MAX_K = 8
MAX_ASSIGNMENTS = 1 << 24  # T * k and E * C the fused route takes
THREADS = 256  # a block of moe_route
BK_MIN, BK_MAX = 32, 256  # depth of its k-tiles
MAX_CHUNKS = 16  # chunks of d a token tile is split over


class Route(NamedTuple):
    """What the expert products and the combine need of the router."""

    logits: torch.Tensor  # (T, E) float32
    probs: torch.Tensor  # (T, E) float32
    vals: torch.Tensor  # (T, k) float32, the gates
    idx: torch.Tensor  # (T, k) int32, their experts
    slot: torch.Tensor  # (T * k,) int32: e * C + pos, or E * C when dropped
    src: torch.Tensor  # (E * C,) int32: the token row in each slot, or -1
    counts: torch.Tensor  # (E,) int32: assignments per expert, kept or not
    aux: torch.Tensor  # () float32, the Switch load-balance loss


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.router_topk.argtypes = [P, P, P, P, I, I, I, P]
    lib.router_topk.restype = I
    lib.moe_route.argtypes = [P] * 14 + [I] * 12 + [P]
    lib.moe_route.restype = I


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"router_topk: logits must be (T, E), got {tuple(logits.shape)}")
    E = logits.shape[1]
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"router_topk: k={k} must lie in [1, min(E={E}, {MAX_K})]")


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax + top-k + renormalise on the card → ``(probs, vals, idx)``."""
    _check(logits, k)
    if not logits.is_cuda:
        raise ValueError(f"router_topk: the CUDA kernel needs a CUDA tensor, got {logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("router_topk: logits must be contiguous float32")
    T, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"router_topk: the kernel takes at most {MAX_EXPERTS} experts, got {E}")
    probs = torch.empty_like(logits)
    vals = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:  # nothing to launch, so nothing to count
        return probs, vals, idx
    lib = build.library("router_topk", _bind)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = lib.router_topk(logits.data_ptr(), probs.data_ptr(), vals.data_ptr(),
                               idx.data_ptr(), T, E, k, stream)
    build.check(lib, code, "router_topk")
    router_topk.launches += 1
    return probs, vals, idx


router_topk.launches = 0


def router_topk_plain(logits: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`router_topk`.

    Top-k is k rounds of ``argmax``, which returns the first maximum, not
    ``torch.topk``, whose order among ties is unspecified.
    """
    _check(logits, k)
    probs = torch.softmax(logits.float(), dim=-1)
    work = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = work.argmax(dim=-1, keepdim=True)
        vals.append(work.gather(-1, i))
        idxs.append(i)
        work = work.scatter(-1, i, -1.0)  # out of place: autograd can see through it
    v = torch.cat(vals, dim=-1)
    v = v / v.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, v, torch.cat(idxs, dim=-1).to(torch.int32)


# --------------------------------------------------------------------- #
# the fused routing stage
# --------------------------------------------------------------------- #
def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def route_plan(T: int, d: int, E: int, sms: int) -> Dict[str, int]:
    """The grid of ``moe_route`` for ``T`` tokens of width ``d`` over ``E``
    experts on a card of ``sms`` SMs.

    A thread holds a 4×4 tile of (tokens, experts); ``NE`` threads span
    the experts (``Ep = 4 * NE >= E``), ``NM`` the token tile ``TM = 4 *
    NM`` (64 rows from T = 1024, else at most 8: a short batch spreads
    over several tiles, and the last block of each ranks its at most 32
    assignments with one warp when k <= 4), and ``KS = 256 / (NE * NM)``
    slices of threads split each k-tile of ``BK`` columns, as deep as a
    thread's staging registers allow (up to 256) so that a short batch
    needs few chunks.  Each tile is split over ``NC`` chunks of ``DC``
    columns of ``d``: about two blocks an SM (so that an SM has a second
    block's warps to run while one waits on its loads), at most 16
    partials a tile, and no more partials than one block sums in about
    64 KB.

    With one tile (``NT == 1``, decode) the launch finishes in place.
    With several, a second launch of ``NT`` blocks places the
    assignments, one block a tile, after the first grid's last block has
    scanned the tiles' counts into bases; it is chained by programmatic
    dependent launch.
    """
    NE = _pow2(math.ceil(E / 4))
    NM = min(16 if T >= 1024 else 2, _pow2(math.ceil(T / 4)), THREADS // NE)
    KS = THREADS // (NE * NM)
    TM, Ep = 4 * NM, 4 * NE
    NT = math.ceil(T / TM)
    BK = BK_MIN
    while BK < BK_MAX and TM * 2 * BK <= 2048 and 2 * BK * Ep <= 8192:
        BK *= 2
    ktiles = math.ceil(d / BK)
    NC = max(1, min(ktiles, 2 * sms // NT, 16384 // (TM * Ep), MAX_CHUNKS))
    DC = math.ceil(ktiles / NC) * BK
    NC = math.ceil(d / DC)
    return dict(TM=TM, NT=NT, NC=NC, DC=DC, BK=BK, NE=NE, NM=NM, KS=KS)


def _check_route(x: torch.Tensor, w: torch.Tensor, k: int, C: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"moe_route: x (T, d) and w (d, E) do not fit: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    T, E = x.shape[0], w.shape[1]
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"moe_route: k={k} must lie in [1, min(E={E}, {MAX_K})]")
    if C < 1:
        raise ValueError(f"moe_route: capacity {C} must be at least 1")
    if T * k > MAX_ASSIGNMENTS or E * C > MAX_ASSIGNMENTS:
        raise ValueError(f"moe_route: T * k = {T * k} and E * C = {E * C} must be at "
                         f"most {MAX_ASSIGNMENTS}")


# per (device, stream): float32 scratch for the partial products, the
# tiles' column sums and counts (no value carries from one launch on)
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _scratch.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = _scratch[(device.index, stream)] = torch.empty(
            max(n, 1024), dtype=torch.float32, device=device)
    return buf


def moe_route(x: torch.Tensor, w: torch.Tensor, k: int, C: int) -> Route:
    """The routing stage on the card in one launch → :class:`Route`.

    ``x (T, d)`` and ``w (d, E)`` contiguous float32 on one card; ``C``
    the capacity of each expert.
    """
    _check_route(x, w, k, C)
    if not x.is_cuda:
        raise ValueError(f"moe_route: the CUDA kernel needs a CUDA tensor, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"moe_route: w on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"moe_route: {name} must be contiguous float32")
    (T, d), E = x.shape, w.shape[1]
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_route: the kernel takes at most {MAX_EXPERTS} experts, got {E}")
    dev = x.device
    f = torch.empty(2 * T * E + T * k + 1, dtype=torch.float32, device=dev)
    i = torch.empty(2 * T * k + E * C + E, dtype=torch.int32, device=dev)
    TE, Tk = T * E, T * k
    out = Route(logits=f[:TE].view(T, E), probs=f[TE:2 * TE].view(T, E),
                vals=f[2 * TE:2 * TE + Tk].view(T, k), idx=i[:Tk].view(T, k),
                slot=i[Tk:2 * Tk], src=i[2 * Tk:2 * Tk + E * C],
                counts=i[2 * Tk + E * C:], aux=f[-1])
    if T == 0:  # nothing to launch, so nothing to count; as the plain version
        out.src.fill_(-1)
        out.counts.zero_()
        out.aux.fill_(math.nan)  # the mean over no tokens
        return out
    plan = route_plan(T, d, E, build.sm_count(dev))
    NT, NC, TM, Ep = plan["NT"], plan["NC"], plan["TM"], 4 * plan["NE"]
    lib = build.library("router_topk", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_part, n_col = NT * NC * TM * Ep, NT * E
        base = _scratch_buffer(dev, stream, n_part + 2 * n_col).data_ptr()
        counters = build.counters(dev, stream, NT + 1)
        code = lib.moe_route(
            x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in out),
            base, base + 4 * n_part, base + 4 * (n_part + n_col), counters.data_ptr(),
            T, d, E, k, C, NT, NC, plan["DC"], plan["BK"], plan["NE"], plan["NM"],
            plan["KS"], stream)
    build.check(lib, code, "moe_route")
    moe_route.launches += 1
    return out


moe_route.launches = 0


def route_logits_plain(logits: torch.Tensor, k: int, C: int,
                       topk: Callable = router_topk_plain) -> Route:
    """The routing stage after the router product, in plain PyTorch: the
    lines of ``repro/models/moe.py:90-119``.  ``topk`` is the top-k
    function: the plain version, or :func:`router_topk` to time the
    unfused chain on the card."""
    T, E = logits.shape
    K = k
    probs, gate_vals, gate_idx = topk(logits.contiguous(), K)
    flat_e = gate_idx.reshape(-1).long()  # (T*K,)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)
    # (bincount would wait on the device for its output size)
    counts = torch.zeros(E, dtype=torch.long, device=logits.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)

    # position within each expert: a stable sort groups the assignments
    # by expert in token order, so rank-in-group is first come first served
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_sorted = torch.arange(T * K, device=logits.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    slot = torch.where(pos < C, flat_e * C + pos, E * C)  # (T*K,)
    # the token in each kept slot; every dropped assignment lands in the
    # extra entry E*C, which is cut off
    src = torch.full((E * C + 1,), -1, dtype=torch.int32, device=logits.device)
    src[slot] = torch.arange(T, dtype=torch.int32, device=logits.device).repeat_interleave(K)
    return Route(logits=logits, probs=probs, vals=gate_vals, idx=gate_idx,
                 slot=slot.to(torch.int32), src=src[:E * C],
                 counts=counts.to(torch.int32), aux=aux)


def moe_route_plain(x: torch.Tensor, w: torch.Tensor, k: int, C: int) -> Route:
    """Plain PyTorch version of :func:`moe_route`: the router product
    ``x @ w``, then :func:`route_logits_plain`."""
    _check_route(x, w, k, C)
    return route_logits_plain(x @ w, k, C)


# --------------------------------------------------------------------- #
# autograd of the routing stage
# --------------------------------------------------------------------- #
def route_backward(x: torch.Tensor, w: torch.Tensor, probs: torch.Tensor,
                   vals: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
                   dvals, daux):
    """``(dx, dw)`` from the gradients of the gates and of the aux loss,
    as JAX differentiates ``repro/models/moe.py:90-98``:

    * the renormalisation ``vals = p_sel / max(Σ_j p_sel, 1e-9)``:
      ``dp_sel = (dvals − Σ_j dvals·vals) / max(Σ_j p_sel, 1e-9)`` (the
      second term only where the sum is above the clamp);
    * ``dp_sel`` scattered into the experts ``idx`` (distinct in a row);
    * the aux loss ``E · Σ_e mean_t(probs)[e] · ce[e]`` adds ``daux · E ·
      ce[e] / T`` to every row (``ce``, the assignment counts over ``T·k``,
      is a constant);
    * the softmax: ``dlogits = probs · (dprobs − Σ_e dprobs·probs)``;
    * the router product: ``dx = dlogits @ wᵀ``, ``dw = xᵀ @ dlogits``.
    """
    T, E = probs.shape
    K = idx.shape[1]
    dprobs = torch.zeros_like(probs)
    if dvals is not None:
        S = probs.gather(1, idx.long()).sum(dim=-1, keepdim=True)
        Sc = S.clamp_min(1e-9)
        inner = (dvals * vals).sum(dim=-1, keepdim=True)
        dp_sel = (dvals - torch.where(S > 1e-9, inner, torch.zeros_like(inner))) / Sc
        dprobs.scatter_(1, idx.long(), dp_sel)
    if daux is not None:
        ce = counts.float() / (T * K)
        dprobs = dprobs + (daux * E) * ce / T
    dlogits = probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True))
    return dlogits @ w.t(), x.t() @ dlogits


class RouteFn(torch.autograd.Function):
    """The routing stage with a gradient: returns the fields of
    :class:`Route`; only ``vals`` and ``aux`` carry one."""

    @staticmethod
    def forward(ctx, x, w, k, C, kernel):
        r = (moe_route if kernel else moe_route_plain)(x, w, k, C)
        ctx.save_for_backward(x, w, r.probs, r.vals, r.idx, r.counts)
        ctx.mark_non_differentiable(r.logits, r.probs, r.idx, r.slot, r.src, r.counts)
        return tuple(r)

    @staticmethod
    def backward(ctx, _dlogits, _dprobs, dvals, _didx, _dslot, _dsrc, _dcounts, daux):
        x, w, probs, vals, idx, counts = ctx.saved_tensors
        dx, dw = route_backward(x, w, probs, vals, idx, counts, dvals, daux)
        return dx, dw, None, None, None
