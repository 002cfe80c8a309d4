"""Recurrent mixers of the port: Mamba2 (SSD) and xLSTM's mLSTM and sLSTM
(counterpart of ``repro/models/ssm.py``, function for function).

* ``*_fwd`` is the full-sequence training path: Mamba2 through the
  chunked SSD scan (:func:`_ssd_chunked`: quadratic products inside a
  chunk, a recurrence over chunk states), mLSTM through its chunked
  stabilized form (:func:`_mlstm_chunked`), sLSTM a loop over time.
* ``*_decode`` is one recurrent step against the carried state of
  ``*_init_state``; it returns the new state as new tensors.

The JAX package runs these in XLA (no Pallas kernel backs them), so they
are plain torch ops here, under autograd.  Each ``jax.lax.scan`` is a
Python loop; the chunk loops return the state *before* each chunk, as
the scans do.  Recurrences run in float32 whatever the tree's dtype.
Maxima are ``amax`` (a tie's gradient split evenly, as JAX's reduce-max
does), and every ``-inf`` mask is a ``torch.where`` before its ``exp``,
so backward sees no NaN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.nn import Params

State = Dict[str, torch.Tensor]


# ===================================================================== #
# Mamba2 (SSD)
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        # the conv runs over x and the (single-group) B, C streams
        return self.d_inner + 2 * self.d_state


def _f32_leaf(values: torch.Tensor, device) -> torch.Tensor:
    """A float32 leaf computed on the CPU (shapes only on ``meta``)."""
    if torch.device(device).type == "meta":
        return torch.empty(values.shape, dtype=torch.float32, device="meta")
    return values.to(device)


def init_mamba2(generator: torch.Generator, cfg: Mamba2Config, dtype=torch.float32,
                device="cuda") -> Params:
    """``in_proj`` → [z (di), x (di), B (ds), C (ds), dt (H)]; ``dt_bias``,
    ``A_log`` and ``D`` are float32 whatever ``dtype``."""
    kw = dict(dtype=dtype, device=device)
    d, di, ds, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    lin_dt = torch.linspace(0.001, 0.1, H, dtype=torch.float32)
    return {
        "in_proj": nn.dense_init(generator, d, 2 * di + 2 * ds + H, **kw),
        "conv_w": nn.normal_init(generator, (cfg.d_conv, cfg.conv_dim), 0.1, dtype, device),
        "conv_b": torch.zeros((cfg.conv_dim,), **kw),
        "dt_bias": _f32_leaf(torch.log(torch.expm1(lin_dt)), device),
        "A_log": _f32_leaf(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)),
                           device),
        "D": _f32_leaf(torch.ones((H,), dtype=torch.float32), device),
        "norm": nn.rmsnorm_init(di, **kw),
        "out_proj": nn.dense_init(generator, di, d, **kw),
    }


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative sums: out[..., i, j] = Σ_{k=j+1..i} a_k."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=log_a.device))
    return torch.where(mask, out, -math.inf)


def _pad_time(a: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``a (B, S, ...)`` with ``pad`` steps of ``value`` after ``S``."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=value)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (``repro/models/ssm.py:86-156``): ``xh (B, S, H,
    P)``, ``dt (B, S, H)`` softplus'ed steps, ``A (H,)`` negative rates,
    ``Bm``/``Cm (B, S, N)``, ``h0 (B, H, P, N)`` → ``(y (B, S, H, P),
    final state (B, H, P, N))``."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = chunk
    ncnk = -(-S // Q)
    pad = ncnk * Q - S
    if pad:
        xh, dt, Bm, Cm = (_pad_time(a, pad) for a in (xh, dt, Bm, Cm))

    xc = xh.reshape(Bsz, ncnk, Q, H, P).float()
    dtc = dt.reshape(Bsz, ncnk, Q, H).float()
    Bc = Bm.reshape(Bsz, ncnk, Q, N).float()
    Cc = Cm.reshape(Bsz, ncnk, Q, N).float()

    dA = dtc * A[None, None, None, :]  # (B,n,Q,H): log decay per step
    dA_cum = torch.cumsum(dA, dim=2)  # within a chunk

    # ---- intra-chunk (quadratic) ----
    L = torch.exp(_segsum(dA.movedim(-1, 2)))  # (B,n,H,Q,Q)
    scores = torch.einsum("bnqm,bnpm->bnqp", Cc, Bc)  # (B,n,Q,Q): CB^T
    M = scores[:, :, None, :, :] * L  # (B,n,H,Q,Q)
    xdt = xc * dtc[..., None]  # (B,n,Q,H,P)
    y_diag = torch.einsum("bnhqp,bnphd->bnqhd", M, xdt)

    # ---- chunk states ----
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,n,Q,H)
    states = torch.einsum("bnqm,bnqh,bnqhd->bnhdm", Bc, decay_to_end * dtc, xc)

    # ---- the recurrence over chunks: the state before each ----
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (B,n,H)
    h = (h0.float() if h0 is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device))
    prevs = []
    for c in range(ncnk):
        prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)  # (B,n,H,P,N)

    # ---- off-diagonal contribution: C_t · decay · h_prev ----
    decay_from_start = torch.exp(dA_cum)  # (B,n,Q,H)
    y_off = torch.einsum("bnqm,bnqh,bnhdm->bnqhd", Cc, decay_from_start, h_prevs)

    y = (y_diag + y_off).reshape(Bsz, ncnk * Q, H, P)[:, :S]
    return y, h


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: Mamba2Config):
    di, ds = cfg.d_inner, cfg.d_state
    return torch.split(zxbcdt, [di, di, ds, ds, cfg.n_heads], dim=-1)


def mamba2_fwd(p: Params, cfg: Mamba2Config, x: torch.Tensor) -> torch.Tensor:
    """Training path: ``(B, S, d_model)`` → ``(B, S, d_model)``."""
    B, S, _ = x.shape
    di, ds, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xs, Bm, Cm, dt = _split_zxbcdt(nn.dense(p["in_proj"], x), cfg)

    # causal depthwise conv over (x, B, C): K shifted products, summed in
    # JAX's order
    xbc = torch.cat([xs, Bm, Cm], dim=-1)  # (B,S,conv_dim)
    w = p["conv_w"].to(xbc.dtype)  # (K, conv_dim)
    K = w.shape[0]
    xbc_pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xbc_pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K)) \
        + p["conv_b"].to(xbc.dtype)
    xs, Bm, Cm = torch.split(F.silu(conv), [di, ds, ds], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)
    xh = xs.reshape(B, S, H, P)
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = nn.rmsnorm(p["norm"], y * F.silu(z))
    return nn.dense(p["out_proj"], y)


def mamba2_init_state(cfg: Mamba2Config, batch: int, dtype=torch.float32,
                      device="cuda") -> State:
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p: Params, cfg: Mamba2Config, x: torch.Tensor, state: State
                  ) -> Tuple[torch.Tensor, State]:
    """One recurrent step: ``x (B, 1, d_model)``."""
    B = x.shape[0]
    di, ds, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xs, Bm, Cm, dt = _split_zxbcdt(nn.dense(p["in_proj"], x[:, 0]), cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)  # (B, conv_dim)
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B,K,cd)
    w = p["conv_w"].to(xbc.dtype)
    conv = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(xbc.dtype)
    xs, Bm, Cm = torch.split(F.silu(conv), [di, ds, ds], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])  # (B,H)
    xh = xs.reshape(B, H, P).float()
    dBx = torch.einsum("bn,bh,bhp->bhpn", Bm.float(), dt, xh)
    h = state["ssm"] * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = nn.rmsnorm(p["norm"], y * F.silu(z[:, None, :]))
    return nn.dense(p["out_proj"], y), {"ssm": h, "conv": hist[:, 1:, :]}


# ===================================================================== #
# mLSTM (xLSTM's matrix-memory cell, chunked gated linear attention)
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class MlstmConfig:
    d_model: int
    n_heads: int
    expand: int = 2
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def init_mlstm(generator: torch.Generator, cfg: MlstmConfig, dtype=torch.float32,
               device="cuda") -> Params:
    """The gates ``w_i`` and ``w_f`` are float32 (std 0.02) whatever ``dtype``."""
    kw = dict(dtype=dtype, device=device)
    gate = dict(dtype=torch.float32, device=device, std=0.02)
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "up_proj": nn.dense_init(generator, d, 2 * di, **kw),  # x and the gate z
        "wq": nn.dense_init(generator, di, di, **kw),
        "wk": nn.dense_init(generator, di, di, **kw),
        "wv": nn.dense_init(generator, di, di, **kw),
        "w_i": nn.dense_init(generator, di, H, **gate),  # input gate
        "w_f": nn.dense_init(generator, di, H, **gate),  # forget gate
        "norm": nn.rmsnorm_init(di, **kw),
        "down_proj": nn.dense_init(generator, di, d, **kw),
    }


def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_f: torch.Tensor, log_i: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked stabilized mLSTM (``repro/models/ssm.py:261-360``): ``q``,
    ``k``, ``v (B, S, H, D)`` float32, ``log_f`` (≤ 0) and ``log_i (B, S,
    H)`` → ``(B, S, H, D)``.  The exact chunkwise form of the sequential
    recurrence: the running max-stabilizer ``m`` is carried through the
    loop over chunks, and the ``max(|q·n|, 1)`` normalizer floor is
    applied in true scale, matching :func:`mlstm_decode`."""
    B, S, H, D = q.shape
    Q = chunk
    ncnk = -(-S // Q)
    pad = ncnk * Q - S
    if pad:
        q, k, v, log_f = (_pad_time(a, pad) for a in (q, k, v, log_f))
        log_i = _pad_time(log_i, pad, value=-1e9)

    qc = q.reshape(B, ncnk, Q, H, D)
    kc = k.reshape(B, ncnk, Q, H, D)
    vc = v.reshape(B, ncnk, Q, H, D)
    fc = log_f.reshape(B, ncnk, Q, H)
    ic = log_i.reshape(B, ncnk, Q, H)

    f_cum = torch.cumsum(fc, dim=2)  # within a chunk
    f_total = f_cum[:, :, -1, :]  # (B,n,H)

    # intra-chunk log-decay: dmat[q_, t] = f_cum[q_] - f_cum[t] + i[t]
    lf = f_cum.movedim(2, -1)  # (B,n,H,Q)
    li = ic.movedim(2, -1)
    dmat = lf[..., :, None] - lf[..., None, :] + li[..., None, :]  # (B,n,H,Q,Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri, dmat, -math.inf)
    m_intra = dmat.amax(dim=-1)  # (B,n,H,Q)

    # ---- chunk kv/n states with a per-chunk local stabilizer mc ----
    to_end = f_total[:, :, None, :] - f_cum + ic  # (B,n,Q,H)
    mc = to_end.amax(dim=2)  # (B,n,H)
    w_state = torch.exp(to_end - mc[:, :, None, :])
    kv_state = torch.einsum("bnqhd,bnqh,bnqhe->bnhde", kc, w_state, vc)
    n_state = torch.einsum("bnqhd,bnqh->bnhd", kc, w_state)

    # ---- the loop over chunks carrying (KVs, Ns, m): KV_true = KVs·exp(m) ----
    Ckv = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    Cn = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), -math.inf, dtype=torch.float32, device=q.device)
    kv_prev, n_prev, m_prev = [], [], []
    for c in range(ncnk):
        kv_prev.append(Ckv)  # the state *before* this chunk
        n_prev.append(Cn)
        m_prev.append(m)
        ftot = f_total[:, c]
        m_new = torch.maximum(m + ftot, mc[:, c])
        a = torch.exp(m + ftot - m_new)
        b = torch.exp(mc[:, c] - m_new)
        Ckv = Ckv * a[..., None, None] + kv_state[:, c] * b[..., None, None]
        Cn = Cn * a[..., None] + n_state[:, c] * b[..., None]
        m = m_new
    kv_prev = torch.stack(kv_prev, dim=1)  # (B,n,H,D,D)
    n_prev = torch.stack(n_prev, dim=1)  # (B,n,H,D)
    m_prev = torch.stack(m_prev, dim=1)  # (B,n,H)

    # ---- per-row stabilizer across intra + inter contributions ----
    m_state_row = lf + m_prev[..., None]  # (B,n,H,Q): f_cum[q] + m_prev
    m_row = torch.maximum(m_intra, m_state_row)
    m_row = torch.where(torch.isfinite(m_row), m_row, 0.0)
    wmat = torch.exp(dmat - m_row[..., None])  # (B,n,H,Q,Q)

    scores = torch.einsum("bnqhd,bnthd->bnhqt", qc, kc) / math.sqrt(D)
    w = scores * wmat
    y_intra = torch.einsum("bnhqt,bnthd->bnqhd", w, vc)
    norm_intra = w.sum(dim=-1).movedim(-1, 2)  # (B,n,Q,H)

    decay_q = torch.exp(m_state_row - m_row)  # (B,n,H,Q)
    y_inter = torch.einsum("bnqhd,bnhq,bnhde->bnqhe", qc, decay_q, kv_prev) / math.sqrt(D)
    norm_inter = torch.einsum("bnqhd,bnhq,bnhd->bnhq", qc, decay_q,
                              n_prev).movedim(-1, 2) / math.sqrt(D)  # (B,n,Q,H)

    num = y_intra + y_inter  # (B,n,Q,H,D)
    den = norm_intra + norm_inter  # (B,n,Q,H)
    # true-scale floor: max(|den·exp(m_row)|, 1) → max(|den|, exp(-m_row))
    floor = torch.exp(-m_row.movedim(-1, 2))
    den = torch.maximum(den.abs(), floor)
    y = num / den[..., None]
    return y.reshape(B, ncnk * Q, H, D)[:, :S]


def _mlstm_gates(p: Params, xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_i, log_f)``: the gates' pre-activation and log-sigmoid, float32."""
    xf = xi.float()
    return nn.dense(p["w_i"], xf), F.logsigmoid(nn.dense(p["w_f"], xf))


def mlstm_fwd(p: Params, cfg: MlstmConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    di, H, D = cfg.d_inner, cfg.n_heads, cfg.head_dim
    xi, z = torch.chunk(nn.dense(p["up_proj"], x), 2, dim=-1)
    q, k, v = (nn.dense(p[n], xi).reshape(B, S, H, D).float() for n in ("wq", "wk", "wv"))
    log_i, log_f = _mlstm_gates(p, xi)
    y = _mlstm_chunked(q, k, v, log_f, log_i, cfg.chunk)
    y = y.reshape(B, S, di).to(x.dtype)
    y = nn.rmsnorm(p["norm"], y) * F.silu(z)
    return nn.dense(p["down_proj"], y)


def mlstm_init_state(cfg: MlstmConfig, batch: int, device="cuda") -> State:
    H, D = cfg.n_heads, cfg.head_dim
    kw = dict(dtype=torch.float32, device=device)
    return {
        "kv": torch.zeros((batch, H, D, D), **kw),
        "n": torch.zeros((batch, H, D), **kw),
        "m": torch.full((batch, H), -1e9, **kw),
    }


def mlstm_decode(p: Params, cfg: MlstmConfig, x: torch.Tensor, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """Sequential stabilized mLSTM step (the exact xLSTM recurrence)."""
    B = x.shape[0]
    di, H, D = cfg.d_inner, cfg.n_heads, cfg.head_dim
    xi, z = torch.chunk(nn.dense(p["up_proj"], x[:, 0]), 2, dim=-1)
    q, k, v = (nn.dense(p[n], xi).reshape(B, H, D).float() for n in ("wq", "wk", "wv"))
    log_i, log_f = _mlstm_gates(p, xi)  # (B,H)

    m_new = torch.maximum(log_f + state["m"], log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    kv = state["kv"] * f_sc[..., None, None] + i_sc[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state["n"] * f_sc[..., None] + i_sc[..., None] * k
    qs = q / math.sqrt(D)
    num = torch.einsum("bhd,bhde->bhe", qs, kv)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
    y = nn.rmsnorm(p["norm"], y) * F.silu(z[:, None, :])
    return nn.dense(p["down_proj"], y), {"kv": kv, "n": n, "m": m_new}


# ===================================================================== #
# sLSTM (scalar-memory cell with exponential gating)
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class SlstmConfig:
    d_model: int
    n_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


_SLSTM_GATES = ("i", "f", "z", "o")


def init_slstm(generator: torch.Generator, cfg: SlstmConfig, dtype=torch.float32,
               device="cuda") -> Params:
    """Per gate: ``w_g (d, d)``, the block-diagonal recurrent mixing
    ``r_g (H, Dh, Dh)`` and a float32 bias ``b_g``."""
    kw = dict(dtype=dtype, device=device)
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    p: Params = {"norm": nn.rmsnorm_init(d, **kw)}
    for g in _SLSTM_GATES:
        p[f"w_{g}"] = nn.dense_init(generator, d, d, **kw)
        p[f"r_{g}"] = nn.normal_init(generator, (H, Dh, Dh), 1.0 / math.sqrt(d), dtype,
                                     device)
        p[f"b_{g}"] = torch.zeros((d,), dtype=torch.float32, device=device)
    p["out"] = nn.dense_init(generator, d, d, **kw)
    return p


def slstm_init_state(cfg: SlstmConfig, batch: int, device="cuda") -> State:
    kw = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), **kw), "n": torch.ones((batch, d), **kw),
            "h": torch.zeros((batch, d), **kw), "m": torch.zeros((batch, d), **kw)}


def _slstm_cell(p: Params, cfg: SlstmConfig, xt: torch.Tensor, state: State) -> State:
    """One sLSTM step; ``xt (B, d)`` float32."""
    B = xt.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    h_prev = state["h"].reshape(B, H, Dh)

    def pre(g):
        rec = torch.einsum("bhd,hde->bhe", h_prev, p[f"r_{g}"].float()).reshape(B, -1)
        return nn.dense(p[f"w_{g}"], xt) + rec + p[f"b_{g}"]

    zi, zf, zz, zo = (pre(g) for g in _SLSTM_GATES)
    m_new = torch.maximum(zf + state["m"], zi)
    i_sc = torch.exp(zi - m_new)
    f_sc = torch.exp(zf + state["m"] - m_new)
    c = f_sc * state["c"] + i_sc * torch.tanh(zz)
    n = f_sc * state["n"] + i_sc
    h = torch.sigmoid(zo) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_fwd(p: Params, cfg: SlstmConfig, x: torch.Tensor) -> torch.Tensor:
    """A loop over time (the sLSTM has no parallel form)."""
    B, S, _ = x.shape
    xf = x.float()
    state = slstm_init_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, cfg, xf[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,d)
    return nn.dense(p["out"], nn.rmsnorm(p["norm"], y))


def slstm_decode(p: Params, cfg: SlstmConfig, x: torch.Tensor, state: State
                 ) -> Tuple[torch.Tensor, State]:
    new_state = _slstm_cell(p, cfg, x[:, 0].float(), state)
    y = new_state["h"][:, None, :].to(x.dtype)
    return nn.dense(p["out"], nn.rmsnorm(p["norm"], y)), new_state
