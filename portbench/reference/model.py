"""Plain PyTorch reference of a served model under top-k page attention.

It follows the published block of the configuration (RMSNorm, GQA with
RoPE, a SwiGLU FFN or a softmax top-k MoE of SwiGLU experts, no
capacity, an untied LM head) and the serving engine's attention rule:
a prompt is prefilled with exact causal attention; each decode step at
position ``p`` attends its ``recent`` newest pages exactly, the ``topk``
older pages whose key means score highest against the layer-0 probe
query (the token's embedding through the first norm and ``wq``, averaged
over each KV head's query heads), and itself.  The reference works the
selection out from its own keys.  Float32, TF32 off, no kernels, no
cache beyond its own dense one; it imports nothing of the program.

:func:`judge` teacher-forces every request over its prompt and served
tokens, all requests in lockstep, and reads at each served token the gap
by which the token's logit lies below the reference's best.  A MoE route
or a top-k page choice that is a tie within float32 rounding (the
boundary gap at most ``AMBIGUOUS`` of the largest magnitude) has two
correct answers, and every later position of the request reads keys and
values that follow from the choice.  A prompt with at most
``MAX_FOLLOWED`` tied routes is judged on every way of resolving them,
one branch each (the branch that reads the narrowest widest gap is the
program's); a prompt with more is set aside.  In decode a request is
judged up to its first tie, and the tokens after it are set aside.
"""

from __future__ import annotations

import math
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: a boundary gap (k-th minus (k+1)-th page score or router logit) at or
#: below this share of the largest magnitude is a tie at float32 rounding:
#: ten times the ~1e-6 by which two float32 evaluations of the same sums
#: differ (a prompt's route tied at 4.3e-7 split one request on an H100)
AMBIGUOUS = 1e-5

#: a prompt with at most this many tied routes is judged on each of the
#: 2**n ways of resolving them (a row of keys and values each, so a
#: chat sample of 16 holds at most 64 rows); one with more is set aside
MAX_FOLLOWED = 2


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate ``x (..., T, heads, D)`` at positions ``pos (..., T)``: pairs
    ``(x_i, x_{i+D/2})`` by ``pos * base^(-2i/D)``."""
    half = x.shape[-1] // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[..., None] * inv
    c, s = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


class Model:
    """The weights (``embed``, ``final_norm``, ``lm_head`` and a dict a
    layer) and the numbers of the configuration file."""

    def __init__(self, config: Dict[str, Any], w: Dict[str, Any]) -> None:
        self.w = w
        self.L = config["num_hidden_layers"]
        self.d = config["hidden_size"]
        self.H = config["num_attention_heads"]
        self.Hkv = config["num_key_value_heads"]
        self.D = config["head_dim"]
        self.G = self.H // self.Hkv
        self.eps = config["rms_norm_eps"]
        self.base = config["rope_theta"]
        self.k = config.get("num_experts_per_tok", 0)

    # ------------------------------------------------------------ FFN --
    def ffn(self, lay: Dict[str, torch.Tensor], h: torch.Tensor, dense_experts: bool,
            flip: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """FFN of ``h (T, d)`` → ``(y, margin (T,))``: the route's boundary
        gap (k-th minus (k+1)-th router logit) over the largest |logit|;
        infinite for a dense FFN.  Rows where ``flip (T,)`` is set take the
        (k+1)-th expert in place of the k-th: a tied route's other way."""
        if "router" not in lay:
            g = torch.nn.functional.silu(h @ lay["f_gate"]) * (h @ lay["f_up"])
            return g @ lay["f_down"], torch.full((h.shape[0],), float("inf"), device=h.device)
        logits = h @ lay["router"]
        probs = torch.softmax(logits, dim=-1)
        vals, idx = probs.topk(self.k + 1, dim=-1)
        if flip is not None:
            vals[flip, self.k - 1] = vals[flip, self.k]
            idx[flip, self.k - 1] = idx[flip, self.k]
        vals, idx = vals[:, :self.k], idx[:, :self.k]
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        srt = logits.sort(dim=-1, descending=True).values
        amb = (srt[:, self.k - 1] - srt[:, self.k]) / logits.abs().amax(dim=-1)
        if dense_experts:  # every expert on every row: a few rows a step
            a = torch.nn.functional.silu(torch.einsum("td,edf->tef", h, lay["e_gate"])) \
                * torch.einsum("td,edf->tef", h, lay["e_up"])
            ye = torch.einsum("tef,efd->ted", a, lay["e_down"])
            y = (ye.gather(1, idx[:, :, None].expand(-1, -1, self.d)) * vals[:, :, None]).sum(1)
            return y, amb
        y = torch.zeros_like(h)
        for e in range(lay["e_gate"].shape[0]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                xe = h[rows]
                a = torch.nn.functional.silu(xe @ lay["e_gate"][e]) * (xe @ lay["e_up"][e])
                y.index_add_(0, rows, (a @ lay["e_down"][e]) * vals[rows, slot][:, None])
        return y, amb

    # -------------------------------------------------------- prefill --
    def prefill(self, toks: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                forced: Optional[Dict[Tuple[int, int], bool]] = None) -> List[Tuple[int, int]]:
        """Exact causal attention over ``toks (T,)``; writes each layer's
        keys (after RoPE) and values into ``kc``/``vc (L, >=T, Hkv, D)``.
        ``forced`` maps a route's ``(layer, token)`` to whether it takes its
        other way.  Returns the routes, other than those, that tie."""
        T = toks.shape[0]
        forced = forced or {}
        ties: List[Tuple[int, int]] = []
        if T == 0:
            return ties
        w, dev = self.w, toks.device
        x = w["embed"][toks].float()
        pos = torch.arange(T, device=dev)
        for li, lay in enumerate(w["layers"]):
            h = rmsnorm(x, lay["norm1"], self.eps)
            q = rope((h @ lay["wq"]).view(T, self.H, self.D), pos, self.base)
            k = rope((h @ lay["wk"]).view(T, self.Hkv, self.D), pos, self.base)
            v = (h @ lay["wv"]).view(T, self.Hkv, self.D)
            kc[li, :T], vc[li, :T] = k, v
            o = torch.empty((T, self.H, self.D), device=dev)
            for s0 in range(0, T, 512):  # query blocks keep the scores small
                s1 = min(T, s0 + 512)
                qb = q[s0:s1].view(s1 - s0, self.Hkv, self.G, self.D) / math.sqrt(self.D)
                sc = torch.einsum("qhgd,thd->hgqt", qb, k[:s1])
                mask = torch.arange(s1, device=dev)[None, :] <= torch.arange(s0, s1, device=dev)[:, None]
                sc = sc.masked_fill(~mask, float("-inf"))
                o[s0:s1] = torch.einsum("hgqt,thd->qhgd", torch.softmax(sc, dim=-1),
                                        v[:s1]).reshape(s1 - s0, self.H, self.D)
            x = x + o.reshape(T, -1) @ lay["wo"]
            flip = torch.zeros(T, dtype=torch.bool, device=dev)
            flip[[t for (l, t), f in forced.items() if l == li and f]] = True
            y, mg = self.ffn(lay, rmsnorm(x, lay["norm2"], self.eps), dense_experts=False,
                             flip=flip)
            ties += [(li, t) for t in (mg <= AMBIGUOUS).nonzero()[:, 0].tolist()
                     if (li, t) not in forced]
            x = x + y
        return ties


def _prefill_branches(m: Model, toks: torch.Tensor, Tmax: int, device):
    """The prompt's keys and values, one ``(kc, vc, tied)`` a branch: one
    branch where no route ties; one for each way of resolving ``n <=
    MAX_FOLLOWED`` tied routes (``tied`` where that way ties a further
    route); a single tied branch where more tie."""
    def run(forced):
        kc = torch.zeros((m.L, Tmax, m.Hkv, m.D), device=device)
        vc = torch.zeros_like(kc)
        return kc, vc, m.prefill(toks, kc, vc, forced)

    kc, vc, ties = run(None)
    if not ties:
        return [(kc, vc, False)]
    if len(ties) > MAX_FOLLOWED:
        return [(kc, vc, True)]
    out = [(kc, vc, False)]
    for ways in itertools.product((False, True), repeat=len(ties)):
        if any(ways):
            kc, vc, more = run(dict(zip(ties, ways)))
            out.append((kc, vc, bool(more)))
    return out


def judge(model: Model, requests: Sequence[Tuple[Sequence[int], Sequence[int]]],
          page_size: int, topk: int, recent: int, device) -> Dict[str, Any]:
    """Teacher-force ``(prompt, served)`` pairs and read, at every served
    token, ``max(logits) - logits[served]`` from the reference, on each
    branch of the prompt (:func:`_prefill_branches`); a request is judged
    on its branch of the narrowest widest gap.  Returns the widest gap
    over judged tokens, the count judged, the counts set aside as ties of
    the page choice or the route, and the judged requests' prompt lengths."""
    P, m = page_size, model
    N_req = [len(s) for _, s in requests]
    Tmax = max(len(p) - 1 + n for (p, _), n in zip(requests, N_req)) + 1
    M = -(-Tmax // P)
    # one row a branch of each request's prompt
    req, kcs, vcs, prompt_tied = [], [], [], []
    followed = 0
    for r, (p, s) in enumerate(requests):
        seq = torch.tensor(list(p) + list(s), dtype=torch.long, device=device)
        branches = _prefill_branches(m, seq[:len(p) - 1], Tmax, device)
        followed += len(branches) > 1
        for kc_b, vc_b, tied in branches:
            req.append(r)
            kcs.append(kc_b)
            vcs.append(vc_b)
            prompt_tied.append(tied)
    kc, vc = torch.stack(kcs), torch.stack(vcs)
    del kcs, vcs
    R = len(req)
    S = [len(requests[r][0]) for r in req]
    N = [N_req[r] for r in req]
    toks = torch.zeros((R, Tmax + 1), dtype=torch.long)
    for i, r in enumerate(req):
        seq = list(requests[r][0]) + list(requests[r][1])
        toks[i, :len(seq)] = torch.tensor(seq, dtype=torch.long)
    toks = toks.to(device)
    ksum = torch.zeros((R, M, m.L, m.Hkv, m.D), device=device)
    kcnt = torch.zeros((R, M), device=device)
    for i in range(R):
        T = S[i] - 1
        if T:
            n = -(-T // P)
            kp = torch.nn.functional.pad(kc[i, :, :T], (0, 0, 0, 0, 0, n * P - T))
            ksum[i, :n] = kp.view(m.L, n, P, m.Hkv, m.D).sum(dim=2).movedim(0, 1)
            kcnt[i, :n] = torch.clamp(T - torch.arange(n, device=device) * P, max=P).float()

    ar = torch.arange(R, device=device)
    S_t = torch.tensor(S, device=device)
    N_t = torch.tensor(N, device=device)
    w = model.w
    lay0 = w["layers"][0]
    A_old = topk * P
    offs = torch.arange(P, device=device)
    span = torch.arange(recent * P + 1, device=device)
    rows = []  # per step: (gap, page margin, route margin, active), each (R,)
    for j in range(max(N)):
        active = N_t > j
        p = torch.clamp(S_t - 1 + j, max=Tmax - 1)
        tok = toks[ar, p]
        target = toks[ar, p + 1]
        # top-k page selection from the reference's own key means
        n_pg = (p + P - 1) // P
        older = torch.clamp(n_pg - recent, min=0)
        x0 = w["embed"][tok].float()
        qm = (rmsnorm(x0, lay0["norm1"], m.eps) @ lay0["wq"]).view(R, m.Hkv, m.G, m.D).mean(2)
        means = ksum / kcnt.clamp_min(1.0)[:, :, None, None, None]
        scores = torch.einsum("rhd,rmlhd->rm", qm, means)
        page = torch.arange(M, device=device)[None, :]
        scores = scores.masked_fill(page >= older[:, None], float("-inf"))
        kk = min(topk + 1, M)
        top_v, top_i = scores.topk(kk, dim=1)
        sel_ok = top_v[:, :topk] > float("-inf")
        sel_margin = torch.full((R,), float("inf"), device=device)
        if kk > topk:
            finite = torch.where(scores > float("-inf"), scores.abs(), torch.zeros_like(scores))
            sel_margin = torch.where(
                older > topk, (top_v[:, topk - 1] - top_v[:, topk]) / finite.amax(dim=1),
                sel_margin)
        old_pos = (top_i[:, :topk, None] * P + offs).reshape(R, A_old)
        old_ok = sel_ok[:, :, None].expand(-1, -1, P).reshape(R, A_old)
        new_pos = older[:, None] * P + span
        new_ok = new_pos <= p[:, None]
        pos_idx = torch.clamp(torch.cat([old_pos, new_pos], dim=1), max=Tmax - 1)
        ok = torch.cat([old_ok, new_ok], dim=1)

        x = x0
        route_margin = torch.full((R,), float("inf"), device=device)
        for li, lay in enumerate(w["layers"]):
            h = rmsnorm(x, lay["norm1"], m.eps)
            q = rope((h @ lay["wq"]).view(R, 1, m.H, m.D), p[:, None], m.base)[:, 0]
            k = rope((h @ lay["wk"]).view(R, 1, m.Hkv, m.D), p[:, None], m.base)[:, 0]
            v = (h @ lay["wv"]).view(R, m.Hkv, m.D)
            kc[ar, li, p] = k
            vc[ar, li, p] = v
            kg = kc[ar[:, None], li, pos_idx]  # (R, A, Hkv, D)
            vg = vc[ar[:, None], li, pos_idx]
            qg = q.view(R, m.Hkv, m.G, m.D) / math.sqrt(m.D)
            sc = torch.einsum("rhgd,rahd->rhga", qg, kg)
            sc = sc.masked_fill(~ok[:, None, None, :], float("-inf"))
            o = torch.einsum("rhga,rahd->rhgd", torch.softmax(sc, dim=-1), vg)
            x = x + o.reshape(R, -1) @ lay["wo"]
            y, mg = m.ffn(lay, rmsnorm(x, lay["norm2"], m.eps), dense_experts=True)
            route_margin = torch.minimum(route_margin, mg)
            x = x + y
        logits = rmsnorm(x, w["final_norm"], m.eps) @ w["lm_head"]
        gap = logits.amax(dim=1) - logits.gather(1, target[:, None])[:, 0]
        rows.append(torch.stack([gap, sel_margin, route_margin, active.float()]))
        # the step's keys join their page's mean
        pg = p // P
        ksum[ar, pg] += kc[ar, :, p] * active[:, None, None, None].float()
        kcnt[ar, pg] += active.float()
    g, sm, rm, act = torch.stack(rows).cpu().unbind(1)  # each (steps, R)
    act = act > 0
    tie = act & ((sm <= AMBIGUOUS) | (rm <= AMBIGUOUS))
    in_prompt = torch.tensor(prompt_tied)
    in_decode = tie.any(dim=0) & ~in_prompt
    tie[0] |= in_prompt
    # a branch is judged up to its first tie
    use = act & (torch.cumsum(tie.int(), dim=0) == 0)
    gu = torch.where(use, g, torch.zeros_like(g))
    # each request by its branch of the narrowest widest gap, of those judged
    keep = torch.zeros(R, dtype=torch.bool)
    for r in range(len(requests)):
        mine = [i for i in range(R) if req[i] == r and use[:, i].any()]
        if mine:
            keep[min(mine, key=lambda i: (float(gu[:, i].max()), i))] = True
    use &= keep
    gu = torch.where(use, g, torch.zeros_like(g))
    judged = [len(requests[req[i]][0]) for i in range(R) if keep[i]]
    out = {"widest_gap": float(gu.max()), "judged_tokens": int(use.sum()),
           "set_aside_tokens": sum(N_req) - int(use.sum()),
           "tied_in_prompt": len({req[i] for i in range(R) if in_prompt[i]}),
           "prompt_ties_followed": followed,
           "tied_in_decode": len({req[i] for i in range(R) if keep[i] and in_decode[i]}),
           "judged_prompt_lens": sorted(judged),
           "requests": len(requests), "served_tokens": sum(N_req)}
    # where the widest gaps lie: request, served index, the margins there
    # and the narrowest margins of the branch before it
    worst = []
    for flat in gu.flatten().argsort(descending=True)[:3].tolist():
        j, i = divmod(flat, R)
        if gu[j, i] <= 0:
            break
        worst.append({"request": req[i], "served": j, "gap": float(gu[j, i]),
                      "page_margin": float(sm[j, i]), "route_margin": float(rm[j, i]),
                      "margin_before": float(torch.minimum(sm[:j, i], rm[:j, i]).min()) if j else None})
    out["worst"] = worst
    return out
