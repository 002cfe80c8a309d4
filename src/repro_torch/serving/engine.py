"""Serving engine: continuous batching over the tiered paged KV cache.

Counterpart of ``repro/serving/engine.py`` for the **batched** data
plane, for GQA attention archs with a dense or an MoE FFN.  Prefill
runs ``kernels.ops.flash_attention`` per layer over the prompt, and MoE
blocks route through ``kernels.ops.router_topk``.  All active sequences
decode in one step:

* top-k page selection: each sequence attends its last ``recent_pages``
  pages exactly plus the ``topk_pages`` older pages ranked by
  query·page-key-summary relevance (``topk_pages=None`` attends every
  page).  The selected pages are touched in the pool — that touch stream
  is what TPP consumes;
* per-step block tables of global frames, padded to power-of-two sizes,
  feed ``kernels.ops.paged_attention`` once per layer in position mode;
* the new token's K/V lands in the store by an in-place indexed write,
  page-key summaries accumulate in a device tensor, and migration
  payloads move in staged ``page_gather``/``page_scatter`` batches.

The policy (TPP) receives each step's slow- and fast-tier page hits and
migrates payloads through the cache's migration hook.

Not yet ported (each raises ``NotImplementedError``): the one-sequence
``data_plane="reference"`` plane, the multi-tenant QoS control plane
(``EngineConfig.qos``) and ``as_shard_pool`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import PageType, Tier, TppConfig, make_policy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.paged_attention import PAD_PAGE_POS
from repro_torch.models import nn
from repro_torch.models.attention import _rotate, make_cos_sin
from repro_torch.models.ffn import ffn_fwd
from repro_torch.models.model import ModelConfig, tree_map
from repro_torch.models.moe import moe_fwd
from repro_torch.serving.kv_cache import KVCacheConfig, TieredKVCache, bucket as _bucket


class AdmissionError(RuntimeError):
    """Raised when ``add_request`` refuses a request (``reason="max_seqs"``:
    the engine is at its sequence cap — finish one first)."""

    def __init__(self, message: str, reason: str = "max_seqs") -> None:
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    page_size: int = 16
    num_fast: int = 256
    num_slow: int = 1024
    topk_pages: Optional[int] = 4  # None → exact full attention
    recent_pages: int = 2  # always-attended tail (exact local context)
    policy: str = "tpp"
    tpp: TppConfig = dataclasses.field(default_factory=TppConfig)
    max_seqs: int = 8
    data_plane: str = "batched"  # the only plane ported so far
    qos: Optional[Any] = None  # multi-tenant QoS: not ported yet
    qos_class: str = "standard"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class _Seq:
    """Engine-side sequence state."""

    def __init__(self, rid: int, tenant: int = 0,
                 qos_class: str = "standard") -> None:
        self.rid = rid
        self.tenant = tenant
        self.qos_class = qos_class
        self.pages: List[int] = []  # pids, in order
        self.cur_len = 0
        self.paused = False
        # prefilled but not yet inserted into a decode lane
        self.detached = False


def _flat_layers(params: Any, cfg: ModelConfig) -> List[Any]:
    """Unstack the per-repeat params → one param dict per layer (views)."""
    out: List[Any] = []
    for sp, (pat, reps) in zip(params["stacks"], cfg.stacks):
        for r in range(reps):
            for pos in range(len(pat)):
                out.append(tree_map(lambda x: x[r], sp["blocks"][pos]))
    return out


class ServingEngine:
    """Batched tiered-KV serving for GQA attention architectures.

    ``params`` must already live on ``device``.  ``device`` defaults to
    ``"cuda"``; an engine asked for CUDA on a machine without it raises
    rather than running on the CPU.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        engine: EngineConfig,
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ServingEngine(device='cuda') but CUDA is not available; "
                    "pass device='cpu' to run the plain PyTorch path"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        for spec in cfg.all_specs():
            if spec.kind != "attn" or spec.attn.is_mla:
                raise ValueError(
                    "ServingEngine pages GQA attention archs; SSM/hybrid "
                    "archs serve from O(1) recurrent state, MLA via dense path"
                )
        if engine.data_plane != "batched":
            raise NotImplementedError(
                f"data_plane={engine.data_plane!r} is not ported yet: ROADMAP "
                "Queue 1 item 'reference data plane and eager copies'"
            )
        if engine.qos is not None:
            raise NotImplementedError(
                "EngineConfig.qos is not ported yet: ROADMAP Queue 1 item "
                "'QoS and TierSan'"
            )
        if engine.topk_pages is not None and engine.recent_pages < 1:
            raise ValueError(
                "batched data plane needs recent_pages >= 1 with top-k "
                "attention (the decode-tail page must be block-table "
                "addressable)"
            )
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(
                f"params live on {table.device}, the engine on {self.device}"
            )
        self.cfg = cfg
        self.ecfg = engine
        self.specs = cfg.all_specs()
        self.layers = _flat_layers(params, cfg)
        self.params = params
        a0 = self.specs[0].attn
        self.kv = TieredKVCache(
            KVCacheConfig(
                n_layers=cfg.n_layers,
                page_size=engine.page_size,
                n_kv_heads=a0.n_kv_heads,
                head_dim=a0.head_dim,
                num_fast=engine.num_fast,
                num_slow=engine.num_slow,
            ),
            tpp=engine.tpp,
            device=self.device,
        )
        self.policy = make_policy(engine.policy, self.kv.pool, seed=seed)
        self.seqs: Dict[int, _Seq] = {}
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.steps = 0
        # per-step per-sequence tier hit split {rid: (fast, slow)}
        self.last_hits: Dict[int, Tuple[int, int]] = {}
        # per-slot device summary state
        self._slot_of: Dict[int, int] = {}
        self._free_slots = list(range(engine.max_seqs - 1, -1, -1))
        self._mp_cap = 8
        L, Hkv, D = cfg.n_layers, a0.n_kv_heads, a0.head_dim
        # +1 trash slot: padded batch lanes accumulate there
        self._ksum = torch.zeros((engine.max_seqs + 1, self._mp_cap, L, Hkv, D),
                                 dtype=torch.float32, device=self.device)
        self._kcnt = torch.zeros((engine.max_seqs + 1, self._mp_cap),
                                 dtype=torch.float32, device=self.device)
        pa0 = self.layers[0]
        self._probe_params = (params["embed"], pa0["norm1"], pa0["attn"]["wq"])

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---------------------------------------------------------------- #
    # request lifecycle
    # ---------------------------------------------------------------- #
    def add_request(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        qos_class: Optional[str] = None,
        tenant: int = 0,
    ) -> int:
        """Admit a request and prefill its prompt into the tiered cache."""
        if len(self.seqs) >= self.ecfg.max_seqs:
            raise AdmissionError(
                f"engine at max_seqs={self.ecfg.max_seqs}; finish() a "
                "sequence before admitting another",
                reason="max_seqs",
            )
        cls = qos_class or self.ecfg.qos_class
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=list(prompt), max_new=max_new)
        self.requests[rid] = req
        self.seqs[rid] = _Seq(rid, tenant=tenant, qos_class=cls)
        self._slot_of[rid] = self._free_slots.pop()
        self._prefill(req)
        return rid

    def prefill_request(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        qos_class: Optional[str] = None,
        tenant: int = 0,
    ) -> int:
        """Admit + prefill a request *detached* from the decode batch;
        ``step()`` skips it until :meth:`insert_request`."""
        rid = self.add_request(
            prompt, max_new=max_new, qos_class=qos_class, tenant=tenant
        )
        self.seqs[rid].detached = True
        return rid

    def insert_request(self, rid: int) -> None:
        """Attach a prefilled (detached) sequence to the decode batch."""
        seq = self.seqs[rid]
        if not seq.detached:
            raise ValueError(
                f"request {rid} is already inserted into the decode batch"
            )
        seq.detached = False

    def free_lanes(self) -> int:
        """Decode lanes still unclaimed (``max_seqs`` minus live seqs)."""
        return self.ecfg.max_seqs - len(self.seqs)

    def pause(self, rid: int) -> None:
        """Session pause: pages become FILE (cold prefix bulk, §5.4)."""
        seq = self.seqs[rid]
        seq.paused = True
        for pid in seq.pages:
            self.kv.retype(pid, PageType.FILE)

    def resume(self, rid: int) -> None:
        seq = self.seqs[rid]
        seq.paused = False
        if seq.pages:
            # the still-being-written tail resumes as the hot decode page
            self.kv.retype(seq.pages[-1], PageType.ANON)

    def finish(self, rid: int) -> Request:
        """Release a sequence; returns its (now detached) Request."""
        seq = self.seqs.pop(rid)
        for pid in seq.pages:
            self.kv.free_page(pid)
        req = self.requests.pop(rid)
        slot = self._slot_of.pop(rid)
        self._ksum[slot] = 0.0
        self._kcnt[slot] = 0.0
        self._free_slots.append(slot)
        return req

    # ---------------------------------------------------------------- #
    # prefill
    # ---------------------------------------------------------------- #
    def _ensure_page(self, seq: _Seq) -> Tuple[int, int]:
        """Page + slot for the next token; allocates on boundary."""
        slot = seq.cur_len % self.ecfg.page_size
        if slot == 0:
            if seq.pages:
                # the sealed tail page becomes long-lived prefix bulk
                self.kv.retype(seq.pages[-1], PageType.FILE)
            seq.pages.append(
                self.kv.alloc_page(PageType.ANON, tenant=seq.tenant)
            )
        return seq.pages[-1], slot

    def _prefill_forward(self, req: Request) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the stack over ``prompt[:-1]`` → per-layer K and V of shape
        ``(L, S, Hkv, D)``.  The last prompt token is fed by the first
        decode step."""
        toks = torch.tensor(req.prompt[:-1], dtype=torch.int32,
                            device=self.device)[None, :]  # (1, S)
        S = toks.shape[1]
        x = nn.embed(self.params["embed"], toks)
        pos = torch.arange(S, dtype=torch.int32, device=self.device)[None, :]
        k_layers, v_layers = [], []
        for li, spec in enumerate(self.specs):
            pa = self.layers[li]
            a = spec.attn
            h = nn.rmsnorm(pa["norm1"], x)
            q = nn.dense(pa["attn"]["wq"], h).reshape(1, S, a.n_heads, a.head_dim)
            k = nn.dense(pa["attn"]["wk"], h).reshape(1, S, a.n_kv_heads, a.head_dim)
            v = nn.dense(pa["attn"]["wv"], h).reshape(1, S, a.n_kv_heads, a.head_dim)
            cos, sin = make_cos_sin(a, pos)
            if cos is not None:
                q = _rotate(a, q, cos, sin)
                k = _rotate(a, k, cos, sin)
            # (1, S, H, D) → (1, H, S, D) views: the kernel takes strides
            o = kernel_ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=a.window,
            )  # (1, H, S, D)
            x = x + nn.dense(pa["attn"]["wo"], o.transpose(1, 2).reshape(1, S, -1))
            if spec.has_ffn:
                x = x + self._ffn(pa, spec, x)
            k_layers.append(k[0])  # (S, Hkv, D)
            v_layers.append(v[0])
        return torch.stack(k_layers, dim=0), torch.stack(v_layers, dim=0)

    def _prefill(self, req: Request) -> None:
        seq = self.seqs[req.rid]
        if len(req.prompt) <= 1:
            return
        k_all, v_all = self._prefill_forward(req)  # (L, S, Hkv, D)
        self._prefill_write_batched(seq, k_all, v_all)

    def _prefill_write_batched(self, seq: _Seq, k_all: torch.Tensor,
                               v_all: torch.Tensor) -> None:
        """Land the whole prompt KV in one indexed write per store and seed
        the per-page key-summary tensors."""
        P = self.ecfg.page_size
        L, S = k_all.shape[0], k_all.shape[1]
        pids, slots = [], []
        for _ in range(S):
            pid, slot = self._ensure_page(seq)
            pids.append(pid)
            slots.append(slot)
            seq.cur_len += 1
        self.kv.write_tokens(pids, slots, k_all.movedim(1, 0), v_all.movedim(1, 0))
        npages = len(seq.pages)
        self._grow_summaries(npages)
        pad = npages * P - S
        kp = F.pad(k_all.float(), (0, 0, 0, 0, 0, pad))
        sums = kp.reshape(L, npages, P, kp.shape[2], kp.shape[3]).sum(dim=2)
        counts = np.full(npages, P, np.float32)
        counts[-1] = P - pad
        slot_id = self._slot_of[seq.rid]
        self._ksum[slot_id, :npages] = sums.movedim(0, 1)  # (npages, L, Hkv, D)
        self._kcnt[slot_id, :npages] = self._to_device(counts)

    def _grow_summaries(self, needed: int) -> None:
        if needed <= self._mp_cap:
            return
        new_cap = _bucket(needed)
        pad = new_cap - self._mp_cap
        self._ksum = F.pad(self._ksum, (0, 0, 0, 0, 0, 0, 0, pad))
        self._kcnt = F.pad(self._kcnt, (0, pad))
        self._mp_cap = new_cap

    # ---------------------------------------------------------------- #
    # page selection (the access skew)
    # ---------------------------------------------------------------- #
    def _select_pages(self, seq: _Seq, older_scores: np.ndarray) -> List[int]:
        """Recent tail pages (exact) + top-k older pages by relevance."""
        n = len(seq.pages)
        recent = seq.pages[max(0, n - self.ecfg.recent_pages):]
        if self.ecfg.topk_pages is None:
            return list(seq.pages)
        older = seq.pages[: max(0, n - self.ecfg.recent_pages)]
        if not older or self.ecfg.topk_pages == 0:
            return recent
        order = np.argsort(older_scores)[::-1][: self.ecfg.topk_pages]
        return [older[i] for i in sorted(order)] + recent

    # ---------------------------------------------------------------- #
    # decode
    # ---------------------------------------------------------------- #
    def step(self) -> Dict[int, int]:
        """One decode step for all active sequences → {rid: token}."""
        active = [s for s in self.seqs.values()
                  if not s.paused and not s.detached
                  and not self.requests[s.rid].done]
        self.last_hits = {}
        out, slow_hits, fast_hits = self._decode_batched(active)
        for rid, tok in out.items():
            req = self.requests[rid]
            req.out.append(tok)
            if len(req.out) >= req.max_new:
                req.done = True
        self.policy.step(slow_hits, fast_hits)
        self.steps += 1
        if self.steps % 4 == 0:
            self.kv.pool.end_interval()
        return out

    def _decode_batched(
        self, active: List[_Seq]
    ) -> Tuple[Dict[int, int], List[int], List[int]]:
        """One decode step for all active sequences."""
        if not active:
            return {}, [], []
        self.kv.flush_migrations()
        ecfg = self.ecfg
        P = ecfg.page_size
        B = len(active)
        toks = np.zeros(B, np.int32)
        for b, seq in enumerate(active):
            req = self.requests[seq.rid]
            toks[b] = req.out[-1] if req.out else req.prompt[-1]

        # top-k relevance scores from the device summary tensors (one
        # small transfer per step)
        scores = None
        if (ecfg.topk_pages not in (None, 0)
                and any(len(s.pages) > ecfg.recent_pages for s in active)):
            slot_ids = np.asarray([self._slot_of[s.rid] for s in active], np.int32)
            scores = self._score_impl(
                self._probe_params, self._ksum, self._kcnt,
                self._to_device(toks), self._to_device(slot_ids),
            ).cpu().numpy()

        # selection + touch/tier accounting, in sequence order
        sels: List[List[int]] = []
        s_hits: List[int] = []
        f_hits: List[int] = []
        for b, seq in enumerate(active):
            n_older = max(0, len(seq.pages) - ecfg.recent_pages)
            older_scores = (scores[b, :n_older] if scores is not None
                            else np.zeros(n_older, np.float32))
            sel = self._select_pages(seq, older_scores)
            sels.append(sel)
            nf = ns = 0
            for pid in sel:
                tier = self.kv.pool.touch(pid)
                if tier == Tier.SLOW:
                    s_hits.append(pid)
                    ns += 1
                else:
                    f_hits.append(pid)
                    nf += 1
            self.last_hits[seq.rid] = (nf, ns)

        # allocate every sequence's write target (page-boundary allocs)
        writes = [self._ensure_page(seq) for seq in active]
        self._grow_summaries(max(len(s.pages) for s in active))

        # per-step block tables: selected pages (+ the write page when a
        # boundary alloc created it after selection), padded to buckets
        entries = []
        for b, seq in enumerate(active):
            ent = list(sels[b])
            if writes[b][0] not in ent:
                ent.append(writes[b][0])
            entries.append(ent)
        Bp = _bucket(B)
        MPp = _bucket(max(len(e) for e in entries))
        trash = self.kv.trash_frame
        bt = np.full((Bp, MPp), trash, np.int32)
        ps = np.full((Bp, MPp), PAD_PAGE_POS, np.int32)
        # per-lane vectors: toks, q_pos, wframe, wslot, slot, gi
        lanes = np.zeros((6, Bp), np.int32)
        lanes[2] = trash
        lanes[4] = ecfg.max_seqs
        for b, seq in enumerate(active):
            page_index = {pid: i for i, pid in enumerate(seq.pages)}
            for j, pid in enumerate(entries[b]):
                bt[b, j] = self.kv.global_frame(pid)
                ps[b, j] = page_index[pid] * P
            lanes[:, b] = (toks[b], seq.cur_len,
                           self.kv.global_frame(writes[b][0]), writes[b][1],
                           self._slot_of[seq.rid], len(seq.pages) - 1)

        # one host→device copy for all of the step's index data
        flat = self._to_device(np.concatenate([lanes.ravel(), bt.ravel(), ps.ravel()]))
        lane_t = flat[: 6 * Bp].view(6, Bp)
        bt_t = flat[6 * Bp: 6 * Bp + Bp * MPp].view(Bp, MPp)
        ps_t = flat[6 * Bp + Bp * MPp:].view(Bp, MPp)
        out_toks = self._batched_step_impl(
            lane_t[0], lane_t[1], bt_t, ps_t,
            lane_t[2], lane_t[3], lane_t[4], lane_t[5],
        ).cpu().numpy()
        out: Dict[int, int] = {}
        for b, seq in enumerate(active):
            seq.cur_len += 1
            out[seq.rid] = int(out_toks[b])
        return out, s_hits, f_hits

    def _batched_step_impl(self, toks, q_pos, block_table, page_start,
                           wframe, wslot, slot_ids, gi) -> torch.Tensor:
        """The batched decode step: token K/V lands by an in-place indexed
        write, attention runs through ``kernels.ops.paged_attention`` per
        layer; the stores and summary tensors are updated in place.
        Returns the greedy next token of every lane."""
        params, k_store, v_store = self.params, self.kv.k_store, self.kv.v_store
        B = toks.shape[0]
        x = nn.embed(params["embed"], toks[:, None])  # (B, 1, d)
        pos = q_pos[:, None]
        wf, ws = wframe.long(), wslot.long()
        k_layers = []
        for li, spec in enumerate(self.specs):
            pa = self.layers[li]
            a = spec.attn
            h = nn.rmsnorm(pa["norm1"], x)
            q = nn.dense(pa["attn"]["wq"], h).reshape(B, 1, a.n_heads, a.head_dim)
            k = nn.dense(pa["attn"]["wk"], h).reshape(B, 1, a.n_kv_heads, a.head_dim)
            v = nn.dense(pa["attn"]["wv"], h).reshape(B, 1, a.n_kv_heads, a.head_dim)
            cos, sin = make_cos_sin(a, pos)
            if cos is not None:
                q = _rotate(a, q, cos, sin)
                k = _rotate(a, k, cos, sin)
            k_t, v_t = k[:, 0], v[:, 0]  # (B, Hkv, D)
            # land the step's token KV; padded lanes all write the same
            # trash frame and slot with identical payloads
            k_store[wf, li, :, ws, :] = k_t.to(k_store.dtype)
            v_store[wf, li, :, ws, :] = v_t.to(v_store.dtype)
            o = kernel_ops.paged_attention(
                q[:, 0], k_store[:, li], v_store[:, li], block_table,
                page_pos=page_start, q_pos=q_pos, window=a.window,
            )  # (B, H, D)
            x = x + nn.dense(pa["attn"]["wo"], o.reshape(B, 1, -1).to(x.dtype))
            if spec.has_ffn:
                # padded lanes go through the MoE too, as in the JAX
                # engine: they count towards each expert's capacity
                x = x + self._ffn(pa, spec, x)
            k_layers.append(k_t)
        h = nn.rmsnorm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            logits = h @ params["embed"]["table"].T.to(h.dtype)
        else:
            logits = nn.dense(params["lm_head"], h)
        toks_out = logits[:, -1].argmax(dim=-1).to(torch.int32)
        # incremental page-key summaries; padded lanes share the trash
        # slot, so the sum must accumulate duplicates
        k_all = torch.stack(k_layers, dim=1).float()  # (B, L, Hkv, D)
        idx = (slot_ids.long(), gi.long())
        self._ksum.index_put_(idx, k_all, accumulate=True)
        self._kcnt.index_put_(idx, torch.ones(B, device=self.device), accumulate=True)
        return toks_out

    @staticmethod
    def _ffn(pa: Any, spec: Any, x: torch.Tensor) -> torch.Tensor:
        """The block's FFN on ``norm2(x)``: MoE (``router_topk``) or dense."""
        h = nn.rmsnorm(pa["norm2"], x)
        if spec.moe is not None:
            return moe_fwd(pa["moe"], spec.moe, h)[0]
        return ffn_fwd(pa["ffn"], h, spec.ffn_kind)

    def _score_impl(self, probe_params, ksum, kcnt, toks, slot_ids) -> torch.Tensor:
        """Query·page-key-summary relevance for every (seq, page)."""
        embed_p, norm1_p, wq_p = probe_params
        a0 = self.specs[0].attn
        B = toks.shape[0]
        x = nn.embed(embed_p, toks[:, None])
        qp = nn.dense(wq_p, nn.rmsnorm(norm1_p, x))
        qm = qp.reshape(B, a0.n_kv_heads, -1, a0.head_dim).mean(dim=2)
        sid = slot_ids.long()
        means = ksum[sid] / kcnt[sid].clamp_min(1.0)[:, :, None, None, None]
        return torch.einsum("bhd,bmlhd->bm", qm.float(), means)

    # ---------------------------------------------------------------- #
    def as_shard_pool(self, *args, **kwargs):
        raise NotImplementedError(
            "as_shard_pool is not ported yet: ROADMAP Queue 1 item "
            "'traffic, expert tiering, fleet and training'"
        )

    def stats(self) -> Dict[str, Any]:
        vs = self.kv.pool.vmstat
        return {
            "steps": self.steps,
            "local_fraction": vs.local_access_fraction,
            "demoted": vs.pgdemote_total,
            "promoted": vs.pgpromote_total,
            "migrated_bytes": self.kv.migrated_bytes,
            "fast_free": self.kv.pool.free_frames(Tier.FAST),
            "slow_used": self.kv.pool.used_frames(Tier.SLOW),
        }
