"""Continuous-batching *decode* serve engine (the LLM stack; join-query
serving lives in repro_torch.serve.join_engine).

Fixed-width decode slots + host control plane: admit requests into free
slots (prefill writes their KV), decode all active slots in one batched
decode_step with per-slot cur_len, retire finished sequences and refill.
The batch never changes shape, only the slot occupancy does.

The engine runs on the device of its parameters, eagerly. It holds the
weights once at the dtype the forward reads them at
(transformer.compute_params), so a step does not cast the weights again.
Each decode step uploads the slots' tokens and lengths in one
non-blocking copy and reads one argmax per slot back; a prefill reads one
argmax back per prompt.

Prefill teacher-forces the prompt through batched decode steps over every
slot, as the reference engine does: each step also rewrites the other
slots' KV at their current position with their pending token, the same
write their next step makes. A recurrent mixer (mamba, rwkv) has no such
idempotent write: those steps advance the other slots' state, and a slot's
state is not reset when a new request takes it. The engine keeps this, so
its tokens are the reference engine's.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig, compute_params, decode_step, init_cache
from repro_torch.serve.paged_kv import PagedAllocator


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeServeEngine:
    """`on_emit(req, pos, logits)`, where given, is called for every token
    emitted, with the (vocab,) fp32 logits row it was taken from (left on
    the device) and the position of the token those logits follow."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int, max_len: int, greedy: bool = True,
                 on_emit=None):
        self.device = next(params.parameters()).device
        self.params = compute_params(params, cfg)
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        self.cur_len = np.zeros(slots, np.int32)
        self.active: list[Request | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.pages = PagedAllocator(num_pages=slots * (max_len // 16 + 1), page_size=16)
        self._next_tok = np.zeros((slots, 1), np.int32)
        self.greedy = greedy
        self.on_emit = on_emit
        self.steps = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @torch.inference_mode()
    def _decode(self) -> torch.Tensor:
        """One batched decode step over every slot at its pending token and
        length; returns the logits (slots, 1, vocab)."""
        host = torch.from_numpy(np.stack([self._next_tok[:, 0], self.cur_len]))
        if self.device.type == "cuda":
            # pinned and non-blocking: the copy does not stall the host
            up = host.pin_memory().to(self.device, non_blocking=True)
        else:
            up = host.clone()
        logits, self.cache = decode_step(self.params, self.cfg, up[0][:, None], self.cache, up[1])
        return logits

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self.pages.alloc(req.rid, len(req.prompt))
                self._prefill(s, req)

    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill by teacher-forcing the prompt through decode steps (simple
        and exact; a production path would use the full-sequence forward
        and scatter its KV)."""
        for tok in req.prompt:
            self._next_tok[slot, 0] = tok
            logits = self._decode()
            self.cur_len[slot] += 1
        nxt = int(torch.argmax(logits[slot, -1]))
        self._next_tok[slot, 0] = nxt
        req.out.append(nxt)
        if self.on_emit is not None:
            self.on_emit(req, int(self.cur_len[slot]) - 1, logits[slot, -1])

    def step(self) -> int:
        """One engine iteration: admit + one batched decode. Returns the
        number of active sequences plus the queue's length."""
        self._admit()
        if not any(self.active):
            return 0
        logits = self._decode()
        toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()
        self.steps += 1
        n_active = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.cur_len[s] += 1
            self.pages.alloc(req.rid, int(self.cur_len[s]) + 1)
            req.out.append(int(toks[s]))
            self._next_tok[s, 0] = toks[s]
            if self.on_emit is not None:
                self.on_emit(req, int(self.cur_len[s]) - 1, logits[s, -1])
            if len(req.out) >= req.max_new or self.cur_len[s] >= self.max_len - 1:
                req.done = True
                self.pages.release(req.rid)
                self.active[s] = None
                self.cur_len[s] = 0
            else:
                n_active += 1
        return n_active + len(self.queue)

    def run(self, max_steps: int = 10_000) -> None:
        while (self.queue or any(self.active)) and self.steps < max_steps:
            self.step()


# the reference's pre-rename public name, kept beside it
ServeEngine = DecodeServeEngine
