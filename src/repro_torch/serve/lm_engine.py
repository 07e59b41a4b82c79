"""Batched LM serving engine: prefill per admitted request, then one decode
step at a time over a fixed pool of slots — the port of
``repro/serve/lm_engine.py``.

The engine owns a cache of ``max_batch`` slots × ``max_len`` positions.
Requests wait in a queue; each free slot takes one with a batch-1 prefill,
whose caches are copied into the slot in place.  Every ``step()`` decodes
one token for all slots at their own positions (greedy argmax, one host
read per step); a request finishes on its token budget, on EOS or at
``max_len - 1`` and frees its slot.  Slots without a request decode too
(their output is ignored, as in the reference); a freed slot's cache length
is set back to 0 so that its writes stay inside the cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.attention import KVCache


def _leaves(cache) -> list[torch.Tensor]:
    """A block's cache as its tensors: a ``KVCache``'s k, v and length, a
    state tensor, the members of a state tuple; none for ``None``."""
    if cache is None:
        return []
    if isinstance(cache, KVCache):
        return [cache.k, cache.v, cache.length]
    if isinstance(cache, tuple):
        return list(cache)
    return [cache]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) integer
    max_new_tokens: int = 32
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: dict, cfg: ModelConfig, *, max_batch: int = 4,
                 max_len: int = 128, eos_id: int | None = None):
        self.model = model
        self.cfg = cfg
        self.device = model["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.caches = lm.init_caches(cfg, max_batch, max_len, self.device)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)     # next write position
        self.slot_budget = np.zeros(max_batch, np.int32)  # remaining new tokens
        self.last_token = np.zeros((max_batch, 1), np.int32)
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    # -- queue management ----------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            cache1 = lm.init_caches(self.cfg, 1, self.max_len, self.device)
            prompt = torch.as_tensor(np.asarray(req.prompt)[None, :], device=self.device)
            logits, cache1 = lm.prefill(self.model, self.cfg, prompt, cache1)
            first = int(torch.argmax(logits[0, -1]))
            req.generated.append(first)
            # copy the request's prefill state into the pool at ``slot``:
            # every cache leaf (K/V and lengths, an SSM state, each member
            # of an sLSTM's (c, n, m)) has the batch at dim 0
            for pool, one in zip(self.caches, cache1):
                for dst, src in zip(_leaves(pool), _leaves(one)):
                    dst[slot:slot + 1].copy_(src)
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.last_token[slot, 0] = first

    def _free(self, slot: int) -> None:
        self.slot_req[slot] = None
        for pool in self.caches:
            if isinstance(pool, KVCache):
                pool.length[slot] = 0

    # -- decode --------------------------------------------------------------

    def step(self) -> int:
        """Admit waiting requests, decode one token for all active slots.

        Returns the number of active slots stepped.
        """
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        token = torch.as_tensor(self.last_token, device=self.device)
        logits, self.caches = lm.decode_step(self.model, self.cfg, token, self.caches,
                                             self.slot_pos.copy())
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt[i])
            req.generated.append(tok)
            self.slot_pos[i] += 1
            self.last_token[i, 0] = tok
            self.slot_budget[i] -= 1
            if self.slot_budget[i] <= 0 or (self.eos_id is not None and tok == self.eos_id) \
               or self.slot_pos[i] >= self.max_len - 1:
                req.done = True
                self.finished.append(req)
                self._free(i)
        return len(active)

    def run(self, max_steps: int = 1000) -> list[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            if self.step() == 0 and not self.queue:
                break
            steps += 1
        return self.finished
