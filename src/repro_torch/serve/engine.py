"""LM serving: slot-based continuous batching.

The port of ``Request`` and ``ServeEngine`` from ``repro/serve/engine.py``
with the slot logic unchanged: a fixed pool of B slots shares one decode
step; a request claims a free slot, is prefilled alone (one
``transformer.prefill``, which runs the flash attention kernel on the
card) into that slot's cache region, then joins the shared per-step
decode batch over all B slots; a finished slot returns to the pool.

Greedy requests (``temperature <= 0``) take the argmax of the logits, as
the reference does. Sampled ones draw from ``softmax(logits /
temperature)`` with the engine's ``torch.Generator`` (seeded by ``seed``):
the same distribution as the reference's ``jax.random.categorical``, not
the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..models import transformer as tf
from ..models.common import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    max_new: int = 32
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeEngine:
    """Slot engine over ``params`` (on their device). ``backend`` is the
    attention backend of the prefills (``kernels.ops.resolve_backend``)."""

    def __init__(self, cfg: ModelConfig, params: dict, batch_slots: int = 8,
                 cache_len: int = 512, seed: int = 0, *,
                 backend: str = "auto"):
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.cache_len = cache_len
        self.backend = backend
        self.device = params["embed"].device
        self.state = tf.init_decode_state(cfg, batch_slots, cache_len,
                                          device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)    # per-slot token count
        self.free = list(range(batch_slots))
        self.active: dict[int, Request] = {}
        self.generator = torch.Generator().manual_seed(seed)

    # -- slot management ------------------------------------------------

    def _merge_state(self, slot: int, one_state: dict) -> None:
        """Write a single-request prefill state into batch slot ``slot``."""
        for sk, blocks in self.state.items():
            for bk, leaves in blocks.items():
                for name, leaf in leaves.items():
                    leaf[:, slot] = one_state[sk][bk][name][:, 0]

    def submit(self, req: Request) -> bool:
        if not self.free:
            return False
        slot = self.free.pop()
        req.slot = slot
        tokens = torch.as_tensor(np.asarray(req.prompt)[None])
        logits, st = tf.prefill(self.params, self.cfg, {"tokens": tokens},
                                self.cache_len, backend=self.backend)
        self._merge_state(slot, st)
        self.pos[slot] = len(req.prompt)
        req.out.append(self._sample(logits[0, -1], req))
        self.active[slot] = req
        return True

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if req.temperature <= 0:
            return int(logits.argmax())
        probs = torch.softmax(logits.float().cpu() / req.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    # -- decode ------------------------------------------------------------

    def step(self) -> None:
        """One decode step for all slots (the free ones padded)."""
        if not self.active:
            return
        toks = np.zeros((self.B, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1]
        # per-slot positions (continuous batching: slots at different depths)
        logits, self.state = tf.decode_step(
            self.params, self.cfg, self.state, {"tokens": torch.as_tensor(toks)},
            torch.as_tensor(self.pos.copy()))
        lg = logits[:, 0]
        greedy = lg.argmax(-1).tolist()
        for slot, req in list(self.active.items()):
            tok = (greedy[slot] if req.temperature <= 0
                   else self._sample(lg[slot], req))
            req.out.append(tok)
            self.pos[slot] += 1
            if len(req.out) >= req.max_new:
                req.done = True
                del self.active[slot]
                self.free.append(slot)

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        while pending or self.active:
            while pending and self.free:
                self.submit(pending.pop(0))
            self.step()
        return requests
