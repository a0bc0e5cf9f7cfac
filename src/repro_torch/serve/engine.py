"""Batched serving engine: fixed-slot continuous batching over the model
API's prefill and decode steps, a port of the reference package's
``serve/engine.py``.

B slots; incoming requests fill free slots (each prompt prefilled on its
own, its decode state placed into the batch state at its slot), every
engine tick decodes one token for all active slots, and finished slots
(EOS or max_tokens) are drained and refilled.  Slots share one position
counter, so only prompts of equal length are co-batched.  Greedy or
temperature sampling (a ``torch.Generator`` seeded from ``seed``).

Each decode-state leaf's batch axis comes from the family's
``cache_specs`` (the index of ``"batch"`` in its logical axes), so
layouts with the batch anywhere (zamba2's Mamba state is (groups, layers,
B, ...)) are placed right.  ``stats`` counts prefills and decode steps and
the host seconds each took; both end with a token read back to the host,
so on the card they include the device's work.

A ``vlm`` prompt is prefilled with zero patch embeddings (float32, one per
patch position) in place of its first ``n_patches`` tokens, and an
``encdec`` prompt over zero frame embeddings (float32, ``min(len(prompt),
enc_len_cap)`` frames), as in the reference's engine; ``prefill_batch``
builds that batch.  A prompt shorter than ``n_patches`` raises
``ValueError`` (``models/transformer.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import ModelApi
from ..models.module import tree_leaves, tree_map


def prefill_batch(cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """The prefill batch of ``tokens`` (B,T) for ``ModelApi.prefill_fn``:
    for a ``vlm`` also zero patch embeddings (B, n_patches, d_model), for
    an ``encdec`` zero frame embeddings (B, min(T, enc_len_cap),
    d_model)."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.zeros(
            (tokens.shape[0], min(tokens.shape[1], cfg.enc_len_cap),
             cfg.d_model), dtype=torch.float32, device=tokens.device)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(
            (tokens.shape[0], cfg.n_patches, cfg.d_model),
            dtype=torch.float32, device=tokens.device)
    return batch


@dataclass
class Request:
    prompt: List[int]
    max_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0
    # filled by the engine
    output: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, api: ModelApi, params, batch_slots: int = 4,
                 max_seq: int = 128, eos_id: Optional[int] = None,
                 seed: int = 0):
        self.api = api
        self.params = params
        self.B = batch_slots
        self.S = max_seq
        self.eos = eos_id
        self.device = tree_leaves(params)[0].device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.cur_len = [0] * batch_slots
        self.cache = None
        self.queue: List[Request] = []
        specs = api.cache_specs(ShapeConfig("serve", max_seq, batch_slots,
                                            "decode"))
        self.bdims = tree_map(lambda s: s.logical.index("batch"), specs)
        self.stats = dict(prefills=0, decode_steps=0, prefill_s=0.0,
                          decode_s=0.0)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request):
        self.queue.append(req)

    @torch.inference_mode()
    def _prefill_one(self, slot: int, req: Request):
        """Prefill one request and place its decode state into the batch
        state at ``slot``."""
        active = [r for r in self.slots if r is not None and r is not req]
        if active and len(req.prompt) != len(active[0].prompt):
            raise ValueError("co-batched prompts must share a length bucket")
        t0 = time.perf_counter()
        toks = torch.tensor(req.prompt, dtype=torch.long,
                            device=self.device)[None, :]
        logits, cache1 = self.api.prefill_fn(
            self.params, prefill_batch(self.api.cfg, toks), cache_len=self.S)
        if self.cache is None:
            self.cache = tree_map(lambda x, bd: torch.cat([x] * self.B, bd),
                                  cache1, self.bdims)
        tree_map(lambda full, one, bd: full.narrow(bd, slot, 1).copy_(one),
                 self.cache, cache1, self.bdims)
        self.cur_len[slot] = len(req.prompt)
        req.output.append(self._sample(logits, req))
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _sample(self, logits, req: Request) -> int:
        logits = logits[0] if logits.ndim == 2 else logits[0, -1]
        if req.temperature > 0:
            probs = torch.softmax(logits.float() / req.temperature, dim=-1)
            return int(torch.multinomial(probs, 1, generator=self.gen))
        return int(torch.argmax(logits))

    # --------------------------------------------------------------- tick
    def _fill_slots(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self._prefill_one(i, req)

    @torch.inference_mode()
    def step(self):
        """One engine tick: decode one token for every active slot."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        t0 = time.perf_counter()
        last = torch.zeros((self.B, 1), dtype=torch.long)
        for i in active:
            last[i, 0] = self.slots[i].output[-1]
        cur = max(self.cur_len[i] for i in active)
        logits, self.cache = self.api.decode_fn(
            self.params, self.cache,
            {"tokens": last.to(self.device), "cur_index": cur})
        for i in active:
            req = self.slots[i]
            tok = self._sample(logits[i:i + 1], req)
            req.output.append(tok)
            self.cur_len[i] += 1
            if (self.eos is not None and tok == self.eos) or \
                    len(req.output) >= req.max_tokens or \
                    self.cur_len[i] >= self.S - 1:
                req.done = True
                self.slots[i] = None
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0

    def run_until_done(self, max_ticks: int = 1000) -> List[Request]:
        finished: List[Request] = []
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            # the queue too: a request admitted by this tick can finish in
            # it (ROADMAP §C 22)
            before = [r for r in self.slots if r] + list(self.queue)
            self.step()
            ticks += 1
            for r in before:
                if r.done and r not in finished:
                    finished.append(r)
        return finished
