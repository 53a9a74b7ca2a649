"""Batched serving engine: prefill + decode with a slotted cache.

Port of ``repro.serve.engine``.  Static-slot batching: waves of up to
``batch_slots`` requests; each request is prefilled alone, the wave's
caches are stacked on the batch axis, and one decode step at a time runs
over the whole wave in lockstep greedy decoding, ``cache["len"]`` masking
the unwritten cache positions.  There is no jit: the model runs eagerly
and the decode step updates the cache in place (the reference donates
it).

One difference from the reference: ``ServeEngine`` takes ``use_kernel``
(default True) and builds its model with it, so a dense model's prefill
runs the flash-attention CUDA kernel on the card.  The reference engine
builds with the default ``use_kernel=False``; the computation is the same
either way (the kernel computes the plain attention it replaces).  The
moe and vlm families run the same dense stack, so their prefill launches
the kernel once per layer too; a vlm request is prefilled behind
``n_image_tokens`` zero image embeddings, so ``max_len`` must cover the
image prefix and the prompt (the prefill raises otherwise); decode steps
past ``max_len`` overwrite the cache's last row, as the reference's do
(``layers.apply_attention_decode``).  For
the ssm family (Mamba-2) ``use_kernel`` changes nothing here: it reaches
only ``forward`` and ``loss``, while prefill runs the chunked scan (it
needs the final state) and decode the one-step recurrence, so serving
launches no SSD kernel, as in the reference.  Nor for the hybrid family
(zamba2): its prefill runs the chunked scan and the shared block's plain
attention, as the reference's does, so serving it launches no kernel at
all.  Its cache (the ssm cache of every layer, the shared block's K/V of
every group) is stacked on the batch axis like the others.  Nor for the
encdec family (whisper), whose every attention is plain, as in the
reference: a request is prefilled behind ``encoder_seq`` zero encoder
frames (there is no audio frontend, as in the reference's engine), and
its cross-attention cache ("ck", "cv") is stacked with the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


def _stack(caches: List[dict]) -> dict:
    """Concatenate per-request caches on the batch axis (axis 1 of every
    cache tensor, at any depth of nesting: the ssm cache is
    {"conv", "state"} under "ssm", beside "k" and "v" for the hybrid
    family); ``len`` is shared by the wave."""
    if len(caches) == 1:
        return caches[0]
    out = {}
    for key, leaf in caches[0].items():
        if isinstance(leaf, dict):
            out[key] = _stack([c[key] for c in caches])
        elif torch.is_tensor(leaf):
            out[key] = torch.cat([c[key] for c in caches], dim=1)
        else:
            out[key] = leaf
    return out


class ServeEngine:
    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_len: int = 512, greedy: bool = True,
                 use_kernel: bool = True, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, use_kernel=use_kernel,
                                 device=self.device)
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self._queue: List[Request] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    def submit(self, req: Request):
        req.out_tokens = []
        self._queue.append(req)

    def _prefill_one(self, req: Request):
        self.stats["prefills"] += 1
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None, :]
        batch = {"tokens": tokens}
        if self.cfg.family == "encdec":
            batch["encoder_embeds"] = torch.zeros(
                (1, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        if self.cfg.family == "vlm":
            # no image frontend: a zero image prefix, as the reference's
            # engine serves it (the prefill's ``max_len`` must cover it)
            batch["image_embeds"] = torch.zeros(
                (1, self.cfg.n_image_tokens, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        cache, logits = self.model.prefill(self.params, batch,
                                           max_len=self.max_len)
        first = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
        return cache, first

    def warm(self, prompt_lens) -> Dict[str, int]:
        """Run a tiny throwaway request per prompt length through the real
        serving path (the reference precompiles this way; here it warms
        the kernel build and the allocator).  Warm traffic is real traffic
        and counts in ``stats``."""
        if isinstance(prompt_lens, int):
            prompt_lens = [prompt_lens]
        lens = sorted({int(n) for n in prompt_lens})
        before = dict(self.stats)
        for i, n in enumerate(lens):
            self.run([Request(rid=-1 - i, prompt=np.zeros(n, np.int32),
                              max_new_tokens=2)])
        return {"buckets": len(lens),
                "prefills": self.stats["prefills"] - before["prefills"],
                "decode_steps": (self.stats["decode_steps"]
                                 - before["decode_steps"])}

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve a list of requests to completion (batched decode).

        Slots run the decode loop in lockstep waves of up to B; each wave
        drains before the next fills (static batching).
        """
        for r in requests:
            self.submit(r)
        results: Dict[int, List[int]] = {}
        with torch.inference_mode():
            while self._queue:
                wave = [self._queue.pop(0)
                        for _ in range(min(self.B, len(self._queue)))]
                self._run_wave(wave)
                for r in wave:
                    results[r.rid] = r.out_tokens
                    self.stats["tokens_out"] += len(r.out_tokens)
        return results

    def _run_wave(self, wave: List[Request]):
        lens = {len(r.prompt) for r in wave}
        assert len(lens) == 1, \
            "wave prompts must share a length (cache['len'] is per-wave); " \
            "the caller buckets by prompt length"
        caches, cur = [], []
        for r in wave:
            cache, first = self._prefill_one(r)
            r.out_tokens.append(first)
            caches.append(cache)
            cur.append(first)
        cache = _stack(caches)
        steps = max(r.max_new_tokens for r in wave) - 1
        alive = np.ones(len(wave), bool)
        for _ in range(max(steps, 0)):
            toks = torch.tensor(cur, dtype=torch.long,
                                device=self.device)[:, None]
            cache, logits = self.model.decode(self.params, cache, toks)
            self.stats["decode_steps"] += 1
            nxt = torch.argmax(logits[:, :self.cfg.vocab_size],
                               dim=-1).tolist()
            for i, r in enumerate(wave):
                if alive[i] and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(nxt[i]))
                    cur[i] = int(nxt[i])
                else:
                    alive[i] = False
            if not alive.any():
                break
