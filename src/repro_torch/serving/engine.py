"""Batched serving engine: prefill, then one decode step per new token
against caches allocated at `max_seq`, with greedy or temperature
sampling, for every family `models/lm.py` builds (dense: phi3-medium-14b,
yi-9b, qwen2.5-3b, starcoder2-15b; ssm: mamba2-370m; hybrid: zamba2-7b;
moe: deepseek-v2-lite-16b, phi3.5-moe-42b-a6.6b; vlm:
llama-3.2-vision-11b; encdec: whisper-base).  A vlm or encdec prefill
takes its stub frontend output in `extra` (`image_embeds` or `frames`).
It computes on the model's device (the card unless the model was built on
the CPU); the sampled tokens stay there until the end.  Under a profiler
`generate` records the spans `repro_torch.serve.prefill` (the prompt's
upload, the prefill and the first sample), `repro_torch.serve.decode`
(one a decode step, with its sample) and `repro_torch.serve.to_host`
(`spans.py`)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import lm
from ..spans import span


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: lm.LM, max_seq: int,
                 temperature: float = 0.0, seed: int = 0):
        self.cfg = cfg
        self.model = model
        self.max_seq = max_seq
        self.temperature = temperature
        self.device = model.embed.tok.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1)
        probs = torch.softmax(logits[:, -1] / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(self, prompt_tokens: np.ndarray, max_new_tokens: int,
                 extra: Optional[Dict[str, object]] = None) -> np.ndarray:
        """prompt_tokens: (B, S) int32 (right-aligned, no padding support in
        this minimal loop); extra: the prefill batch's other inputs
        (`image_embeds`, `frames`), numpy arrays or tensors, put on the
        model's device.  Returns (B, max_new_tokens) int32."""
        b, s = prompt_tokens.shape
        if s + max_new_tokens > self.max_seq:
            raise ValueError(f"{s} prompt + {max_new_tokens} new tokens "
                             f"exceed max_seq={self.max_seq}")
        with span("serve.prefill"):
            tokens = torch.from_numpy(
                np.ascontiguousarray(prompt_tokens)).to(self.device)
            batch = {"tokens": tokens}
            for k, v in (extra or {}).items():
                batch[k] = torch.as_tensor(v).to(self.device)
            logits, caches = lm.prefill_fn(self.cfg, self.model, batch,
                                           max_seq=self.max_seq)
            tok = self._sample(logits)
        out = []
        for i in range(max_new_tokens):
            out.append(tok)
            with span("serve.decode"):
                logits, caches = lm.decode_fn(self.cfg, self.model,
                                              tok[:, None], caches, s + i)
                tok = self._sample(logits)
        with span("serve.to_host"):
            return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
