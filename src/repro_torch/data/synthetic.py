"""Deterministic synthetic data pipeline (port of
``repro.data.synthetic``).

An infinite, seeded token stream with next-token labels. Each step derives
its batch from a counter-based key, so restarts reproduce the same stream
with no data service. The draws are the port's threefry (``fold_in``,
``split``, ``randint``, ``uniform``), so a batch is bit for bit the
reference's under the non-partitionable scheme.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core import threefry
from ..core.device import DeviceLike, resolve_device


class SyntheticTokens:
    """Markov-ish token stream: mixture of n-gram structure + noise so the
    CE loss has learnable signal (pure uniform tokens would be flat)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 structure: float = 0.8,
                 device: Optional[DeviceLike] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.structure = structure
        self.device = resolve_device(device)

    PERIOD = 16

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        dev = self.device
        key = threefry.fold_in(threefry.PRNGKey(self.seed), step)
        k1, k2, k3, k4 = threefry.split(key, 4)
        b, s, v = self.batch, self.seq_len, self.vocab
        # structured component: periodic sequences (token_t = token_{t-P})
        p = min(self.PERIOD, s)
        pattern = threefry.randint(k1, (b, p), 0, v, device=dev)
        reps = -(-s // p)
        periodic = pattern.repeat(1, reps)[:, :s]
        noise = threefry.randint(k2, (b, s), 0, v, device=dev)
        use_structure = threefry.uniform(k3, (b, s), device=dev) < float(
            np.float32(self.structure))
        tokens = torch.where(use_structure, periodic, noise).to(torch.int32)
        labels = torch.cat(
            [tokens[:, 1:],
             threefry.randint(k4, (b, 1), 0, v, device=dev)], dim=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_for_model(model, shape, step: int, seed: int = 0,
                    batch_override: Optional[int] = None,
                    device: Optional[DeviceLike] = None):
    """Concrete batch matching model.input_specs (incl. stub modalities),
    on ``device`` (default: the card). Token batches equal the
    reference's; the image embeddings are ``threefry.normal`` draws
    (within a few float32 ulps of the reference's)."""
    dev = resolve_device(device)
    specs = model.input_specs(shape, batch_override)
    b = batch_override or shape.global_batch
    out = {}
    if "tokens" in specs and shape.kind == "train":
        st = SyntheticTokens(model.cfg.vocab, shape.seq_len, b, seed,
                             device=dev)
        out.update(st.batch_at(step))
    elif "tokens" in specs:
        key = threefry.fold_in(threefry.PRNGKey(seed), step)
        out["tokens"] = threefry.randint(
            key, tuple(specs["tokens"].shape), 0, model.cfg.vocab,
            device=dev)
    for name in ("frames", "img_embeds"):
        if name in specs:
            key = threefry.fold_in(threefry.PRNGKey(seed + 99), step)
            shp = tuple(specs[name].shape)
            out[name] = (threefry.normal(key, shp, device=dev)
                         / float(np.float32(np.sqrt(shp[-1]))))
    return out
