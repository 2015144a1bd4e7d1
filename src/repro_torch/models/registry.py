"""Unified model interface (port of ``repro.models.registry``): every
ported architecture exposes the same entry points, used by the trainer,
the serving functions and the tests."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import threefry
from ..core.device import DeviceLike, resolve_device
from . import encdec, transformer
from . import spec as spec_mod

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def _module(cfg: ModelConfig):
    """The module of a config's family: ``encdec`` or ``transformer``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; have {FAMILIES}")
    return encdec if cfg.family == "encdec" else transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Dict[str, Any]

    # ---- parameters ----
    def abstract_params(self):
        return spec_mod.abstract(self.param_specs)

    def init(self, key: torch.Tensor, device: Optional[DeviceLike] = None):
        return spec_mod.initialize(self.param_specs, key, device)

    def n_params(self) -> int:
        return spec_mod.count_params(self.param_specs)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k of the expert pool)."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.family != "moe" or not cfg.moe_experts:
            return total
        expert = sum(int(np.prod(s.shape)) for p, s in
                     spec_mod.tree_paths(self.param_specs).items()
                     if "/moe/w" in p)
        return total - expert + expert * cfg.moe_topk // cfg.moe_experts

    # ---- compute ----
    @property
    def _impl(self):
        return _module(self.cfg)

    def loss(self, params, batch):
        return self._impl.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: Optional[int] = None):
        return self._impl.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, cache, tokens):
        return self._impl.decode_step(self.cfg, params, cache, tokens)

    def cache_specs(self, batch: int, max_len: int):
        return self._impl.cache_specs(self.cfg, batch, max_len)

    def abstract_cache(self, batch: int, max_len: int):
        return spec_mod.abstract(self.cache_specs(batch, max_len))

    def init_cache(self, batch: int, max_len: int,
                   device: Optional[DeviceLike] = None):
        dev = resolve_device(device)
        return spec_mod.map_specs(
            lambda p, s: torch.zeros(s.shape,
                                     dtype=spec_mod.torch_dtype(s.dtype),
                                     device=dev),
            self.cache_specs(batch, max_len))

    # ---- inputs ----
    def input_specs(self, shape: ShapeConfig,
                    batch_override: Optional[int] = None) -> Dict[str, Any]:
        """Stand-ins (tensors on the ``meta`` device) for every model input
        of one cell."""
        cfg = self.cfg
        b = batch_override or shape.global_batch
        s = shape.seq_len

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            out = {"tokens": meta((b, s), torch.int32)}
            if shape.kind == "train":
                out["labels"] = meta((b, s), torch.int32)
            if cfg.family == "encdec":
                out["frames"] = meta((b, cfg.enc_len, cfg.d_model),
                                     torch.float32)
            if cfg.family == "vlm":
                out["img_embeds"] = meta((b, cfg.vlm_prefix, cfg.d_model),
                                         torch.float32)
            return out
        # decode: one token with a KV/state cache of seq_len
        return {"tokens": meta((b,), torch.int32)}

    def concrete_inputs(self, shape: ShapeConfig, key: torch.Tensor,
                        batch_override: Optional[int] = None,
                        device: Optional[DeviceLike] = None):
        """The reference's inputs from the same key. Each input's key folds
        in ``hash(name) % 2**31``, Python's string hash, which differs
        between processes: compare with the reference in one process."""
        dev = resolve_device(device)
        specs = self.input_specs(shape, batch_override)
        out = {}
        for name, s in specs.items():
            k = threefry.fold_in(key, hash(name) % (2 ** 31))
            if s.dtype == torch.int32:
                out[name] = threefry.randint(k, tuple(s.shape), 0,
                                             self.cfg.vocab, device=dev)
            else:
                out[name] = threefry.normal(k, tuple(s.shape), device=dev)
        return out


def build_model(cfg: ModelConfig) -> Model:
    """The model of a config of any family in ``FAMILIES``."""
    return Model(cfg=cfg, param_specs=_module(cfg).build_specs(cfg))

