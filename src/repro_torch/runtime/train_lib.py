"""[LM-scaffold appendix — DESIGN.md §9.] Train step builders of the
port's LM launcher (``repro_torch.launch.train``), port of
``repro.runtime.train_lib``; no ESCG module imports this."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.device import DeviceLike, resolve_device
from ..models import spec as spec_mod
from ..models.registry import Model
from ..models.spec import ParamSpec, tree_leaves
from ..optim import clip_by_global_norm, compression, get_optimizer
from ..parallel.ctx import like


def state_specs(model: Model, compress: bool = False) -> Dict[str, Any]:
    """ParamSpec tree for the full train state (params + opt + step
    [+ error-feedback residuals when gradient compression is on])."""
    opt = get_optimizer(model.cfg.optimizer)
    specs = {
        "params": model.param_specs,
        "opt": opt.state_specs(model.param_specs),
        "step": ParamSpec((), (), init="zeros", dtype="int32"),
    }
    if compress:
        specs["ef"] = compression.ef_state_specs(model.param_specs)
    return specs


def make_train_step(model: Model,
                    schedule: Optional[Callable] = None,
                    grad_clip: float = 1.0,
                    compress: bool = False) -> Callable:
    """(state, batch) -> (state, metrics), in the reference's order: loss
    and grads (``torch.autograd``), [int8 error-feedback compression],
    clipping by the global norm, the schedule's lr, the optimizer. The
    step returns a new state and leaves its argument as it was.

    ``compress``: the residual buffer lives IN the train state (it must
    persist across steps).
    """
    opt = get_optimizer(model.cfg.optimizer)
    if schedule is None:
        def schedule(step):
            return torch.tensor(3e-4, dtype=torch.float32,
                                device=step.device)

    def train_step(state, batch):
        live = spec_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                                 state["params"])
        with torch.enable_grad():
            loss, mets = model.loss(live, batch)
            # a param the loss does not reach (zamba2's shared block's
            # ln2/mlp) gets a zero grad, as jax.grad gives it
            flat = torch.autograd.grad(loss, tree_leaves(live),
                                       materialize_grads=True)
        it = iter(flat)
        # a sharded param's grad in its param's layout (on one device, or
        # on plain tensors, the grad itself)
        grads = spec_mod.tree_map(lambda p: like(next(it), p), live)
        loss = loss.detach()
        mets = {k: v.detach() for k, v in mets.items()}
        new_ef = None
        if compress:
            grads, new_ef = compression.compress_grads(grads, state["ef"])
            new_ef = spec_mod.tree_map(like, new_ef, state["ef"])
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = schedule(state["step"])
        with torch.no_grad():
            params, opt_state = opt.apply(state["params"], grads,
                                          state["opt"], lr, state["step"])
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        if compress:
            new_state["ef"] = new_ef
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **mets}
        return new_state, metrics

    return train_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, cache, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch["tokens"])
    return decode_step


def init_state(model: Model, key: torch.Tensor, compress: bool = False,
               device: Optional[DeviceLike] = None) -> Dict[str, Any]:
    """The train state on ``device`` (default: the card): the params drawn
    from ``key``, the optimizer's state and the residuals zero, step 0."""
    dev = resolve_device(device)
    specs = state_specs(model, compress)
    state = {k: spec_mod.initialize(v, key, dev) if k != "params" else
             model.init(key, dev) for k, v in specs.items()}
    state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def place_state(model: Model, state: Dict[str, Any], mesh,
                rules: Dict[str, Any], compress: bool = False
                ) -> Dict[str, Any]:
    """A whole train state (params, the optimizer's moments, the step and
    the int8 error-feedback residuals) as DTensors on ``mesh``, each leaf
    laid out by the rules from its spec (the reference's ``in_shardings``
    of ``named_sharding_tree(state_specs(...))``)."""
    from ..parallel.sharding import distribute_tree
    return distribute_tree(state, state_specs(model, compress), mesh, rules)


def abstract_state(model: Model, compress: bool = False) -> Dict[str, Any]:
    return spec_mod.abstract(state_specs(model, compress))
