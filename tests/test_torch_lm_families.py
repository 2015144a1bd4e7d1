"""The port's moe, ssm, hybrid and encdec families (``repro_torch.models``:
``moe.py``, ``ssm.py``, ``encdec.py`` and their paths through
``transformer.py`` and ``registry.py``) against the JAX package's, on the
CPU.

Every model runs at its ``reduced()`` size with the reference's own
weights carried across (``convert.params_from_jax``), the JAX draws under
``jax.threefry_partitionable(False)``. Tolerances are ``test_torch_lm.py``'s
(its ``_close``, ``_close_adamw``): loss relative 1e-5, grads within 1e-4
of the leaf's largest |grad|, one optimizer step 1e-5; prefill and decode
logits within 1e-4 of the reference's and a decode within 2e-2 of a full
prefill (the reference test's). Components:

* ``moe_layer``: the routing (``topi``, the kept choices) equal to the
  reference's, output and aux within 1e-5, against a per-token loop over
  the experts within the reference test's 2e-4 / 2e-3;
* the selective scans within 1e-5 (``tests/test_models.py``'s), the
  Mamba-1 decode steps against the chunked forward within 1e-5;
* ``mamba2_forward`` within 1e-5 relative and 1e-5 of the output's
  largest |value|; its grads within 1e-4 of the leaf's largest |grad|.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import spec as jspec
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.runtime import train_lib as jtl
from repro_torch import convert
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.core import threefry
from repro_torch.data import batch_for_model
from repro_torch.models import (build_model, common, encdec, moe, spec,
                                ssm, transformer)
from repro_torch.models.spec import tree_leaves
from repro_torch.runtime import train_lib
from repro_torch.runtime.checkpoint import CheckpointManager
from test_torch_lm import (_close, _close_adamw, _init, _models, _nf, _np,
                           _to_port, _train_batch, _ulps)

FAMILIES = ("moe", "ssm", "hybrid", "encdec")
NEW = sorted(a for a, c in ARCHS.items() if c.family in FAMILIES)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _reference_params(specs, seed):
    with _nf():
        p = jspec.initialize(specs, jax.random.PRNGKey(seed))
    return p, convert.params_from_jax(_np(p), "cpu")


def _grads_close(jg, tg, what):
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jg), tg)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(),
                                   err_msg=f"{what}: leaf {i}")


def _port_grads(fn, params):
    live = spec.tree_map(lambda p: p.detach().requires_grad_(True), params)
    out = fn(live)
    return out, torch.autograd.grad(out, tree_leaves(live),
                                    materialize_grads=True)


def test_new_families_are_the_configs_left():
    """The five configs of this slice: every config in ``ARCHS`` builds."""
    assert NEW == ["falcon-mamba-7b", "grok-1-314b", "kimi-k2-1t-a32b",
                   "whisper-small", "zamba2-7b"]
    for arch, cfg in ARCHS.items():
        assert build_model(cfg).cfg.name == arch


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family"):
        build_model(ARCHS["granite-3-8b"].reduced().replace(family="rnn"))


@pytest.mark.parametrize("n", [7, 14, 17, 40])
def test_threefry_normal_blocked_scheme(n, monkeypatch):
    """A leaf of 2^32 - 1 words or more (kimi-k2's experts at one layer:
    5.6e9) takes the reference's blocked scheme: ``split(key, nblocks +
    1)``, a whole block from each of the first keys, the rest from the
    last. With the block cut to 7 words, the port's normals against that
    scheme built from ``jax.random``'s own split and normals: the bits
    exact, values within 4 float32 ulps."""
    monkeypatch.setattr(threefry, "_BLOCK", 7)
    nb, rem = divmod(n, 7)
    with _nf():
        key = jax.random.PRNGKey(11)
        keys = jax.random.split(key, nb + 1) if nb else [key]
        parts = [jax.random.normal(k, (7,)) for k in keys[:nb]]
        parts.append(jax.random.normal(keys[nb] if nb else key, (rem,)))
        want = np.concatenate([np.asarray(p) for p in parts])
    got = threefry.normal(convert.key_from_jax(jax.random.key_data(key)),
                          (n,)).numpy()
    assert got.shape == want.shape and _ulps(got, want) <= 4


# ------------------------------ the models -------------------------------- #

@pytest.mark.parametrize("arch", NEW)
def test_loss_grads_and_step_match_reference(arch):
    """Loss (ce and the MoE aux), grads and one step of the config's own
    optimizer (AdamW; Adafactor for kimi-k2) against the reference's."""
    jm, tm = _models(arch)
    state = _init(jm)
    jb, tb = _train_batch(jm)
    jstep = jtl.make_train_step(jm)

    @jax.jit
    def reference(st, b):
        return (jax.value_and_grad(jm.loss, has_aux=True)(st["params"], b),
                jstep(st, b))
    ((jl, jmets), jg), (jnext, jmet) = reference(state, jb)

    tstate = _to_port(state)
    live = spec.tree_map(lambda p: p.detach().requires_grad_(True),
                         tstate["params"])
    tl, tmets = tm.loss(live, tb)
    tg = torch.autograd.grad(tl, tree_leaves(live), materialize_grads=True)
    tl = tl.detach()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    tmets = {k: v.detach() for k, v in tmets.items()}
    np.testing.assert_allclose(float(tmets["ce"]), float(jmets["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmets["aux"]), float(jmets["aux"]),
                               rtol=1e-5, atol=1e-7)
    if jm.cfg.family == "moe":
        assert float(tmets["aux"]) > 0
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    _grads_close(jg, tg, f"{arch} grads")

    tnext, tmet = train_lib.make_train_step(tm)(tstate, tb)
    assert int(tnext["step"]) == 1
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    if tm.cfg.optimizer == "adafactor":
        _close(jnext, tnext, 1e-5, 1e-5, f"{arch} Adafactor step")
    else:
        _close_adamw(jnext, tnext, f"{arch} AdamW step")
    _close(state, tstate, 0, 0, f"{arch} state before the step")


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 12 tokens and one decode step against the reference's
    (logits and every cache leaf), and the port's decode against its own
    13-token prefill. MoE takes ``moe_cf=8.0``, as the reference's test
    does: capacity drops legitimately differ between a 12-token prefill
    and a 1-token decode."""
    kw = {"moe_cf": 8.0} if ARCHS[arch].family == "moe" else {}
    jm, tm = _models(arch, **kw)
    with _nf():
        params = jm.init(jax.random.PRNGKey(0))
        pre = jm.concrete_inputs(JShape("p", 13, 2, "prefill"),
                                 jax.random.PRNGKey(0))
    t, max_len = 12, 16
    jlt, jcache = jm.prefill(params, dict(pre, tokens=pre["tokens"][:, :t]),
                             max_len=max_len)
    jls, jcache2 = jm.decode_step(params, jcache, pre["tokens"][:, t])

    tp = convert.params_from_jax(_np(params), "cpu")
    tpre = convert.state_from_jax(_np(pre), "cpu")
    prefill = train_lib.make_prefill_step(tm, max_len)
    decode = train_lib.make_decode_step(tm)
    tlt, tcache = prefill(tp, dict(tpre, tokens=tpre["tokens"][:, :t]))
    assert int(tcache["len"]) == t
    assert sorted(tcache) == sorted(jcache)
    assert sorted(tcache) == sorted(tm.cache_specs(2, max_len))
    tls, tcache2 = decode(tp, tcache, {"tokens": tpre["tokens"][:, t]})
    assert int(tcache2["len"]) == t + 1
    tfull, _ = prefill(tp, tpre)
    np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)
    _close(jcache, tcache, 1e-4, 1e-4, f"{arch} prefill cache")
    _close(jcache2, tcache2, 1e-4, 1e-4, f"{arch} decode cache")
    for name, leaf in tcache.items():      # every leaf as cache_specs says
        want = tm.cache_specs(2, max_len)[name]
        assert tuple(leaf.shape) == want.shape, name
        assert leaf.dtype == spec.torch_dtype(want.dtype), name
    np.testing.assert_allclose(tls.numpy(), tfull.numpy(), rtol=2e-2,
                               atol=2e-2)
    # the reference's cache carried across decodes to its logits
    tlj, _ = decode(tp, convert.state_from_jax(_np(jcache), "cpu"),
                    {"tokens": tpre["tokens"][:, t]})
    np.testing.assert_allclose(tlj.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_n_active_params_matches_reference(arch):
    jm, tm = jbuild(JARCHS[arch]), build_model(ARCHS[arch])
    assert tm.n_active_params() == jm.n_active_params()
    if tm.cfg.family == "moe":
        assert tm.n_active_params() < 0.3 * tm.n_params()


def test_input_specs_carry_the_frames():
    jm, tm = _models("whisper-small")
    for kind in ("train", "prefill", "decode"):
        want = jm.input_specs(JShape("c", 8, 2, kind))
        got = tm.input_specs(ShapeConfig("c", 8, 2, kind))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


# --------------------------------- MoE ------------------------------------ #

def _moe_cfgs(**kw):
    base = dict(moe_experts=4, moe_topk=2, moe_dff=32)
    base.update(kw)
    return (JARCHS["grok-1-314b"].reduced().replace(**base),
            ARCHS["grok-1-314b"].reduced().replace(**base))


@pytest.mark.parametrize("groups,seed", [(2, 1), (1, 9), (4, 5)])
def test_moe_layer_matches_reference_with_drops(groups, seed):
    """At the default ``moe_cf`` (1.25) on a batch where some choices
    overflow their expert's capacity: ``topi`` and the kept choices equal
    the reference's, the output, aux and grads within 1e-5 / 1e-4."""
    jcfg, tcfg = _moe_cfgs(moe_groups=groups)
    jp, tp = _reference_params(jmoe.moe_specs(jcfg), seed)
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_layer(jp, x, jcfg)
    ty, taux = moe.moe_layer(tp, _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    # the reference's routing, step by step
    g = moe.n_groups(tcfg, 32)
    tok = x.reshape(2, g, 32 // g, -1)
    probs = jax.nn.softmax(tok @ np.asarray(jp["router"]), axis=-1)
    _, jtopi = jax.lax.top_k(probs, 2)
    r = moe.route(tp, _t(tok), tcfg)
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(jtopi))
    onehot = jax.nn.one_hot(jtopi, 4)
    flat = onehot.reshape(2, g, -1, 4)
    pos = (jnp.cumsum(flat, axis=2) - flat).reshape(onehot.shape)
    jpos = np.asarray(jnp.sum(pos * onehot, axis=-1))
    np.testing.assert_array_equal(r.pos.numpy(), jpos)
    np.testing.assert_array_equal(r.keep.numpy(), jpos < r.cap)
    assert int((~r.keep).sum()) > 0, "no choice was dropped"

    w = np.random.default_rng(seed + 1).standard_normal(
        x.shape).astype(np.float32)
    def jloss(p, x_):
        y, aux = jmoe.moe_layer(p, x_, jcfg)
        return jnp.sum(y * w) + aux
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tx = _t(x).requires_grad_(True)
    live = spec.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    y, aux = moe.moe_layer(live, tx, tcfg)
    tg = torch.autograd.grad((y * _t(w)).sum() + aux,
                             tree_leaves(live) + [tx])
    _grads_close(list(jax.tree.leaves(jg[0])) + [jg[1]], tg, "moe grads")


def test_moe_layer_matches_dense_loop():
    """``tests/test_models.py::test_moe_layer_matches_dense_loop`` on the
    port: with ample capacity (no drops) the dispatch products equal an
    explicit loop over each token's experts."""
    _, cfg = _moe_cfgs(moe_cf=8.0, moe_groups=1)
    _, p = _reference_params(jmoe.moe_specs(cfg), 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_layer(p, x, cfg)
    assert np.isfinite(float(aux))
    probs = torch.softmax(x @ p["router"], -1)
    topv, topi = torch.topk(probs, 2)
    topv = topv / topv.sum(-1, keepdim=True)
    want = np.zeros(tuple(x.shape), np.float64)
    xn = x.numpy().astype(np.float64)
    for b in range(2):
        for s in range(8):
            for j in range(2):
                e = int(topi[b, s, j])
                h = xn[b, s] @ p["wi"][e].numpy()
                hg = xn[b, s] @ p["wg"][e].numpy()
                h = h / (1 + np.exp(-h)) * hg
                want[b, s] += float(topv[b, s, j]) * (h @ p["wo"][e].numpy())
    np.testing.assert_allclose(y.numpy(), want, atol=2e-4, rtol=2e-3)


def test_moe_routing_at_full_width_matches_reference(monkeypatch):
    """Layer 0's routing at grok-1's full widths (d_model 6144, 48 heads of
    128, 8 experts, top-2, 16 groups, ``moe_cf`` 1.25) on the first of
    ``chip_smoke.py``'s ``[lm/moe]`` prompts (4095 tokens of its seed-0
    draw), in float32 compute: ``transformer.moe_routing``'s residual
    within 1e-5 of the reference's embedding and attention block, its
    ``topi`` and capacity slots (``where(keep, pos, cap)``) equal to those
    the reference's ``moe_layer`` computes (read from its own ``top_k``
    and capacity ``one_hot`` calls), with choices dropped; the layer's
    output and aux within 1e-5. Cuts that the routing does not read: the
    embedding table holds only the prompt's rows (drawn at the full
    table's init scale), and the expert FFN is 8 wide."""
    kw = dict(n_layers=1, moe_dff=8, compute_dtype="float32")
    jcfg = JARCHS["grok-1-314b"].replace(**kw)
    tcfg = ARCHS["grok-1-314b"].replace(**kw)
    seq = 4095
    toks = batch_for_model(build_model(tcfg),
                           ShapeConfig("prefill", seq + 1, 2, "prefill"),
                           0, 0, device="cpu")["tokens"][:1, :seq]
    used, compact = np.unique(toks.numpy(), return_inverse=True)
    compact = compact.reshape(toks.shape).astype(np.int32)
    std = np.float32(1 / np.sqrt(tcfg.vocab_padded))
    rows = (np.random.default_rng(0).standard_normal(
        (len(used), tcfg.d_model)) * std).astype(np.float32)
    with _nf():
        jlp = jspec.initialize(jtransformer._layer_specs(jcfg),
                               jax.random.PRNGKey(0))
    tp = convert.params_from_jax(
        _np({"embed": {"tokens": rows},
             "layers": jax.tree.map(lambda v: v[None], jlp)}), "cpu")

    jx = jtransformer._embed(jcfg, {"embed": {"tokens": rows}}, compact)
    jx, _, _ = jtransformer._attn_block(jcfg, jlp, jx, jnp.arange(seq))
    jh = jcommon.rmsnorm(jx, jlp["ln2"])
    seen = {}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen["topi"] = np.asarray(out[1])
        return out

    def spy_one_hot(x, n, **kw):
        if n != jcfg.moe_experts:                # the capacity one-hot
            seen["slot"] = np.asarray(x)
        return one_hot(x, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    jy, jaux = jmoe.moe_layer(jlp["moe"], jh, jcfg)
    monkeypatch.undo()

    with torch.no_grad():
        x, r = transformer.moe_routing(tcfg, tp, torch.from_numpy(compact))
        lp = spec.tree_map(lambda v: v[0], tp["layers"])
        y, aux = moe.moe_layer(lp["moe"], common.rmsnorm(x, lp["ln2"]),
                               tcfg)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-5,
                               atol=1e-5 * np.abs(jx).max())
    assert r.topi.shape == (1, 15, 273, 2) and r.cap == 86
    np.testing.assert_array_equal(r.topi.numpy(), seen["topi"])
    slot = torch.where(r.keep, r.pos, float(r.cap))
    np.testing.assert_array_equal(slot.numpy(), seen["slot"])
    assert int((~r.keep).sum()) > 0, "no choice was dropped"
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_capacity_onehot_of_a_dropped_choice():
    """A dropped choice goes to index ``cap``: a row of zeros, as
    ``jax.nn.one_hot`` gives (``F.one_hot`` would raise)."""
    cap = 3
    pos = np.array([[0, 1], [2, 3], [5, 2]], np.float32)
    keep = pos < cap
    want = jax.nn.one_hot(jnp.where(keep, pos, cap).astype(jnp.int32), cap,
                          dtype=jnp.float32)
    got = moe.capacity_onehot(_t(pos), torch.from_numpy(keep), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1, 1].sum()) == 0 and float(got[2, 0].sum()) == 0


# ------------------------------ the scans --------------------------------- #

@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 16)])
def test_ssm_scans_match_reference(s, chunk):
    """``_ssm_scan_chunked`` and ``_ssm_scan_fused`` against the
    reference's and a sequential loop (a chunk that does not divide the
    sequence is halved, as the reference's)."""
    rs = np.random.default_rng(s)
    b, di, n = 2, 6, 4
    a = rs.uniform(0.5, 0.99, (b, s, di, n)).astype(np.float32)
    bu = rs.standard_normal((b, s, di, n)).astype(np.float32)
    h0 = rs.standard_normal((b, di, n)).astype(np.float32)
    jh, jl = jssm._ssm_scan_chunked(a, bu, h0, chunk)
    th, tl = ssm._ssm_scan_chunked(_t(a), _t(bu), _t(h0), chunk)
    h, seq = h0, []
    for t in range(s):
        h = a[:, t] * h + bu[:, t]
        seq.append(h)
    for got, want in ((th, jh), (tl, jl), (th, np.stack(seq, 1))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    xc = rs.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((b, s, di)))).astype(np.float32)
    bs = rs.standard_normal((b, s, n)).astype(np.float32)
    cs = rs.standard_normal((b, s, n)).astype(np.float32)
    am = -np.exp(rs.standard_normal((di, n))).astype(np.float32)
    dsk = rs.standard_normal(di).astype(np.float32)
    jy, jhl = jssm._ssm_scan_fused(xc, dt, bs, cs, am, dsk, h0, chunk)
    ty, thl = ssm._ssm_scan_fused(*(_t(v) for v in
                                    (xc, dt, bs, cs, am, dsk, h0)), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(thl.numpy(), np.asarray(jhl), rtol=1e-5,
                               atol=1e-5)


def test_fused_scan_grads_match_reference():
    """The fused scan's chunks under ``torch.utils.checkpoint``: grads of
    every input within 1e-4 of the reference's."""
    rs = np.random.default_rng(7)
    b, s, di, n = 2, 32, 6, 4
    args = [rs.standard_normal((b, s, di)),
            np.log1p(np.exp(rs.standard_normal((b, s, di)))),
            rs.standard_normal((b, s, n)), rs.standard_normal((b, s, n)),
            -np.exp(rs.standard_normal((di, n))), rs.standard_normal(di),
            rs.standard_normal((b, di, n))]
    args = [a.astype(np.float32) for a in args]
    w = rs.standard_normal((b, s, di)).astype(np.float32)
    def jloss(*a):
        y, hl = jssm._ssm_scan_fused(*a, 8)
        return jnp.sum(y * w) + jnp.sum(hl)
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(*args)
    targs = [_t(a).requires_grad_(True) for a in args]
    y, hl = ssm._ssm_scan_fused(*targs, 8)
    tg = torch.autograd.grad((y * _t(w)).sum() + hl.sum(), targs)
    _grads_close(jg, tg, "fused scan grads")


def test_mamba1_decode_steps_match_chunked_forward():
    """Mamba-1 one token at a time from its conv and SSM state equals the
    chunked forward over the whole sequence (and its final state)."""
    jcfg = JARCHS["falcon-mamba-7b"].reduced()
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    _, p = _reference_params(jssm.mamba1_specs(jcfg), 2)
    x = _t(np.random.default_rng(2).standard_normal((2, 20, cfg.d_model)))
    with torch.no_grad():
        y, st = ssm.mamba1_forward(p, x, cfg)
        state = {"conv": torch.zeros(2, cfg.ssm_conv - 1, cfg.d_inner),
                 "ssm": torch.zeros(2, cfg.d_inner, cfg.ssm_state)}
        steps = []
        for t in range(20):
            yt, state = ssm.mamba1_forward(p, x[:, t:t + 1], cfg, state)
            steps.append(yt)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), st[k].numpy(),
                                   rtol=1e-5, atol=1e-5)


def _mamba2_setup(chunk, seq=256):
    jcfg = JARCHS["zamba2-7b"].reduced().replace(ssm_chunk=chunk)
    cfg = ARCHS["zamba2-7b"].reduced().replace(ssm_chunk=chunk)
    jp, tp = _reference_params(jssm.mamba2_specs(jcfg), 0)
    with _nf():
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (1, seq, jcfg.d_model)))
    return jcfg, cfg, jp, tp, x


def _mamba2_loss_jax(cfg, x):
    return lambda p: jnp.mean(jssm.mamba2_forward(p, x, cfg)[0] ** 2)


def _mamba2_loss(cfg, x):
    return lambda p: torch.mean(ssm.mamba2_forward(p, _t(x), cfg)[0] ** 2)


@pytest.mark.parametrize("chunk", [4, 16, 128])
def test_mamba2_forward_matches_reference(chunk):
    """The SSD forward at chunks 4, 16 and 128 (zamba2-7b's own) over 256
    tokens: output and final state against the reference's."""
    jcfg, cfg, jp, tp, x = _mamba2_setup(chunk)
    jy, jst = jssm.mamba2_forward(jp, x, jcfg)
    with torch.no_grad():
        ty, tst = ssm.mamba2_forward(tp, _t(x), cfg)
    for got, want in ((ty, jy), (tst["ssm"], jst["ssm"]),
                      (tst["conv"], jst["conv"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_mamba2_grad_matches_reference_at_chunk_16():
    jcfg, cfg, jp, tp, x = _mamba2_setup(16)
    jg = jax.jit(jax.grad(_mamba2_loss_jax(jcfg, x)))(jp)
    _, tg = _port_grads(_mamba2_loss(cfg, x), tp)
    _grads_close(jg, tg, "mamba2 grads, chunk 16")


def test_mamba2_grad_finite_at_chunk_128():
    """At zamba2-7b's own chunk of 128 the reference's gradient is NaN (its
    ``_segsum_decay`` overflows ``exp`` above the diagonal before masking:
    ROADMAP.md, Open items, the ``_segsum_decay`` NaN). The port masks
    first: its gradient is finite and equals its own gradient at chunk 16
    within 1e-4 of each leaf's largest |grad|."""
    jcfg, cfg, jp, tp, x = _mamba2_setup(128)
    jg = jax.jit(jax.grad(_mamba2_loss_jax(jcfg, x)))(jp)
    nan = {k: bool(jnp.isnan(v).any()) for k, v in jg.items()}
    assert nan["in_proj"] and nan["a_log"] and nan["dt_bias"], nan
    _, g128 = _port_grads(_mamba2_loss(cfg, x), tp)
    _, g16 = _port_grads(_mamba2_loss(cfg.replace(ssm_chunk=16), x), tp)
    assert all(bool(torch.isfinite(g).all()) for g in g128)
    for i, (a, b) in enumerate(zip(g16, g128)):
        a = a.numpy()
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(),
                                   err_msg=f"leaf {i}")


# ------------------------------ the hybrid -------------------------------- #

def test_hybrid_groups_shared_block_and_caches():
    """zamba2 with 5 layers and ``attn_every=2``: two groups, each followed
    by the one shared attention block (its weights used twice), and one
    layer left over with none. The per-application KV cache, the layers'
    conv and SSM states, the logits and the shared block's grads equal the
    reference's."""
    kw = dict(n_layers=5, attn_every=2)
    jm, tm = _models("zamba2-7b", **kw)
    assert tuple(tm.cache_specs(2, 16)["k"].shape)[0] == 2
    with _nf():
        params = jm.init(jax.random.PRNGKey(3))
        pre = jm.concrete_inputs(JShape("p", 10, 2, "prefill"),
                                 jax.random.PRNGKey(3))
    jlt, jc = jm.prefill(params, pre, max_len=12)
    jls, jc2 = jm.decode_step(params, jc, pre["tokens"][:, 0])
    tp = convert.params_from_jax(_np(params), "cpu")
    tpre = convert.state_from_jax(_np(pre), "cpu")
    with torch.no_grad():
        tlt, tc = tm.prefill(tp, tpre, max_len=12)
        tls, tc2 = tm.decode_step(tp, tc, tpre["tokens"][:, 0])
    assert tuple(tc["k"].shape) == (2, 2, 12, tm.cfg.n_kv, tm.cfg.head_dim)
    assert tuple(tc["ssm"].shape)[0] == 5
    np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)
    _close(jc2, tc2, 1e-4, 1e-4, "hybrid decode cache")
    # the two applications wrote different k: the block ran twice
    assert not torch.equal(tc["k"][0], tc["k"][1])

    jb = {"tokens": pre["tokens"], "labels": pre["tokens"]}
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(params)
    tb = {"tokens": tpre["tokens"], "labels": tpre["tokens"]}
    _, tg = _port_grads(lambda p: tm.loss(p, tb)[0], tp)
    _grads_close(jg, tg, "hybrid grads")
    shared = tree_leaves(tm.param_specs).index(
        tm.param_specs["shared_attn"]["attn"]["wq"])
    assert float(tg[shared].abs().sum()) > 0


def test_hybrid_train_state_checkpoint_roundtrip(tmp_path):
    """A zamba2 train state after one AdamW step saved and restored by
    ``CheckpointManager``, every leaf bit for bit; the restored state
    steps on to the same state as the original."""
    _, tm = _models("zamba2-7b")
    jm = jbuild(JARCHS["zamba2-7b"].reduced())
    state = _to_port(_init(jm))
    _, tb = _train_batch(jm)
    step = train_lib.make_train_step(tm)
    s1, _ = step(state, tb)
    cm = CheckpointManager(str(tmp_path), device="cpu")
    cm.save(1, s1)
    cm.wait()
    n, got = cm.restore()
    assert n == 1 and set(got["params"]) == set(s1["params"])
    a, b = tree_leaves(s1), tree_leaves(got)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    s2, _ = step(s1, tb)
    g2, _ = step(got, tb)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(s2),
                                                 tree_leaves(g2)))


# ------------------------------ encdec ------------------------------------ #

def test_encdec_encode_decoder_and_cross_cache():
    """whisper: ``encode``, ``_decoder`` (train logits) and the cross k/v
    that prefill stores and decode reads, against the reference's."""
    jm, tm = _models("whisper-small")
    cfg = tm.cfg
    with _nf():
        params = jm.init(jax.random.PRNGKey(5))
        pre = jm.concrete_inputs(JShape("p", 9, 2, "prefill"),
                                 jax.random.PRNGKey(5))
    tp = convert.params_from_jax(_np(params), "cpu")
    frames = pre["frames"]
    jenc = jencdec.encode(jm.cfg, params, frames)
    with torch.no_grad():
        tenc = encdec.encode(cfg, tp, _t(frames))
        np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc),
                                   rtol=1e-5, atol=1e-5)
        toks = np.array(pre["tokens"])
        jlog, _ = jencdec._decoder(jm.cfg, params, toks, jnp.arange(9),
                                   enc_out=jenc, mode="train")
        tlog, _ = encdec._decoder(cfg, tp, torch.from_numpy(toks),
                                  torch.arange(9), enc_out=tenc,
                                  mode="train")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-5, atol=1e-5)
        _, jc = jencdec.prefill(jm.cfg, params, pre, max_len=12)
        _, tc = tm.prefill(tp, convert.state_from_jax(_np(pre), "cpu"),
                           max_len=12)
    assert tuple(tc["xk"].shape) == (cfg.n_layers, 2, cfg.enc_len, cfg.n_kv,
                                     cfg.head_dim)
    assert tuple(tc["k"].shape)[2] == 12
    for key in ("xk", "xv", "k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # the cross k/v are the encoder output's projections, layer by layer
    for i in range(cfg.n_layers):
        lp = {"xattn": {k: v[i] for k, v in
                        tp["dec_layers"]["xattn"].items()}}
        k, v = encdec._cross_kv(cfg, lp, tenc)
        assert torch.equal(tc["xk"][i], k) and torch.equal(tc["xv"][i], v)


# ------------------------------ the launcher ------------------------------ #

@pytest.mark.parametrize("arch", ["zamba2-7b", "kimi-k2-1t-a32b"])
def test_train_launcher_runs_the_new_families(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch A --reduced --steps 3
    --device cpu`` as a process; kimi-k2 takes Adafactor from its
    config."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
         "--log_every", "1", "--ckpt_dir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"arch={arch}" in out.stdout and "steps 0->3" in out.stdout
    assert "device=cpu" in out.stdout
    if ARCHS[arch].family == "moe":
        assert "(active " in out.stdout
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.stdout.splitlines() if "] step " in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
    st = CheckpointManager(str(tmp_path), device="cpu").restore()[1]
    if ARCHS[arch].optimizer == "adafactor":
        assert set(st["opt"]["layers"]["attn"]["wq"]) == {"vr", "vc"}
    else:
        assert set(st["opt"]["layers"]["mamba"]["in_proj"]) == {"m", "v"}
