"""The port's LM appendix (``repro_torch.models``, ``optim``, ``data``,
``runtime.train_lib``) against the JAX package's, on the CPU.

Every dense and vlm architecture runs at its ``reduced()`` size with the
reference's own weights carried across (``convert.params_from_jax``); the
other families are ``test_torch_lm_families.py``'s, and the full configs'
sizes here cover every architecture.
Random draws on the JAX side are scoped to
``jax.threefry_partitionable(False)``, the scheme the port reproduces.
Tolerances, stated once:

* ``loss_fn``: relative 1e-5; grads: within 1e-4 of the leaf's largest
  |grad| (float32 sums in another order);
* one train step (AdamW, Adafactor, int8 error feedback): every state leaf
  within 1e-5 absolute and relative, a bfloat16 leaf within one bfloat16
  ulp, and a param whose AdamW first update is ill-conditioned (|grad|
  under 1e-6) within the update's range (``_close_adamw``);
* prefill and decode logits: within 1e-4 of the reference's; decode
  against a full forward within the reference test's 2e-2;
* ``gqa_attention``: chunked against full within 1e-5, and each within
  1e-5 of the reference;
* ``SyntheticTokens`` and token batches: exactly equal; ``initialize``
  and ``threefry.normal``: the uniform bits exact, values within 4
  float32 ulps (``erf_inv``'s ``log1p``/``sqrt`` are PyTorch's), bfloat16
  leaves within one bfloat16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import spec as jspec
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.runtime import train_lib as jtl
from repro_torch import convert
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.core import threefry
from repro_torch.data import SyntheticTokens, batch_for_model
from repro_torch.models import build_model, common, spec
from repro_torch.models.spec import ParamSpec, tree_leaves
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               compression, cosine_schedule)
from repro_torch.runtime import train_lib

DENSE = sorted(a for a, c in ARCHS.items() if c.family in ("dense", "vlm"))
TRAIN = (32, 2)            # seq, batch of the train steps


def _nf():
    return jax.threefry_partitionable(False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return convert.state_from_jax(_np(tree), "cpu")


def _close(jax_tree, port_tree, rtol, atol, what):
    """Leaf by leaf; a bfloat16 leaf also within one bfloat16 ulp (a
    float32 value 1e-6 away can round to the neighbouring bfloat16)."""
    jl = jax.tree.leaves(jax_tree)
    pl = tree_leaves(port_tree)
    assert len(jl) == len(pl), what
    for i, (a, b) in enumerate(zip(jl, pl)):
        bf16 = b.dtype == torch.bfloat16
        np.testing.assert_allclose(
            convert.state_to_numpy(b), np.asarray(a, np.float32),
            rtol=max(rtol, 2.0 ** -8) if bf16 else rtol, atol=atol,
            err_msg=f"{what}: leaf {i}")


def _close_adamw(jnext, tnext, what, lr=3e-4):
    """A state after one AdamW step: every leaf within 1e-5, except that
    AdamW's first update of a param is g / (|g| + 1e-8), whose slope
    1e-8 / (|g| + 1e-8)^2 turns a float32 rounding of a grad below 1e-6
    into a change of order 1: there the param is held to the update's
    range, 2 lr. The first moment (1 - b1) g says where."""
    _close({k: v for k, v in jnext.items() if k != "params"},
           {k: v for k, v in tnext.items() if k != "params"},
           1e-5, 1e-5, what)
    moments = jax.tree.leaves(jnext["opt"])[0::2]      # m, v per param
    for i, (a, m, b) in enumerate(zip(jax.tree.leaves(jnext["params"]),
                                      moments,
                                      tree_leaves(tnext["params"]))):
        a = np.asarray(a, np.float32)
        ill = np.abs(np.asarray(m)) / 0.1 < 1e-6
        tol = np.where(ill, 2 * lr, 1e-5 + 1e-5 * np.abs(a))
        err = np.abs(convert.state_to_numpy(b) - a)
        assert (err <= tol).all(), (what, i, float(err.max()),
                                    int(ill.sum()))


def _models(arch, **kw):
    return (jbuild(JARCHS[arch].reduced().replace(**kw)),
            build_model(ARCHS[arch].reduced().replace(**kw)))


def _train_batch(jmodel, seed=1):
    with _nf():
        b = jsyn.batch_for_model(jmodel, JShape("t", TRAIN[0], TRAIN[1],
                                                "train"), 0, seed)
    return b, convert.state_from_jax(_np(b), "cpu")


def _init(jmodel, **kw):
    with _nf():
        return jtl.init_state(jmodel, jax.random.PRNGKey(0), **kw)


# ------------------------------ the model --------------------------------- #

@pytest.mark.parametrize("arch", DENSE)
def test_loss_grads_and_adamw_step_match_reference(arch):
    jm, tm = _models(arch)
    state = _init(jm)
    if jm.cfg.qkv_bias:              # biases start at zero: give them grads
        state["params"]["layers"]["attn"]["bq"] += 0.05
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
    tg = torch.autograd.grad(tl, tree_leaves(live))
    tl = tl.detach()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmets["ce"]), float(jmets["ce"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tg):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())

    tnext, tmet = train_lib.make_train_step(tm)(tstate, tb)
    assert int(tnext["step"]) == 1
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    _close_adamw(jnext, tnext, f"{arch} AdamW step")
    # the step leaves its argument as it was
    _close(state, tstate, 0, 0, f"{arch} state before the step")


@pytest.mark.parametrize("arch", ["granite-3-8b", "pixtral-12b"])
def test_adafactor_step_matches_reference(arch):
    jm, tm = _models(arch, optimizer="adafactor")
    state = _init(jm)
    jb, tb = _train_batch(jm, seed=2)
    sched_j = jopt.cosine_schedule(1e-3, warmup=2, total=10)
    sched_t = cosine_schedule(1e-3, warmup=2, total=10)
    jstep = jax.jit(jtl.make_train_step(jm, schedule=sched_j))
    tstep = train_lib.make_train_step(tm, schedule=sched_t)
    j1, _ = jstep(state, jb)
    j2, jmet = jstep(j1, jb)
    t1, _ = tstep(_to_port(state), tb)
    t2, tmet = tstep(t1, tb)
    assert set(t2["opt"]["layers"]["mlp"]["wi"]) == {"vr", "vc"}
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    _close(j2, t2, 1e-5, 1e-5, f"{arch} Adafactor, two steps")


def test_compressed_steps_match_reference_and_carry_residuals():
    """int8 error feedback inside the train step (the reference's
    ``test_train_step_ef_state_persists_across_steps`` on yi-9b): the
    first step equals the reference's; the residuals accumulate and evolve
    over a second step, whose loss equals the reference's. The second
    state is not compared element by element: a grad 1e-7 away from the
    reference's can round to the other int8 level at a .5 boundary, which
    moves that residual by a whole quantum."""
    jm, tm = _models("yi-9b")
    state = _init(jm, compress=True)
    jb, tb = _train_batch(jm, seed=3)
    jstep = jax.jit(jtl.make_train_step(jm, compress=True))
    tstep = train_lib.make_train_step(tm, compress=True)
    j1, _ = jstep(state, jb)
    _, jmet2 = jstep(j1, jb)
    t1, _ = tstep(_to_port(state), tb)
    t2, tmet2 = tstep(t1, tb)
    _close_adamw(j1, t1, "compressed step 1")
    ef1 = tree_leaves(t1["ef"])[0].float().abs().sum()
    ef2 = tree_leaves(t2["ef"])[0].float().abs().sum()
    assert float(ef1) > 0.0 and float(ef1) != float(ef2)
    np.testing.assert_allclose(float(tmet2["loss"]), float(jmet2["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    jm, tm = _models(arch)
    with _nf():
        params = jm.init(jax.random.PRNGKey(0))
        pre = jm.concrete_inputs(JShape("p", 13, 2, "prefill"),
                                 jax.random.PRNGKey(0))
    t, prefix = 12, jm.cfg.vlm_prefix      # pixtral's images come first
    jlt, jcache = jm.prefill(params, dict(pre, tokens=pre["tokens"][:, :t]),
                             max_len=prefix + t + 4)
    jls, _ = jm.decode_step(params, jcache, pre["tokens"][:, t])

    tp = convert.params_from_jax(_np(params), "cpu")
    tpre = convert.state_from_jax(_np(pre), "cpu")
    prefill = train_lib.make_prefill_step(tm, prefix + t + 4)
    decode = train_lib.make_decode_step(tm)
    tlt, tcache = prefill(tp, dict(tpre, tokens=tpre["tokens"][:, :t]))
    assert int(tcache["len"]) == prefix + t
    assert tcache["k"].shape[2] == prefix + t + 4
    tls, tcache2 = decode(tp, tcache, {"tokens": tpre["tokens"][:, t]})
    assert int(tcache2["len"]) == prefix + t + 1
    tfull, _ = prefill(tp, tpre)
    np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tls.numpy(), tfull.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_decode_chunked_cache_and_vocab_padding():
    """A cache longer than ``attn_chunk`` takes the kv-chunked branch in
    decode, and the padded vocab columns are masked."""
    jm, tm = _models("granite-3-8b", vocab=100, attn_chunk=8)
    assert tm.cfg.vocab_padded == 256
    with _nf():
        params = jm.init(jax.random.PRNGKey(4))
        pre = jm.concrete_inputs(JShape("p", 20, 1, "prefill"),
                                 jax.random.PRNGKey(4))
    tp = convert.params_from_jax(_np(params), "cpu")
    tpre = convert.state_from_jax(_np(pre), "cpu")
    jlt, jc = jm.prefill(params, dict(pre, tokens=pre["tokens"][:, :19]),
                         max_len=24)
    jls, _ = jm.decode_step(params, jc, pre["tokens"][:, 19])
    with torch.no_grad():
        tlt, tc = tm.prefill(tp, dict(tpre, tokens=tpre["tokens"][:, :19]),
                             max_len=24)
        tls, _ = tm.decode_step(tp, tc, tpre["tokens"][:, 19])
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)
    assert np.all(tlt.numpy()[..., 100:] <= -1e29)


@pytest.mark.parametrize("chunk", [0, 8])
def test_gqa_attention_matches_reference_and_full(chunk):
    """Both branches of ``gqa_attention`` (full; kv-chunked online softmax
    with per-chunk recompute) against the reference's, the chunked one
    against the full one (values and grads), and decode's ``kv_len``
    masking against a truncated cache."""
    rs = np.random.default_rng(0)
    b, s, h, kv, hd = 2, 30, 8, 4, 16
    q, k, v = (rs.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    def jattn(q_, k_, v_):
        return jcommon.gqa_attention(q_, k_, v_, causal=True, chunk=chunk)
    want = jax.jit(jattn)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = common.gqa_attention(tq, tk, tv, causal=True, chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    full = common.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True, chunk=0)
    np.testing.assert_allclose(got.detach().numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    w = torch.from_numpy(rs.standard_normal(got.shape).astype(np.float32))
    grads = torch.autograd.grad((got * w).sum(), (tq, tk, tv))
    jgrads = jax.jit(jax.grad(lambda q_, k_, v_: jnp.sum(
        jattn(q_, k_, v_) * w.numpy()), argnums=(0, 1, 2)))(q, k, v)
    for a, bb in zip(jgrads, grads):
        np.testing.assert_allclose(bb.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    kl = 20
    dec = common.gqa_attention(tq[:, :1].detach(), tk.detach(), tv.detach(),
                               causal=False, q_offset=kl - 1,
                               kv_len=torch.tensor(kl), chunk=chunk)
    ref = common.gqa_attention(tq[:, :1].detach(), tk[:, :kl].detach(),
                               tv[:, :kl].detach(), causal=False, chunk=0)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rotary_and_rmsnorm_match_reference():
    rs = np.random.default_rng(1)
    x = rs.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5) + 7
    np.testing.assert_allclose(
        common.rotary(torch.from_numpy(x), torch.from_numpy(pos),
                      1e6).numpy(),
        np.asarray(jcommon.rotary(x, pos, 1e6)), rtol=1e-5, atol=1e-5)
    sc = rs.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(sc)})
        .numpy(),
        np.asarray(jcommon.rmsnorm(x, {"scale": sc})), rtol=1e-5, atol=1e-6)


# ------------------------------ parameters -------------------------------- #

def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_threefry_normal_matches_reference(n, monkeypatch):
    """Uniform bits exact; normals within 4 float32 ulps, drawn whole and
    in slices of 3 counter pairs (the pairing i <-> i + ceil(n/2))."""
    with _nf():
        key = jax.random.fold_in(jax.random.PRNGKey(9), n)
        want = np.asarray(jax.random.normal(key, (n,), jnp.float32))
        lo = np.nextafter(np.float32(-1), np.float32(0))
        uni = np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, 1.0))
    tkey = convert.key_from_jax(jax.random.key_data(key))
    got_uni = threefry._to_unit_float(threefry.random_bits(tkey, (n,)),
                                      threefry._NORMAL_LO, 1.0)
    np.testing.assert_array_equal(got_uni.numpy(), uni)
    whole = threefry.normal(tkey, (n,)).numpy()
    monkeypatch.setattr(threefry, "_NORMAL_SLICE", 3)
    sliced = threefry.normal(tkey, (n,)).numpy()
    np.testing.assert_array_equal(whole, sliced)
    assert _ulps(whole, want) <= 4


def test_initialize_matches_reference(monkeypatch):
    """``initialize`` of a reduced model, of odd-sized and bfloat16 leaves,
    drawn in slices: zeros and ones exact, normals within 4 float32 ulps,
    bfloat16 within one bfloat16 ulp."""
    monkeypatch.setattr(threefry, "_NORMAL_SLICE", 50)
    jm, tm = _models("qwen1.5-32b")
    tree = {"m": tm.param_specs,
            "odd": ParamSpec((3, 5, 7), ("layers", "embed", "ffn"),
                             scale=2.0),
            "half": ParamSpec((9, 33), ("embed", "ffn"), dtype="bfloat16")}
    jtree = {"m": jm.param_specs,
             "odd": jspec.ParamSpec((3, 5, 7), ("layers", "embed", "ffn"),
                                    scale=2.0),
             "half": jspec.ParamSpec((9, 33), ("embed", "ffn"),
                                     dtype="bfloat16")}
    with _nf():
        want = jspec.initialize(jtree, jax.random.PRNGKey(5))
    got = spec.initialize(tree, threefry.PRNGKey(5), "cpu")
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        a = np.asarray(a)
        if b.dtype == torch.bfloat16:
            wa = a.astype(np.float32).view(np.int32) >> 16
            wb = b.view(torch.int16).numpy().astype(np.int32)
            assert np.abs(wa - wb).max() <= 1
        else:
            assert b.dtype == torch.float32 and _ulps(a, b.numpy()) <= 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_shapes_of_full_configs(arch):
    """Full (unreduced) configs: counts, bytes and shapes equal the
    reference's, on the ``meta`` device (nothing allocated)."""
    jm, tm = jbuild(JARCHS[arch]), build_model(ARCHS[arch])
    assert tm.n_params() == jm.n_params()
    assert spec.param_bytes(tm.param_specs) == jspec.param_bytes(
        jm.param_specs)
    ab = tree_leaves(tm.abstract_params())
    assert all(t.device.type == "meta" for t in ab)
    assert [tuple(t.shape) for t in ab] == [
        tuple(s.shape) for s in jax.tree.leaves(jm.abstract_params())]
    cache = tree_leaves(tm.abstract_cache(2, 64))
    assert [tuple(t.shape) for t in cache] == [
        tuple(s.shape) for s in jax.tree.leaves(jm.abstract_cache(2, 64))]


def test_granite_full_width_size():
    """The chip's cell: granite-3-8b at full width with 8 of its 40
    layers holds about 2.0 B parameters."""
    m = build_model(ARCHS["granite-3-8b"].replace(n_layers=8))
    assert m.cfg.vocab_padded == 49408
    assert 1.9e9 < m.n_params() < 2.1e9


def test_concrete_inputs_match_reference():
    """``hash(name)`` folds each input's key, as the reference's: equal in
    one process. Tokens exact, image embeddings within 4 ulps."""
    jm, tm = _models("pixtral-12b")
    for kind, seq in (("train", 16), ("prefill", 16), ("decode", 16)):
        with _nf():
            want = jm.concrete_inputs(JShape("c", seq, 2, kind),
                                      jax.random.PRNGKey(6))
        got = tm.concrete_inputs(ShapeConfig("c", seq, 2, kind),
                                 threefry.PRNGKey(6), device="cpu")
        assert set(got) == set(want)
        for name, a in want.items():
            a = np.asarray(a)
            b = got[name].numpy()
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, a)
            else:
                assert _ulps(a, b) <= 4


# ------------------------------- the data --------------------------------- #

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (128, 64, 4, 3, 17), (37, 50, 3, 2, 5), (49155, 8, 2, 0, 0),
    (1000, 100, 1, 7, 123456)])
def test_synthetic_tokens_equal_reference(vocab, seq, batch, seed, step):
    with _nf():
        want = jsyn.SyntheticTokens(vocab, seq, batch, seed).batch_at(step)
    got = SyntheticTokens(vocab, seq, batch, seed,
                          device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch,kind", [("granite-3-8b", "train"),
                                       ("pixtral-12b", "train"),
                                       ("yi-9b", "prefill"),
                                       ("minitron-4b", "decode")])
def test_batch_for_model_equals_reference(arch, kind):
    jm, tm = _models(arch)
    with _nf():
        want = jsyn.batch_for_model(jm, JShape("t", 16, 2, kind), 4, 1)
    got = batch_for_model(tm, ShapeConfig("t", 16, 2, kind), 4, 1,
                          device="cpu")
    assert set(got) == set(want)
    for name, a in want.items():
        a = np.asarray(a)
        assert tuple(got[name].shape) == a.shape
        if a.dtype == np.int32:
            np.testing.assert_array_equal(got[name].numpy(), a)
        else:
            assert _ulps(a, got[name].numpy()) <= 4


def test_synthetic_stream_properties():
    """The reference's ``tests/test_data.py`` on the port: deterministic
    per step, labels are the next tokens, periodic structure present."""
    st = SyntheticTokens(vocab=1024, seq_len=64, batch=8, seed=1,
                         structure=1.0, device="cpu")
    a, b = st.batch_at(17), st.batch_at(17)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], st.batch_at(18)["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    p = SyntheticTokens.PERIOD
    t = a["tokens"].numpy()
    np.testing.assert_array_equal(t[:, p:], t[:, :-p])
    t0 = SyntheticTokens(1024, 64, 8, seed=1, structure=0.0,
                         device="cpu").batch_at(0)["tokens"].numpy()
    assert (t0[:, p:] == t0[:, :-p]).mean() < 0.05
    first = next(iter(st))
    assert torch.equal(first["tokens"], st.batch_at(0)["tokens"])


# ------------------------------ optimizers -------------------------------- #

def _rand_tree(seed, shapes):
    rs = np.random.default_rng(seed)
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_apply_matches_reference(name):
    """``apply`` on leaves of 1, 2 and 3 (stacked, per-layer) dims, at
    step 3, against the reference's."""
    shapes = {"b": (8,), "w": (4, 8), "s": (3, 4, 8)}
    jo = jopt.adamw() if name == "adamw" else jopt.adafactor()
    to = adamw() if name == "adamw" else adafactor()
    specs = {k: ParamSpec(s, (None,) * len(s)) for k, s in shapes.items()}
    jspecs = {k: jspec.ParamSpec(s, (None,) * len(s))
              for k, s in shapes.items()}
    params, grads = _rand_tree(0, shapes), _rand_tree(1, shapes)
    st_specs = jo.state_specs(jspecs)
    state = jax.tree.map(lambda s: np.abs(np.random.default_rng(2)
                                          .standard_normal(s.shape))
                         .astype(np.float32) * 0.01,
                         st_specs, is_leaf=jspec.is_spec)
    assert jax.tree.structure(st_specs, is_leaf=jspec.is_spec) == \
        jax.tree.structure(to.state_specs(specs), is_leaf=spec.is_spec)
    jp, js = jo.apply(params, grads, state, jnp.float32(0.01),
                      jnp.int32(3))
    tp, ts = to.apply(_to_port(params), _to_port(grads), _to_port(state),
                      torch.tensor(0.01), torch.tensor(3, dtype=torch.int32))
    _close(jp, tp, 1e-5, 1e-6, f"{name} params")
    _close(js, ts, 1e-5, 1e-7, f"{name} state")


def test_adamw_first_step_by_hand():
    opt = adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    specs = {"a": {"w": ParamSpec((4, 8), ("embed", "ffn"))},
             "b": ParamSpec((8,), (None,), init="zeros")}
    params = spec.initialize(specs, threefry.PRNGKey(0), "cpu")
    state = spec.initialize(opt.state_specs(specs), threefry.PRNGKey(1),
                            "cpu")
    grads = spec.tree_map(lambda p: torch.ones_like(p) * 0.5, params)
    new_p, new_s = opt.apply(params, grads, state, torch.tensor(0.1),
                             torch.tensor(0, dtype=torch.int32))
    np.testing.assert_allclose(new_p["a"]["w"].numpy(),
                               params["a"]["w"].numpy() - 0.1, atol=1e-5)
    np.testing.assert_allclose(new_s["a"]["w"]["m"].numpy(), 0.05,
                               atol=1e-7)


def test_adafactor_descends_quadratic_and_is_factored():
    opt = adafactor()
    specs = {"w": ParamSpec((8, 8), ("embed", "ffn"))}
    st_specs = opt.state_specs({"w": ParamSpec((64, 128),
                                               ("embed", "ffn"))})
    assert st_specs["w"]["vr"].shape == (64,)
    assert st_specs["w"]["vc"].shape == (128,)
    params = spec.initialize(specs, threefry.PRNGKey(0), "cpu")
    state = spec.initialize(opt.state_specs(specs), threefry.PRNGKey(1),
                            "cpu")
    target = spec.initialize(specs, threefry.PRNGKey(5), "cpu")["w"]
    l0 = float(((params["w"] - target) ** 2).sum())
    for step in range(50):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = opt.apply(params, grads, state, torch.tensor(0.05),
                                  torch.tensor(step, dtype=torch.int32))
    assert float(((params["w"] - target) ** 2).sum()) < 0.2 * l0


def test_global_norm_clip_and_cosine_schedule():
    clipped, norm = clip_by_global_norm({"a": torch.ones(3) * 4.0}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(48), rel=1e-6)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.ones(3) * 0.1}, 1.0)
    np.testing.assert_allclose(same["a"].numpy(), 0.1, atol=1e-7)
    half = torch.ones(3, dtype=torch.bfloat16) * 4
    assert clip_by_global_norm({"h": half}, 1.0)[0]["h"].dtype == \
        torch.bfloat16
    sch, jsch = cosine_schedule(1e-3, warmup=10, total=100), \
        jopt.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (0, 3, 10, 55, 99, 100, 140):
        got = float(sch(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(float(jsch(jnp.int32(s))), rel=1e-6)


def test_compression_matches_reference():
    rs = np.random.default_rng(3)
    grads = {"a": {"w": (rs.standard_normal((16, 64)) * 3)
                   .astype(np.float32)},
             "b": rs.standard_normal(5).astype(np.float32)}
    ef = jax.tree.map(lambda g: (rs.standard_normal(g.shape) * 1e-3)
                      .astype(np.float32), grads)
    jef = jax.tree.map(lambda e: jnp.asarray(e, jnp.bfloat16), ef)
    jg, je = jcomp.compress_grads(grads, jef)
    tg, te = compression.compress_grads(
        _to_port(grads), spec.tree_map(lambda e: e.to(torch.bfloat16),
                                       _to_port(ef)))
    _close(jg, tg, 1e-6, 1e-7, "compressed grads")
    for a, b in zip(jax.tree.leaves(je), tree_leaves(te)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    q, scale = compression.quantize_int8(torch.from_numpy(grads["a"]["w"]))
    jq, jscale = jcomp.quantize_int8(grads["a"]["w"])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert compression.wire_bytes({"w": ParamSpec((4, 8), (None, None))}) \
        == (128, 32)


def test_state_specs_and_abstract_state():
    _, tm = _models("granite-3-8b")
    specs = train_lib.state_specs(tm, compress=True)
    assert set(specs) == {"params", "opt", "step", "ef"}
    ab = train_lib.abstract_state(tm, compress=True)
    assert ab["ef"]["unembed"].dtype == torch.bfloat16
    assert ab["step"].shape == () and ab["step"].dtype == torch.int32
    st = train_lib.init_state(tm, threefry.PRNGKey(0), device="cpu")
    assert int(st["step"]) == 0 and dataclasses.is_dataclass(tm.cfg)
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(st["opt"]))
