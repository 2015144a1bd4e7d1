"""State-space (Mamba) blocks (port of ``repro.models.ssm``).

Mamba-1 (falcon-mamba-7b): a selective scan over a diagonal SSM, computed
chunk by chunk: a log-depth (Hillis-Steele) scan within a chunk, a loop
across chunks. PyTorch has no associative scan, so the within-chunk scan
is plain tensor operations over the chunk axis; it rounds differently from
XLA's scan tree, so the port holds it to the reference within float32
tolerance, not bit for bit.
Mamba-2 (zamba2-7b): the SSD dual form, a scalar decay per head, chunked
into matrix products.

Both give single-token decode recurrences for serving.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.ctx import whole_along
from .common import silu
from .spec import ParamSpec


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    linear cut-off above a threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _chunk_size(s: int, chunk: int) -> int:
    """The reference's chunk for a sequence of ``s``: halved until it
    divides ``s``."""
    while s % chunk:
        chunk //= 2
    return chunk


# ------------------------------- mamba-1 --------------------------------- #

def mamba1_specs(cfg) -> dict:
    d, di, n, cv = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = max(1, d // 16)
    dt = cfg.param_dtype
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner2"), dtype=dt),
        "conv_w": ParamSpec((cv, di), ("conv", "inner"), dtype=dt),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros", dtype=dt),
        "x_dbc": ParamSpec((di, dtr + 2 * n), ("inner", "dbc"), dtype=dt),
        "dt_proj": ParamSpec((dtr, di), ("dt_rank", "inner"), dtype=dt),
        "dt_bias": ParamSpec((di,), ("inner",), init="zeros", dtype=dt),
        "a_log": ParamSpec((di, n), ("inner", "state"), init="ones",
                           dtype="float32"),
        "d_skip": ParamSpec((di,), ("inner",), init="ones", dtype="float32"),
        "out_proj": ParamSpec((di, d), ("inner", "embed"), dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,di), w: (cv,di). state: (B,cv-1,di)."""
    cv = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cv - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(cv))
    return out + b.to(x.dtype)


def _new_conv_state(x: torch.Tensor, state, cv: int) -> torch.Tensor:
    """The last ``cv - 1`` inputs of the conv, the state's before ``x``."""
    b, _, c = x.shape
    prev = (state.to(x.dtype) if state is not None else
            x.new_zeros((b, cv - 1, c)))
    return torch.cat([prev, x], dim=1)[:, -(cv - 1):, :]


def _scan_chunk(a: torch.Tensor, u: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``combine((al, ul), (ar, ur)) = (al ar, ul ar +
    ur)`` along axis 1 (Hillis-Steele: log2(Q) levels; each shifts a and u
    by the level's offset along the axis, a padded with ones and u with
    zeros, then one fused multiply-add and one product). a, u: (B, Q,
    ...)."""
    q = a.shape[1]
    pad = [0, 0] * (a.dim() - 2)
    d = 1
    while d < q:
        u = torch.addcmul(u, F.pad(u, pad + [d, -d]), a)
        a = a * F.pad(a, pad + [d, -d], value=1.0)
        d *= 2
    return a, u


def _ssm_scan_chunked(a: torch.Tensor, bu: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bu_t, diagonal. a, bu: (B, S, di, n) f32.
    Returns (h over all t, final h). Chunked: the scan within a chunk, a
    loop across chunks. (The spec path: it materialises the full
    (B,S,di,n) state; the layer uses the fused form below.)"""
    s = a.shape[1]
    chunk = _chunk_size(s, chunk)
    h, outs = h0, []
    for c0 in range(0, s, chunk):
        aa, uu = _scan_chunk(a[:, c0:c0 + chunk], bu[:, c0:c0 + chunk])
        h_all = torch.addcmul(uu, aa, h[:, None])
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def _fused_step(h, xq, dtq, bq, cq, a):
    """One chunk of the fused scan: (h at its end, y of its steps)."""
    da = torch.exp(dtq[..., None] * a)                  # (B,Q,di,n)
    bu = (dtq * xq)[..., None] * bq[:, :, None, :]
    aa, uu = _scan_chunk(da, bu)
    hq = torch.addcmul(uu, aa, h[:, None])              # (B,Q,di,n)
    yq = torch.einsum("bqdn,bqn->bqd", hq, cq)
    return hq[:, -1], yq


def _ssm_scan_fused(xc: torch.Tensor, dt: torch.Tensor, b_ssm: torch.Tensor,
                    c_ssm: torch.Tensor, a: torch.Tensor,
                    d_skip: torch.Tensor, h0: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan: y_t = C_t · h_t + D x_t with
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, without a (B, S, di, n)
    tensor: the (B, Q, di, n) decay and input products live only inside
    each chunk's step, which runs under ``torch.utils.checkpoint`` when
    grads are on (the reference's ``jax.checkpoint``: the backward pass
    recomputes a chunk instead of saving its state).

    xc, dt: (B, S, di) f32;  b_ssm, c_ssm: (B, S, n) f32;  a: (di, n);
    h0: (B, di, n). Returns (y (B, S, di) f32, h_last).
    """
    s = xc.shape[1]
    chunk = _chunk_size(s, chunk)
    remat = torch.is_grad_enabled()
    h, ys = h0, []
    for c0 in range(0, s, chunk):
        xs = (xc[:, c0:c0 + chunk], dt[:, c0:c0 + chunk],
              b_ssm[:, c0:c0 + chunk], c_ssm[:, c0:c0 + chunk])
        if remat:
            h, yq = checkpoint(_fused_step, h, *xs, a, use_reentrant=False)
        else:
            h, yq = _fused_step(h, *xs, a)
        ys.append(yq)
    return torch.cat(ys, dim=1) + xc * d_skip, h


def mamba1_forward(p: dict, x: torch.Tensor, cfg,
                   state: Dict[str, torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d). Returns (y, new_state). state carries conv + ssm for
    decode; pass None for training (zero init, state returned anyway)."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    dtr = max(1, cfg.d_model // 16)
    ct = x.dtype
    x = whole_along(x, 1)      # on a mesh: the chunk loop's slices local

    xz = x @ p["in_proj"].to(ct)
    xi, z = torch.split(xz, di, dim=-1)

    conv_state = None if state is None else state["conv"]
    xc = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    new_conv = _new_conv_state(xi, conv_state, cfg.ssm_conv)
    xc = silu(xc)

    dbc = xc @ p["x_dbc"].to(ct)
    dt_r, b_ssm, c_ssm = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"].to(ct)
                  + p["dt_bias"].to(ct)).float()
    a = -torch.exp(p["a_log"])                          # (di, n), negative

    h0 = (x.new_zeros((bsz, di, n), dtype=torch.float32) if state is None
          else state["ssm"])
    y, h_last = _ssm_scan_fused(
        xc.float(), dt, b_ssm.float(), c_ssm.float(), a, p["d_skip"], h0,
        cfg.ssm_chunk)
    y = y.to(ct) * silu(z)
    out = y @ p["out_proj"].to(ct)
    return out, {"conv": new_conv, "ssm": h_last}


# ------------------------------- mamba-2 --------------------------------- #

def mamba2_specs(cfg) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    cv = cfg.ssm_conv
    dt = cfg.param_dtype
    d_conv_in = di + 2 * n                      # x, B, C share the conv
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * n + nh),
                             ("embed", "inner_zxbcdt"), dtype=dt),
        "conv_w": ParamSpec((cv, d_conv_in), ("conv", "inner"), dtype=dt),
        "conv_b": ParamSpec((d_conv_in,), ("inner",), init="zeros", dtype=dt),
        "a_log": ParamSpec((nh,), ("heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((nh,), ("heads",), init="zeros",
                             dtype="float32"),
        "d_skip": ParamSpec((nh,), ("heads",), init="ones", dtype="float32"),
        "norm_scale": ParamSpec((di,), ("inner",), init="ones", dtype=dt),
        "out_proj": ParamSpec((di, d), ("inner", "embed"), dtype=dt),
    }


def _segsum_decay(log_a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(sum_{j<t<=i} log_a_t) for j <= i else 0.
    log_a: (..., Q). Returns (..., Q, Q).

    Departs from the reference's formulation, not from its values: the
    reference takes ``exp`` of the whole (Q, Q) square of cumulative-sum
    differences and masks the upper triangle afterwards. Above the
    diagonal the differences are positive and overflow ``exp`` at long
    chunks (about 240 over zamba2-7b's 128 steps), and the backward pass
    then multiplies the mask's zero by inf: every gradient through the SSD
    is NaN. Here the differences are masked to -inf before ``exp``, so the
    lower triangle is the same float32 value and the gradient is finite.
    """
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., i, j)
    mask = torch.ones((q, q), dtype=torch.bool, device=log_a.device).tril()
    return torch.exp(torch.where(mask, diff, -torch.inf))


def mamba2_forward(p: dict, x: torch.Tensor, cfg,
                   state: Dict[str, torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSD chunked form. x: (B,S,d) -> (y, state). Each of the reference's
    three-operand products is contracted pairwise so that no (b, c, h, i,
    j, p) tensor appears: the largest intermediate is (B, nc, nh, Q, Q)."""
    bsz, s, _ = x.shape
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ph = di // nh                                      # head dim
    ct = x.dtype
    x = whole_along(x, 1)      # on a mesh: the chunk loop's indexing local

    proj = x @ p["in_proj"].to(ct)
    z, xbc, dt_in = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc_c = silu(_causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state))
    new_conv = _new_conv_state(xbc, conv_state, cfg.ssm_conv)
    xi, b_ssm, c_ssm = torch.split(xbc_c, [di, n, n], dim=-1)

    dt = softplus(dt_in.float() + p["dt_bias"])       # (B,S,nh)
    a = -torch.exp(p["a_log"])                         # (nh,)
    log_da = dt * a                                    # (B,S,nh) negative
    xh = xi.reshape(bsz, s, nh, ph).float()
    bf = b_ssm.float()                                 # (B,S,n)
    cf = c_ssm.float()
    dtx = xh * dt[..., None]                           # dt-weighted input

    q = _chunk_size(s, cfg.ssm_chunk)
    nc = s // q

    la = log_da.reshape(bsz, nc, q, nh)
    xq = dtx.reshape(bsz, nc, q, nh, ph)
    bq = bf.reshape(bsz, nc, q, n)
    cq = cf.reshape(bsz, nc, q, n)

    # intra-chunk: Y = (C B^T ∘ L) X
    lmat = _segsum_decay(la.transpose(2, 3))           # (B,nc,nh,Q,Q)
    cb = torch.einsum("bcin,bcjn->bcij", cq, bq)       # (B,nc,Q,Q)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", lmat * cb[:, :, None], xq)

    # chunk states: S_c = sum_j decay_to_end_j * B_j X_j^T  (B,nc,nh,n,p)
    cum = torch.cumsum(la, dim=2)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,nh)
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", bq,
                           decay_end[..., None] * xq)

    # inter-chunk recurrence over c: H_{c} = decay_chunk_c * H_{c-1} + S_c
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (B,nc,nh)
    h = (x.new_zeros((bsz, nh, n, ph), dtype=torch.float32)
         if state is None else state["ssm"])
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # (B,nc,nh,n,p)

    # inter-chunk output: C_t decay_from_start_t H_{c-1}
    decay_start = torch.exp(cum)                       # (B,nc,Q,nh)
    y_inter = (torch.einsum("bcin,bchnp->bcihp", cq, h_prevs)
               * decay_start[..., None])

    y = (y_intra + y_inter).reshape(bsz, s, nh, ph)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(ct)
    # gated RMSNorm (mamba2)
    yf = y.float() * silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()
    out = yf.to(ct) @ p["out_proj"].to(ct)
    return out, {"conv": new_conv, "ssm": h}
