"""State-space and recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

Port of ``repro.models.ssm``. Mamba2 and mLSTM are both scalar-decay
gated linear recurrences on a matrix state,

    H_t = a_t · H_{t-1} + k_t v_tᵀ,      y_t = q_tᵀ H_t,

evaluated on the prefill by :func:`chunked_gla` in chunks (a quadratic
product inside each chunk, the state carried across chunks) with
batched matmuls, or by the CUDA kernel K4
(:func:`repro_torch.kernels.ssm_scan.gla_scan`), and one decode step at
a time by :func:`gla_step`. The same switch that sends attention through
K3 sends the prefill's scan through K4 (``use_kernel``, from
``cfg.use_flash``): the JAX package's blocks call ``chunked_gla`` and
drop its final state, which K4 does not return. K4 has no backward, in
the JAX package as here, so a kernel prefill that needs gradients
raises. The recurrence runs in f32 with the decays in log space.

One difference from the JAX package: inside a chunk the upper triangle of
the decay-weighted scores is dropped by a select, as the TPU kernel
does. The JAX ``chunked_gla`` multiplies by a 0/1 mask instead, and the
``exp(la_t − la_s)`` of that triangle overflows to inf for small decays
(a ≈ 1e-6), so ``inf · 0`` gives NaN there (ROADMAP, caveat R4); the
JAX Mamba2 and mLSTM blocks inherit it, the port's do not.

sLSTM has a hidden-to-hidden recurrent matrix, so it runs as a Python
loop over time with an f32 carry, where the JAX package runs
``lax.scan``; its input projection is one product over the whole
sequence before the loop. The decode steps write the blocks' states in
place (``copy_``), as the attention decode writes its cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.common import apply_norm, dense, dense_init, norm_init

_LOG_EPS = 1e-12


def chunked_gla(a, k, v, q, h0=None, chunk: int = 64):
    """Chunked gated linear recurrence.

    a: (B, S, H) decay in (0, 1]; k, q: (B, S, H, Dk); v: (B, S, H, Dv);
    h0: (B, H, Dk, Dv) or None for zeros. Returns y (B, S, H, Dv) f32 and
    the final state (B, H, Dk, Dv) f32.
    """
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    a, k, v, q = (x.to(torch.float32) for x in (a, k, v, q))
    pad = (-s) % chunk
    if pad:  # identity steps: a = 1, k = v = q = 0
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        k, v, q = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v, q))
    nc = (s + pad) // chunk
    resh = lambda x: x.reshape((b, nc, chunk) + x.shape[2:])
    k_c, v_c, q_c = resh(k), resh(v), resh(q)
    la = torch.cumsum(torch.log(resh(a).clamp_min(_LOG_EPS)), dim=2)  # (B,nc,c,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=a.device).tril()
    tri = tri[None, :, :, None]

    hstate = (torch.zeros(b, h, dk, dv, dtype=torch.float32, device=a.device)
              if h0 is None else h0.to(torch.float32))
    ys = []
    for i in range(nc):
        la_i, k_i, v_i, q_i = la[:, i], k_c[:, i], v_c[:, i], q_c[:, i]
        # inter-chunk: y += decay(start→t) · qᵀ H_prev
        y_inter = torch.einsum("bthd,bhdv->bthv",
                               q_i * torch.exp(la_i)[..., None], hstate)
        # intra-chunk, causal by select (quadratic in `chunk` only)
        ratio = torch.exp(la_i[:, :, None, :] - la_i[:, None, :, :])  # (B,t,s,H)
        scores = torch.einsum("bthd,bshd->btsh", q_i, k_i)
        scores = torch.where(tri, scores * ratio, 0.0)
        y_intra = torch.einsum("btsh,bshv->bthv", scores, v_i)
        # carry: H ← decay(chunk)·H + Σ_s decay(s→end)·k_s v_sᵀ
        dec_end = torch.exp(la_i[:, -1:, :] - la_i)  # (B,c,H)
        hstate = (torch.exp(la_i[:, -1])[..., None, None] * hstate
                  + torch.einsum("bshd,bshv->bhdv", k_i * dec_end[..., None], v_i))
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, dv)[:, :s]
    return y, hstate


def gla_step(hstate, a_t, k_t, v_t, q_t):
    """One decode step. hstate: (B, H, Dk, Dv); a_t: (B, H); k_t, q_t:
    (B, H, Dk); v_t: (B, H, Dv). Returns (y (B, H, Dv), new state), f32."""
    f32 = lambda x: x.to(torch.float32)
    h_new = (f32(a_t)[..., None, None] * f32(hstate)
             + f32(k_t)[..., :, None] * f32(v_t)[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", f32(q_t), h_new)
    return y, h_new


def gla_prefill(a, k, v, q, *, chunk, use_kernel):
    """The prefill's scan, y (B, S, H, Dv) f32: K4 when ``use_kernel``
    (the wrapper launches it on the card and runs its sequential plain
    version on the CPU), else :func:`chunked_gla`."""
    if not use_kernel:
        return chunked_gla(a, k, v, q, chunk=chunk)[0]
    if any(t.requires_grad for t in (a, k, v, q)):
        raise NotImplementedError(
            "the scan kernel has no backward; train with use_flash=False "
            "(chunked_gla), as the JAX package does")
    return scan_ops.gla_scan(a, k, v, q, chunk=chunk)


# ============================================================== causal conv

def init_causal_conv(key, channels, width, dtype):
    return {"w": (trandom.normal(key, (width, channels)) * (width ** -0.5)
                  ).to(dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=key.device)}


def causal_conv(params, x, state=None):
    """Depthwise causal conv. x: (B, S, C); state: (B, width−1, C) or
    None. Returns (y, new_state), new_state the trailing width−1 inputs.
    Each tap is a product and an add in x's dtype, as the JAX package's
    ``sum`` of products rounds them."""
    width = params["w"].shape[0]
    s = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = xp[:, :s] * params["w"][0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * params["w"][i]
    y = y + params["b"]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y, new_state


# ================================================================== Mamba2

def mamba2_dims(d_model, head_dim=64, expand=2):
    d_inner = expand * d_model
    return d_inner, d_inner // head_dim


def init_mamba2(key, d_model, d_state, dtype, head_dim=64, expand=2,
                conv_width=4):
    d_inner, n_heads = mamba2_dims(d_model, head_dim, expand)
    ks = trandom.split(key, 5)
    conv_ch = d_inner + 2 * d_state
    f32 = dict(dtype=torch.float32, device=key.device)
    return {
        "in_proj": dense_init(
            ks[0], d_model, 2 * d_inner + 2 * d_state + n_heads, dtype),
        "conv": init_causal_conv(ks[1], conv_ch, conv_width, dtype),
        "a_log": torch.zeros((n_heads,), **f32),         # A = −exp(a_log)
        "dt_bias": torch.full((n_heads,), -2.0, **f32),  # softplus ≈ 0.13
        "d_skip": torch.ones((n_heads,), **f32),
        "gate_norm": norm_init(d_inner, dtype, device=key.device),
        "out_proj": dense_init(ks[4], d_inner, d_model, dtype),
    }


def _mamba2_preact(params, x, d_state, head_dim, conv_state=None):
    """Shared by the prefill and decode: projections, conv, gates. k and
    q are the conv output's B and C rows broadcast over the heads (stride
    0), never copied per head."""
    b, s, d_model = x.shape
    d_inner, n_heads = mamba2_dims(d_model, head_dim)
    zxbcdt = dense(params["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    # x, B and C lie side by side: the conv reads them as one view.
    conv_in = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    conv_out, conv_state = causal_conv(params["conv"], conv_in, conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :d_inner]
    bmat = conv_out[..., d_inner:d_inner + d_state]
    cmat = conv_out[..., d_inner + d_state:]

    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (B,S,H)
    a = torch.exp(-torch.exp(params["a_log"]) * dt)                 # decay
    xh = xin.reshape(b, s, n_heads, head_dim)
    k = bmat[:, :, None, :].expand(b, s, n_heads, d_state)
    v = xh.to(torch.float32) * dt[..., None]
    q = cmat[:, :, None, :].expand(b, s, n_heads, d_state)
    return z, xh, a, k, v, q, conv_state, d_inner, n_heads


def _mamba2_out(params, y, xh, z, dtype):
    b, s = y.shape[:2]
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, s, -1).to(dtype)
    y = apply_norm(params["gate_norm"], y * F.silu(z))
    return dense(params["out_proj"], y)


def apply_mamba2(params, x, *, d_state, head_dim=64, chunk=64,
                 use_kernel=False):
    """Training / prefill path. x: (B, S, D) -> y (B, S, D)."""
    z, xh, a, k, v, q, _, _, _ = _mamba2_preact(params, x, d_state, head_dim)
    y = gla_prefill(a, k, v, q, chunk=chunk, use_kernel=use_kernel)
    return _mamba2_out(params, y, xh, z, x.dtype)


def init_mamba2_state(batch, d_model, d_state, dtype, head_dim=64,
                      conv_width=4, device=None):
    d_inner, n_heads = mamba2_dims(d_model, head_dim)
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner + 2 * d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, n_heads, d_state, head_dim),
                           dtype=torch.float32, device=device),
    }


def decode_mamba2(params, x, state, *, d_state, head_dim=64):
    """One-token decode. x: (B, 1, D) -> (y (B, 1, D), state), the state
    written in place."""
    z, xh, a, k, v, q, conv_state, _, _ = _mamba2_preact(
        params, x, d_state, head_dim, conv_state=state["conv"])
    y, ssm = gla_step(state["ssm"], a[:, 0], k[:, 0], v[:, 0], q[:, 0])
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(ssm)
    return _mamba2_out(params, y[:, None], xh, z, x.dtype), state


# =================================================================== mLSTM

def init_mlstm(key, d_model, n_heads, dtype, expand=2, conv_width=4):
    d_inner = expand * d_model
    dh = d_inner // n_heads
    ks = trandom.split(key, 7)
    # q/k/v are per-head block-diagonal (xLSTM's proj_blocksize).
    blockdiag = lambda k: (trandom.normal(k, (n_heads, dh, dh))
                           * (dh ** -0.5)).to(dtype)
    return {
        "in_proj": dense_init(ks[0], d_model, 2 * d_inner, dtype),
        "conv": init_causal_conv(ks[1], d_inner, conv_width, dtype),
        "wq": blockdiag(ks[2]),
        "wk": blockdiag(ks[3]),
        "wv": blockdiag(ks[4]),
        "w_gates": dense_init(ks[5], d_model, 2 * n_heads, torch.float32,
                              use_bias=True),
        "out_norm": norm_init(d_inner, dtype, device=key.device),
        "out_proj": dense_init(ks[6], d_inner, d_model, dtype),
    }


def _mlstm_preact(params, x, n_heads, conv_state=None):
    b, s, _ = x.shape
    up = dense(params["in_proj"], x)
    xin, z = torch.chunk(up, 2, dim=-1)
    conv_out, conv_state = causal_conv(params["conv"], xin, conv_state)
    conv_out = F.silu(conv_out)
    d_inner = conv_out.shape[-1]
    dh = d_inner // n_heads
    hs = lambda t: t.reshape(b, s, n_heads, dh)
    bd = lambda w, t: torch.einsum("bshd,hde->bshe", hs(t), w)
    q = bd(params["wq"], conv_out) * (dh ** -0.5)
    k = bd(params["wk"], conv_out) * (dh ** -0.5)
    v = bd(params["wv"], xin)
    gates = dense(params["w_gates"], x.to(torch.float32))
    i_g, f_g = torch.chunk(gates, 2, dim=-1)              # (B,S,H)
    i_g = torch.sigmoid(i_g)
    f_g = torch.sigmoid(f_g + 3.0)                        # bias toward remember
    # Normalizer trick: v' = [v, 1]; the extra column accumulates n_t.
    v_ext = torch.cat([v.to(torch.float32),
                       v.new_ones(v.shape[:-1] + (1,), dtype=torch.float32)],
                      dim=-1)
    k_in = k.to(torch.float32) * i_g[..., None]
    return z, q.to(torch.float32), k_in, v_ext, f_g, conv_state, d_inner


def _mlstm_out(params, y_ext, z, dtype):
    b, s = y_ext.shape[:2]
    num, den = y_ext[..., :-1], y_ext[..., -1:]
    h = num / (torch.abs(den) + 1.0)
    h = h.reshape(b, s, -1).to(dtype)
    h = apply_norm(params["out_norm"], h) * F.silu(z)
    return dense(params["out_proj"], h)


def apply_mlstm(params, x, *, n_heads, chunk=64, use_kernel=False):
    z, q, k_in, v_ext, f_g, _, _ = _mlstm_preact(params, x, n_heads)
    y_ext = gla_prefill(f_g, k_in, v_ext, q, chunk=chunk,
                        use_kernel=use_kernel)
    return _mlstm_out(params, y_ext, z, x.dtype)


def init_mlstm_state(batch, d_model, n_heads, dtype, expand=2, conv_width=4,
                     device=None):
    d_inner = expand * d_model
    dh = d_inner // n_heads
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, dh, dh + 1), dtype=torch.float32,
                           device=device),
    }


def decode_mlstm(params, x, state, *, n_heads):
    z, q, k_in, v_ext, f_g, conv_state, _ = _mlstm_preact(
        params, x, n_heads, conv_state=state["conv"])
    y, ssm = gla_step(state["ssm"], f_g[:, 0], k_in[:, 0], v_ext[:, 0],
                      q[:, 0])
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(ssm)
    return _mlstm_out(params, y[:, None], z, x.dtype), state


# =================================================================== sLSTM

def init_slstm(key, d_model, n_heads, dtype):
    dh = d_model // n_heads
    ks = trandom.split(key, 3)
    return {
        "w_in": dense_init(ks[0], d_model, 4 * d_model, dtype, use_bias=True),
        # Block-diagonal recurrence: per-head (dh, 4*dh).
        "r": (trandom.normal(ks[1], (n_heads, dh, 4 * dh)) * (dh ** -0.5)
              ).to(dtype),
        "out_proj": dense_init(ks[2], d_model, d_model, dtype),
    }


def slstm_cell(pre, r, state):
    """One step. pre: (B, H, 4·dh), the input projection of this step in
    the input's dtype; r: (H, dh, 4·dh) f32; state: dict of (B, H, dh) f32
    tensors c, n, h. Returns the new state; its h is the step's output in
    f32 (the caller casts it to the input's dtype).

    The gates are the JAX package's, at its rounding points: i, f, o one
    sigmoid over the four gate blocks after f's +1 (z's sigmoid is
    computed and unused), z a tanh, so a step is a dozen launches."""
    rec = torch.einsum("bhd,hde->bhe", state["h"], r)
    g = (pre + rec).to(torch.float32).unflatten(-1, (4, -1))  # i, f, z, o
    g[..., 1, :] += 1.0                         # f: bias toward remember
    sig = torch.sigmoid(g)
    i_g, f_g, o_g = sig[..., 0, :], sig[..., 1, :], sig[..., 3, :]
    z_g = torch.tanh(g[..., 2, :])
    c = f_g * state["c"] + i_g * z_g
    n = f_g * state["n"] + i_g
    h = o_g * c / torch.clamp(n, min=1.0)      # f32 carry
    return {"c": c, "n": n, "h": h}


def init_slstm_state(batch, d_model, n_heads, device=None):
    dh = d_model // n_heads
    zeros = lambda: torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                                device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros()}


def _slstm_inputs(params, x, n_heads):
    """The input projections of every step at once, (B, S, H, 4·dh), and
    r in f32 (the JAX einsum of the f32 carry with r promotes r)."""
    b, s, _ = x.shape
    pre = dense(params["w_in"], x).reshape(b, s, n_heads, -1)
    return pre, params["r"].to(torch.float32)


def apply_slstm(params, x, *, n_heads):
    """A Python loop over time (the recurrence runs hidden to hidden)."""
    b, s, d_model = x.shape
    pre, r = _slstm_inputs(params, x, n_heads)
    state = init_slstm_state(b, d_model, n_heads, device=x.device)
    hs = []
    for t in range(s):
        state = slstm_cell(pre[:, t], r, state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d_model).to(x.dtype)
    return dense(params["out_proj"], y)


def decode_slstm(params, x, state, *, n_heads):
    b, _, d_model = x.shape
    pre, r = _slstm_inputs(params, x, n_heads)
    new = slstm_cell(pre[:, 0], r, state)
    for name, t in new.items():
        state[name].copy_(t)
    y = new["h"].reshape(b, 1, d_model).to(x.dtype)
    return dense(params["out_proj"], y), state
