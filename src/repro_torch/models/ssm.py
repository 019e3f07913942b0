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
JAX Mamba2 and mLSTM blocks inherit it, the port's do not. The port
selects the exponent as well, so the triangle's exp is 0, not inf, and
the gradient stays finite where a select of the product alone would
give ``0 · inf`` in the backward.

sLSTM has a hidden-to-hidden recurrent matrix, so it runs as a Python
loop over time with an f32 carry, where the JAX package runs
``lax.scan``; its input projection is one product over the whole
sequence before the loop. Where gradients are wanted the loop is one
autograd node (:class:`_SLSTMScan`) whose backward walks time in reverse
by hand: autograd would record a dozen nodes a step and run each of
them in its engine. On the card each loop (the forward, with or without
what the backward keeps, and the backward) runs as a CUDA graph,
captured at its first call with a shape: the host launched every step's
dozen small kernels one by one, and that, not the card, bounded an
xlstm prefill and train step. The decode steps write the blocks' states
in place (``copy_``), as the attention decode writes its cache.
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
    # One unbind a tensor, not a slice a chunk: a slice's backward builds
    # a full-size zero gradient and adds it in, an unbind's stacks them.
    for la_i, k_i, v_i, q_i in zip(*(x.unbind(1) for x in (la, k_c, v_c, q_c))):
        # inter-chunk: y += decay(start→t) · qᵀ H_prev
        y_inter = torch.einsum("bthd,bhdv->bthv",
                               q_i * torch.exp(la_i)[..., None], hstate)
        # intra-chunk, causal by select (quadratic in `chunk` only). The
        # exponent is selected too: exp of the upper triangle's la_t − la_s
        # overflows for small decays, and the select's backward would
        # multiply its zero gradient by that inf.
        ratio = torch.exp(torch.where(
            tri, la_i[:, :, None, :] - la_i[:, None, :, :], -torch.inf))  # (B,t,s,H)
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
    f32 (the caller casts it to the input's dtype)."""
    return _slstm_step(pre, r, state)[0]


def _slstm_step(pre, r, state):
    """:func:`slstm_cell`, and the step's gates: the sigmoid over the four
    gate blocks (B, H, 4, dh) and z's tanh (B, H, dh).

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
    return {"c": c, "n": n, "h": h}, (sig, z_g)


def _scan_forward(pre, r, keep):
    """The sLSTM loop over time from a zero state: ``pre`` (B, S, H, 4·dh)
    in the input's dtype and ``r`` (H, dh, 4·dh) f32 to every step's h,
    (B, S, H, dh) f32, written into one buffer as the loop goes; with
    ``keep`` also the gates (B, S, H, 4, dh), z, c and n of every step,
    which the backward reads."""
    b, s, n_heads, e = pre.shape
    f32 = dict(dtype=torch.float32, device=pre.device)
    shape = (b, s, n_heads, e // 4)
    out = [torch.empty(shape, **f32)]
    if keep:
        out += [torch.empty((b, s, n_heads, 4, e // 4), **f32)] + [
            torch.empty(shape, **f32) for _ in range(3)]
    state = init_slstm_state(b, e // 4 * n_heads, n_heads, device=pre.device)
    for t, pre_t in enumerate(pre.unbind(1)):
        state, gates = _slstm_step(pre_t, r, state)
        out[0][:, t] = state["h"]
        if keep:
            for buf, x in zip(out[1:], gates + (state["c"], state["n"])):
                buf[:, t] = x
    return tuple(out)


def _scan_backward(d_out, r, h, sig, z, c, n, *, pre_dtype):
    """The gradients of :func:`_scan_forward`'s h with respect to ``pre``
    (in ``pre_dtype``) and ``r``, from the kept gates, z, c and n. dh,
    dc and dn are carried back through time by hand, about ten launches
    a step; whatever does not depend on the carries is formed for all
    steps at once before the loop, and r's gradient is one product over
    all steps after it."""
    i, f, o = sig[:, :, :, 0], sig[:, :, :, 1], sig[:, :, :, 3]
    m = torch.clamp(n, min=1.0)
    shift = lambda x: torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    # h = o·c / max(n, 1): dh's share of dc, dn and o's pre-activation.
    dc_dh = o / m
    dn_dh = torch.where(n >= 1.0, -(o * c) / (m * m), 0.0)
    # Each gate block's pre-activation gradient is dc·P + dn·Q + dh·R
    # (the blocks i, f, z, o along dim 3): i from c += i·z and n += i,
    # f from f·c_prev and f·n_prev, z from i·z, o from h.
    di, df = i * (1 - i), f * (1 - f)
    zero = torch.zeros_like(i)
    p = torch.stack([z * di, shift(c) * df, i * (1 - z * z), zero], 3)
    q = torch.stack([di, shift(n) * df, zero, zero], 3)
    rr = torch.stack([zero, zero, zero, c / m * o * (1 - o)], 3)
    del di, df, zero, m
    d_g = torch.empty_like(p)
    dh = dc = dn = None
    for t in range(d_out.shape[1] - 1, -1, -1):
        dh = d_out[:, t] if dh is None else d_out[:, t] + dh
        dc = dh * dc_dh[:, t] if dc is None else torch.addcmul(
            dc, dh, dc_dh[:, t])
        dn = dh * dn_dh[:, t] if dn is None else torch.addcmul(
            dn, dh, dn_dh[:, t])
        g_t = d_g[:, t]
        torch.mul(dc.unsqueeze(2), p[:, t], out=g_t)
        g_t.addcmul_(dn.unsqueeze(2), q[:, t])
        g_t.addcmul_(dh.unsqueeze(2), rr[:, t])
        dc, dn = dc * f[:, t], dn * f[:, t]
        dh = torch.einsum("bhe,hde->bhd", g_t.flatten(-2), r)
    d_g = d_g.flatten(-2)
    return d_g.to(pre_dtype), torch.einsum("bshd,bshe->hde", shift(h), d_g)


#: The CUDA graphs of the sLSTM loops, one for each function, shapes and
#: dtypes: (graph, static inputs, outputs). None of their ops has a
#: nondeterministic form, so one graph serves both settings of
#: ``torch.use_deterministic_algorithms``.
_GRAPHS = {}


def _graphed(fn, *args, **kw):
    """``fn(*args, **kw)``: on CUDA tensors through a CUDA graph of it,
    captured at the first call with these shapes (after one call on a
    side stream, as capture requires) and replayed after copying
    ``args`` into its static inputs; the outputs are copies, so the next
    replay leaves them alone. A loop's thousands of small launches then
    cost the host one replay; on the CPU ``fn`` runs as it is."""
    if not args[0].is_cuda:
        return fn(*args, **kw)
    key = (fn.__name__, tuple(sorted(kw.items())), args[0].device,
           tuple((x.shape, x.dtype) for x in args))
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  for x in args]
        for dst, x in zip(static, args):
            dst.copy_(x)
        side = torch.cuda.Stream(device=args[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = fn(*static, **kw)
        entry = _GRAPHS[key] = (graph, static, outs)
    else:
        for dst, x in zip(entry[1], args):
            dst.copy_(x)
    entry[0].replay()
    return tuple(x.clone() for x in entry[2])


def release_slstm_graphs():
    """Free the sLSTM's CUDA graphs and the device memory they hold."""
    _GRAPHS.clear()


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM loop over time as one autograd node: ``pre`` (B, S, H,
    4·dh) and ``r`` (H, dh, 4·dh) f32 to every step's h, (B, S, H, dh)
    f32. Forward and backward each run as one CUDA graph on the card
    (:func:`_graphed`)."""

    @staticmethod
    def forward(ctx, pre, r):
        h, *kept = _graphed(_scan_forward, pre, r, keep=True)
        ctx.pre_dtype = pre.dtype
        ctx.save_for_backward(r, h, *kept)
        return h

    @staticmethod
    def backward(ctx, d_out):
        return _graphed(_scan_backward, d_out, *ctx.saved_tensors,
                        pre_dtype=ctx.pre_dtype)


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
    """A loop over time (the recurrence runs hidden to hidden), one CUDA
    graph on the card; one autograd node where gradients are wanted."""
    b, s, d_model = x.shape
    pre, r = _slstm_inputs(params, x, n_heads)
    if torch.is_grad_enabled() and (pre.requires_grad or r.requires_grad):
        y = _SLSTMScan.apply(pre, r)
    else:
        y, = _graphed(_scan_forward, pre, r, keep=False)
    return dense(params["out_proj"], y.reshape(b, s, d_model).to(x.dtype))


def decode_slstm(params, x, state, *, n_heads):
    b, _, d_model = x.shape
    pre, r = _slstm_inputs(params, x, n_heads)
    new = slstm_cell(pre[:, 0], r, state)
    for name, t in new.items():
        state[name].copy_(t)
    y = new["h"].reshape(b, 1, d_model).to(x.dtype)
    return dense(params["out_proj"], y), state
