"""The gated-linear-recurrence engine of the Mamba2 and mLSTM blocks.

Port of the GLA part of ``repro.models.ssm``. Mamba2 and mLSTM are both
scalar-decay gated linear recurrences on a matrix state,

    H_t = a_t · H_{t-1} + k_t v_tᵀ,      y_t = q_tᵀ H_t,

evaluated by :func:`chunked_gla` in chunks (a quadratic product inside
each chunk, the state carried across chunks) with batched matmuls, and
by :func:`gla_step` one decode step at a time. The recurrence runs in
f32 with the decays in log space. The CUDA kernel K4
(:func:`repro_torch.kernels.ssm_scan.gla_scan`) computes the same ``y``
without materialising the chunks.

One difference from the JAX package: inside a chunk the upper triangle of
the decay-weighted scores is dropped by a select, as the TPU kernel
does. The JAX ``chunked_gla`` multiplies by a 0/1 mask instead, and the
``exp(la_t − la_s)`` of that triangle overflows to inf for small decays
(a ≈ 1e-6), so ``inf · 0`` gives NaN there (ROADMAP, caveat R4).

The Mamba2, mLSTM and sLSTM blocks and ``causal_conv`` are not ported
yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
