"""Plain PyTorch version of the flash-attention kernel K3.

The wrapper in :mod:`repro_torch.kernels.flash_attention.ops` takes it
for CPU tensors; on the card it is what the CUDA kernel is held against.
It computes what the kernel computes, in f32: q upcast and scaled by
``Dh**-0.5``, causal and/or sliding-window masks, GQA by head index, and
a row with no visible key gives exact zeros (p is forced to 0 and the
denominator clamped to ≥ 1e-30, as in the TPU kernel). The JAX
package's ``ref.py`` gives the mean of v on such rows instead; this
version follows the kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(s, t, *, causal, window, device=None):
    """(S, T) bool: key ``j`` is visible to query ``i``."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, H, S, Dh); k, v: (B, Hkv, T, Dh) -> (B, H, S, Dh) in q's
    dtype, computed in f32."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    qf = (q.to(torch.float32) * (dh ** -0.5)).reshape(b, hkv, g, s, dh)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(torch.float32))
    mask = visible_mask(s, t, causal=causal, window=window, device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32)) / denom
    return out.reshape(b, h, s, dh).to(q.dtype)
