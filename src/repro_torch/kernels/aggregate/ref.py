"""Plain PyTorch versions of the aggregate kernels K1 and K2.

The wrappers in :mod:`repro_torch.kernels.aggregate.ops` take these for
CPU tensors; on the card they are what the CUDA kernels are held
against. Accumulation is f32 throughout; masked rows are dropped by a
row select, never a multiply.
"""

from __future__ import annotations

import torch


def _weighted_sum(g, w, mask):
    g32 = g.to(torch.float32)
    if mask is not None:
        g32 = torch.where(mask.reshape(-1, 1) > 0, g32, 0.0)
    return torch.einsum("n,np->p", w.to(torch.float32), g32)


def masked_scaled_aggregate_ref(g, w, mask=None, out_dtype=None):
    """K1: g (N, P), w (N,) → (P,) = w @ g_sel, in ``out_dtype``
    (default ``g.dtype``)."""
    out_dtype = g.dtype if out_dtype is None else out_dtype
    return _weighted_sum(g, w, mask).to(out_dtype)


def masked_scaled_aggregate_update_ref(g, w, eta, params=None, mask=None,
                                       out_dtype=None):
    """K2: ``params − eta·(w @ g_sel)`` in ``params.dtype``, or without
    ``params`` the f32 delta ``−eta·(w @ g_sel)``; ``out_dtype``
    overrides either."""
    acc = _weighted_sum(g, w, mask)
    eta = torch.as_tensor(eta, dtype=torch.float32, device=g.device)
    if params is None:
        out = -eta * acc
        return out if out_dtype is None else out.to(out_dtype)
    out_dtype = params.dtype if out_dtype is None else out_dtype
    return (params.to(torch.float32) - eta * acc).to(out_dtype)
