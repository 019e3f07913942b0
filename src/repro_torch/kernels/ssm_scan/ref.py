"""Plain PyTorch version of the gated-linear-recurrence scan K4.

The sequential recurrence, one position at a time, in f32:

    H_t = a_t · H_{t-1} + k_t v_tᵀ,      y_t = q_tᵀ H_t,      H_0 = 0.

Port of ``repro.kernels.ssm_scan.ref``. The wrapper in
:mod:`repro_torch.kernels.ssm_scan.ops` takes it for CPU tensors; on the
card it is what the CUDA kernel is held against. It upcasts each operand
to f32 (a copy for a bf16 operand, which the kernel does not make) and
updates one ``(BH, dk, dv)`` state in place instead of building a new one
each step.
"""

from __future__ import annotations

import torch


def gla_scan_ref(a, k, v, q):
    """a: (BH, S); k, q: (BH, S, dk); v: (BH, S, dv) -> y (BH, S, dv) f32."""
    a, k, v, q = (x.to(torch.float32) for x in (a, k, v, q))
    bh, s = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    h = torch.zeros(bh, dk, dv, dtype=torch.float32, device=a.device)
    y = torch.empty(bh, s, dv, dtype=torch.float32, device=a.device)
    for t in range(s):
        h.mul_(a[:, t, None, None]).baddbmm_(k[:, t, :, None], v[:, t, None, :])
        y[:, t] = torch.bmm(q[:, t, None, :], h)[:, 0]
    return y
