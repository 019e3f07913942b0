"""Theorem 1 / Corollary 1 constants and strongly-convex test problems.

Port of ``repro.core.convergence``:

    C = ( Σ_i (T_i,max − 1) p_i²  +  Σ_i Σ_j p_i p_j ) G²          (eq. 21)

    E[F(w^T)] − F* ≤ (L/μ)(1−ημ)^T (F(w⁰) − F* − ηC/2) + ηLC/(2μ)  (eq. 20)

plus quadratic problems with closed-form optima, the quickstart's
problem and the cheapest test of the whole loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom


def variance_constant(p, t_max, g2) -> torch.Tensor:
    """C from eq. (21); ``t_max`` is the (N,) per-client T_{i,max} (or
    1/β_i, T_i per Corollary 1), ``g2`` the second-moment bound G²."""
    p = torch.as_tensor(p, dtype=torch.float32)
    t_max = torch.as_tensor(t_max, dtype=torch.float32)
    return (torch.sum((t_max - 1.0) * p ** 2) + torch.sum(p) ** 2) * g2


def theorem1_bound(t, f0_gap, mu, lsmooth, eta, c) -> torch.Tensor:
    """Right-hand side of eq. (20) as a function of iteration t."""
    t = torch.as_tensor(t, dtype=torch.float32)
    decay = (lsmooth / mu) * (1.0 - eta * mu) ** t * (f0_gap - eta * c / 2.0)
    floor = eta * lsmooth * c / (2.0 * mu)
    return decay + floor


def error_floor(mu, lsmooth, eta, c) -> float:
    """The non-vanishing term ηLC/(2μ) (Remark 1)."""
    return float(eta * lsmooth * c / (2.0 * mu))


def max_step_size(mu, lsmooth) -> float:
    """η ≤ min{1/(2μ), 1/L} required by Theorem 1."""
    return float(min(1.0 / (2.0 * mu), 1.0 / lsmooth))


class QuadraticProblem(NamedTuple):
    """N-client quadratic: F_i(w) = ½ wᵀ A_i w − b_iᵀ w + c_i, with
    μ = λ_min(Σ p_i A_i), L = λ_max(Σ p_i A_i) and
    w* = (Σ p_i A_i)⁻¹ Σ p_i b_i in closed form."""

    a: torch.Tensor       # (N, d, d)
    b: torch.Tensor       # (N, d)
    p: torch.Tensor       # (N,)
    w_star: torch.Tensor  # (d,)
    mu: float
    lsmooth: float

    @property
    def n_clients(self) -> int:
        return self.a.shape[0]

    @property
    def dim(self) -> int:
        return self.a.shape[1]

    def local_grad(self, i, w, key=None, noise=0.0):
        """∇F_i(w), plus optional isotropic noise."""
        g = self.a[i] @ w - self.b[i]
        if key is not None and noise > 0.0:
            g = g + noise * trandom.normal(key, g.shape)
        return g

    def all_grads(self, w, key=None, noise=0.0):
        """(N, d) stacked local gradients, optionally noisy."""
        g = torch.einsum("nij,j->ni", self.a, w) - self.b
        if key is not None and noise > 0.0:
            g = g + noise * trandom.normal(key, g.shape)
        return g

    def global_loss(self, w):
        quad = 0.5 * torch.sum(self.p * ((self.a @ w) @ w))
        lin = torch.sum(self.p * (self.b @ w))
        return quad - lin

    def suboptimality(self, w):
        return self.global_loss(w) - self.global_loss(self.w_star)

    def grad_second_moment_bound(self, radius: float) -> float:
        """G² over the ball ||w − w*|| ≤ radius (deterministic gradients):
        ||∇F_i(w)|| ≤ L_i·radius + ||A_i w* − b_i||."""
        a = self.a.detach().cpu().numpy()
        ws = self.w_star.detach().cpu().numpy()
        b = self.b.detach().cpu().numpy()
        worst = 0.0
        for i in range(a.shape[0]):
            li = float(np.linalg.eigvalsh(a[i]).max())
            resid = float(np.linalg.norm(a[i] @ ws - b[i]))
            worst = max(worst, (li * radius + resid) ** 2)
        return worst


def make_quadratic(key, n_clients: int, dim: int, hetero: float = 1.0,
                   cond: float = 10.0) -> QuadraticProblem:
    """Random well-conditioned quadratic with heterogeneous client optima
    (per-client SPD spectra in [1, cond]); ``hetero`` sets how far apart
    the client minimizers are, which is what makes Benchmark 1's bias
    visible. Built on ``key``'s device."""
    k1, k2, k3 = trandom.split(key, 3).unbind(0)
    qs = trandom.normal(k1, (n_clients, dim, dim))
    q, _ = torch.linalg.qr(qs)
    eigs = torch.linspace(1.0, cond, dim, device=key.device)
    a = (q * eigs) @ q.transpose(-1, -2)
    centers = hetero * trandom.normal(k2, (n_clients, dim))
    b = torch.einsum("nij,nj->ni", a, centers)
    p_raw = trandom.uniform(k3, (n_clients,), 0.5, 1.5)
    p = p_raw / torch.sum(p_raw)
    a_bar = torch.einsum("n,nij->ij", p, a)
    b_bar = torch.einsum("n,ni->i", p, b)
    w_star = torch.linalg.solve(a_bar, b_bar)
    eig = torch.linalg.eigvalsh(a_bar)
    return QuadraticProblem(a=a, b=b, p=p, w_star=w_star,
                            mu=float(eig[0]), lsmooth=float(eig[-1]))


def biased_fixed_point(problem: QuadraticProblem, participation) -> torch.Tensor:
    """Fixed point of unscaled best-effort SGD (Benchmark 1): with
    participation probabilities q_i and no rescaling the expected update
    drives w to argmin Σ_i q_i p_i F_i, the biased optimum."""
    q = torch.as_tensor(participation, dtype=torch.float32,
                        device=problem.p.device)
    a_bar = torch.einsum("n,nij->ij", q * problem.p, problem.a)
    b_bar = torch.einsum("n,ni->i", q * problem.p, problem.b)
    return torch.linalg.solve(a_bar, b_bar)
