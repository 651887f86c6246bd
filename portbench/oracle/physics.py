"""The implicit FDM time step, worked out in float64 PyTorch over a batch of
buildings: the simultaneous (Jacobi) update of sbsim's TF simulator,
"Equation 22" (tf_simulator.py:573-853 of google/sbsim; its float32 NumPy
transcription is sbsim_tpu_torch/physics/reference_impl.py:tf_jacobi_step,
whose formula this is), iterated to a residual, plainly or with Chebyshev
acceleration (Golub and Van Loan, Matrix Computations, sec. 10.1.5)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.oracle.building import Grid


class Stencil:
    """The grid's planes on a device, and the Jacobi map over (B, H, W)."""

    def __init__(self, grid: Grid, dt_sec: float, device):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
        f = {k: t(v) for k, v in grid.faces.items()}
        u, v, z = t(grid.u), t(grid.v), grid.floor_height_m
        rho, cp = t(grid.density), t(grid.heat_capacity)
        self.vz, self.uz = v * z, u * z
        self.k_l, self.k_r = f["k_left"] / u, f["k_right"] / u
        self.k_b, self.k_t = f["k_bottom"] / v, f["k_top"] / v
        self.h_lr = f["h_left"] + f["h_right"]
        self.h_bt = f["h_bottom"] + f["h_top"]
        # The TF simulator's capacity term, heat capacity twice as it has it.
        self.mass = rho * u * v * cp * z * cp / dt_sec
        self.fixed = torch.as_tensor(grid.fixed, device=device)
        self.device = device

    def planes(self, input_q, t_inf, h):
        """(constant part of the numerator, denominator) per env."""
        t3, h3 = t_inf.view(-1, 1, 1), h.view(-1, 1, 1)
        denom = (self.vz * (self.k_l + self.k_r + h3 * self.h_lr)
                 + self.uz * (self.k_b + self.k_t + h3 * self.h_bt) + self.mass)
        const = (self.vz * h3 * self.h_lr * t3 + self.uz * h3 * self.h_bt * t3 + input_q)
        return const, denom

    def jacobi(self, x, t_minus, const, denom, t_inf):
        """One simultaneous update; neighbours outside the frame read the
        ambient temperature ("left" is x[i, j+1], "above" x[i-1, j])."""
        t3 = t_inf.view(-1, 1, 1).expand_as(x)
        left = torch.cat([x[:, :, 1:], t3[:, :, :1]], dim=2)
        right = torch.cat([t3[:, :, :1], x[:, :, :-1]], dim=2)
        above = torch.cat([t3[:, :1], x[:, :-1]], dim=1)
        below = torch.cat([x[:, 1:], t3[:, :1]], dim=1)
        numer = (self.vz * (self.k_l * left + self.k_r * right)
                 + self.uz * (self.k_b * below + self.k_t * above)
                 + self.mass * t_minus + const)
        return torch.where(self.fixed, t3, numer / denom)


def solve(st: Stencil, temp, input_q, t_inf, h, threshold: float, limit: int,
          rho: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new temp, iterations per env): Jacobi updates until every env's
    largest change is at most `threshold` or `limit` updates were made;
    with `rho` (the Jacobi map's spectral radius) > 0, Chebyshev's
    semi-iteration over the same map, stopped by the same rule and ending
    with one Jacobi update of the converged iterate."""
    temp = temp.double()
    const, denom = st.planes(input_q.double(), t_inf.double(), h.double())
    t_inf = t_inf.double()
    step = lambda x: st.jacobi(x, temp, const, denom, t_inf)
    x_prev, x = temp, step(temp)
    done = (x - x_prev).abs().amax(dim=(-2, -1)) <= threshold
    iters = torch.ones(temp.shape[0], dtype=torch.int64, device=temp.device)
    omega = 1.0 / (1.0 - rho * rho / 2.0) if rho > 0 else 1.0
    k = 1
    while k < limit and not bool(done.all()):
        jx = step(x)
        delta = (jx - x).abs().amax(dim=(-2, -1))
        if rho > 0:
            omega = 1.0 / (1.0 - rho * rho * omega / 4.0)
            nxt = omega * (jx - x_prev) + x_prev
        else:
            nxt = jx
        active = (~done).view(-1, 1, 1)
        x_prev = torch.where(active, x, x_prev)
        x = torch.where(active, nxt, x)
        iters = torch.where(done, iters, iters + 1)
        done = done | (delta <= threshold)
        k += 1
    return (step(x) if rho > 0 else x), iters


def spectral_radius(st: Stencil, h: float, iterations: int = 200) -> float:
    """The Jacobi map's spectral radius on this grid, by power iteration
    from a fixed start."""
    zero = torch.zeros(1, dtype=torch.float64, device=st.device)
    const, denom = st.planes(torch.zeros(st.fixed.shape, dtype=torch.float64,
                                         device=st.device)[None], zero,
                             torch.full((1,), float(h), dtype=torch.float64, device=st.device))
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.rand((1,) + tuple(st.fixed.shape), generator=g, dtype=torch.float64).to(st.device)
    x = torch.where(st.fixed, 0.0, x)
    rho = 0.0
    for _ in range(iterations):
        y = st.jacobi(x, torch.zeros_like(x), torch.zeros_like(x), denom, zero)
        norm = float(y.norm())
        rho, x = norm / float(x.norm()), y / norm
    return rho
