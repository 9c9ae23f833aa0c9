"""Branin-Hoo on the unit square, standardised to mean 0 and variance 1 over the domain
(Picheny, Wagner and Ginsbourger, 2013), a frozen copy that the benchmark evaluates for
the program and the reference alike. Global minimum (0.397887 - 54.8104) / 51.9496."""
import math

import torch


def objective(u: torch.Tensor) -> torch.Tensor:
    """``[N, 2] -> [N, 1]``, in the dtype and on the device of ``u``."""
    x0, x1 = u[:, 0] * 15.0 - 5.0, u[:, 1] * 15.0
    b, c, t = 5.1 / (4 * math.pi**2), 5.0 / math.pi, 1.0 / (8 * math.pi)
    branin = (x1 - b * x0**2 + c * x0 - 6.0) ** 2 + 10.0 * (1 - t) * torch.cos(x0) + 10.0
    return ((branin - 54.8104) / 51.9496)[:, None]
