"""What the benchmark's input generators of every configuration share."""
from __future__ import annotations

import torch


def simulate(A, x, noise, gen):
    """k-space (nc, M) of image x through the plain forward model A, plus
    complex white noise at ``noise`` times the RMS of each component."""
    y = A.forward(x)
    sigma = noise * float(torch.sqrt(torch.mean(y.abs() ** 2) / 2))
    n = torch.randn(y.shape + (2,), generator=gen, device=y.device)
    return y + sigma * torch.view_as_complex(n)
