"""Random right-hand-side field generators (six families) + GRF sampler.

Port of ``multigrid_feanet_tpu/data/rhs.py`` (the reference's
Data/RHS/generate_rhs.py:6-56 and gaussian_random_field.py:47-92).  The math
of each family is the JAX package's; randomness comes from an explicit CPU
``torch.Generator`` in place of a ``jax.random`` key, so the numbers differ
from the JAX package's for the same seed while their distributions agree.
Fields are float32 CPU tensors.

Families (equal shares in :func:`make_dataset`):
  1. uniform-random field with random affine coefs  (coef0*U + coef1)
  2. sparse random points (n/2 nonzeros, random magnitude)
  3. Gaussian random field, spectral 1/|k|^(alpha/2), alpha ~ U(2, 5)
  4. random trigonometric  c0*sin(c1*pi*x)*sin(c2*pi*y)
  5. random polynomial     c0*x^2 + c1*y^2 + c2*x*y + c3
  6. discontinuous: trig / poly split by a random line a*x + b > y
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _xy(n: int):
    c = torch.linspace(-1.0, 1.0, n)
    return torch.meshgrid(c, c, indexing="xy")


def _uniform(gen, shape=(), low=0.0, high=1.0):
    return low + (high - low) * torch.rand(shape, generator=gen)


def random_field(gen: torch.Generator, n: int) -> torch.Tensor:
    coef = 10.0 * _uniform(gen, (2,)) - 5.0
    return coef[0] * _uniform(gen, (n, n)) + coef[1]


def sparse_points(gen: torch.Generator, n: int) -> torch.Tensor:
    """~n/2 random nonzero points with magnitudes (10 U - 5) * U."""
    num = n // 2
    ii = torch.randint(0, n, (num,), generator=gen)
    jj = torch.randint(0, n, (num,), generator=gen)
    mags = (10.0 * _uniform(gen, (num,)) - 5.0) * _uniform(gen, (num,))
    out = torch.zeros((n, n))
    out[ii, jj] = mags
    return out


def gaussian_random_field(gen: torch.Generator, n: int, alpha: float = 3.0,
                          normalize: bool = True, noise=None) -> torch.Tensor:
    """Spectral GRF with power-law amplitude 1/|k|^(alpha/2).  ``noise`` (a
    complex (n, n) field) replaces the standard complex normal draw."""
    kf = torch.fft.fftfreq(n) * n  # integer momentum indices, fft order
    kx, ky = torch.meshgrid(kf, kf, indexing="ij")
    amplitude = torch.pow(kx**2 + ky**2 + 1e-10, -float(alpha) / 4.0)
    amplitude[0, 0] = 0.0
    if noise is None:
        re = torch.randn((n, n), generator=gen)
        noise = torch.complex(re, torch.randn((n, n), generator=gen))
    noise = noise if torch.is_tensor(noise) else torch.from_numpy(np.array(noise, np.complex64))
    field = torch.fft.ifft2(noise * amplitude).real.to(torch.float32)
    if normalize:
        field = field - field.mean()
        field = field / field.std(correction=0)
    return field


def gaussian_random_field_random_alpha(gen: torch.Generator, n: int) -> torch.Tensor:
    alpha = float(_uniform(gen, (), 2.0, 5.0))
    return gaussian_random_field(gen, n, alpha)


def trigonometric(gen: torch.Generator, n: int) -> torch.Tensor:
    xx, yy = _xy(n)
    coef = 10.0 * _uniform(gen, (3,)) - 5.0
    return coef[0] * torch.sin(coef[1] * math.pi * xx) * torch.sin(coef[2] * math.pi * yy)


def polynomial(gen: torch.Generator, n: int) -> torch.Tensor:
    xx, yy = _xy(n)
    coef = 10.0 * _uniform(gen, (4,)) - 5.0
    return coef[0] * xx**2 + coef[1] * yy**2 + coef[2] * xx * yy + coef[3]


def discontinuous(gen: torch.Generator, n: int) -> torch.Tensor:
    """Trig field on one side of a random line, poly field on the other."""
    xx, yy = _xy(n)
    a = 20.0 * _uniform(gen) - 10.0
    b = 2.0 * _uniform(gen) - 1.0
    c1 = 10.0 * _uniform(gen, (3,)) - 5.0
    c2 = 10.0 * _uniform(gen, (3,)) - 5.0
    trig = c1[0] * torch.sin(c1[1] * math.pi * xx) * torch.sin(c1[2] * math.pi * yy)
    poly = c2[0] * xx**2 + c2[1] * yy**2 + c2[2] * xx * yy
    return torch.where(a * xx + b > yy, trig, poly)


FAMILIES = (
    random_field,
    sparse_points,
    gaussian_random_field_random_alpha,
    trigonometric,
    polynomial,
    discontinuous,
)


def make_dataset(n: int, count: int, seed: int = 0) -> torch.Tensor:
    """(count, n, n) RHS fields in equal family shares (family-major order,
    like the reference's h5 layout); family ``i`` draws from a generator
    seeded with ``(seed, i)``."""
    per = count // len(FAMILIES)
    rem = count - per * (len(FAMILIES) - 1)
    chunks = []
    for fi, fam in enumerate(FAMILIES):
        gen = torch.Generator().manual_seed(seed * len(FAMILIES) + fi)
        m = rem if fi == len(FAMILIES) - 1 else per
        chunks.append(torch.stack([fam(gen, n) for _ in range(m)]) if m else
                      torch.zeros((0, n, n)))
    return torch.cat(chunks, dim=0)
