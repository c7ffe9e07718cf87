"""Surface scattering (BSDF) by counted rejection with a fixed budget.

Port of `optiland_tpu/core/scatter.py`: every ray gets `budget` disk
draws at once; a mask keeps the first that lands in the hemisphere, and a
ray whose draws all miss keeps its specular direction (probability ~0 for
physical sigmas).

Randomness: the JAX package draws from threefry keys, which a
`torch.Generator` cannot reproduce. The port's stream is its own:
`scatter_directions` draws its standard uniforms with `torch.rand` from
the generator it is given, (budget, N) for the radius and as many for the
angle, in that order; and the tracer gives each BSDF surface a generator of
its own (`surface_generator`). For a bitwise comparison, the caller passes
the uniforms as `draws` (the test computes them from JAX's keys); they go
through the same affine maps as JAX's `jax.random.uniform(minval,
maxval)`.
"""

from __future__ import annotations

import math

import torch


def _local_basis(L, M, N, nx, ny, nz):
    """Tangent basis (a, b) about the normal: a = n x v, b = n x a, with v
    the x axis where the ray's L < 0.999, else the y axis (the reference's
    arbitrary-vector choice, which tests the ray, not the normal)."""
    use_x = L < 0.999
    one, zero = torch.ones_like(L), torch.zeros_like(L)
    avx = torch.where(use_x, one, zero)
    avy = torch.where(use_x, zero, one)
    ax = ny * 0.0 - nz * avy
    ay = nz * avx - nx * 0.0
    az = nx * avy - ny * avx
    amag = torch.sqrt(ax * ax + ay * ay + az * az)
    ax, ay, az = ax / amag, ay / amag, az / amag
    bx = ny * az - nz * ay
    by = nz * ax - nx * az
    bz = nx * ay - ny * ax
    return (ax, ay, az), (bx, by, bz)


def _uniform(u, lo, hi):
    """`jax.random.uniform(minval=lo, maxval=hi)` of the standard draws u."""
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def _disk(u_r, u_t, kind: str, sigma: float):
    """The disk offsets (x, y) of one attempt from its two uniform rows."""
    if kind == "lambertian":
        r = torch.sqrt(u_r)
        th = _uniform(u_t, 0.0, 2.0 * math.pi)
        return r * torch.cos(th), r * torch.sin(th)
    # gaussian (Box-Muller)
    u1 = _uniform(u_r, 1e-12, 1.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = 2.0 * math.pi * u_t
    return sigma * r * torch.cos(th), sigma * r * torch.sin(th)


def disk_draws(generator, n: int, budget: int, dtype, device):
    """The port's stream: (u_r, u_t), each (budget, n) standard uniforms
    from `generator` (None: the global generator of `device`)."""
    return tuple(torch.rand((budget, n), generator=generator, dtype=dtype,
                            device=device) for _ in range(2))


def surface_generator(base_seed: int, k: int, device) -> torch.Generator:
    """Surface k's generator under the trace's `base_seed` (the
    counterpart of JAX's `fold_in(scatter_key, k)`)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(base_seed) * 1_000_003 + int(k)) % (1 << 63))
    return g


def scatter_directions(generator, L, M, N, nx, ny, nz,
                       kind: str = "lambertian", sigma: float = 0.1,
                       budget: int = 8, draws=None):
    """Scattered unit directions for every ray; returns (L', M', N').
    `kind` is "lambertian" or "gaussian"; `draws` (u_r, u_t), each (budget,
    N), replaces the generator's."""
    # orient the normal into the outgoing hemisphere (the geometry's normals
    # have nz < 0; the scatter is centred forward)
    sgn = torch.sign(nx * L + ny * M + nz * N)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
    (ax, ay, az), (bx, by, bz) = _local_basis(L, M, N, nx, ny, nz)
    r_dot_a = L * ax + M * ay + N * az
    r_dot_b = L * bx + M * by + N * bz

    if draws is None:
        draws = disk_draws(generator, L.shape[0], budget, L.dtype, L.device)
    u_r, u_t = (torch.as_tensor(d, dtype=L.dtype, device=L.device)
                for d in draws)
    done = torch.zeros(L.shape, dtype=torch.bool, device=L.device)
    sx = torch.zeros_like(L)
    sy = torch.zeros_like(L)
    for a in range(u_r.shape[0]):
        x, y = _disk(u_r[a], u_t[a], kind, sigma)
        cand_x = r_dot_a + x
        cand_y = r_dot_b + y
        ok = (1.0 - cand_x**2 - cand_y**2) >= 0.0
        take = ok & ~done
        sx = torch.where(take, cand_x, sx)
        sy = torch.where(take, cand_y, sy)
        done = done | ok
    sz = torch.sqrt(torch.clamp(1.0 - sx**2 - sy**2, min=0.0))
    Ls = sx * ax + sy * bx + sz * nx
    Ms = sx * ay + sy * by + sz * ny
    Ns = sx * az + sy * bz + sz * nz
    # an exhausted budget keeps the specular direction
    return (torch.where(done, Ls, L), torch.where(done, Ms, M),
            torch.where(done, Ns, N))


class LambertianBSDF:
    kind = "lambertian"
    sigma = 0.0

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash("lambertian")


class GaussianBSDF:
    kind = "gaussian"

    def __init__(self, sigma: float):
        self.sigma = float(sigma)

    def __eq__(self, other):
        return type(self) is type(other) and self.sigma == other.sigma

    def __hash__(self):
        return hash(("gaussian", self.sigma))
