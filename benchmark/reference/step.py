"""One model step of HOMME's rsplit > 0 cadence in field form, plain
PyTorch on any device and in any float dtype:

  1. SSPRK3 dynamics (Shu-Osher form) on the CAAR tendencies, with the
     continuous projection P = rspheremp * DSS(spheremp * .) after every
     stage and the mean-flux accumulators weighted (1/6, 1/6, 2/3);
  2. biharmonic hyperviscosity nu on u, v, T: two weak Laplacians, each
     closed by rspheremp * DSS, then X -= dt * nu * grad^4 X;
  3. qsplit SSPRK3 tracer substeps on the new winds, each stage
     P(L(y, bounds(q_in))): y the Euler update (in the Shu-Osher
     combination), L the mass-conserving limiter with bounds from the
     element extrema of the stage's input (without the limiter, P(y));
  4. on a remap step the conservative piecewise-linear (minmod) remap of
     u, v, T and the mixing ratios to the hybrid reference levels, then,
     with the fixer, the global dry-mass fixer toward the initial air
     mass.

Fields are [nelem, nlev, 4, 4] (tracers [nelem, ntracer, nlev, 4, 4],
tracer 0 the moisture the dynamics reads). Equations: routine_mod.F90 and
the SphereOperators of HOMME, as listed beside each function.
"""
from __future__ import annotations

import dataclasses

import torch

REARTH = 6.376e6
RREARTH = 1.0 / REARTH
RGAS = 287.04
CP = 1005.0
KAPPA = RGAS / CP
RVAP = 461.50
MOIST = RVAP / RGAS - 1.0          # T_v = T (1 + MOIST * qdp / dp)
B_WEIGHTS = (1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0)


def lift(g: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-element array [nelem, ..., 4, 4] broadcast against a field of
    ``ndim`` dimensions: singleton axes after the element axis."""
    while g.dim() < ndim:
        g = g.unsqueeze(1)
    return g


class Sphere:
    """The grid's arrays (``grid.build``) as tensors of one dtype on one
    device, with the DSS over its global dofs."""

    def __init__(self, g: dict, dtype, device):
        def t(name):
            return torch.as_tensor(g[name], dtype=dtype, device=device)

        self.dtype, self.device = dtype, device
        self.nelem, self.ndof = g["nelem"], g["ndof"]
        for name in ("dvv", "d", "dinv", "metinv", "metdet", "rmetdet",
                     "mp", "spheremp", "rspheremp", "fcor"):
            setattr(self, name, t(name))
        self.gdof = torch.as_tensor(g["gdof"].reshape(-1), device=device)

    def dss(self, x: torch.Tensor) -> torch.Tensor:
        """Each dof's values summed over the elements that share it and
        handed back to every alias."""
        e = x.shape[0]
        cols = x.reshape(e, -1, 16).transpose(1, 2).reshape(e * 16, -1)
        tot = torch.zeros(self.ndof, cols.shape[1], dtype=x.dtype,
                          device=x.device).index_add_(0, self.gdof, cols)
        return tot[self.gdof].reshape(e, 16, -1).transpose(1, 2) \
            .reshape(x.shape)

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """rspheremp * DSS(x) for an already spheremp-weighted x."""
        return lift(self.rspheremp, x.dim()) * self.dss(x)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The continuous projection P(x) = rspheremp * DSS(spheremp * x)."""
        return self.assemble(lift(self.spheremp, x.dim()) * x)

    def g(self, name: str, ndim: int, a: int | None = None,
          b: int | None = None) -> torch.Tensor:
        x = getattr(self, name)
        if a is not None:
            x = x[:, a, b]
        return lift(x, ndim)


# -- horizontal operators (SphereOperators.hpp) -------------------------------

def _dx(dvv, s):
    return torch.einsum("il,...ij->...lj", dvv, s)


def _dy(dvv, s):
    return torch.einsum("...ji,il->...jl", s, dvv)


def _ax(dvv, x):
    return torch.einsum("ms,...sn->...mn", dvv, x)


def _ay(dvv, x):
    return torch.einsum("...ms,ns->...mn", x, dvv)


def gradient(S: Sphere, s):
    """Latlon gradient of a scalar (hpp:228-269)."""
    n = s.dim()
    v1, v2 = _dx(S.dvv, s) * RREARTH, _dy(S.dvv, s) * RREARTH
    return (S.g("dinv", n, 0, 0) * v1 + S.g("dinv", n, 1, 0) * v2,
            S.g("dinv", n, 0, 1) * v1 + S.g("dinv", n, 1, 1) * v2)


def divergence(S: Sphere, v1, v2):
    """Spherical divergence of a latlon vector (hpp:314-358)."""
    n = v1.dim()
    metdet = S.g("metdet", n)
    gv1 = metdet * (S.g("dinv", n, 0, 0) * v1 + S.g("dinv", n, 0, 1) * v2)
    gv2 = metdet * (S.g("dinv", n, 1, 0) * v1 + S.g("dinv", n, 1, 1) * v2)
    return (_dx(S.dvv, gv1) + _dy(S.dvv, gv2)) \
        * (S.g("rmetdet", n) * RREARTH)


def vorticity(S: Sphere, u, v):
    """Spherical vorticity of (u, v) (hpp:405-449)."""
    n = u.dim()
    vco1 = S.g("d", n, 0, 0) * u + S.g("d", n, 1, 0) * v
    vco2 = S.g("d", n, 0, 1) * u + S.g("d", n, 1, 1) * v
    return (_dx(S.dvv, vco2) - _dy(S.dvv, vco1)) \
        * (S.g("rmetdet", n) * RREARTH)


def divergence_wk(S: Sphere, v1, v2):
    """Weak divergence, the adjoint of ``gradient`` (hpp:493-534)."""
    n = v1.dim()
    sph = S.g("spheremp", n)
    c1 = S.g("dinv", n, 0, 0) * v1 + S.g("dinv", n, 0, 1) * v2
    c2 = S.g("dinv", n, 1, 0) * v1 + S.g("dinv", n, 1, 1) * v2
    return -RREARTH * (_ax(S.dvv, sph * c1) + _ay(S.dvv, sph * c2))


def laplace_wk(S: Sphere, s):
    """Scalar weak Laplacian div_wk(grad s) (hpp:537-550)."""
    return divergence_wk(S, *gradient(S, s))


def vlaplace_wk(S: Sphere, u, v, nu_ratio: float = 1.0):
    """Vector weak Laplacian, contravariant form: grad_wk(nu_ratio div) -
    curl_wk(vort) + the undamped rigid rotation (hpp:938-994)."""
    n = u.dim()
    mp, metdet = S.g("mp", n), S.g("metdet", n)
    div = nu_ratio * divergence(S, u, v)
    vort = vorticity(S, u, v)
    # grad_sphere_wk_testcov (hpp:694-771)
    ax, ay = _ax(S.dvv, mp * div), _ay(S.dvv, mp * div)
    b0 = -metdet * (S.g("metinv", n, 0, 0) * ax + S.g("metinv", n, 1, 0) * ay)
    b1 = -metdet * (S.g("metinv", n, 0, 1) * ax + S.g("metinv", n, 1, 1) * ay)
    g1 = (S.g("d", n, 0, 0) * b0 + S.g("d", n, 0, 1) * b1) * RREARTH
    g2 = (S.g("d", n, 1, 0) * b0 + S.g("d", n, 1, 1) * b1) * RREARTH
    # curl_sphere_wk_testcov (hpp:640-692)
    c0, c1 = -_ay(S.dvv, mp * vort), _ax(S.dvv, mp * vort)
    k1 = (S.g("d", n, 0, 0) * c0 + S.g("d", n, 0, 1) * c1) * RREARTH
    k2 = (S.g("d", n, 1, 0) * c0 + S.g("d", n, 1, 1) * c1) * RREARTH
    rigid = 2.0 * S.g("spheremp", n) * RREARTH * RREARTH
    return rigid * u + (g1 - k1), rigid * v + (g2 - k2)


# -- dynamics (routine_mod.F90:7-177, rsplit > 0) ----------------------------

def caar_rhs(S: Sphere, hv: dict, u, v, t, dp, qdp_moist, phis, pecnd):
    """The tendencies (du, dv, dT, ddp) and the diagnostics phi, omega_p,
    u dp, v dp of one state; vertically Lagrangian (no vertical
    advection)."""
    ptop = float(hv["hyai"][0]) * float(hv["ps0"])
    p = ptop + torch.cumsum(dp, -3) - 0.5 * dp
    gp1, gp2 = gradient(S, p)
    vgrad_p = u * gp1 + v * gp2
    vdp1, vdp2 = u * dp, v * dp
    divdp = divergence(S, vdp1, vdp2)
    vort = vorticity(S, u, v)
    t_v = t * (1.0 + MOIST * (qdp_moist / dp))
    # geopotential, the reverse integral of Rgas T_v dp / p (:255-293)
    h = RGAS * t_v * (dp / p)
    above = torch.flip(torch.cumsum(torch.flip(h, (-3,)), -3), (-3,)) - h
    phi = lift(phis, h.dim()) + above + 0.5 * h
    # omega / p by the forward integral of the divergence (:207-252)
    omega_p = (vgrad_p - (torch.cumsum(divdp, -3) - divdp) - 0.5 * divdp) / p
    ephi = 0.5 * (u * u + v * v) + phi + pecnd
    gt1, gt2 = gradient(S, t)
    ge1, ge2 = gradient(S, ephi)
    gpterm = RGAS * t_v / p
    fv = S.g("fcor", u.dim()) + vort
    du = v * fv - ge1 - gpterm * gp1
    dv = -u * fv - ge2 - gpterm * gp2
    dt_ = -(u * gt1 + v * gt2) + KAPPA * t_v * omega_p
    return (du, dv, dt_, -divdp), dict(phi=phi, omg=omega_p, vn0u=vdp1,
                                        vn0v=vdp2)


def dynamics(S: Sphere, hv: dict, st: dict, moist, consts: dict,
             dt: float):
    """SSPRK3 of (u, v, T, dp) with a projection per stage, T_v from the
    moisture tracer ``moist``. Returns the new (u, v, T, dp), phi of the
    last stage and the accumulators."""
    x0 = tuple(st[k] for k in ("u", "v", "T", "dp"))
    acc = {k: st[k] for k in ("vn0u", "vn0v", "omg")}

    def stage(x, w):
        tend, diag = caar_rhs(S, hv, *x, moist, consts["phis"],
                              consts["pecnd"])
        for k in acc:
            acc[k] = acc[k] + w * diag[k]
        return tuple(a + dt * b for a, b in zip(x, tend)), diag["phi"]

    y, _ = stage(x0, B_WEIGHTS[0])
    x1 = tuple(S.project(a) for a in y)
    y, _ = stage(x1, B_WEIGHTS[1])
    x2 = tuple(S.project(0.75 * a + 0.25 * b) for a, b in zip(x0, y))
    y, phi = stage(x2, B_WEIGHTS[2])
    x3 = tuple(S.project(a / 3.0 + (2.0 / 3.0) * b) for a, b in zip(x0, y))
    return x3, phi, acc


def hyperviscosity(S: Sphere, u, v, t, nu: float, dt: float,
                   subcycle: int = 1):
    """X -= (dt / subcycle) nu grad^4 X for u, v (vector) and T (scalar)."""
    step = dt / subcycle * nu
    for _ in range(subcycle):
        l1, l2 = (S.assemble(a) for a in vlaplace_wk(S, u, v))
        lt = S.assemble(laplace_wk(S, t))
        b1, b2 = (S.assemble(a) for a in vlaplace_wk(S, l1, l2))
        bt = S.assemble(laplace_wk(S, lt))
        u, v, t = u - step * b1, v - step * b2, t - step * bt
    return u, v, t


# -- tracers ------------------------------------------------------------------

def limit(S: Sphere, y, q_in, iters: int):
    """Clip y into the element extrema of q_in, level by level, keeping
    each element's mass sum(spheremp * y): the clipped-off mass (with what
    a pass could not place) goes back into the room toward the bound its
    sign selects, in proportion; after ``iters`` passes any residual is
    spread uniformly by weight."""
    w = lift(S.spheremp, y.dim())
    tiny = torch.finfo(y.dtype).tiny

    def esum(x):
        return x.sum((-2, -1), keepdim=True)

    qmin = q_in.amin((-2, -1), keepdim=True)
    qmax = q_in.amax((-2, -1), keepdim=True)
    mass = esum(w * y)
    carry = torch.zeros_like(mass)
    for _ in range(iters):
        yc = torch.minimum(torch.maximum(y, qmin), qmax)
        lost = esum(w * (y - yc)) + carry
        up = lost > 0
        room = torch.where(up, qmax - yc, yc - qmin)
        total = esum(w * room)
        give = torch.where(up, torch.minimum(lost, total),
                           torch.maximum(lost, -total))
        carry = lost - give
        share = give.abs() / total.clamp(min=tiny)
        y = yc + share * (torch.where(up, qmax, qmin) - yc)
    return y + (mass - esum(w * y)) / esum(w.expand_as(y))


def tracers(S: Sphere, q, u, v, dt: float, iters: int | None):
    """One SSPRK3 substep of the tracer masses q on the winds (u, v),
    each stage limited by ``iters`` passes; ``iters`` None: unlimited."""
    uq, vq = u.unsqueeze(1), v.unsqueeze(1)

    def euler(x):
        return x - dt * divergence(S, uq * x, vq * x)

    def lim(y, q_in):
        return y if iters is None else limit(S, y, q_in, iters)

    q1 = S.project(lim(euler(q), q))
    q2 = S.project(lim(0.75 * q + 0.25 * euler(q1), q1))
    return S.project(lim(q / 3.0 + (2.0 / 3.0) * euler(q2), q2))


# -- the remap and the fixer --------------------------------------------------

def _levels_last(x):
    """[..., K, 4, 4] -> [columns, K]."""
    k = x.shape[-3]
    return torch.movedim(x, -3, -1).reshape(-1, k)


def _levels_back(c, like):
    k = like.shape[-3]
    shape = list(like.shape)
    moved = shape[:-3] + shape[-2:] + [k]
    return torch.movedim(c.reshape(moved), -1, -3)


def remap_column(x, dp_src, dp_tgt):
    """Cell averages x [C, K] on layers dp_src to layers dp_tgt (equal
    totals): the integral of the source's minmod-limited linear
    reconstruction up to each target interface, differenced."""
    c, k = x.shape
    zero = torch.zeros_like(x[:, :1])
    s = torch.cat([zero, torch.cumsum(dp_src, 1)], 1)          # [C, K+1]
    t = torch.cat([zero, torch.cumsum(dp_tgt, 1)], 1)
    g = (x[:, 1:] - x[:, :-1]) / (0.5 * (dp_src[:, 1:] + dp_src[:, :-1]))
    g_lo, g_hi = torch.cat([zero, g], 1), torch.cat([g, zero], 1)
    slope = torch.where(g_lo * g_hi > 0,
                        torch.sign(g_lo) * torch.minimum(g_lo.abs(),
                                                         g_hi.abs()),
                        torch.zeros_like(g_lo))
    below = torch.cat([zero, torch.cumsum(x * dp_src, 1)], 1)  # mass under s_k
    cell = (torch.searchsorted(s[:, :k].contiguous(), t.contiguous(),
                               right=True) - 1).clamp(0, k - 1)
    dpk = dp_src.gather(1, cell)
    xi = torch.minimum((t - s.gather(1, cell)).clamp(min=0.0), dpk)
    integral = below.gather(1, cell) + x.gather(1, cell) * xi \
        + slope.gather(1, cell) * (0.5 * xi * xi - 0.5 * xi * dpk)
    # the last interface covers the whole source column
    integral[:, -1] = below[:, -1]
    return (integral[:, 1:] - integral[:, :-1]) / dp_tgt


def remap_layers(hv: dict, dp) -> tuple:
    """The remap's source and target layers [columns, K] for a state with
    layers dp: the Lagrangian dp to the hybrid reference levels of the same
    column mass."""
    dp_src = _levels_last(dp)
    ps = float(hv["hyai"][0]) * float(hv["ps0"]) + dp_src.sum(1, keepdim=True)
    hyai = torch.as_tensor(hv["hyai"], dtype=ps.dtype, device=ps.device)
    hybi = torch.as_tensor(hv["hybi"], dtype=ps.dtype, device=ps.device)
    dp_ref = torch.diff(hyai)[None] * float(hv["ps0"]) \
        + torch.diff(hybi)[None] * ps
    dp_tgt = dp_ref * (dp_src.sum(1, keepdim=True)
                       / dp_ref.sum(1, keepdim=True))
    return dp_src, dp_tgt


def remap_field(x, layers: tuple):
    """A field's cell averages remapped between ``remap_layers``' layers."""
    return _levels_back(remap_column(_levels_last(x), *layers), x)


def air_mass(S: Sphere, dp) -> torch.Tensor:
    """The spheremp-weighted air mass of dp."""
    return (lift(S.spheremp, dp.dim()) * dp).sum()


@dataclasses.dataclass
class AirStep:
    """One step of everything but the tracers, and what the tracers' part
    of the same step (``tracer_step``) takes from it."""
    out: dict               # u, v, T, dp and the accumulators after the step
    phi: torch.Tensor
    u: torch.Tensor         # the winds the tracers ride: after
    v: torch.Tensor         # hyperviscosity, before the remap
    dp: torch.Tensor        # dp before the remap
    dp_remapped: torch.Tensor | None     # after the remap, before the fixer
    layers: tuple | None    # the remap's layers; None off a remap step
    ratio: torch.Tensor | None           # the fixer's factor; None without
    dt: float
    nsub: int
    iters: int | None


def air_step(S: Sphere, hv: dict, st: dict, moist, consts: dict, cfg: dict,
             remap_step: bool, mass_target=None) -> AirStep:
    """The dynamics, hyperviscosity and, on a remap step, the remap of u,
    v, T and dp with the fixer's factor, from the state ``st`` (u, v, T,
    dp, vn0u, vn0v, omg) and its moisture tracer ``moist`` [nelem, nlev,
    4, 4]. ``cfg`` as ``model_step`` reads it."""
    if cfg["remap"] != "plm":
        raise ValueError(f"reference: remap scheme {cfg['remap']!r}; "
                         f"it carries out plm")
    dt = float(cfg["dt"])
    (u, v, t, dp), phi, acc = dynamics(S, hv, st, moist, consts, dt)
    if cfg["nu"]:
        u, v, t = hyperviscosity(S, u, v, t, float(cfg["nu"]), dt,
                                 int(cfg["hypervis_subcycle"]))
    out = dict(u=u, v=v, T=t, dp=dp, **acc)
    dp_remapped = layers = ratio = None
    if remap_step:
        layers = remap_layers(hv, dp)
        for k in ("u", "v", "T"):
            out[k] = remap_field(out[k], layers)
        dp_remapped = _levels_back(layers[1], dp)
        out["dp"] = dp_remapped
        if cfg["mass_fixer"]:
            ratio = mass_target / air_mass(S, dp_remapped)
            out["dp"] = dp_remapped * ratio
    return AirStep(out=out, phi=phi, u=u, v=v, dp=dp,
                   dp_remapped=dp_remapped, layers=layers, ratio=ratio,
                   dt=dt, nsub=max(int(cfg["qsplit"]), 1),
                   iters=int(cfg["limiter_iters"]) if cfg["limiter"]
                   else None)


def tracer_step(S: Sphere, a: AirStep, q):
    """The same step for a block of tracer masses q [nelem, n, nlev, 4,
    4]: qsplit SSPRK3 substeps on ``a``'s winds, each stage limited where
    the configuration says so; on a remap step the mixing ratios remapped
    to ``a``'s layers and, with the fixer, scaled by its factor. Tracers
    do not mix, so any blocking of them gives the same values."""
    for _ in range(a.nsub):
        q = tracers(S, q, a.u, a.v, a.dt / a.nsub, a.iters)
    if a.layers is not None:
        ratio = q / a.dp.unsqueeze(1)
        q = torch.stack([remap_field(ratio[:, i], a.layers)
                         for i in range(ratio.shape[1])], 1) \
            * a.dp_remapped.unsqueeze(1)
        if a.ratio is not None:
            q = q * a.ratio
    return q


def model_step(S: Sphere, hv: dict, st: dict, consts: dict, cfg: dict,
               remap_step: bool, mass_target=None, tracer_block=None):
    """One step from state ``st`` (u, v, T, dp, q, vn0u, vn0v, omg).
    ``cfg`` holds dt, nu, hypervis_subcycle, qsplit, limiter (whether the
    tracer stages limit), limiter_iters, remap (the scheme: "plm") and
    mass_fixer (whether a remap step ends with the fixer toward
    ``mass_target``). The tracers advance ``tracer_block`` at a time (all
    at once by default), which bounds the memory the substep holds.
    Returns (new state, phi)."""
    a = air_step(S, hv, st, st["q"][:, 0], consts, cfg, remap_step,
                 mass_target)
    nq = st["q"].shape[1]
    blocks = [tracer_step(S, a, st["q"][:, b:b + (tracer_block or nq)])
              for b in range(0, nq, tracer_block or nq)]
    q = blocks[0] if len(blocks) == 1 else torch.cat(blocks, 1)
    return dict(a.out, q=q), a.phi
