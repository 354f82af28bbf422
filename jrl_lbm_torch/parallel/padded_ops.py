"""Halo-padded variants of the lattice ops for a mesh of shards
(counterpart of the JAX package's `parallel/padded_ops.py`).

These mirror the semantics of `jrl_lbm_torch.ops.{stream,stencil,coupling,
macro}` (same reference citations apply), but operate on local blocks
padded with a 1-cell halo (`parallel.halo.pad_halo`) and apply the
reference's domain-edge rules through global-coordinate masks instead of
static border slices, so a shard only touches an edge rule if it owns a
piece of the global border. Plain PyTorch: the plain path of the sharded
cylinder and JRL steps (`parallel/sharded.py`).

Neighbour-rule recap (per the reference CUDA kernels):
* FLUID cells: periodic wrap, provided by the ring halo exchange;
* non-FLUID cells: reflect-clamp (streaming: x-1<0 -> 1, x+1>=W -> W-2)
  or minmax-clamp (stencils/coupling: max(0, x-1), min(W-1, x+1));
* symmetry axis: the negative-side neighbour collapses onto the axis
  line and the incoming channel index is mirrored.
"""

from __future__ import annotations

import math

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.ops.equilibrium import feq
from jrl_lbm_torch.parallel.halo import DomainInfo
from jrl_lbm_torch.utils.types import CellType


def _sl(arrp: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Interior view shifted by (dy, dx) into the 1-cell-padded block."""
    h = arrp.shape[-2] - 2
    w = arrp.shape[-1] - 2
    return arrp[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def pull2(arrp, ex: int, ey: int, is_fluid, dom: DomainInfo, style: str):
    """Value at each cell pulled from (y - ey, x - ex) with edge rules.

    ``style``: 'reflect' (streaming clamp) or 'minmax' (stencil clamp).
    Candidate (mask, offset) pairs are applied in precedence order per
    axis; the cartesian product handles corners where both axes clamp.
    """
    not_fluid = ~is_fluid

    def axis_cands(e, at_lo, at_hi, axis_sym):
        cands = [(None, -e)]
        if e == 1:  # pulling from the negative side
            cands.append((at_lo & not_fluid, 1 if style == "reflect" else 0))
            if axis_sym:
                cands.append((at_lo, 0))  # axis override beats everything
        elif e == -1:  # pulling from the positive side
            cands.append((at_hi & not_fluid, -1 if style == "reflect" else 0))
        return cands

    x_cands = axis_cands(ex, dom.at_x0, dom.at_xW, dom.axis_x)
    y_cands = axis_cands(ey, dom.at_y0, dom.at_yH, dom.axis_y)

    v = None
    for my, yo in y_cands:
        for mx, xo in x_cands:
            patch = _sl(arrp, yo, xo)
            if v is None:
                v = patch
                continue
            if mx is None:
                m = my
            elif my is None:
                m = mx
            else:
                m = mx & my
            v = torch.where(m, patch, v)
    return v


def at2(arrp, sx, sy, is_fluid, dom):
    """Value from offset (sx, sy) with the minmax clamp (stencil rule)."""
    return pull2(arrp, -sx, -sy, is_fluid, dom, style="minmax")


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

def propagate_padded(fp, flagsp, dom: DomainInfo, phi_obs=None, rho=None, vel=None,
                     inflow_vel=None, inflow_density: float | None = None, dx: float = 1.0,
                     dt: float = 1.0):
    """Padded-block port of `ops.stream.propagate`: ``fp`` ``[Q, h+2,
    w+2]`` and ``flagsp`` ``[h+2, w+2]`` halo-padded, ``phi_obs``, ``rho``,
    ``vel`` local; returns ``(rho, vel, f_new)``."""
    flags = _sl(flagsp, 0, 0)
    dtype, dev = fp.dtype, fp.device
    h, w = dom.h, dom.w

    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs_maskp = (flagsp == int(CellType.OBSTACLE)).to(dtype)

    REFL = lattice.REFLECT
    MX = lattice.MIRROR_X
    MY = lattice.MIRROR_Y

    f0 = _sl(fp[0], 0, 0)
    raw_in = [f0] + [None] * 8
    streamed = [f0] + [None] * 8

    for q in range(1, 9):
        ex, ey = int(lattice.E[q, 0]), int(lattice.E[q, 1])

        val = pull2(fp[q], ex, ey, is_fluid, dom, "reflect")
        if dom.axis_x and q in lattice.AXIS_X_IN:
            val_m = pull2(fp[int(MX[q])], ex, ey, is_fluid, dom, "reflect")
            val = torch.where(dom.at_x0, val_m, val)
        if dom.axis_y and q in lattice.AXIS_Y_IN:
            val_m = pull2(fp[int(MY[q])], ex, ey, is_fluid, dom, "reflect")
            val = torch.where(dom.at_y0, val_m, val)
        raw_in[q] = val

        nbr_obs = pull2(obs_maskp, ex, ey, is_fluid, dom, "reflect") > 0.5
        f_this = _sl(fp[int(REFL[q])], 0, 0)
        if phi_obs is None:
            v_obs = f_this
        else:
            f_prev = val
            nxt = pull2(fp[int(REFL[q])], -ex, -ey, is_fluid, dom, "reflect")
            if dom.axis_x and q in lattice.AXIS_X_OUT:
                oq = int(MX[q])
                nxt_m = pull2(fp[int(REFL[oq])], -ex, -ey, is_fluid, dom, "reflect")
                nxt = torch.where(dom.at_x0, nxt_m, nxt)
            if dom.axis_y and q in lattice.AXIS_Y_OUT:
                oq = int(MY[q])
                nxt_m = pull2(fp[int(REFL[oq])], -ex, -ey, is_fluid, dom, "reflect")
                nxt = torch.where(dom.at_y0, nxt_m, nxt)
            t = phi_obs
            v1 = (2.0 * t - 1.0) * f_prev + (2.0 - 2.0 * t) * f_this
            v2 = (2.0 * t) * f_this + (1.0 - 2.0 * t) * nxt
            v_obs = torch.where((t >= 0.5) & (t <= 1.0), v1,
                                torch.where((t >= 0.0) & (t <= 0.5), v2, f_this))
        streamed[q] = torch.where(nbr_obs, v_obs, val)

    out = [f0]
    for p in range(1, 9):
        out.append(torch.where(is_obs, raw_in[int(REFL[p])], streamed[p]))
    f_new = torch.stack(out, dim=0)

    # --- INFLOW ---
    rho_out, vel_out = rho, vel
    in_mask = flags == int(CellType.INFLOW)
    has_inflow_density = inflow_density is not None and inflow_density >= 0
    if has_inflow_density:
        rho_in = torch.full((h, w), inflow_density, dtype=dtype, device=dev)
    elif rho is not None:
        rho_in = rho
    else:
        rho_in = torch.zeros((h, w), dtype=dtype, device=dev)
    if inflow_vel is not None:
        u_in = torch.as_tensor(inflow_vel, dtype=dtype, device=dev)[:, None, None].expand(2, h, w)
    elif vel is not None:
        u_in = vel
    else:
        u_in = torch.zeros((2, h, w), dtype=dtype, device=dev)
    f_new = torch.where(in_mask[None], feq(rho_in, u_in, dx=dx, dt=dt), f_new)
    if rho is not None and has_inflow_density:
        rho_out = torch.where(in_mask, rho_in, rho_out)
    if vel is not None and inflow_vel is not None:
        vel_out = torch.where(in_mask[None], u_in, vel_out)

    # --- INFLOW_2 ---
    in2_mask = flags == int(CellType.INFLOW_2)
    u2 = vel if vel is not None else torch.zeros((2, h, w), dtype=dtype, device=dev)
    f_new = torch.where(in2_mask[None], feq(torch.ones((h, w), dtype=dtype, device=dev), u2,
                                            dx=dx, dt=dt), f_new)
    if rho is not None:
        rho_out = torch.where(in2_mask, torch.ones((), dtype=dtype, device=dev), rho_out)

    # --- OUTFLOW: copy all 9 populations from the adjacent interior cell.
    # The source offsets are strictly inward, so they are local to the
    # shard that owns the border (blocks must be >= 2 wide); rows then
    # columns, like the unsharded op.
    of_mask = flags == int(CellType.OUTFLOW)

    def shift_in(a, dim, lo_mask, hi_mask):
        a = torch.where(lo_mask, torch.roll(a, -1, dims=dim), a)  # value from +1
        return torch.where(hi_mask, torch.roll(a, 1, dims=dim), a)  # value from -1

    g = shift_in(f_new, -2, dom.at_y0[None], dom.at_yH[None])
    g = shift_in(g, -1, dom.at_x0[None], dom.at_xW[None])
    f_new = torch.where(of_mask[None], g, f_new)
    return rho_out, vel_out, f_new


# ---------------------------------------------------------------------------
# Stencils
# ---------------------------------------------------------------------------

def grad_padded(rhop, flagsp, dom, dx: float = 1.0):
    """Padded port of `ops.stencil.get_grad`."""
    flags = _sl(flagsp, 0, 0)
    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs_p = (flagsp == int(CellType.OBSTACLE)).to(rhop.dtype)

    def val(sx, sy):
        return at2(rhop, sx, sy, is_fluid, dom)

    def nbr_obs(sx, sy):
        return at2(obs_p, sx, sy, is_fluid, dom) > 0.5

    def component(pairs):
        """Sum of the direction pairs ``(weight, (a, b), (c, d))`` of one
        component; a blocked pair adds 0 and zeroes the component."""
        g = torch.zeros_like(_sl(rhop, 0, 0))
        blocked = torch.zeros_like(is_obs)
        for wgt, (p_a, p_b), (v_a, v_b) in pairs:
            p = nbr_obs(*p_a) | nbr_obs(*p_b)
            d = val(*v_a) - val(*v_b)
            g = g + torch.where(p, 0.0, wgt * d if wgt != 1.0 else d)
            blocked = blocked | p
        return torch.where(blocked, 0.0, g)

    gx = component([(4.0, ((1, 0), (-1, 0)), ((1, 0), (-1, 0))),
                    (1.0, ((1, 1), (-1, 1)), ((1, 1), (-1, 1))),
                    (1.0, ((-1, -1), (1, -1)), ((1, -1), (-1, -1)))])
    gy = component([(4.0, ((0, 1), (0, -1)), ((0, 1), (0, -1))),
                    (1.0, ((1, 1), (1, -1)), ((1, 1), (1, -1))),
                    (1.0, ((-1, 1), (-1, -1)), ((-1, 1), (-1, -1)))])
    grad = torch.stack([gx, gy], dim=0) / (12.0 * dx)
    return torch.where(is_obs[None], 0.0, grad)


def div_padded(velp, flagsp, dom, dx: float = 1.0):
    """Padded port of `ops.stencil.get_div`."""
    flags = _sl(flagsp, 0, 0)
    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    u, v = velp[0], velp[1]

    def at(a, sx, sy):
        return at2(a, sx, sy, is_fluid, dom)

    d = 4.0 * (at(u, 1, 0) - at(u, -1, 0))
    d = d + at(u, 1, 1) - at(u, -1, 1)
    d = d + at(u, 1, -1) - at(u, -1, -1)
    d = d + 4.0 * (at(v, 0, 1) - at(v, 0, -1))
    d = d + at(v, 1, 1) - at(v, 1, -1)
    d = d + at(v, -1, 1) - at(v, -1, -1)
    return torch.where(is_obs, 0.0, d / (12.0 * dx))


# ---------------------------------------------------------------------------
# Solid-fluid coupling
# ---------------------------------------------------------------------------

def solve_boundary_padded(velp, flagsp, f, phi_obs, dom: DomainInfo, obs_vel_p=None,
                          tau: float = 1.0, dx: float = 1.0, dt: float = 1.0):
    """Padded port of `ops.coupling.solve_boundary`: ``velp`` (and
    ``obs_vel_p``) ``[2, h+2, w+2]``, ``flagsp`` padded, ``f`` ``[Q, h,
    w]`` local (post-streaming; only this cell's values are read)."""
    flags = _sl(flagsp, 0, 0)
    dtype = f.dtype
    h, w = dom.h, dom.w
    c = dx / dt
    cs2 = c * c / 3.0
    eps = 1e-10

    is_fluid = flags == int(CellType.FLUID)
    is_obs = flags == int(CellType.OBSTACLE)
    obs_p = (flagsp == int(CellType.OBSTACLE)).to(dtype)
    skip = is_obs | dom.at_xW | dom.at_yH

    E = lattice.E
    REFL = lattice.REFLECT
    w_np = lattice.W

    t = phi_obs
    t_ok = (t > -eps) & (t <= 1.0 + eps)

    valid = []
    vel_tgt_x = torch.zeros((h, w), dtype=dtype, device=f.device)
    vel_tgt_y = torch.zeros((h, w), dtype=dtype, device=f.device)
    rho_tgt = torch.sum(f, dim=0)
    count = torch.zeros((h, w), dtype=dtype, device=f.device)

    for q in range(9):
        ex, ey = int(E[q, 0]), int(E[q, 1])
        v_q = (at2(obs_p, ex, ey, is_fluid, dom) > 0.5) & t_ok
        valid.append(v_q)
        vmask = v_q.to(dtype)
        count = count + vmask
        tq = torch.where(v_q, t, torch.zeros_like(t))

        ux = at2(velp[0], -ex, -ey, is_fluid, dom)
        uy = at2(velp[1], -ex, -ey, is_fluid, dom)
        if dom.axis_x and q in lattice.AXIS_X_IN:
            ux = torch.where(dom.at_x0, -ux, ux)
        if dom.axis_y and q in lattice.AXIS_Y_IN:
            uy = torch.where(dom.at_y0, -uy, uy)

        if obs_vel_p is not None:
            obs_ux = at2(obs_vel_p[0], ex, ey, is_fluid, dom)
            obs_uy = at2(obs_vel_p[1], ex, ey, is_fluid, dom)
            vel_tgt_x = vel_tgt_x + vmask * (tq * ux + obs_ux) / (tq + 1.0)
            vel_tgt_y = vel_tgt_y + vmask * (tq * uy + obs_uy) / (tq + 1.0)
            qi = int(REFL[q])
            rho_tgt = rho_tgt + vmask * 6.0 * float(w_np[q]) * (
                float(E[qi, 0]) * obs_ux + float(E[qi, 1]) * obs_uy)
        else:
            vel_tgt_x = vel_tgt_x + vmask * tq * ux / (tq + 1.0)
            vel_tgt_y = vel_tgt_y + vmask * tq * uy / (tq + 1.0)

    safe_count = torch.where(count > 0, count, torch.ones_like(count))
    u0 = vel_tgt_x / safe_count
    u1 = vel_tgt_y / safe_count

    def grad12(ap):
        def at(sx, sy):
            return at2(ap, sx, sy, is_fluid, dom)

        gx = (4.0 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))
              + (at(1, -1) - at(-1, -1))) / 12.0
        gy = (4.0 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
              + (at(-1, 1) - at(-1, -1))) / 12.0
        return gx, gy

    g00, g01 = grad12(velp[0])
    g10, g11 = grad12(velp[1])

    f_new = list(f.unbind(0))
    for q in range(9):
        qi = int(REFL[q])
        e0, e1 = float(E[qi, 0]), float(E[qi, 1])
        pab = (u0 * u0 - cs2 * tau * (g00 + g00)) * (e0 * e0 - cs2)
        pab = pab + (u1 * u0 - cs2 * tau * (g10 + g01)) * (e1 * e0)
        pab = pab + (u0 * u1 - cs2 * tau * (g01 + g10)) * (e0 * e1)
        pab = pab + (u1 * u1 - cs2 * tau * (g11 + g11)) * (e1 * e1 - cs2)
        recon = float(w_np[qi]) * rho_tgt * (
            1.0 + (c / cs2) * (u0 * e0 + u1 * e1) + 0.5 * pab / (cs2 * cs2))
        f_new[qi] = torch.where(valid[q] & ~skip, recon, f_new[qi])
    return torch.stack(f_new)


# ---------------------------------------------------------------------------
# Macro moments (local + masked contact angle)
# ---------------------------------------------------------------------------

def macro_padded(f, rho, vel, flags, dom: DomainInfo, dx: float = 1.0, dt: float = 1.0,
                 contact_angle: float | None = None):
    """Padded port of `ops.macro.macro_compute`.

    The contact-angle border extrapolation reads only INWARD (up to 2
    cells from the global border), so it needs no halo, just global
    border masks. Corner cells read their two adjacent border values,
    also local to the corner-owning shard.
    """
    c = dx / dt
    is_obs = flags == int(CellType.OBSTACLE)
    macro_rho = torch.sum(f, dim=0)
    rho_new = torch.where(is_obs, rho, macro_rho)

    if contact_angle is not None:
        tanv = math.tan(math.pi / 2.0 - float(contact_angle))

        def in_x(a, k):  # value from k cells inward along +x (toward interior)
            return torch.roll(a, -k, dims=-1)

        def in_x_neg(a, k):
            return torch.roll(a, k, dims=-1)

        def in_y(a, k):
            return torch.roll(a, -k, dims=-2)

        def in_y_neg(a, k):
            return torch.roll(a, k, dims=-2)

        r = rho_new
        zero = torch.zeros_like(r)
        # col 0 rows 1..H-2: rho[y, 2] + tanv*|rho[y+1,1] - rho[y-1,1]|
        hlp = torch.abs(in_y_neg(in_x(r, 1), 1) - in_y(in_x(r, 1), 1))
        v_left = in_x(r, 2) + tanv * hlp
        # col W-1: rho[y, W-3] + tanv*|rho[y+1,W-2] - rho[y-1,W-2]|
        hlp = torch.abs(in_y_neg(in_x_neg(r, 1), 1) - in_y(in_x_neg(r, 1), 1))
        v_right = in_x_neg(r, 2) + tanv * hlp
        # row 0: rho[2, x] + tanv*|rho[1,x+1] - rho[1,x-1]|
        hlp = torch.abs(in_y(in_x_neg(r, 1), 1) - in_y(in_x(r, 1), 1))
        v_bot = in_y(r, 2) + tanv * hlp
        # row H-1: rho[H-3, x] + tanv*|rho[H-2,x+1] - rho[H-2,x-1]|
        hlp = torch.abs(in_y_neg(in_x_neg(r, 1), 1) - in_y_neg(in_x(r, 1), 1))
        v_top = in_y_neg(r, 2) + tanv * hlp

        inner_y = (~dom.at_y0) & (~dom.at_yH)
        inner_x = (~dom.at_x0) & (~dom.at_xW)
        rho_obs = zero
        rho_obs = torch.where(dom.at_x0 & inner_y, v_left, rho_obs)
        rho_obs = torch.where(dom.at_xW & inner_y, v_right, rho_obs)
        rho_obs = torch.where(dom.at_y0 & inner_x, v_bot, rho_obs)
        rho_obs = torch.where(dom.at_yH & inner_x, v_top, rho_obs)

        # corners: average of the two adjacent rho_obs values; the
        # reference's bottom-right corner uses rho_obs[-2,-2] twice
        # (`LBM_macro_compute_2d.py:269`)
        c00 = 0.5 * (in_y(rho_obs, 1) + in_x(rho_obs, 1))
        c_h0 = 0.5 * (in_y_neg(rho_obs, 1) + in_x(rho_obs, 1))
        c0w = 0.5 * (in_x_neg(rho_obs, 1) + in_y(rho_obs, 1))
        chw = in_y_neg(in_x_neg(rho_obs, 1), 1)
        rho_obs = torch.where(dom.at_y0 & dom.at_x0, c00, rho_obs)
        rho_obs = torch.where(dom.at_yH & dom.at_x0, c_h0, rho_obs)
        rho_obs = torch.where(dom.at_y0 & dom.at_xW, c0w, rho_obs)
        rho_obs = torch.where(dom.at_yH & dom.at_xW, chw, rho_obs)

        rho_new = torch.where(is_obs, rho_obs, rho_new)

    mom_x = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    mom_y = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    safe_rho = torch.where(rho_new == 0, torch.ones_like(rho_new), rho_new)
    vel_new = torch.stack([mom_x, mom_y], dim=0) * (c / safe_rho)[None]
    vel_new = torch.where(is_obs[None], vel, vel_new)
    return rho_new, vel_new
