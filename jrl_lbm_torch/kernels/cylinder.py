"""Cylinder-channel kernels: the CUDA kernels of the fused step, their
plain PyTorch twins and the glue that runs them (counterpart of the JAX
package's `ops/pallas/fused_step.py`).

Replace the TPU kernels of `jrl_lbm_tpu/ops/pallas/fused_step.py`:

* ``cyl_full`` (`csrc/cyl_full.cu`) <- ``_make_full_kernel``: one
  full-boundary step (all six cell types, sub-grid bounce, INFLOW plug,
  OUTFLOW copy, static-cylinder coupling, moments, MRT) on given rows;
* ``cyl_interior`` (`csrc/cyl_interior.cu`) <- ``_make_interior_kernel``:
  one plain-channel step (static wall columns) on given rows;
* ``cyl_interior_k`` (`csrc/cyl_interior_k.cu`) <- ``_make_interior_kernel2``:
  k plain-channel steps per launch (temporal blocking);
* ``cyl_band_k`` (`csrc/cyl_band_k.cu`) <- ``_make_full_kernel2``: k
  full-boundary steps per launch on the band rows, "cyl" or "edge"
  variant;
* ``cyl_pass`` (`csrc/cyl_pass.cu`) <- the three calls of
  ``_fused_step2_split_impl`` (``_make_interior_kernel2`` and
  ``_make_full_kernel2`` "cyl" and "edge") in one launch: a k-step pass
  streamed row by row, bit for bit the three launches above, which stay
  as its yardstick (``route="launches"``). The runner's k-step passes go
  through it.

Each kernel reads only the previous state and writes its rows of separate
output buffers, so the interior and band launches of one step need no
merge copy: state ping-pongs between two buffer sets. Rows a launch does
not own are left as they are in the output buffers.

A wrapper given tensors on the CPU runs the twin; given tensors on the
card it launches the kernel or raises. ``<wrapper>.launches`` counts the
launches. The twins compute each step on the whole grid and write the
wrapper's rows; a k-step twin runs k whole-grid steps. On those rows that
is what the kernel computes: a k-step tile recomputes its k-cell halo,
which is exact on a border that `check_border` accepts. ``cyl_pass``'s
twin runs those twins block by block, each on the grid NaN beyond the
block's window (`cyl_pass_ref`). Their arithmetic
follows the Pallas bodies: the
division-free equilibrium `_feq_terms` and the paired even/odd MRT
`_mrt_apply`, so kernel and twin round alike (the sources build with
``--fmad=false``).

Semantics of the fused step kept from the JAX package (its module note):
no contact-angle extrapolation; OBSTACLE rho passes through at k=1 and is
``cfg.density`` in the k-step kernels; obstacle velocity 0 and no body
force; OUTFLOW only on the global border; no INFLOW_2 rule. The split
path assumes the cylinder scene: plain-channel rows outside the band
(walls at x = 0 and W-1); the k-step path checks the border once per
flags field.

Storage of f (``bf16_dev``, as in the JAX package): ``False`` keeps f in
float32; ``True`` stores the deviation g = f - w_q in bfloat16, rounded
to nearest; ``"sr"`` rounds it stochastically, adding 16 random bits to
the float32 pattern of g and keeping its top 16 bits. The bits come from
Philox4x32-10 (`philox.py`, `csrc/philox.cuh`) under the key (seed,
launch number): one `LaunchKeys` per step or runner hands each launch its
own key, so a seed replays its run and no two launches share a key. rho
and vel stay float32. Each kernel and twin converts only where f is read
from or written to its buffers: a k-step pass rounds once. The launch
counts are per kernel name (``<wrapper>.launches``) and per storage mode
(``<wrapper>.launches_by_mode``, keyed by `MODE_NAMES`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.kernels import build, philox
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.utils.types import CellType

FLUID = int(CellType.FLUID)
OBSTACLE = int(CellType.OBSTACLE)
INFLOW = int(CellType.INFLOW)
OUTFLOW = int(CellType.OUTFLOW)

E = lattice.E
REFL = lattice.REFLECT
W_Q = lattice.W
CS2 = 1.0 / 3.0
_QPAIRS = ((1, 3), (2, 4), (5, 7), (6, 8))
KMAX = 8  # deepest temporal blocking the k-step kernels take (csrc/cyl_common.cuh)
MODE_NAMES = ("f32", "bf16", "bf16_sr")  # by csrc/cyl_common.cuh::Storage code


# ---------------------------------------------------------------------------
# Storage of f
# ---------------------------------------------------------------------------

def _storage(bf16_dev) -> int:
    """The storage code (csrc/cyl_common.cuh::Storage) of ``bf16_dev``:
    0 for False, 1 for True, 2 for "sr"; any other value raises."""
    if bf16_dev is False:
        return 0
    if bf16_dev is True:
        return 1
    if isinstance(bf16_dev, str) and bf16_dev == "sr":
        return 2
    raise ValueError(f"bf16_dev={bf16_dev!r}: the storage modes are False (float32), "
                     "True (bf16 deviations, round to nearest) and \"sr\" (stochastic rounding)")


def _weights(device) -> torch.Tensor:
    """w_q as float32 ``[9, 1, 1]`` (each weight rounded once from double)."""
    return torch.tensor(W_Q, dtype=torch.float32, device=device)[:, None, None]


def f_to_storage(f, bf16_dev=False):
    """The kernels' storage form of a float32 ``f``: ``f`` itself, or the
    deviation f - w_q as ``torch.bfloat16``, rounded to nearest (also for
    "sr", as ``fused_step.py::f_to_storage`` prepares a state)."""
    if _storage(bf16_dev) == 0:
        return f
    return (f - _weights(f.device)).to(torch.bfloat16)


def f_from_storage(g, bf16_dev=False):
    """float32 f of a stored ``g``: ``g`` itself, or float(g) + w_q."""
    if _storage(bf16_dev) == 0:
        return g
    return g.to(torch.float32) + _weights(g.device)


def sr_round(d, key):
    """Stochastic rounding of float32 deviations ``d`` [9, H, W] to
    bfloat16: the 16 Philox bits of each population and cell
    (`philox.sr_bits`) added to the float32 pattern, the top 16 bits kept."""
    bits = d.contiguous().view(torch.int32).to(torch.int64) & philox.MASK32
    r = philox.sr_bits(d[0].numel(), key, d.device).view(d.shape)
    top = (((bits + r) & 0xFFFF0000) >> 16).to(torch.int32)
    return (top - ((top >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def _store(f, bf16_dev, key):
    """One store of a float32 ``f`` [9, H, W] as the kernels store it
    (``csrc/cyl_common.cuh::f_store``); ``key`` is the launch's Philox key
    (stochastic rounding only)."""
    if _storage(bf16_dev) < 2:
        return f_to_storage(f, bf16_dev)
    return sr_round(f - _weights(f.device), key)


class LaunchKeys:
    """The Philox keys ``(seed, launch number)`` of the stochastic-rounding
    launches of one seed: `next` hands each launch the next number. A step
    or runner holds one; the runner shares it among its k=4, k=2 and k=1
    steps. Setting ``n`` back replays the same keys."""

    def __init__(self, seed: int):
        if not 0 <= int(seed) < 2 ** 32:
            raise ValueError(f"seed {seed}: the Philox key takes 0 <= seed < 2**32")
        self.seed, self.n = int(seed), 0

    def next(self):
        if self.n >= 2 ** 32:
            raise ValueError("2**32 launches under one seed: the launch numbers are spent")
        key = (self.seed, self.n)
        self.n += 1
        return key


# ---------------------------------------------------------------------------
# Constants of a configuration
# ---------------------------------------------------------------------------

def _feq_terms(rho, ux, uy):
    """Division-free D2Q9 equilibrium (``fused_step.py::_feq_terms``) of
    tensors or Python floats; 9 values."""
    uv = ux * ux + uy * uy
    base = 1.0 - 1.5 * uv
    eus = {1: ux, 2: uy, 5: ux + uy, 6: uy - ux}
    out = [None] * 9
    out[0] = rho * (float(W_Q[0]) * base)
    for q, qb in _QPAIRS:
        eu = eus[q]
        c = base + 4.5 * (eu * eu)
        e3 = 3.0 * eu
        rw = rho * float(W_Q[q])
        out[q] = rw * (c + e3)
        out[qb] = rw * (c - e3)
    return out


def _pair_decomp(A):
    """Even/odd form of the relaxation matrix over the opposite-direction
    pairs (``fused_step.py::_pair_decomp``); None when A does not respect
    the parity (never for `mrt_matrices`)."""
    ev, od = {}, {}
    for q in range(9):
        ev[q] = [A[q][0]] + [0.5 * (A[q][i] + A[q][j]) for i, j in _QPAIRS]
        od[q] = [0.5 * (A[q][i] - A[q][j]) for i, j in _QPAIRS]
    tol = 1e-10
    for q, qb in _QPAIRS:
        if any(abs(x - y) > tol for x, y in zip(ev[q], ev[qb])):
            return None
        if any(abs(x + y) > tol for x, y in zip(od[q], od[qb])):
            return None
    if any(abs(x) > tol for x in od[0]):
        return None
    return ev, od


class Consts:
    """What the kernels and twins take from a `CylinderConfig`."""

    def __init__(self, cfg):
        self.H, self.W = cfg.res
        self.tau = float(cfg.tau)
        self.density = float(cfg.density)
        self.inflow_vx, self.inflow_vy = 0.0, float(cfg.Vmax)
        minv_s_m, _ = _collide.mrt_matrices(cfg.tau)
        A = [[float(minv_s_m[a][b]) for b in range(9)] for a in range(9)]
        dec = _pair_decomp(A)
        if dec is None:
            raise ValueError("MRT matrix without the even/odd pair form: not supported")
        self.ev, self.od = dec
        self.feq_in = _feq_terms(self.density, self.inflow_vx, self.inflow_vy)


@functools.lru_cache(maxsize=16)
def consts(cfg) -> Consts:
    return Consts(cfg)


# ---------------------------------------------------------------------------
# Plain twins: one step on the whole grid
# ---------------------------------------------------------------------------

def _shift(a, ex: int, ey: int, nf, style: str):
    """Value at (y, x) from (y - ey, x - ex): FLUID cells wrap; non-FLUID
    cells (``nf``) on the border take the reflected (``"reflect"``: x-1 < 0
    -> 1) or the clamped (``"clamp"``) neighbour (``fused_step.py`` pull)."""
    if ex == 0 and ey == 0:
        return a
    wrap = torch.roll(a, (ey, ex), dims=(-2, -1))
    b = torch.roll(a, ex, dims=-1)
    if ex == 1:
        b[..., 0] = a[..., 1] if style == "reflect" else a[..., 0]
    elif ex == -1:
        b[..., -1] = a[..., -2] if style == "reflect" else a[..., -1]
    c = torch.roll(b, ey, dims=-2)
    if ey == 1:
        c[..., 0, :] = b[..., 1, :] if style == "reflect" else b[..., 0, :]
    elif ey == -1:
        c[..., -1, :] = b[..., -2, :] if style == "reflect" else b[..., -1, :]
    return torch.where(nf, c, wrap)


def _dot(coeffs, vals):
    acc = None
    for c, x in zip(coeffs, vals):
        if c == 0.0:
            continue
        term = x if c == 1.0 else c * x
        acc = term if acc is None else acc + term
    return 0.0 if acc is None else acc


def _mrt_apply(c: Consts, fb, fe, is_obs):
    """Paired even/odd M^-1 S M relaxation with OBSTACLE passthrough
    (``fused_step.py::_mrt_apply``); list of 9 planes."""
    d = [fe[q] - fb[q] for q in range(9)]
    u = [d[0]] + [d[i] + d[j] for i, j in _QPAIRS]
    v = [d[i] - d[j] for i, j in _QPAIRS]
    out = [None] * 9
    out[0] = fb[0] + _dot(c.ev[0], u)
    for q, qb in _QPAIRS:
        e_part = _dot(c.ev[q], u)
        o_part = _dot(c.od[q], v)
        out[q] = fb[q] + (e_part + o_part)
        out[qb] = fb[qb] + (e_part - o_part)
    return [torch.where(is_obs, fb[q], out[q]) for q in range(9)]


def _moments_mrt(c: Consts, f_new, is_obs, rho_obs, vx_obs, vy_obs):
    """Moments with the OBSTACLE passthrough values, then MRT; returns
    ``(f [9,H,W], rho, vx, vy)``."""
    macro_rho = f_new[0]
    for q in range(1, 9):
        macro_rho = macro_rho + f_new[q]
    rho_n = torch.where(is_obs, rho_obs, macro_rho)
    mom_x = f_new[1] - f_new[3] + f_new[5] - f_new[6] - f_new[7] + f_new[8]
    mom_y = f_new[2] - f_new[4] + f_new[5] + f_new[6] - f_new[7] - f_new[8]
    safe_rho = torch.where(rho_n == 0, 1.0, rho_n)
    u_x = torch.where(is_obs, vx_obs, mom_x / safe_rho)
    u_y = torch.where(is_obs, vy_obs, mom_y / safe_rho)
    out = _mrt_apply(c, f_new, _feq_terms(rho_n, u_x, u_y), is_obs)
    return torch.stack(out), rho_n, u_x, u_y


def lean_step_ref(f, c: Consts):
    """One plain-channel step on every row (``_lean_step_rows``): wall
    columns x = 0 and W-1 (static bounce, rho = ``cfg.density``, vel 0),
    FLUID elsewhere; returns ``(f, rho, vx, vy)``."""
    H, W = f.shape[-2:]
    gx = torch.arange(W, device=f.device).expand(H, W)
    at_x0, at_xW = gx == 0, gx == W - 1
    is_obs = at_x0 | at_xW
    nbr_lo, nbr_hi = gx == 1, gx == W - 2

    def pull(q):
        ex, ey = int(E[q, 0]), int(E[q, 1])
        rows = torch.roll(f[q], ey, dims=-2)
        if ex == 0:
            return rows
        base = torch.roll(rows, ex, dims=-1)
        if ex == 1:
            return torch.where(at_x0, torch.roll(rows, -1, dims=-1), base)
        return torch.where(at_xW, torch.roll(rows, 1, dims=-1), base)

    raw_in = [f[0]] + [pull(q) for q in range(1, 9)]
    f_new = [raw_in[0]]
    for q in range(1, 9):
        ex = int(E[q, 0])
        streamed = raw_in[q]
        if ex == 1:
            streamed = torch.where(nbr_lo, f[int(REFL[q])], streamed)
        elif ex == -1:
            streamed = torch.where(nbr_hi, f[int(REFL[q])], streamed)
        f_new.append(torch.where(is_obs, raw_in[int(REFL[q])], streamed))
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return _moments_mrt(c, f_new, is_obs, torch.full_like(zero, c.density), zero, zero)


def full_step_ref(f, vel, flags, phi, c: Consts, rho_obs, vel_obs):
    """One full-boundary step on every row (``_make_full_kernel`` /
    ``_full_step_rows``). ``vel`` feeds the coupling stencils; ``rho_obs``
    and ``vel_obs`` ([2, H, W] or scalars) are what OBSTACLE cells keep.
    With ``phi`` None (the "edge" variant) there is no sub-grid bounce and
    no coupling, and ``vel`` is not read. Returns ``(f, rho, vx, vy)``."""
    H, W = flags.shape
    dev = f.device
    gy = torch.arange(H, device=dev)[:, None].expand(H, W)
    gx = torch.arange(W, device=dev)[None, :].expand(H, W)
    at_y0, at_yH = gy == 0, gy == H - 1
    at_x0, at_xW = gx == 0, gx == W - 1
    nf = flags != FLUID
    is_obs = flags == OBSTACLE
    obs_f = is_obs.to(f.dtype)
    coupling = phi is not None
    if coupling:
        t_ok = (phi > -1e-10) & (phi <= 1.0 + 1e-10)
    else:
        phi = torch.zeros((H, W), dtype=f.dtype, device=dev)
        t_ok = torch.zeros((H, W), dtype=torch.bool, device=dev)

    raw_in = [f[0]]
    for q in range(1, 9):
        raw_in.append(_shift(f[q], int(E[q, 0]), int(E[q, 1]), nf, "reflect"))
    f_new = [f[0]]
    for q in range(1, 9):
        ex, ey = int(E[q, 0]), int(E[q, 1])
        nbr_obs = _shift(obs_f, ex, ey, nf, "reflect") > 0.5
        f_this = f[int(REFL[q])]
        nxt = _shift(f[int(REFL[q])], -ex, -ey, nf, "reflect")
        v1 = (2.0 * phi - 1.0) * raw_in[q] + (2.0 - 2.0 * phi) * f_this
        v2 = (2.0 * phi) * f_this + (1.0 - 2.0 * phi) * nxt
        v_obs = torch.where(t_ok, torch.where(phi >= 0.5, v1, v2), f_this)
        streamed = torch.where(nbr_obs, v_obs, raw_in[q])
        f_new.append(torch.where(is_obs, raw_in[int(REFL[q])], streamed))

    in_mask = flags == INFLOW
    for q in range(9):
        f_new[q] = torch.where(in_mask, c.feq_in[q], f_new[q])

    of_mask = flags == OUTFLOW
    for q in range(9):
        g = f_new[q]
        g = torch.where(at_y0, torch.roll(g, -1, dims=0), g)
        g = torch.where(at_yH, torch.roll(g, 1, dims=0), g)
        g = torch.where(at_x0, torch.roll(g, -1, dims=1), g)
        g = torch.where(at_xW, torch.roll(g, 1, dims=1), g)
        f_new[q] = torch.where(of_mask, g, f_new[q])

    if coupling:
        _couple(f_new, vel, nf, is_obs, obs_f, phi, t_ok, at_xW | at_yH, c)

    return _moments_mrt(c, f_new, is_obs, rho_obs, vel_obs[0], vel_obs[1])


def _couple(f_new, vel, nf, is_obs, obs_f, phi, t_ok, border, c: Consts):
    """Static-cylinder nonequilibrium reconstruction, in place on the list
    ``f_new`` (``_make_full_kernel`` coupling section)."""
    skip = is_obs | border
    rho_tgt = f_new[0]
    for q in range(1, 9):
        rho_tgt = rho_tgt + f_new[q]
    vel_tgt_x = torch.zeros_like(phi)
    vel_tgt_y = torch.zeros_like(phi)
    count = torch.zeros_like(phi)
    valid = []
    tq = torch.where(t_ok, phi, 0.0)
    tqr = tq / (tq + 1.0)
    for q in range(9):
        ex, ey = int(E[q, 0]), int(E[q, 1])
        v_q = (_shift(obs_f, -ex, -ey, nf, "clamp") > 0.5) & t_ok
        valid.append(v_q)
        vmask = v_q.to(phi.dtype)
        count = count + vmask
        ux = _shift(vel[0], ex, ey, nf, "clamp")
        uy = _shift(vel[1], ex, ey, nf, "clamp")
        vel_tgt_x = vel_tgt_x + vmask * tqr * ux
        vel_tgt_y = vel_tgt_y + vmask * tqr * uy
    safe_count = torch.where(count > 0, count, 1.0)
    u0 = vel_tgt_x / safe_count
    u1 = vel_tgt_y / safe_count

    def grad12(a):
        def at(sx, sy):
            return _shift(a, -sx, -sy, nf, "clamp")

        gxx = (4.0 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))
               + (at(1, -1) - at(-1, -1))) / 12.0
        gyy = (4.0 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
               + (at(-1, 1) - at(-1, -1))) / 12.0
        return gxx, gyy

    g00, g01 = grad12(vel[0])
    g10, g11 = grad12(vel[1])
    cs2tau = CS2 * c.tau
    for q in range(9):
        qi = int(REFL[q])
        e0, e1 = float(E[qi, 0]), float(E[qi, 1])
        pab = (u0 * u0 - cs2tau * (g00 + g00)) * (e0 * e0 - CS2)
        pab = pab + (u1 * u0 - cs2tau * (g10 + g01)) * (e1 * e0)
        pab = pab + (u0 * u1 - cs2tau * (g01 + g10)) * (e0 * e1)
        pab = pab + (u1 * u1 - cs2tau * (g11 + g11)) * (e1 * e1 - CS2)
        recon = float(W_Q[qi]) * rho_tgt * (
            1.0 + (1.0 / CS2) * (u0 * e0 + u1 * e1) + 0.5 * pab / (CS2 * CS2)
        )
        f_new[qi] = torch.where(valid[q] & ~skip, recon, f_new[qi])


def _write_rows(out, segs, f=None, rho=None, vx=None, vy=None):
    for y0, y1 in segs:
        if f is not None:
            out["f"][:, y0:y1] = f[:, y0:y1]
        if rho is not None:
            out["rho"][y0:y1] = rho[y0:y1]
            out["vel"][0, y0:y1] = vx[y0:y1]
            out["vel"][1, y0:y1] = vy[y0:y1]


# Each twin loads f from its storage, runs float32 steps and stores once.

def cyl_full_ref(f, rho, vel, flags, phi, out, segs, c: Consts, bf16_dev=False, key=None):
    fn, rho_n, vx, vy = full_step_ref(f_from_storage(f, bf16_dev), vel, flags, phi, c, rho, vel)
    _write_rows(out, segs, _store(fn, bf16_dev, key), rho_n, vx, vy)


def cyl_interior_ref(f, out, segs, c: Consts, write_macro: bool, bf16_dev=False, key=None):
    fn, rho, vx, vy = lean_step_ref(f_from_storage(f, bf16_dev), c)
    _write_rows(out, segs, _store(fn, bf16_dev, key), *((rho, vx, vy) if write_macro else ()))


def cyl_interior_k_ref(f, out, segs, k: int, c: Consts, write_macro: bool, bf16_dev=False,
                       key=None):
    f = f_from_storage(f, bf16_dev)
    for _ in range(k):
        f, rho, vx, vy = lean_step_ref(f, c)
    _write_rows(out, segs, _store(f, bf16_dev, key), *((rho, vx, vy) if write_macro else ()))


def cyl_band_k_ref(f, vel, flags, phi, out, segs, k: int, edge: bool, c: Consts, bf16_dev=False,
                   key=None):
    """k full steps with OBSTACLE rho ``cfg.density``; OBSTACLE vel is
    carried from step to step ("cyl") or 0 ("edge", no coupling)."""
    f = f_from_storage(f, bf16_dev)
    rho_obs = torch.full_like(flags, c.density, dtype=f.dtype)
    for _ in range(k):
        vel_obs = torch.zeros_like(vel) if edge else vel
        f, rho, vx, vy = full_step_ref(f, vel, flags, None if edge else phi, c, rho_obs,
                                       vel_obs)
        vel = torch.stack([vx, vy])
    _write_rows(out, segs, _store(f, bf16_dev, key), rho, vel[0], vel[1])


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

MAX_SEGS = 3


class CylParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("nseg", ctypes.c_int),
        ("write_macro", ctypes.c_int), ("seg", ctypes.c_int * (2 * MAX_SEGS)),
        ("cs2tau", ctypes.c_float), ("wall_density", ctypes.c_float),
        ("feq_in", ctypes.c_float * 9), ("ev0", ctypes.c_float * 5),
        ("ev", (ctypes.c_float * 5) * 4), ("od", (ctypes.c_float * 4) * 4),
        ("key", ctypes.c_uint32 * 2),
    ]


def _params(c: Consts, segs, write_macro: bool, key=None) -> CylParams:
    p = CylParams(H=c.H, W=c.W, nseg=len(segs), write_macro=int(write_macro),
                  cs2tau=CS2 * c.tau, wall_density=c.density)
    for i, (y0, y1) in enumerate(segs):
        p.seg[2 * i], p.seg[2 * i + 1] = y0, y1
    if key is not None:
        p.key[:] = [int(x) & 0xFFFFFFFF for x in key]
    p.feq_in[:] = [float(x) for x in c.feq_in]
    p.ev0[:] = c.ev[0]
    for i, (q, _) in enumerate(_QPAIRS):
        p.ev[i][:] = c.ev[q]
        p.od[i][:] = c.od[q]
    return p


def _check(c: Consts, segs, f_dtype=torch.float32, **tensors) -> torch.device:
    """Float32 (flags int32; f and f_out ``f_dtype``) contiguous tensors
    of the grid on one CUDA device, outputs apart from inputs, and 1-3
    sorted disjoint row segments inside the grid."""
    H, W = c.H, c.W
    if H < 3 or W < 3:
        raise ValueError(f"grid {H}x{W} too small for the kernels (need >= 3x3)")
    if not 1 <= len(segs) <= MAX_SEGS:
        raise ValueError(f"{len(segs)} row segments; the kernels take 1 to {MAX_SEGS}")
    last = 0
    for y0, y1 in segs:
        if not last <= y0 < y1 <= H:
            raise ValueError(f"row segments {segs} not sorted, disjoint and inside [0, {H})")
        last = y1
    tensors = {name: tl for name, tl in tensors.items() if tl[0] is not None}
    for name, (t, lead) in tensors.items():
        want = tuple(lead) + (H, W)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        want_dtype = {"flags": torch.int32, "f": f_dtype, "f_out": f_dtype}.get(name,
                                                                             torch.float32)
        if t.dtype != want_dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    ptrs = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    outs = {v for k, v in ptrs.items() if k.endswith("_out")}
    ins = {v for k, v in ptrs.items() if not k.endswith("_out")}
    if outs & ins or len(outs) != sum(k.endswith("_out") for k in ptrs):
        raise ValueError("output buffers must be apart from the inputs and from each other")
    dev = None
    for name, (t, _) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: on {t.device}, the kernel needs the card")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the others on {dev}")
    return dev


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_k(k: int):
    if not 1 <= int(k) <= KMAX:
        raise ValueError(f"k = {k}: the temporal-blocking kernels take 1 <= k <= {KMAX}")


def _mode(bf16_dev, key, f, f_out):
    """``(storage code, f dtype)`` of a launch: f and f_out must hold the
    mode's storage, and a stochastic-rounding launch needs its Philox key."""
    st = _storage(bf16_dev)
    fdt = torch.float32 if st == 0 else torch.bfloat16
    for name, t in (("f", f), ("f_out", f_out)):
        if t.dtype != fdt:
            raise ValueError(f"{name}: dtype {t.dtype}, but bf16_dev={bf16_dev!r} stores {fdt}")
    if st == 2 and key is None:
        raise ValueError("bf16_dev=\"sr\" needs the launch's Philox key (seed, launch number)")
    return st, fdt


def _count(fn, st: int):
    fn.launches += 1
    fn.launches_by_mode[MODE_NAMES[st]] += 1


# Each wrapper takes f and out["f"] in the storage of ``bf16_dev`` (float32,
# or bfloat16 for True and "sr"), and for "sr" the launch's Philox key.

def cyl_full(f, rho, vel, flags, phi, out, segs, c: Consts, bf16_dev=False, key=None):
    """One full-boundary step on the rows of ``segs`` (``[(y0, y1), ...]``)
    into ``out["f"]``, ``out["rho"]``, ``out["vel"]``."""
    st, fdt = _mode(bf16_dev, key, f, out["f"])
    if f.device.type == "cpu":
        return cyl_full_ref(f, rho, vel, flags, phi, out, segs, c, bf16_dev, key)
    dev = _check(c, segs, fdt, f=(f, (9,)), rho=(rho, ()), vel=(vel, (2,)), flags=(flags, ()),
                 phi=(phi, ()), f_out=(out["f"], (9,)), rho_out=(out["rho"], ()),
                 vel_out=(out["vel"], (2,)))
    p = _params(c, segs, True, key)
    fn = build.bind("cyl_full", "cyl_full_launch", [_P] * 8 + [_I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), rho.data_ptr(), vel.data_ptr(), flags.data_ptr(), phi.data_ptr(),
                 out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(), st,
                 ctypes.byref(p), _stream(dev))
    build.check(err, "cyl_full")
    _count(cyl_full, st)


def cyl_interior(f, out, segs, c: Consts, write_macro: bool, bf16_dev=False, key=None):
    """One plain-channel step on the rows of ``segs``; rho and vel are
    written only with ``write_macro``."""
    st, fdt = _mode(bf16_dev, key, f, out["f"])
    if f.device.type == "cpu":
        return cyl_interior_ref(f, out, segs, c, write_macro, bf16_dev, key)
    rho_o, vel_o = (out["rho"], out["vel"]) if write_macro else (None, None)
    dev = _check(c, segs, fdt, f=(f, (9,)), f_out=(out["f"], (9,)), rho_out=(rho_o, ()),
                 vel_out=(vel_o, (2,)))
    p = _params(c, segs, write_macro, key)
    fn = build.bind("cyl_interior", "cyl_interior_launch", [_P] * 4 + [_I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), out["f"].data_ptr(), _ptr(rho_o), _ptr(vel_o), st,
                 ctypes.byref(p), _stream(dev))
    build.check(err, "cyl_interior")
    _count(cyl_interior, st)


def cyl_interior_k(f, out, segs, k: int, c: Consts, write_macro: bool, bf16_dev=False,
                   key=None):
    """k plain-channel steps in one launch on the rows of ``segs``."""
    st, fdt = _mode(bf16_dev, key, f, out["f"])
    if f.device.type == "cpu":
        return cyl_interior_k_ref(f, out, segs, k, c, write_macro, bf16_dev, key)
    _check_k(k)
    rho_o, vel_o = (out["rho"], out["vel"]) if write_macro else (None, None)
    dev = _check(c, segs, fdt, f=(f, (9,)), f_out=(out["f"], (9,)), rho_out=(rho_o, ()),
                 vel_out=(vel_o, (2,)))
    p = _params(c, segs, write_macro, key)
    fn = build.bind("cyl_interior_k", "cyl_interior_k_launch", [_P] * 4 + [_I, _I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), out["f"].data_ptr(), _ptr(rho_o), _ptr(vel_o), int(k), st,
                 ctypes.byref(p), _stream(dev))
    build.check(err, "cyl_interior_k")
    _count(cyl_interior_k, st)


def cyl_band_k(f, vel, flags, phi, out, segs, k: int, edge: bool, c: Consts, bf16_dev=False,
               key=None):
    """k full-boundary steps in one launch on the rows of ``segs``:
    the "cyl" variant, or with ``edge`` the INFLOW/OUTFLOW variant (no
    coupling, no vel/phi reads)."""
    st, fdt = _mode(bf16_dev, key, f, out["f"])
    if f.device.type == "cpu":
        return cyl_band_k_ref(f, vel, flags, phi, out, segs, k, edge, c, bf16_dev, key)
    _check_k(k)
    dev = _check(c, segs, fdt, f=(f, (9,)), vel=(vel, (2,)), flags=(flags, ()), phi=(phi, ()),
                 f_out=(out["f"], (9,)), rho_out=(out["rho"], ()), vel_out=(out["vel"], (2,)))
    p = _params(c, segs, True, key)
    fn = build.bind("cyl_band_k", "cyl_band_k_launch", [_P] * 7 + [_I, _I, _I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), vel.data_ptr(), flags.data_ptr(), phi.data_ptr(),
                 out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(), int(k),
                 int(bool(edge)), st, ctypes.byref(p), _stream(dev))
    build.check(err, "cyl_band_k")
    _count(cyl_band_k, st)


# ---------------------------------------------------------------------------
# The k-step pass in one launch (cyl_pass, csrc/cyl_pass.cu)
# ---------------------------------------------------------------------------

CLS_INTERIOR, CLS_CYL, CLS_EDGE = 0, 1, 2  # csrc/cyl_pass_state.cuh::PassClass
PASS_KS = (2, 3, 4)  # the depths cyl_pass is built for
CP_THREADS, CP_BLOCKS_PER_SM = 512, 2  # csrc/cyl_pass_state.cuh, as built (cyl_pass_shape)
CP_D, CP_R, CP_G = 6, 4, 16  # slots of the input, sub-step and geometry rings
CP_SMS = 132  # SMs of an H100 SXM: the items a pass is cut into on the CPU
CP_MIN_RUN = 8  # rows of the shortest run (a run's window adds 4 k phases)
# a row's device time in the pass relative to an interior row's, by class
# (interior, cyl, edge): band runs are shorter by it, so that the blocks of
# the one wave end together (swept with tools/cyl_pass_probe.py: PERF.md)
CYL_PASS_COST = (1.0, 2.0, 2.0)


def cyl_pass_cols(k: int, threads: int = CP_THREADS) -> int:
    """Window columns a block takes at depth k (a multiple of 32)."""
    return (threads // k) & ~31


def cyl_pass_smem(cls: int, k: int, rs: int, es: int) -> int:
    """Bytes of shared memory of a block of class ``cls`` at depth k, ring
    rows of ``rs`` elements, f stored in ``es`` bytes
    (``csrc/cyl_pass_state.cuh::cp_smem_bytes``)."""
    vel = 2 if cls == CLS_CYL else 0
    geo = (0, 2, 1)[cls]
    return CP_D * 9 * rs * es + 4 * rs * (CP_D * vel + CP_G * geo + (k - 1) * CP_R * (9 + vel))


def cyl_pass_budget(blocks_per_sm: int) -> int:
    """Dynamic shared memory a block may take with ``blocks_per_sm`` blocks
    an SM (228 KB an SM, 1 KB of each block kept by the system, the static
    mbarriers; at most 227 KB a block)."""
    return min(233_472 // blocks_per_sm - 1024 - 64, 232_448)


def _align(es: int) -> int:
    """Elements of 16 bytes: a cp.async.bulk copy's alignment."""
    return 16 // es


def cyl_pass_strip(cls: int, k: int, es: int, threads: int = CP_THREADS,
                   budget: int = cyl_pass_budget(CP_BLOCKS_PER_SM)) -> int:
    """The widest strip (a multiple of 8 columns) of class ``cls`` at depth
    k: its window (k columns a side) fits the block's columns and its rings
    ``budget`` bytes."""
    pad = -(-k // _align(es)) * _align(es)
    s = (cyl_pass_cols(k, threads) - 2 * k) // 8 * 8
    while s > 8 and cyl_pass_smem(cls, k, s + 2 * pad, es) > budget:
        s -= 8
    return s


def cyl_pass_rs(cls: int, k: int, es: int, threads: int = CP_THREADS,
                blocks_per_sm: int = CP_BLOCKS_PER_SM) -> int:
    """Elements of a ring row of class ``cls`` at depth k: the widest
    strip's window with its 16-byte pads, a compile-time constant of the
    kernel (``csrc/cyl_pass_state.cuh::cp_rs``)."""
    pad = -(-k // _align(es)) * _align(es)
    return cyl_pass_strip(cls, k, es, threads, cyl_pass_budget(blocks_per_sm)) + 2 * pad


def cyl_pass_strips(W: int, width: int):
    """Column strips ``[(x0, x1), ...]`` of at most ``width`` columns, ends
    on multiples of 8 (W % 8 == 0), widths within 8 of each other."""
    w8, n = W // 8, -(-(W // 8) // (width // 8))
    out, x = [], 0
    for i in range(n):
        w = 8 * (w8 // n + (1 if i < w8 % n else 0))
        out.append((x, x + w))
        x += w
    return out


def cyl_pass_runs(H: int, k: int, segs_by_class, strips_by_class, blocks: int,
                  cost=CYL_PASS_COST, min_run: int = CP_MIN_RUN):
    """Runs ``[(y0, y1, cls), ...]``: each class's segments cut into
    near-equal runs of at most ``tau / cost[cls] - 4 k`` rows (a run of n
    rows takes n + 4 k phases) and at least ``min_run`` where the segment
    allows, for the least ``tau`` whose items (runs x strips) fit
    ``blocks``, else one run a segment."""
    def runs_at(tau):
        out = []
        for cls, segs in enumerate(segs_by_class):
            n_max = max(int(tau / cost[cls]) - 4 * k, min_run)
            for y0, y1 in segs:
                m = max(1, min(-(-(y1 - y0) // n_max), (y1 - y0) // min_run))
                out += [(y0 + (y1 - y0) * i // m, y0 + (y1 - y0) * (i + 1) // m, cls)
                        for i in range(m)]
        return out

    def n_items(runs):
        return sum(len(strips_by_class[cls]) for *_, cls in runs)

    lo, hi = 0.0, max(cost) * (H + 4 * k)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        lo, hi = (lo, mid) if n_items(runs_at(mid)) <= blocks else (mid, hi)
    return runs_at(hi)


def cyl_pass_window(H: int, W: int, k: int, item):
    """``((r0, r1), (c0, c1))``: the rows and columns an item's first
    sub-step reads, its rows and strip k cells a side, cut (not wrapped) at
    the grid's border."""
    y0, y1, _, x0, x1 = item[:5]
    return (max(y0 - k, 0), min(y1 + k, H)), (max(x0 - k, 0), min(x1 + k, W))


def cyl_pass_fits(H: int, W: int, k: int) -> bool:
    """Whether cyl_pass takes the grid and depth: 2 <= k <= 4, W % 8 == 0
    (rows copied 16 bytes at a time), H and W below 2**15 (packed items)."""
    return int(k) in PASS_KS and W % 8 == 0 and H < 2 ** 15 and W < 2 ** 15


def cyl_pass_items(H: int, W: int, k: int, interior, cyl_rows, edge_rows, storage: int = 0,
                   sms: int = CP_SMS, threads: int = CP_THREADS,
                   blocks_per_sm: int = CP_BLOCKS_PER_SM, cost=CYL_PASS_COST,
                   max_width: int | None = None):
    """The blocks of a ``cyl_pass`` launch, ``(y0, y1, cls, x0, x1, a0, a1,
    desc)`` each: block i writes rows [y0, y1) x columns [x0, x1) with the
    class's steps (``CLS_INTERIOR``, ``CLS_CYL``, ``CLS_EDGE``); its ring
    rows hold columns [a0, a1) (x0 - k and x1 + k rounded out to 16 bytes
    of the storage ``storage``, cut to the grid); ``desc``: its window
    walks up (it holds row 0). About one wave of ``blocks_per_sm`` blocks
    an SM; the most costly items first. ``cost``, ``max_width``: the
    rows' cost by class (`cyl_pass_runs`) and a cap on the strips' width
    (`tools/cyl_pass_probe.py` sweeps them)."""
    if not cyl_pass_fits(H, W, k):
        raise ValueError(f"cyl_pass takes 2 <= k <= 4 and W % 8 == 0, H, W < 2**15 "
                         f"(k = {k}, grid {H}x{W})")
    es = 4 if storage == 0 else 2
    segs = (list(interior), list(cyl_rows), list(edge_rows))
    budget = cyl_pass_budget(blocks_per_sm)
    strips = [cyl_pass_strips(W, min(cyl_pass_strip(cls, k, es, threads, budget),
                                     max_width or W)) for cls in range(3)]
    runs = cyl_pass_runs(H, k, segs, strips, sms * blocks_per_sm, cost)
    a = _align(es)
    items = []
    for y0, y1, cls in runs:
        if cls != CLS_EDGE and not (y0 - k >= 1 and y1 + k <= H - 1):
            raise ValueError(f"rows {y0}..{y1 - 1} of class {cls}: the interior and cylinder "
                             f"rows of a pass lie more than k = {k} rows from the border")
        desc = y0 < k
        if desc and y1 > H - k:
            raise ValueError(f"rows {y0}..{y1 - 1}: a run reaches both border rows")
        if (y0 == 0 or y1 == H) and y1 - y0 < 2:
            raise ValueError(f"rows {y0}..{y1 - 1}: a run holding a border row needs two rows")
        for x0, x1 in strips[cls]:
            a0 = max(x0 - k, 0) // a * a
            a1 = min(-(-(x1 + k) // a) * a, W)
            items.append((y0, y1, cls, x0, x1, a0, a1, int(desc)))
    items.sort(key=lambda it: -cost[it[2]] * (it[1] - it[0] + 4 * k))
    return items


def cyl_pass_ref(f, vel, flags, phi, out, rows, k: int, c: Consts, write_macro: bool,
                 bf16_dev=False, keys=None, ctx=None, items=None):
    """The pass item by item (``cyl_pass_items`` unless ``items`` is
    given): each item's class twin (``cyl_interior_k_ref``, or
    ``cyl_band_k_ref`` "cyl" / "edge") on the grid NaN beyond the item's
    window (`cyl_pass_window`), under the class's key (``keys``: interior,
    cyl, edge); only the item's own cells are written. ``ctx`` (the
    wrapper's launch context) is not read."""
    H, W = c.H, c.W
    if items is None:
        items = cyl_pass_items(H, W, k, *rows, _storage(bf16_dev))
    keys = (None, None, None) if keys is None else keys
    for item in items:
        y0, y1, cls, x0, x1 = item[:5]
        (r0, r1), (c0, c1) = cyl_pass_window(H, W, k, item)
        keep = torch.zeros((H, W), dtype=torch.bool, device=f.device)
        keep[r0:r1, c0:c1] = True

        def window(t):
            return torch.where(keep, t, torch.full_like(t, float("nan")))

        tmp = {n: torch.empty_like(out[n]) for n in ("f", "rho", "vel")}
        if cls == CLS_INTERIOR:
            cyl_interior_k_ref(window(f), tmp, [(y0, y1)], k, c, write_macro, bf16_dev, keys[0])
        else:
            cyl_band_k_ref(window(f), window(vel), flags, window(phi), tmp, [(y0, y1)], k,
                           cls == CLS_EDGE, c, bf16_dev, keys[cls])
        out["f"][:, y0:y1, x0:x1] = tmp["f"][:, y0:y1, x0:x1]
        if cls != CLS_INTERIOR or write_macro:
            out["rho"][y0:y1, x0:x1] = tmp["rho"][y0:y1, x0:x1]
            out["vel"][:, y0:y1, x0:x1] = tmp["vel"][:, y0:y1, x0:x1]


class CylPassParams(ctypes.Structure):
    _fields_ = [("c", CylParams), ("key", (ctypes.c_uint32 * 2) * 3), ("rs", ctypes.c_int * 3),
                ("nitems", ctypes.c_int)]


def cyl_pass_shape(k: int, device_index: int = 0):
    """``(threads a block, window columns, blocks an SM)`` of the built
    kernel at depth k (its -D values)."""
    fn = build.bind("cyl_pass", "cyl_pass_shape", [_I, _P, _P, _P])
    t, cols, mb = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), ctypes.byref(t), ctypes.byref(cols), ctypes.byref(mb)), "cyl_pass")
    return t.value, cols.value, mb.value


def cyl_pass_info(k: int, storage: int = 0, device_index: int = 0):
    """``(registers per thread, local bytes)`` of the instance (k, storage)."""
    fn = build.bind("cyl_pass", "cyl_pass_info", [_I, _I, _P, _P])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(fn(int(k), int(storage), ctypes.byref(regs), ctypes.byref(local)),
                    "cyl_pass")
    return regs.value, local.value


def pass_plan(c: Consts, items, k: int, storage: int, dev, threads: int = CP_THREADS,
              blocks_per_sm: int = CP_BLOCKS_PER_SM):
    """``(items packed on ``dev``, CylPassParams, shared memory bytes)`` of
    a launch over ``items`` (`cyl_pass_items`): each class's ring row
    `cyl_pass_rs`; the bytes those of the items' class that takes most."""
    es = 4 if storage == 0 else 2
    rs = [cyl_pass_rs(cls, k, es, threads, blocks_per_sm) for cls in range(3)]
    for _, _, cls, _, _, a0, a1, _ in items:
        if a1 - a0 > rs[cls]:
            raise ValueError(f"an item's ring row of {a1 - a0} elements exceeds {rs[cls]}")
    smem = max(cyl_pass_smem(cls, k, rs[cls], es) for cls in {it[2] for it in items})
    packed = torch.tensor([[y0 | y1 << 16, x0 | x1 << 16, a0 | a1 << 16, cls | d << 4]
                           for y0, y1, cls, x0, x1, a0, a1, d in items],
                          dtype=torch.int32, device=dev)
    params = CylPassParams(c=_params(c, [(0, c.H)], False), nitems=len(items))
    params.rs[:] = rs
    return packed, params, smem


class PassContext:
    """What a ``cyl_pass`` launch needs besides its tensors and stream,
    made once for a grid, its rows, k, a storage mode and a card: the
    items on the card (planned for the built kernel's threads and blocks
    an SM, and the card's SMs), the parameters, the shared memory."""

    def __init__(self, c: Consts, rows, k: int, storage: int, dev: torch.device):
        threads, _, per_sm = cyl_pass_shape(k, dev.index or 0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.items_list = cyl_pass_items(c.H, c.W, k, *rows, storage, sms, threads, per_sm)
        self.items, self.params, self.smem = pass_plan(c, self.items_list, k, storage, dev,
                                                       threads, per_sm)
        self.k, self.storage, self.dev, self.consts = int(k), storage, dev, c
        self.fn = build.bind("cyl_pass", "cyl_pass_launch", [_P] * 8 + [_I, _I, _I, _P, _P])


_CONTEXTS: dict = {}


def cyl_pass_context(c: Consts, rows, k: int, storage: int, dev: torch.device) -> PassContext:
    """The `PassContext` of a grid's pass, made on first use."""
    key = (id(c), tuple(tuple(map(tuple, r)) for r in rows), int(k), storage, dev)
    ctx = _CONTEXTS.get(key)
    if ctx is None or ctx.consts is not c:
        ctx = _CONTEXTS[key] = PassContext(c, rows, k, storage, dev)
    return ctx


def _check_pass(c: Consts, rows, k: int, fdt, f, vel, flags, phi, out) -> torch.device:
    """The tensors of a pass (`_check` of the whole grid), its rows (1-3
    sorted, disjoint segments a class, the interior possibly none), a grid
    and depth the kernel takes, inputs 16-byte aligned (row copies)."""
    H, W = c.H, c.W
    if not cyl_pass_fits(H, W, k):
        raise ValueError(f"cyl_pass takes 2 <= k <= 4 and W % 8 == 0, H, W < 2**15 "
                         f"(k = {k}, grid {H}x{W})")
    for i, segs in enumerate(rows):
        if segs or i > 0:
            _check(c, segs, fdt)
    dev = _check(c, [(0, H)], fdt, f=(f, (9,)), vel=(vel, (2,)), flags=(flags, ()),
                 phi=(phi, ()), f_out=(out["f"], (9,)), rho_out=(out["rho"], ()),
                 vel_out=(out["vel"], (2,)))
    if any(t.data_ptr() % 16 for t in (f, vel, flags, phi)):
        raise ValueError("cyl_pass copies rows of 16-byte aligned inputs")
    return dev


def cyl_pass(f, vel, flags, phi, out, rows, k: int, c: Consts, write_macro: bool, bf16_dev=False,
             keys=None, ctx: PassContext | None = None):
    """One k-step pass in one launch: ``rows = (interior, cyl_rows,
    edge_rows)`` as `make_fused_step2` splits the grid; k plain-channel
    steps on the interior rows (rho and vel with ``write_macro`` only), k
    "cyl" and k "edge" full steps on the band rows, all from ``f``, ``vel``
    (and ``flags``, ``phi``) into ``out``: what ``cyl_interior_k`` and two
    ``cyl_band_k`` launches write, bit for bit. ``keys``: the three Philox
    keys (interior, cyl, edge) of a stochastic-rounding pass. ``ctx``: a
    `PassContext` whose tensors the caller checked (`_check_pass`) once."""
    st, fdt = _mode(bf16_dev, keys, f, out["f"])
    if st == 2 and len(keys) != 3:
        raise ValueError("bf16_dev=\"sr\": cyl_pass takes three keys (interior, cyl, edge)")
    if f.device.type == "cpu":
        return cyl_pass_ref(f, vel, flags, phi, out, rows, k, c, write_macro, bf16_dev, keys)
    if ctx is None:
        dev = _check_pass(c, rows, k, fdt, f, vel, flags, phi, out)
        ctx = cyl_pass_context(c, rows, k, st, dev)
    p = ctx.params
    p.c.write_macro = int(write_macro)
    if keys is not None:
        for i, key in enumerate(keys):
            p.key[i][:] = [int(x) & 0xFFFFFFFF for x in key]
    with torch.cuda.device(ctx.dev):
        err = ctx.fn(f.data_ptr(), vel.data_ptr(), flags.data_ptr(), phi.data_ptr(),
                     out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(),
                     ctx.items.data_ptr(), ctx.k, st, ctx.smem, ctypes.byref(p), _stream(ctx.dev))
    build.check(err, "cyl_pass")
    _count(cyl_pass, st)


WRAPPERS = (cyl_full, cyl_interior, cyl_interior_k, cyl_band_k, cyl_pass)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_mode = dict.fromkeys(MODE_NAMES, 0)


reset_launches()


# ---------------------------------------------------------------------------
# Assembly (``fused_step.py`` glue)
# ---------------------------------------------------------------------------

def _band_tiles(cfg, T, margin=4.0):
    """``(n, b0, b1)``: T-row tiles, and the tile range [b0, b1] covering
    the cylinder +- margin (``fused_step.py::_band_tiles``); tiles 0 and
    n-1 (INFLOW, OUTFLOW) are band tiles too."""
    H, _ = cfg.res
    n = H // T
    cy = cfg.center[1]
    r = cfg.D / 2.0
    b0 = max(0, int((cy - r - margin) // T))
    b1 = min(n - 1, int((cy + r + margin) // T))
    return n, b0, b1


def _choose_interior_T(cfg, tile_rows, interior_rows, margin=4.0):
    """Largest interior tile height that leaves interior tiles to run on;
    ``(T, b0, b1)`` or None."""
    H, _ = cfg.res
    T = interior_rows
    while T >= 8:
        if H % T == 0 and T % tile_rows == 0:
            n, b0, b1 = _band_tiles(cfg, T, margin=margin)
            if b0 >= 1 and b1 <= n - 2 and (n - ((b1 - b0 + 1) + 2)) > 0:
                return T, b0, b1
        T //= 2
    return None


def _split_rows(H, T, b0, b1):
    """``(interior, cyl band, edge band)`` row segments of the split."""
    interior = [s for s in ((T, b0 * T), ((b1 + 1) * T, H - T)) if s[0] < s[1]]
    return interior, [(b0 * T, (b1 + 1) * T)], [(0, T), (H - T, H)]


def _new_out(state, keep_macro: bool):
    """Output buffers of one step; rho and vel start as copies of the
    state's where a step leaves rows of them unwritten."""
    if keep_macro:
        return {"f": torch.empty_like(state["f"]), "rho": state["rho"].clone(),
                "vel": state["vel"].clone()}
    return {k: torch.empty_like(state[k]) for k in ("f", "rho", "vel")}


def _launch_keys(bf16_dev, seed, keys):
    """The `LaunchKeys` of a stochastic-rounding step (``keys`` if
    given, else a new one for ``seed``); None in the other modes."""
    if _storage(bf16_dev) != 2:
        return None
    return keys if keys is not None else LaunchKeys(seed)


def make_fused_step(cfg, tile_rows: int = 8, split: bool = True,
                    interior_rows: int = 32, bf16_dev=False, write_macro: bool = True,
                    seed: int = 0, keys: LaunchKeys | None = None):
    """``step(state, fields, out=None)``: one fused step with the API of
    `models.cylinder.make_step` (``make_fused_step`` of the JAX package).
    The split path (interior rows through ``cyl_interior``, band rows
    through ``cyl_full``) is taken when the band geometry leaves interior
    tiles, else every row goes through ``cyl_full``.

    ``write_macro=False`` (split path only) leaves the interior rows of
    rho/vel unwritten; `make_macro_refresh` recomputes them. The step
    writes into ``out`` (a dict of f/rho/vel buffers apart from the
    state's) when given, else into new buffers; in that mode the new rho
    and vel start as copies of the state's, as the JAX step updates its
    donated buffers.

    ``bf16_dev``: the storage of the state's f (`f_to_storage`). With
    "sr" each launch takes the next key of ``keys`` (a new `LaunchKeys`
    of ``seed`` when None)."""
    keys = _launch_keys(bf16_dev, seed, keys)
    H, W = cfg.res
    if H % tile_rows != 0:
        raise ValueError(f"H = {H} must be divisible by the tile height {tile_rows}")
    T = interior_rows
    use_split = False
    while split and T >= 8:
        if H % T == 0 and T % tile_rows == 0:
            n, b0, b1 = _band_tiles(cfg, T)
            if b0 >= 1 and b1 <= n - 2 and (n - ((b1 - b0 + 1) + 2)) > 0:
                use_split = True
                break
        T //= 2
    c = consts(cfg)
    skip_macro = (not write_macro) and use_split
    if use_split:
        interior, cyl_rows, edge_rows = _split_rows(H, T, b0, b1)
        band = edge_rows[:1] + cyl_rows + edge_rows[1:]
    else:
        band = [(0, H)]

    def step(state, fields, out=None):
        if out is None:
            out = _new_out(state, skip_macro)
        f, rho, vel = state["f"], state["rho"], state["vel"]
        if use_split:
            cyl_interior(f, out, interior, c, not skip_macro, bf16_dev,
                         keys and keys.next())
        cyl_full(f, rho, vel, fields["flags"], fields["phi_obs"], out, band, c, bf16_dev,
                 keys and keys.next())
        return out

    step.keys = keys
    step.skip_macro = skip_macro
    step.split = use_split
    step.rows = (interior if use_split else [], band)
    return step


def check_border(flags):
    """The border the k-step tiles need to be exact (csrc/cyl_common.cuh,
    temporal blocking): OBSTACLE side columns and no FLUID cell on the
    first and last rows, as in the cylinder channel."""
    if not bool((flags[:, [0, -1]] == OBSTACLE).all()) or bool((flags[[0, -1], :] == FLUID).any()):
        raise ValueError("the k-step split path needs the cylinder channel's border: "
                         "OBSTACLE side columns and no FLUID cell on the first and last rows")


ROUTES = ("pass", "launches")


def pass_route(cfg, k: int, route: str | None = None) -> str:
    """How a k-step pass runs: ``"pass"`` (``cyl_pass``, one launch; k =
    2..4 on a grid with W % 8 == 0) or ``"launches"`` (``cyl_interior_k``
    and two ``cyl_band_k`` launches, the yardstick); ``route`` forces one."""
    H, W = cfg.res
    if route is None:
        return "pass" if cyl_pass_fits(H, W, k) else "launches"
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    if route == "pass" and not cyl_pass_fits(H, W, k):
        raise ValueError(f"route 'pass' runs 2 <= k <= 4 on grids with W % 8 == 0 (k = {k}, "
                         f"grid {H}x{W})")
    return route


def make_fused_step2(cfg, tile_rows: int = 8, interior_rows: int = 32,
                     write_macro: bool = False, bf16_dev=False, k: int = 2, seed: int = 0,
                     keys: LaunchKeys | None = None, route: str | None = None):
    """``stepk(state, fields, out=None, ctx=None)``: k steps per call by
    temporal blocking (``make_fused_step2`` of the JAX package): the
    plain-channel steps on the interior rows, the full steps on the
    cylinder band ("cyl") and on the INFLOW/OUTFLOW rows ("edge"), through
    one ``cyl_pass`` launch or, with ``route="launches"``, through
    ``cyl_interior_k`` and two ``cyl_band_k`` launches (`pass_route`); the
    two write the same bits. None where the JAX function returns None: k
    outside 2 <= k <= min(8, tile_rows), or no split that keeps the band
    margin max(4, k+1). Raises on a flags field whose border
    `check_border` refuses. ``bf16_dev``, ``seed``, ``keys``: as for
    `make_fused_step`; a pass takes three keys (interior, cyl, edge) and
    stores f once. ``stepk.context(state, fields, outs)`` checks the
    tensors of a run once and returns the ``ctx`` its passes take (None
    off the card or on the launches route)."""
    keys = _launch_keys(bf16_dev, seed, keys)
    H, W = cfg.res
    if not (2 <= k <= min(8, tile_rows)):
        return None
    choice = _choose_interior_T(cfg, tile_rows, interior_rows, margin=max(4.0, float(k + 1)))
    if choice is None:
        return None
    T, b0, b1 = choice
    n = H // T
    if not (b0 >= 1 and b1 <= n - 2):
        raise ValueError(f"band tiles {b0}..{b1} of {n} touch the INFLOW/OUTFLOW tiles")
    route = pass_route(cfg, k, route)
    c = consts(cfg)
    interior, cyl_rows, edge_rows = _split_rows(H, T, b0, b1)
    rows = (interior, cyl_rows, edge_rows)
    st = _storage(bf16_dev)
    checked = {}

    def check_flags(flags):
        key = (flags.data_ptr(), flags._version, flags.device)
        if checked.get("key") != key:
            check_border(flags)
            checked["key"] = key

    def stepk(state, fields, out=None, ctx=None):
        flags = fields["flags"]
        check_flags(flags)
        if out is None:
            out = _new_out(state, not write_macro)
        f, vel, phi = state["f"], state["vel"], fields["phi_obs"]
        if route == "pass":
            pk = None if keys is None else (keys.next(), keys.next(), keys.next())
            cyl_pass(f, vel, flags, phi, out, rows, k, c, write_macro, bf16_dev, pk, ctx)
            return out
        cyl_interior_k(f, out, interior, k, c, write_macro, bf16_dev, keys and keys.next())
        cyl_band_k(f, vel, flags, phi, out, cyl_rows, k, False, c, bf16_dev,
                   keys and keys.next())
        cyl_band_k(f, vel, flags, phi, out, edge_rows, k, True, c, bf16_dev,
                   keys and keys.next())
        return out

    def context(state, fields, outs):
        """The ``ctx`` of a run's passes from ``state`` into the buffers
        ``outs`` (and back): their tensors checked here, once."""
        if route != "pass" or state["f"].device.type == "cpu":
            return None
        check_flags(fields["flags"])
        fdt = torch.float32 if st == 0 else torch.bfloat16
        dev = None
        for src in [state] + list(outs):
            for dst in outs:
                if dst is not src:
                    dev = _check_pass(c, rows, k, fdt, src["f"], src["vel"], fields["flags"],
                                      fields["phi_obs"], dst)
        return cyl_pass_context(c, rows, k, st, dev)

    stepk.keys = keys
    stepk.skip_macro = not write_macro
    stepk.k = k
    stepk.rows = rows
    stepk.route = route
    stepk.context = context
    return stepk


def make_macro_refresh(cfg, bf16_dev=False):
    """``refresh(state, fields)``: rho and vel recomputed from f on every
    non-OBSTACLE cell, OBSTACLE cells keep the stored values (a plain
    elementwise pass; MRT conserves mass and momentum, so it equals the
    kernels' pre-collision moments up to float32 round-off). In the bf16
    modes the moments are those of the stored f (`f_from_storage`)."""
    _storage(bf16_dev)

    def refresh(state, fields):
        f = f_from_storage(state["f"], bf16_dev)
        rho_m = f[0]
        for q in range(1, 9):
            rho_m = rho_m + f[q]
        mom_x = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
        mom_y = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
        is_obs = fields["flags"] == OBSTACLE
        safe = torch.where(rho_m == 0, 1.0, rho_m)
        rho = torch.where(is_obs, state["rho"], rho_m)
        u_x = torch.where(is_obs, state["vel"][0], mom_x / safe)
        u_y = torch.where(is_obs, state["vel"][1], mom_y / safe)
        return dict(state, rho=rho, vel=torch.stack([u_x, u_y]))

    return refresh


def make_fused_cylinder_runner(cfg, tile_rows: int = 16, split: bool = True,
                               interior_rows: int = 32, bf16_dev=False,
                               write_macro: bool = False, seed: int = 0,
                               route: str | None = None):
    """``run(state, fields, n)``: n steps through the kernels, k=4 passes
    while at least 4 steps remain (unless ``LBM_FUSED_K`` is set to
    another value than 4), then k=2, then single steps, then one macro
    refresh (``make_fused_cylinder_runner`` of the JAX package, same
    defaults). The state ping-pongs between two buffer sets allocated per
    call; the caller's state is never written. Each k-step pass is one
    ``cyl_pass`` launch, its tensors checked once a run, or with
    ``route="launches"`` three (`pass_route`).

    ``bf16_dev``: the storage of the state's f (convert a float32 state
    with `f_to_storage` first). With "sr" the k=4, k=2 and single steps
    share one `LaunchKeys` of ``seed`` (``run.keys``), which goes on
    counting across calls: a runner never reuses a key, and a new runner
    of the same seed replays the same run."""
    keys = _launch_keys(bf16_dev, seed, None)
    step = make_fused_step(cfg, tile_rows, split=split, interior_rows=interior_rows,
                           bf16_dev=bf16_dev, write_macro=write_macro, keys=keys)
    step2 = step4 = None
    if split:
        step2 = make_fused_step2(cfg, tile_rows, interior_rows=interior_rows,
                                 write_macro=write_macro, bf16_dev=bf16_dev, keys=keys,
                                 route=route)
        if os.environ.get("LBM_FUSED_K", "4") == "4":
            step4 = make_fused_step2(cfg, tile_rows, interior_rows=interior_rows,
                                     write_macro=write_macro, bf16_dev=bf16_dev, k=4,
                                     keys=keys, route=route)
    skip = (step.skip_macro or (step2 is not None and step2.skip_macro)
            or (step4 is not None and step4.skip_macro))
    refresh = make_macro_refresh(cfg, bf16_dev=bf16_dev) if skip else None

    def run(state, fields, n: int):
        if n <= 0:
            return state
        bufs = [_new_out(state, True), _new_out(state, True)]
        i = 0
        m = n
        plan = [(step4, 4), (step2, 2), (step, 1)]
        for fn, kk in plan:
            if fn is None or m < kk:
                continue
            ctx = fn.context(state, fields, bufs) if kk > 1 else None
            while m >= kk:
                state = fn(state, fields, bufs[i]) if kk == 1 else fn(state, fields, bufs[i], ctx)
                i ^= 1
                m -= kk
        if refresh is not None:
            state = refresh(state, fields)
        return state

    run.step, run.step2, run.step4 = step, step2, step4
    run.keys = keys
    run.route = step4.route if step4 is not None else (step2.route if step2 else None)
    return run
