"""Shear-layer kernel: one doubly-periodic step (periodic pull streaming,
moments, BGK, MRT or KBC relaxation) as a CUDA kernel, its plain PyTorch
twin and the runner (counterpart of the JAX package's
`ops/pallas/fused_periodic.py`).

Replaces the TPU kernel `jrl_lbm_tpu/ops/pallas/fused_periodic.py::
_make_kernel` (``_kbc_apply`` inside it) with ``periodic``
(`csrc/periodic.cu`), one template instance per relaxation: BGK, MRT, and
KBC in its five types (LBGK, KBC_A, KBC_B, KBC_C, KBC_D).

The Pallas kernel needs H to be a multiple of its 8-row blocks; this
kernel runs one thread per cell with modular wrap and takes any H, W >= 2.

A wrapper given tensors on the CPU runs the twin; given tensors on the
card it launches the kernel or raises. ``periodic.launches`` counts the
launches. The twin follows the Pallas body operation by operation: the
division-free equilibrium `_feq_terms`, the paired even/odd `_mrt_apply`
and the unrolled `_kbc_apply`, each Python-float constant rounded once to
float32 where it meets a tensor, so kernel and twin round alike (the
source builds with ``--fmad=false``). The Pallas KBC multiplies by 1 /
(feq + eps) where the jnp op `ops/collide.py::kbc_omega` divides, so the
twin equals the op only to float32 round-off.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jrl_lbm_torch import lattice
from jrl_lbm_torch.kernels import build
from jrl_lbm_torch.kernels.cylinder import _QPAIRS, _dot, _feq_terms, _mrt_apply, _pair_decomp
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.utils.types import KBCType

E = lattice.E
RELAX = {"bgk": 0, "mrt": 1, "kbc": 2}
# template index of each KBC type in csrc/periodic.cu
KBC_KIND = {int(KBCType.LBGK): 0, int(KBCType.KBC_A): 1, int(KBCType.KBC_B): 2,
            int(KBCType.KBC_C): 3, int(KBCType.KBC_D): 4}
# raw-moment rows of `ops/collide.py::KBC_C_MAT` the shear split reads
_M20_ROW = (0, 1, 0, 1, 0, 1, 1, 1, 1)
_M11_ROW = (0, 0, 0, 0, 0, 1, -1, 1, -1)
_M02_ROW = (0, 0, 1, 0, 1, 1, 1, 1, 1)


class PeriodicParams(ctypes.Structure):
    """The constants as `csrc/periodic.cu` reads them."""
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("inv_tau", ctypes.c_float), ("beta", ctypes.c_float), ("beta2", ctypes.c_float),
        ("inv_beta", ctypes.c_float), ("two_m_inv_beta", ctypes.c_float),
        ("eps", ctypes.c_float), ("ev0", ctypes.c_float * 5),
        ("ev", (ctypes.c_float * 5) * 4), ("od", (ctypes.c_float * 4) * 4),
    ]


class Consts:
    """What the kernel and the twin take from a `ShearLayerConfig`; each
    constant as the double the Pallas body forms, rounded once to float32
    where it is used. ``params`` holds them for the kernel, built once."""

    def __init__(self, cfg):
        self.H, self.W = cfg.res
        if cfg.collision not in RELAX:
            raise ValueError(f"the periodic kernel supports bgk/mrt/kbc, not {cfg.collision}")
        self.relax = cfg.collision
        self.kbc = _collide.resolve_kbc_type(cfg.kbc_type) if cfg.collision == "kbc" else None
        if self.kbc is not None and self.kbc not in KBC_KIND:
            raise ValueError(f"unknown KBC type {cfg.kbc_type}")
        tau = float(cfg.tau)
        self.inv_tau = 1.0 / tau
        self.beta = 1.0 / (2.0 * tau)
        self.beta2 = self.beta * 2.0
        self.inv_beta = 1.0 / self.beta
        self.two_m_inv_beta = 2.0 - 1.0 / self.beta
        self.eps = 1e-10
        minv_s_m, _ = _collide.mrt_matrices(tau)
        self.ev, self.od = _pair_decomp([[float(x) for x in row] for row in minv_s_m])
        p = PeriodicParams(H=self.H, W=self.W, inv_tau=self.inv_tau, beta=self.beta,
                           beta2=self.beta2, inv_beta=self.inv_beta,
                           two_m_inv_beta=self.two_m_inv_beta, eps=self.eps)
        p.ev0[:] = self.ev[0]
        for i, (q, _) in enumerate(_QPAIRS):
            p.ev[i][:] = self.ev[q]
            p.od[i][:] = self.od[q]
        self.params = p


@functools.lru_cache(maxsize=16)
def consts(cfg) -> Consts:
    return Consts(cfg)


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------

def _kbc_apply(c: Consts, fb, fe, rho, ux, uy):
    """Unrolled entropic relaxation (``fused_periodic.py::_kbc_apply``);
    list of 9 planes."""
    kbc = c.kbc
    df = [fb[q] - fe[q] for q in range(9)]
    if kbc == int(KBCType.LBGK):
        return [fb[q] - c.beta2 * df[q] for q in range(9)]
    central = kbc in (int(KBCType.KBC_A), int(KBCType.KBC_B))

    def moments(fs):
        if central:
            m20 = m11 = m02 = None
            for q in range(9):
                du = float(E[q, 0]) - ux
                dv = float(E[q, 1]) - uy
                t20, t11, t02 = du * du * fs[q], du * dv * fs[q], dv * dv * fs[q]
                m20 = t20 if m20 is None else m20 + t20
                m11 = t11 if m11 is None else m11 + t11
                m02 = t02 if m02 is None else m02 + t02
        else:
            m20 = _dot(_M20_ROW, fs)
            m11 = _dot(_M11_ROW, fs)
            m02 = _dot(_M02_ROW, fs)
        return m20 + m02, m20 - m02, m11

    include_T = kbc in (int(KBCType.KBC_A), int(KBCType.KBC_C))

    def shear_parts(T, N, PIxy):
        if include_T:
            s0, sp, sq = rho - T, 0.25 * (T + N), 0.25 * (T - N)
        else:
            s0, sp, sq = rho, 0.25 * N, -0.25 * N
        hx, hy = 0.5 * rho * ux, 0.5 * rho * uy
        return [s0, sp + hx, sq + hy, sp - hx, sq - hy,
                0.25 * PIxy, -0.25 * PIxy, 0.25 * PIxy, -0.25 * PIxy]

    sf, se = shear_parts(*moments(fb)), shear_parts(*moments(fe))
    ds = [sf[q] - se[q] for q in range(9)]
    dh = [df[q] - ds[q] for q in range(9)]
    dsdh = dhdh = None
    for q in range(9):
        inv = 1.0 / (fe[q] + c.eps)
        a, b = ds[q] * dh[q] * inv, dh[q] * dh[q] * inv
        dsdh = a if dsdh is None else dsdh + a
        dhdh = b if dhdh is None else dhdh + b
    gamma = c.inv_beta - c.two_m_inv_beta * (dsdh / (dhdh + c.eps))
    return [fb[q] - c.beta * (2.0 * ds[q] + gamma * dh[q]) for q in range(9)]


def periodic_ref(f, out, c: Consts):
    """One step of the twin: ``out["f"]``, ``out["rho"]`` (pre-collision
    density) and ``out["vel"]`` written in place."""
    fb = [f[0]] + [torch.roll(f[q], (int(E[q, 1]), int(E[q, 0])), dims=(-2, -1))
                   for q in range(1, 9)]
    rho = fb[0]
    for q in range(1, 9):
        rho = rho + fb[q]
    mom_x = fb[1] - fb[3] + fb[5] - fb[6] - fb[7] + fb[8]
    mom_y = fb[2] - fb[4] + fb[5] + fb[6] - fb[7] - fb[8]
    safe = torch.where(rho == 0, 1.0, rho)
    ux, uy = mom_x / safe, mom_y / safe
    fe = _feq_terms(rho, ux, uy)
    if c.relax == "bgk":
        fo = [fb[q] + c.inv_tau * (fe[q] - fb[q]) for q in range(9)]
    elif c.relax == "mrt":
        fo = _mrt_apply(c, fb, fe, torch.zeros((), dtype=torch.bool, device=f.device))
    else:
        fo = _kbc_apply(c, fb, fe, rho, ux, uy)
    out["f"].copy_(torch.stack(fo))
    out["rho"].copy_(rho)
    out["vel"][0].copy_(ux)
    out["vel"][1].copy_(uy)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

def _check(c: Consts, f, out):
    """Float32 contiguous ``f`` [9, H, W] and outputs ``f`` [9, H, W],
    ``rho`` [H, W], ``vel`` [2, H, W] on one device, the outputs apart from
    ``f`` and from each other; H, W >= 2 and H * W < 2**31."""
    H, W = c.H, c.W
    if H < 2 or W < 2 or H * W >= 2**31:
        raise ValueError(f"grid {H}x{W}: the periodic kernel takes 2 <= H, W and H * W < 2**31")
    tensors = {"f": (f, (9, H, W)), "f_out": (out["f"], (9, H, W)),
               "rho_out": (out["rho"], (H, W)), "vel_out": (out["vel"], (2, H, W))}
    for name, (t, want) in tensors.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != f.device:
            raise ValueError(f"{name}: on {t.device}, f on {f.device}")
    if len({t.data_ptr() for t, _ in tensors.values()}) != len(tensors):
        raise ValueError("output buffers must be apart from f and from each other")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"f: on {f.device}; the kernel needs the card (the twin the CPU)")


_P = ctypes.c_void_p
_I = ctypes.c_int


def periodic(f, out, c: Consts):
    """One periodic step of ``f`` into ``out["f"]``, ``out["rho"]``,
    ``out["vel"]`` (buffers apart from ``f``)."""
    _check(c, f, out)
    if f.device.type == "cpu":
        return periodic_ref(f, out, c)
    dev = f.device
    fn = build.bind("periodic", "periodic_launch", [_P] * 4 + [_I, _I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), out["f"].data_ptr(), out["rho"].data_ptr(), out["vel"].data_ptr(),
                 RELAX[c.relax], KBC_KIND.get(c.kbc, 0), ctypes.byref(c.params),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check(err, "periodic")
    periodic.launches += 1


periodic.launches = 0


# ---------------------------------------------------------------------------
# Runner (``fused_periodic.py`` glue)
# ---------------------------------------------------------------------------

def _new_out(state):
    return {k: torch.empty_like(state[k]) for k in ("f", "rho", "vel")}


def make_fused_periodic_step(cfg):
    """``step(state, fields, out=None)``: one ``periodic`` call, with the
    API of `models.shear_layer.make_step`; it writes into ``out`` when
    given, else into new buffers. The JAX signature's ``tile_rows``, the
    Pallas kernel's row block, has no counterpart here."""
    c = consts(cfg)

    def step(state, fields, out=None):
        if out is None:
            out = _new_out(state)
        periodic(state["f"], out, c)
        return out

    return step


def make_fused_periodic_runner(cfg):
    """``run(state, fields, n)``: n steps through ``periodic``. Where the
    Pallas call returns new arrays each step, the state ping-pongs between
    two buffer sets allocated per call, with no copies; the caller's state
    is never written."""
    step = make_fused_periodic_step(cfg)

    def run(state, fields, n: int):
        if n <= 0:
            return state
        bufs = [_new_out(state), _new_out(state)]
        for i in range(int(n)):
            state = step(state, fields, bufs[i % 2])
        return state

    run.step = step
    return run
