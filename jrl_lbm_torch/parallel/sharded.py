"""Sharded whole-step functions over a ``(ny, nx)`` mesh (counterpart of
the JAX package's `parallel/sharded.py`): the plain PyTorch path of the
sharded cylinder channel and of the JRL fluid, balance and approach
steps.

JAX runs one program per shard under ``shard_map``, the shards meeting at
each ``ppermute`` and ``psum``. Here each shard this process holds runs
its ``local_step`` in a thread of its own (`_spmd`), and the shards meet
at the same collectives (`Collectives`: `halo.pad_halo` and `halo.psum`
over the mesh), so a local step reads as JAX's does, halo-aware stencils
inside the collision included. On a process-group mesh each process
holds one shard and the collectives are ``torch.distributed``'s.

A sharded state is a dict of lists: for each key, the blocks of the
shards this process holds in ``mesh.local`` order (`shard_state`);
`gather_state` puts a global tensor back together. `state_shardings`
gives the split of each key as a tuple of mesh axes per dimension (the
JAX package returns ``NamedSharding``s, which have no PyTorch
counterpart); ``()`` is replicated.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from jrl_lbm_torch.models import jrl as _jrl
from jrl_lbm_torch.ops import collide as _collide
from jrl_lbm_torch.ops import macro as _macro
from jrl_lbm_torch.parallel import padded_ops as pops
from jrl_lbm_torch.parallel.halo import make_domain, pad_halo, psum
from jrl_lbm_torch.parallel.mesh import AXIS_X, AXIS_Y, Mesh, gather, split
from jrl_lbm_torch.utils.types import CellType

S2 = (AXIS_Y, AXIS_X)  # [H, W]
S3 = (None, AXIS_Y, AXIS_X)  # [C/Q, H, W]
S4 = (None, None, AXIS_Y, AXIS_X)  # [N, 2, H, W]
REP = ()  # replicated


# ---------------------------------------------------------------------------
# One program per shard
# ---------------------------------------------------------------------------

class Collectives:
    """The collectives of the shards of one `_spmd` call: each shard's
    thread calls ``pad(i, x)`` or ``psum(i, x)`` with its own block, and
    every shard of the process must make the same calls in the same
    order, as under ``shard_map``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = len(mesh.local)
        self.barrier = threading.Barrier(self.n)
        self.slots = [None] * self.n
        self.out = None

    def _meet(self, i, x, fn):
        self.slots[i] = x
        self.barrier.wait()
        if i == 0:
            self.out = fn(self.slots)
        self.barrier.wait()
        r = self.out[i] if isinstance(self.out, list) else self.out.to(x.device)
        self.barrier.wait()  # every shard has its result before the next call
        return r

    def pad(self, i, x):
        """``x`` ``[..., h, w]`` padded to ``[..., h+2, w+2]`` with its
        periodic global neighbours (`halo.pad_halo`)."""
        return self._meet(i, x, lambda xs: pad_halo(xs, self.mesh))

    def psum(self, i, x):
        """The sum of ``x`` over every shard of the mesh (`halo.psum`)."""
        return self._meet(i, x, lambda xs: psum(xs, self.mesh))


def _spmd(mesh: Mesh, local_step, *args):
    """``local_step(col, i, coord, *args_i)`` for each shard ``i`` this
    process holds, one thread each; ``args`` are lists in ``mesh.local``
    order (a replicated value may be given as it is). Returns the list of
    results. A shard that raises breaks the others' barrier; the first
    error is raised."""
    col = Collectives(mesh)
    n = col.n
    per = [[a[i] if isinstance(a, list) else a for a in args] for i in range(n)]
    if n == 1:
        return [local_step(col, 0, mesh.local[0], *per[0])]
    out, errors = [None] * n, []

    def body(i):
        try:
            out[i] = local_step(col, i, mesh.local[i], *per[i])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            col.barrier.abort()

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return out


def _block(cfg_res, mesh: Mesh):
    H, W = cfg_res
    ny, nx = mesh.shape
    if H % ny or W % nx:
        raise ValueError("grid must tile the mesh")
    h, w = H // ny, W // nx
    if h < 3 or w < 3:
        raise ValueError("blocks must be at least 3 cells wide")
    return H, W, h, w


def _unzip(outs):
    return [list(x) for x in zip(*outs)]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def state_shardings(mesh: Mesh | None = None):
    """The split of the cylinder scene's state and fields: a tuple of mesh
    axes per dimension (None: not split), ``()`` replicated."""
    state = {"f": S3, "rho": S2, "vel": S3}
    fields = {"flags": S2, "phi_obs": S2, "obs_vel": S3, "force": S3, "inflow_vel": REP}
    return state, fields


def _place(x, spec, mesh: Mesh):
    x = torch.as_tensor(x)
    if spec == REP:
        return [x.to(mesh.devices[c]) for c in mesh.local]
    if spec == (AXIS_X,):  # a [W] row split along the columns
        nx = mesh.shape[1]
        w = x.shape[-1] // nx
        return [x[c[1] * w:(c[1] + 1) * w].to(mesh.devices[c]).contiguous() for c in mesh.local]
    return split(x, mesh)


def _place_tree(tree, specs, mesh):
    return {k: _place(v, specs[k], mesh) for k, v in tree.items()}


def shard_state(state, fields, mesh: Mesh):
    """Place an unsharded (state, fields) pair onto the mesh."""
    st_sh, fl_sh = state_shardings(mesh)
    return _place_tree(state, st_sh, mesh), _place_tree(fields, fl_sh, mesh)


def gather_state(tree, mesh: Mesh):
    """The global tensors of a sharded dict (`shard_state`'s inverse for
    the split keys), on the device of this process's first shard."""
    return {k: gather(v, mesh) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The cylinder channel
# ---------------------------------------------------------------------------

def make_sharded_cylinder_step(cfg, mesh: Mesh):
    """Sharded version of `models.cylinder.make_step` over ``mesh``: a
    function (state, fields) -> state on sharded dicts; each shard
    exchanges halos and runs the padded ops."""
    H, W, h, w = _block(cfg.res, mesh)
    minv_s_m, _ = _collide.mrt_matrices(cfg.tau)

    def local_step(col, i, coord, f, rho, vel, flags, phi_obs, obs_vel, force, inflow_vel):
        dom = make_domain((h, w), (H, W), coord, 0, device=f.device)
        fp = col.pad(i, f)
        flagsp = col.pad(i, flags)
        rho, vel, f = pops.propagate_padded(
            fp, flagsp, dom, phi_obs=None, rho=rho, vel=vel, inflow_vel=inflow_vel,
            inflow_density=cfg.density, dx=cfg.dx, dt=cfg.dt)
        # the coupling reads the velocity field as updated by the INFLOW
        # pass; re-exchange its halo
        velp = col.pad(i, vel)
        obs_vel_p = col.pad(i, obs_vel)
        f = pops.solve_boundary_padded(velp, flagsp, f, phi_obs, dom, obs_vel_p=obs_vel_p,
                                       tau=cfg.tau, dx=cfg.dx, dt=cfg.dt)
        rho, vel = pops.macro_padded(f, rho, vel, flags, dom, dx=cfg.dx, dt=cfg.dt,
                                     contact_angle=cfg.contact_angle)
        f = _collide.mrt_collide(f, rho, vel, flags, minv_s_m=minv_s_m, tau=cfg.tau,
                                 force=force, dx=cfg.dx, dt=cfg.dt)
        return f, rho, vel

    def step(state, fields):
        f, rho, vel = _unzip(_spmd(
            mesh, local_step, state["f"], state["rho"], state["vel"], fields["flags"],
            fields["phi_obs"], fields["obs_vel"], fields["force"], fields["inflow_vel"]))
        return {"f": f, "rho": rho, "vel": vel}

    return step


def make_sharded_cylinder_runner(cfg, mesh: Mesh):
    """``run(state, fields, n)``: n sharded steps on sharded dicts."""
    step = make_sharded_cylinder_step(cfg, mesh)

    def run(state, fields, n: int):
        for _ in range(int(n)):
            state = step(state, fields)
        return state

    return run


# ---------------------------------------------------------------------------
# The JRL fluid phase
# ---------------------------------------------------------------------------

def make_sharded_jrl_fluid_step(cfg, mesh: Mesh):
    """Sharded version of `models.jrl.make_fluid_step` over ``mesh``:
    (state, fields, step_idx) -> state on sharded dicts.

    The moving-tip geometry (flags, phi, obs_vel) is rebuilt per shard
    from GLOBAL coordinates, so nothing is resharded as the tip walks;
    the axisymmetric source terms use the halo-aware grad/div stencils.
    """
    H, W, h, w = _block(cfg.eff_res, mesh)
    ax = 1  # LINE_X_EQ_0
    vel_obs = cfg.vel_obs
    dtype = cfg.dtype
    OBS = int(CellType.OBSTACLE)

    def local_step(col, i, coord, f, rho, vel, base_flags, gmesh, force, step_idx):
        dom = make_domain((h, w), (H, W), coord, ax, device=f.device)
        walks, walks_int = _jrl.tip_walks(cfg.inflow_height, step_idx, vel_obs)
        phi = _jrl._tip_phi(cfg, gmesh, walks)
        zeros = torch.zeros((h, w), dtype=dtype, device=f.device)
        if cfg.shape in _jrl.FLAT_SHAPES:
            tip = (dom.gy < walks_int) & (dom.gx < cfg.Rg_radius)
            obs_vel = torch.stack([zeros, torch.where(tip, vel_obs, 0.0).to(dtype)])
            flags = torch.where(tip, OBS, base_flags).to(torch.int32)
            vel = torch.stack([torch.where(tip, 0.0, vel[0]),
                               torch.where(tip, vel_obs, vel[1])]).to(dtype)
        else:
            is_o = phi <= 0
            obs_v = torch.stack([zeros, torch.where(is_o, vel_obs, 0.0).to(dtype)])
            obs_vel = torch.where(dom.at_yH[None], 0.0, obs_v)
            flags = torch.where(is_o, OBS, base_flags).to(torch.int32)
            vel = torch.where(is_o[None], obs_vel, vel)

        fp = col.pad(i, f)
        flagsp = col.pad(i, flags)
        _, _, f = pops.propagate_padded(fp, flagsp, dom, phi_obs=phi, rho=rho, vel=vel)
        velp = col.pad(i, vel)
        obs_vel_p = col.pad(i, obs_vel)
        f = pops.solve_boundary_padded(velp, flagsp, f, phi, dom, obs_vel_p=obs_vel_p,
                                       tau=cfg.tau)
        rho, vel = pops.macro_padded(f, rho, vel, flags, dom, contact_angle=None)

        # axisymmetric BGK with halo-aware stencils (each grad/div call
        # exchanges the halo of its operand)
        def grad_fn(a):
            return pops.grad_padded(col.pad(i, a), flagsp, dom)

        def div_fn(a):
            return pops.div_padded(col.pad(i, a), flagsp, dom)

        f = _collide.bgk_collide(f, rho, vel, flags, tau=cfg.tau, force=force, mesh_grid=gmesh,
                                 axisymmetric_type=ax, grad_fn=grad_fn, div_fn=div_fn)
        return f, rho, vel

    def step(state, fields, step_idx: int):
        f, rho, vel = _unzip(_spmd(
            mesh, local_step, state["f"], state["rho"], state["vel"], fields["base_flags"],
            fields["mesh"], fields["force"], int(step_idx)))
        return {"f": f, "rho": rho, "vel": vel}

    return step


def make_sharded_jrl_fluid_runner(cfg, mesh: Mesh):
    """``run(state, fields, start_step, n)`` on sharded dicts."""
    step = make_sharded_jrl_fluid_step(cfg, mesh)

    def run(state, fields, start_step: int, n: int):
        for j in range(int(n)):
            state = step(state, fields, int(start_step) + j)
        return state

    return run


def shard_jrl_state(state, fields, mesh: Mesh):
    """Place a JRL fluid-scene (state, fields) pair onto the mesh."""
    state = {"f": _place(state["f"], S3, mesh), "rho": _place(state["rho"], S2, mesh),
             "vel": _place(state["vel"], S3, mesh)}
    fields = {"base_flags": _place(fields["base_flags"], S2, mesh),
              "mesh": _place(fields["mesh"], S3, mesh),
              "force": _place(fields["force"], S3, mesh)}
    return state, fields


# ---------------------------------------------------------------------------
# JRL concentration (C) phase
# ---------------------------------------------------------------------------

def _c_area_row(cfg) -> torch.Tensor:
    """Global [W] lookup of the annulus areas, zero beyond the tip disk
    (a host constant, placed per shard along ``dx``).

    Column x of the lookup holds `cfg.area_array[x]` for x < radius_obs_int
    (the exact float32 values the single-device integrals use), so a
    masked per-cell product + `psum` reproduces the reference's
    `sum(C[row, :rint] * area)` disk integral across shards.
    """
    a = np.zeros((cfg.eff_res[1],), np.float32)
    a[:cfg.radius_obs_int] = cfg.area_array
    return torch.as_tensor(a, dtype=cfg.dtype)


def _c_flags_local(cfg, base_flags, gmesh, dom, walks, walks_int, strict: bool):
    """Per-shard port of `models.jrl._c_flags_at` using global coordinates.

    ``strict`` selects phi < 0 (approach, `C_ethaline:302`) vs phi <= 0
    (balance, `C_ethaline:218`).
    """
    gy, gx = dom.gy, dom.gx
    if cfg.shape in _jrl.FLAT_SHAPES:
        obs = (gy < walks_int) & (gx < cfg.Rg_radius)
    else:
        phi = _jrl._c_tip_phi(cfg, gmesh, walks)
        obs = (phi < 0) if strict else (phi <= 0)
        obs = obs | ((gy < cfg.inflow_height_int) & (gx < cfg.Rg_radius))
    flags = torch.where(obs, int(CellType.OBSTACLE), base_flags)
    head = (gy == walks_int - 1) & (gx < cfg.radius_obs_int)
    return torch.where(head, int(CellType.INFLOW), flags).to(torch.int32)


def make_sharded_balance_step(cfg, mesh: Mesh):
    """Sharded version of `models.jrl.make_balance_step` over ``mesh``:
    (state, fields, flags) -> state on sharded dicts. Zero velocity, fixed
    flags (`C_ethaline:230-253`); the only per-step communication is the
    1-cell halo of (h, flags)."""
    H, W, h_, w_ = _block(cfg.eff_res, mesh)
    ax = 1  # LINE_X_EQ_0
    dtype = cfg.dtype

    def local_step(col, i, coord, C, h, flags, gmesh):
        dom = make_domain((h_, w_), (H, W), coord, ax, device=h.device)
        zero_vel = torch.zeros((2, h_, w_), dtype=dtype, device=h.device)
        hp = col.pad(i, h)
        flagsp = col.pad(i, flags)
        C, _, h = pops.propagate_padded(hp, flagsp, dom, rho=C, vel=zero_vel,
                                        inflow_density=0.0)
        C = _macro.macro_compute_C(h, C, flags)
        h = _collide.bgk_collide(h, C, zero_vel, flags, tau=cfg.tau_D, mesh_grid=gmesh,
                                 is_convection=True, axisymmetric_type=ax)
        return C, h

    def step(state, fields, flags):
        C, h = _unzip(_spmd(mesh, local_step, state["C"], state["h"], flags, fields["mesh"]))
        return {"C": C, "h": h}

    return step


def make_sharded_balance_runner(cfg, mesh: Mesh):
    step = make_sharded_balance_step(cfg, mesh)

    def run(state, fields, flags, n: int):
        for _ in range(int(n)):
            state = step(state, fields, flags)
        return state

    return run


def make_sharded_approach_step(cfg, mesh: Mesh):
    """Sharded version of `models.jrl.make_approach_step` over ``mesh``.

    The moving tip (flags, phi, head-row sink) is rebuilt per shard from
    global coordinates; the stored fluid-velocity history is split over
    the same spatial mesh; and the per-step tip-disk inflow/current
    integrals (`C_ethaline:364-385`) are masked per-shard partial sums
    reduced with `psum` over the mesh.

    Signature matches the single-device step: (state, fields, step_idx)
    -> (state, (new_inflow, new_current, rec_u, rec_v)), the integrals on
    every shard's device alike (the first shard's returned).
    """
    H, W, h_, w_ = _block(cfg.eff_res, mesh)
    ax = 1  # LINE_X_EQ_0
    dtype = cfg.dtype
    v = cfg.vel_obs_conv
    tau_D = cfg.tau_D
    flat = cfg.shape in _jrl.FLAT_SHAPES
    area_row = _place(_c_area_row(cfg), (AXIS_X,), mesh)

    def local_step(col, i, coord, C, h, base_flags, gmesh, vel_field, area, step_idx):
        dev = h.device
        dom = make_domain((h_, w_), (H, W), coord, ax, device=dev)
        walks, walks_int = _jrl.tip_walks(cfg.inflow_height, step_idx, v)
        flags = _c_flags_local(cfg, base_flags, gmesh, dom, walks, walks_int, True)
        phi = _jrl._c_tip_phi(cfg, gmesh, walks)
        C = torch.where(flags == int(CellType.OBSTACLE), 0.0, C).to(dtype)

        # stored-velocity interpolation in tip-position space
        # (`C_ethaline:294-335`); vel_field is the shard's [N, 2, h, w]
        C_vel = _jrl.stored_velocity(vel_field, step_idx, v) * v
        tip_block = (dom.gy < walks_int) & (dom.gx < cfg.Rg_radius)
        C_vel = torch.stack([torch.where(tip_block, 0.0, C_vel[0]),
                             torch.where(tip_block, v, C_vel[1])]).to(dtype)

        hp = col.pad(i, h)
        flagsp = col.pad(i, flags)
        C, _, h = pops.propagate_padded(hp, flagsp, dom, phi_obs=phi, rho=C, vel=C_vel,
                                        inflow_density=0.0)
        C = _macro.macro_compute_C(h, C, flags)
        if cfg.clamp_C:
            C = torch.clamp(C, 0.0, 1.0)
        h = _collide.bgk_collide(h, C, C_vel, flags, tau=tau_D, mesh_grid=gmesh,
                                 is_convection=True, axisymmetric_type=ax)

        # tip-disk integrals as masked partial sums + psum. area is the
        # exact area lookup (zero beyond the disk), so the column bound
        # gx < radius_obs_int is carried by the data.
        area2 = area[None, :].expand(h_, w_)
        row_in = (dom.gy == walks_int).to(dtype)
        row_cur = (dom.gy == walks_int + 1).to(dtype)
        if flat:
            # flux form dC_z + dC_r (`C_cylinder:344-358`)
            Cp = col.pad(i, C)
            r = gmesh[0]
            rCp = col.pad(i, r * C)
            dC_z = C - Cp[..., 0:-2, 1:-1]  # C[y] - C[y-1]
            dC_r = (rCp[..., 1:-1, 2:] - r * C) / r  # (rC[x+1] - rC[x]) / r[x]
            integ = (dC_z + dC_r) * area2
            new_inflow = torch.sum(integ * row_in)
            new_current = torch.sum(integ * row_cur)
        else:
            # plain disk integral (`C_ethaline:364-381`)
            new_inflow = torch.sum(C * area2 * row_in)
            new_current = torch.sum(C * area2 * row_cur)
        rec_u = torch.sum(C_vel[0] * area2 * row_cur)
        rec_v = torch.sum(C_vel[1] * area2 * row_cur)
        ints = col.psum(i, torch.stack([new_inflow, new_current, rec_u, rec_v]))
        return C, h, ints

    def step(state, fields, step_idx: int):
        C, h, ints = _unzip(_spmd(
            mesh, local_step, state["C"], state["h"], fields["base_flags"], fields["mesh"],
            fields["vel_field"], area_row, int(step_idx)))
        return {"C": C, "h": h}, tuple(ints[0].unbind(0))

    return step


def make_sharded_approach_runner(cfg, mesh: Mesh):
    """Sharded analog of `models.jrl.make_approach_runner` (same acc dict)."""
    step = make_sharded_approach_step(cfg, mesh)

    def run(state, fields, start_step: int, n: int):
        z = torch.zeros((), dtype=cfg.dtype)
        acc = {"inflow_sum": z, "current_sum": z, "count": z, "rec_u": z, "rec_v": z}
        for j in range(int(n)):
            state, (inflow, current, rec_u, rec_v) = step(state, fields, int(start_step) + j)
            acc = {
                "inflow_sum": acc["inflow_sum"] + inflow.cpu(),
                "current_sum": acc["current_sum"] + current.cpu(),
                "count": acc["count"] + 1.0,
                "rec_u": rec_u.cpu(),
                "rec_v": rec_v.cpu(),
            }
        return state, acc

    return run


def shard_c_state(state, fields, mesh: Mesh, flags=None):
    """Place a JRL C-scene (state, fields[, flags]) onto the mesh.

    ``fields`` may contain ``vel_field`` [N, 2, H, W] (approach phase),
    which is split spatially over the same mesh.
    """
    state = {"C": _place(state["C"], S2, mesh), "h": _place(state["h"], S3, mesh)}
    out_fields = {"base_flags": _place(fields["base_flags"], S2, mesh),
                  "mesh": _place(fields["mesh"], S3, mesh)}
    if "vel_field" in fields:
        out_fields["vel_field"] = _place(fields["vel_field"], S4, mesh)
    if flags is not None:
        return state, out_fields, _place(flags, S2, mesh)
    return state, out_fields
