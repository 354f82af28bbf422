"""The port's mesh layer (`jrl_lbm_torch/parallel/`, `kernels/halo.py`)
against the JAX package's, on the 8 virtual CPU devices of
`tests/conftest.py`, and a two-process gloo mesh against the local mesh.

The port's shards of a local mesh are CPU tensors here; the JAX side runs
under ``shard_map``. Halo values are copies, so every comparison is
exact. Run as a script, this file is one rank of the two-process test and
imports torch only:

    python tests/test_torch_parallel.py <rank> <world> <port>
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)


def _worker(rank: int, world: int, port: int) -> int:
    """One rank of a (world, 1) gloo process-group mesh: 8 fluid and 8
    approach steps of the JRL case and 8 steps of the sharded cylinder
    (the lean split, and the PIECES route) at 48x32, each equal bit for
    bit to the local mesh's."""
    from jrl_lbm_torch.kernels import jrl_sharded as S
    from jrl_lbm_torch.models import jrl as T
    from jrl_lbm_torch.parallel import make_mesh, multihost
    from jrl_lbm_torch.parallel.mesh import split

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = multihost.pod_mesh(device="cpu")
        assert multihost.mesh_shape(mesh) == (world, 1) and mesh.local == [(rank, 0)]
        local = make_mesh((world, 1), ["cpu"] * world)

        fc = T.JRLFluidConfig(res=(48, 32), Re=4.0, vel_obs_real=0.2848,
                              gravity_strength_real=-9.8, shape="45degree")
        s, fl = T.fluid_init(fc, "cpu")
        got = S.make_sharded_tiled_fluid_runner(fc, mesh)(s, fl, 0, 8)
        want = S.make_sharded_tiled_fluid_runner(fc, local)(s, fl, 0, 8)
        for k in ("f", "rho", "vel"):
            assert torch.equal(got[k], want[k]), f"fluid {k}"

        cc = T.JRLCConfig(res=(48, 32), Re=4.0, Pe=5.0, shape="cylinder")
        st, cf, _ = T.c_init(cc, "cpu")
        vf = torch.as_tensor(np.random.default_rng(11).uniform(-0.5, 0.5, (4, 2, 48, 32))
                             .astype(np.float32))
        got, acc = S.make_sharded_tiled_approach_runner(cc, vf, mesh, unroll=4)(st, cf, 0, 8)
        want, acc_w = S.make_sharded_tiled_approach_runner(cc, vf, local, unroll=4)(st, cf, 0, 8)
        for k in ("h", "C"):
            assert torch.equal(got[k], want[k]), f"approach {k}"
        for k in acc:
            assert torch.equal(acc[k], acc_w[k]), f"approach {k}"
        from jrl_lbm_torch.kernels import cyl_sharded as CS
        from jrl_lbm_torch.models import cylinder as TC

        ccyl = TC.CylinderConfig(res=(48, 32), D=7.4, Re=500.0, cylinder_center=(16.0, 16.0))
        cs, cfl = TC.init(ccyl, "cpu")
        for kw in (dict(), dict(lean_split=False, tile_rows=8)):
            got = CS.make_sharded_fused_cylinder_runner(ccyl, mesh, **kw)(cs, cfl, 8)
            want = CS.make_sharded_fused_cylinder_runner(ccyl, local, **kw)(cs, cfl, 8)
            for k in ("f", "rho", "vel"):
                assert torch.equal(got[k], want[k]), f"cylinder {kw} {k}"
        lifted = multihost.lift({"C": st["C"]}, mesh)["C"]
        assert torch.equal(lifted[0], split(st["C"], local)[rank])
    finally:
        torch.distributed.destroy_process_group()
    print(f"proc {rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*(int(a) for a in sys.argv[1:4])))


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from jrl_lbm_tpu.ops.pallas import fused_jrl_sharded as jsh  # noqa: E402
from jrl_lbm_tpu.parallel import halo as jhalo  # noqa: E402
from jrl_lbm_tpu.parallel import mesh as jmesh  # noqa: E402
from jrl_lbm_torch.kernels import halo as HA  # noqa: E402
from jrl_lbm_torch.parallel import halo, mesh  # noqa: E402


def _jax_mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])


def _port_mesh(shape):
    return mesh.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _shard_map(fn, m, n_out):
    spec = PS(None, jmesh.AXIS_Y, jmesh.AXIS_X)
    return jax.jit(jax.shard_map(fn, mesh=m, in_specs=spec, out_specs=(spec,) * n_out,
                                 check_vma=False))


def _blocks(a: np.ndarray, shape):
    """The per-shard blocks of a global ``[P, ny*bh, nx*bw]`` array, in
    row-major shard order."""
    ny, nx = shape
    bh, bw = a.shape[-2] // ny, a.shape[-1] // nx
    return [a[..., iy * bh:(iy + 1) * bh, ix * bw:(ix + 1) * bw]
            for iy in range(ny) for ix in range(nx)]


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n):
    m = mesh.make_mesh(devices=["cpu"] * n)
    assert m.devices.shape == jmesh.make_mesh(devices=jax.devices()[:n]).devices.shape
    assert m.local == [(iy, ix) for iy in range(m.shape[0]) for ix in range(m.shape[1])]


def test_make_mesh_refuses_mismatch_and_needs_devices():
    with pytest.raises(ValueError, match="does not match"):
        mesh.make_mesh((3, 2), ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not match"):
        jmesh.make_mesh((3, 2), devices=jax.devices()[:4])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


def test_ring_perm_matches_jax():
    for n in range(1, 6):
        for shift in (-1, 1, 2):
            assert halo.ring_perm(n, shift) == jhalo._ring_perm(n, shift)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_pad_halo_matches_jax(shape):
    """Periodic global neighbours with corners, as JAX's ``pad_halo``."""
    x = np.random.default_rng(3).standard_normal((3, 16, 16)).astype(np.float32)
    jm = _jax_mesh(shape)
    (jp,) = _shard_map(lambda a: (jhalo.pad_halo(a, jmesh.AXIS_Y, jmesh.AXIS_X),), jm, 1)(
        jnp.asarray(x))
    pm = _port_mesh(shape)
    got = halo.pad_halo(mesh.split(torch.as_tensor(x), pm), pm)
    for g, w in zip(got, _blocks(np.asarray(jp), shape)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(halo.pad_periodic(torch.as_tensor(x)).numpy(),
                                  np.asarray(jhalo.pad_periodic(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_domain_info_matches_jax(shape):
    H, W = 16, 24
    ny, nx = shape
    h, w = H // ny, W // nx
    jm = _jax_mesh(shape)

    def dom(a):
        d = jhalo.make_domain((h, w), (H, W), jmesh.AXIS_Y, jmesh.AXIS_X, 1)
        return (jnp.stack([d.gy, d.gx, d.at_x0, d.at_xW, d.at_y0, d.at_yH]).astype(jnp.int32),)

    (jd,) = _shard_map(dom, jm, 1)(jnp.zeros((1, H, W), jnp.float32))
    pm = _port_mesh(shape)
    for c, want in zip(pm.local, _blocks(np.asarray(jd), shape)):
        d = halo.make_domain((h, w), (H, W), c, 1, device="cpu")
        got = torch.stack([d.gy, d.gx, d.at_x0, d.at_xW, d.at_y0, d.at_yH]).to(torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (d.h, d.w, d.H, d.W, d.axis_x, d.axis_y) == (h, w, H, W, True, False)
    sd, jsd = halo.make_single_domain((H, W), 2, device="cpu"), jhalo.make_single_domain((H, W), 2)
    np.testing.assert_array_equal(sd.gx.numpy(), np.asarray(jsd.gx))
    assert (sd.axis_x, sd.axis_y) == (jsd.axis_x, jsd.axis_y)


@pytest.mark.parametrize("shape,x_ext", [((2, 2), 2), ((4, 2), 8), ((1, 4), 2), ((2, 1), 2)])
def test_halo_pieces_match_jax(shape, x_ext):
    """Row pieces (``halo_pack`` rows + ppermute) equal the real rows of
    JAX's ``_pieces``; edge blocks (``halo_pack`` columns of the
    row-extended block + ppermute) equal JAX's ``_xblocks``, corners and
    the global wrap included. One group of two tensors (9 + 2 planes)."""
    rng = np.random.default_rng(5)
    H, W = 32, 64
    f = rng.standard_normal((9, H, W)).astype(np.float32)
    v = rng.standard_normal((2, H, W)).astype(np.float32)
    x = np.concatenate([f, v])
    jm = _jax_mesh(shape)
    jt, jb = _shard_map(lambda a: jsh._pieces(a), jm, 2)(jnp.asarray(x))
    pm = _port_mesh(shape)
    groups = [list(g) for g in zip(mesh.split(torch.as_tensor(f), pm),
                                   mesh.split(torch.as_tensor(v), pm))]
    pieces = HA.row_pieces(groups, pm)
    for (t, b), wt, wb in zip(pieces, _blocks(np.asarray(jt), shape),
                              _blocks(np.asarray(jb), shape)):
        np.testing.assert_array_equal(t.numpy(), wt[:, -1])
        np.testing.assert_array_equal(b.numpy(), wb[:, 0])
    if shape[1] == 1:
        return
    jl, jr = _shard_map(lambda a: jsh._xblocks(a, x_ext, interpret=True), jm, 2)(jnp.asarray(x))
    blocks = HA.edge_blocks(groups, pieces, pm, x_ext)
    for (lf, rt), wl, wr in zip(blocks, _blocks(np.asarray(jl), shape),
                                _blocks(np.asarray(jr), shape)):
        np.testing.assert_array_equal(lf.numpy(), wl)
        np.testing.assert_array_equal(rt.numpy(), wr)


def test_halo_pack_twin_phases():
    """``halo_pack``'s twin: edge rows of every plane in group order; edge
    column blocks of the block extended by the given pieces (zeros where
    none), int32 flags alike."""
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.standard_normal((9, 6, 10)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((6, 10)).astype(np.float32))
    first, last = HA.halo_pack([a, b])
    x = torch.cat([a, b[None]])
    assert torch.equal(first, x[:, 0]) and torch.equal(last, x[:, -1])
    top, bot = torch.ones(10, 10), 2 * torch.ones(10, 10)
    lf, rt = HA.halo_pack([a, b], top, bot, 3)
    ext = torch.cat([top[:, None], x, bot[:, None]], dim=1)
    assert torch.equal(lf, ext[..., :3]) and torch.equal(rt, ext[..., -3:])
    lf0, _ = HA.halo_pack([a, b], None, None, 2)
    assert torch.equal(lf0[:, 1:-1], x[..., :2]) and not lf0[:, [0, -1]].any()
    fl = torch.as_tensor(rng.integers(0, 40, (6, 10)).astype(np.int32))
    assert torch.equal(HA.halo_pack([fl])[1], fl[None, -1])


def test_ppermute_and_psum_on_a_local_mesh():
    """A ring of one is the identity; a shift moves each shard's block to
    the next along the axis; psum sums in shard order."""
    pm = _port_mesh((2, 3))
    blocks = [torch.full((2,), float(10 * iy + ix)) for iy, ix in pm.local]
    moved = halo.ppermute(blocks, pm, mesh.AXIS_X, 1)
    for (iy, ix), t in zip(pm.local, moved):
        assert float(t[0]) == 10 * iy + (ix - 1) % 3
    moved = halo.ppermute(blocks, pm, mesh.AXIS_Y, -1)
    for (iy, ix), t in zip(pm.local, moved):
        assert float(t[0]) == 10 * ((iy + 1) % 2) + ix
    one = _port_mesh((1, 1))
    assert halo.ppermute(blocks[:1], one, mesh.AXIS_Y, 1)[0] is blocks[0]
    assert torch.equal(halo.psum(blocks, pm), torch.full((2,), 36.0))
    x = torch.arange(48.0).reshape(2, 4, 6)
    assert torch.equal(mesh.gather(mesh.split(x, pm), pm), x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_mesh_equals_local_mesh():
    """Two processes (this file as a script, torch only) form a (2, 1)
    gloo process-group mesh: 8 fluid and 8 approach steps at 48x32 and 8
    sharded cylinder steps (lean split and PIECES) equal the local (2, 1)
    mesh's bit for bit, integrals included."""
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(here) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "test_torch_parallel.py"),
                               str(i), "2", str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=100)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
        assert f"proc {i} OK" in out, f"rank {i} output:\n{out}"
