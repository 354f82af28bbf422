"""`halo_mesh`: the whole halo exchange of a local mesh held on one device
in one launch (`jrl_lbm_torch/kernels/halo.py`, `csrc/halo_pack.cu`).

On the CPU the wrapper runs its twin, `halo_mesh_ref`, which slices every
piece straight from the neighbour that owns it. These tests hold it bit
for bit to the two-phase exchange (`halo_pack_ref` a shard and phase,
moved by `ppermute`: ``route="shards"``) on meshes of one to six shards,
k = 1..4 rows, 0, 1, 4 and 8 lanes, groups of 1, 2, 3 and 5 tensors with
an int32 flags plane among them; they check the route `exchange` picks
and the layout of the one buffer. The card's kernel is held to the twin
in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_torch.kernels import halo as HA
from jrl_lbm_torch.parallel.mesh import Mesh, make_mesh, split

MESHES = ((1, 1), (2, 1), (3, 1), (4, 1), (1, 2), (1, 3), (2, 2), (3, 2), (2, 3))
SHARD = (5, 9)  # rows, lanes: room for k = 4 and xh = 8
KS = (1, 2, 3, 4)
XHS = (0, 1, 4, 8)


def _fields(shape, seed):
    """Global fields of a mesh of ``shape`` (NaN-free, from a numpy seed):
    f [9], vel [2], phi, rho and int32 flags."""
    rng = np.random.default_rng(seed)
    H, W = SHARD[0] * shape[0], SHARD[1] * shape[1]
    g = {"f": rng.standard_normal((9, H, W)), "vel": rng.standard_normal((2, H, W)),
         "phi": rng.standard_normal((H, W)), "rho": 1.0 + rng.random((H, W))}
    g = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in g.items()}
    g["flags"] = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (H, W)), dtype=torch.int32)
    return g


def _groups(mesh, g):
    """The four field groups of every shard: 1, 2, 3 and 5 tensors, each
    with the flags' bits as float32."""
    sh = {k: split(v, mesh) for k, v in g.items()}
    fl = [x.view(torch.float32) for x in sh["flags"]]
    L = range(len(fl))
    return {1: [[fl[i]] for i in L],
            2: [[sh["f"][i], fl[i]] for i in L],
            3: [[sh["vel"][i], sh["rho"][i], fl[i]] for i in L],
            5: [[fl[i], sh["f"][i], sh["vel"][i], sh["phi"][i], sh["rho"][i]] for i in L]}


def _same(got, want):
    """Two `Halo` lists equal bit for bit, piece by piece."""
    for a, b in zip(got, want):
        assert (a.P, a.k) == (b.P, b.k)
        for name in ("top", "bot", "left", "right"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype, name
                assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_twin_equals_two_phase_exchange(shape):
    """On every mesh, k and lane depth and group, the twin's pieces equal
    the two-phase exchange's bit for bit, and each is a contiguous view,
    16-byte aligned, of one buffer."""
    mesh = make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
    groups = _groups(mesh, _fields(shape, 2500 + 10 * shape[0] + shape[1]))
    for n, grp in groups.items():
        for k in KS:
            for xh in XHS:
                got = HA.halo_mesh_ref(grp, mesh, xh, rows=k)
                _same(got, HA.exchange(grp, mesh, xh, rows=k, route="shards"))
                _same(HA.exchange(grp, mesh, xh, rows=k), got)
                bases = set()
                for hl in got:
                    for t in (hl.top, hl.bot, hl.left, hl.right):
                        if t is not None:
                            assert t.is_contiguous() and t.data_ptr() % 16 == 0, (n, k, xh)
                            bases.add(t.untyped_storage().data_ptr())
                assert len(bases) <= 1, "the pieces of one exchange share one buffer"


def test_int32_group_keeps_its_dtype_and_bits():
    """A group of int32 flags (the C passes' flag pieces) comes back int32,
    its values those of the two-phase exchange."""
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    fl = split(_fields((2, 2), 7)["flags"], mesh)
    got = HA.exchange([[x] for x in fl], mesh, 4, rows=4)
    want = HA.exchange([[x] for x in fl], mesh, 4, rows=4, route="shards")
    assert got[0].top.dtype == torch.int32
    _same(got, want)


def test_route_pick_and_refusals():
    """``route=None`` takes the mesh route on a one-device local mesh and
    the per-shard one on a process group; a forced ``"mesh"`` raises on a
    mesh whose shards sit on two devices, and on groups that differ."""
    mesh = make_mesh((2, 1), ["cpu", "cpu"])
    a = [torch.zeros(2, 5, 9), torch.zeros(2, 5, 9)]
    grp = [[x] for x in a]
    assert HA.halo_route(grp, mesh) == "mesh"
    assert HA.halo_route(grp, Mesh(mesh.devices, group=object())) == "shards"
    two = make_mesh((2, 1), ["cpu", "meta"])
    mixed = [[a[0]], [torch.zeros(2, 5, 9, device="meta")]]
    assert HA.halo_route(mixed, two) == "shards"
    with pytest.raises(ValueError):
        HA.exchange(mixed, two, 0, rows=1, route="mesh")
    with pytest.raises(ValueError):
        HA.exchange(grp, Mesh(mesh.devices, group=object()), 0, route="mesh")
    with pytest.raises(ValueError):  # shards of two shapes
        HA.halo_mesh([[a[0]], [torch.zeros(2, 5, 8)]], mesh, 0)
    with pytest.raises(ValueError):  # deeper than a shard
        HA.halo_mesh(grp, mesh, 0, rows=6)
    with pytest.raises(ValueError):
        HA.exchange(grp, mesh, 0, route="ring")


def test_one_shard_and_launch_count():
    """A mesh of one shard has no pieces; the twin on the CPU counts no
    launch."""
    mesh = make_mesh((1, 1), ["cpu"])
    before = HA.halo_mesh.launches
    (hl,) = HA.halo_mesh([[torch.ones(3, 5, 9)]], mesh, 4, rows=2)
    assert (hl.P, hl.k) == (3, 2)
    assert hl.top is hl.bot is hl.left is hl.right is None
    assert HA.halo_mesh.launches == before
