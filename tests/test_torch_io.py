"""The port's I/O utilities on the CPU against the JAX package's: the
Tecplot writers (native and Python) and readers, the balance zone, the
pbrt volume and OBJ meshes, byte for byte; the standard-library PNG
reader against PIL; the grid functions, `ObsType` and `force_sync`.

Inputs come from numpy with a seed. Tolerances: files byte-equal, reads
exact; grid functions exact, 1e-6 where a float32 sum is reordered.
About 6 s on one worker.
"""

import os
import shutil
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from jrl_lbm_tpu.utils import grid as jgrid
from jrl_lbm_tpu.utils import io as jio
from jrl_lbm_tpu.utils import metrics as jmetrics
from jrl_lbm_tpu.utils import native_io as jnative_io
from jrl_lbm_tpu.utils import types as jtypes
from jrl_lbm_torch import utils as tutils
from jrl_lbm_torch.utils import grid as tgrid
from jrl_lbm_torch.utils import io as tio
from jrl_lbm_torch.utils import metrics as tmetrics
from jrl_lbm_torch.utils import native_io
from jrl_lbm_torch.utils import types as ttypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "validation", "goldens")


def _fields(seed, H=9, W=7):
    """rho, C and the staggered u [H, W+1], v [H+1, W], float32, with a few
    values whose text is awkward (integers, tiny, huge, subnormal)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 3.0, size=(H, W)).astype(np.float32)
    C = rng.normal(size=(H, W)).astype(np.float32)
    u = (rng.normal(size=(H, W + 1)) * 1e-3).astype(np.float32)
    v = rng.normal(size=(H + 1, W)).astype(np.float32)
    rho[0, 0], C[0, 1], C[1, 1], u[2, 2], v[3, 3] = 1.0, -2.5e-7, 3.0e38, 1e-45, 0.0
    return rho, C, u, v


def _read(path):
    with open(path, "rb") as fo:
        return fo.read()


@pytest.fixture
def python_path(monkeypatch):
    """The port's writers with the native library out of reach."""
    monkeypatch.setattr(native_io, "get_lib", lambda: None)


def test_native_library_builds_where_gxx_exists():
    if shutil.which("g++") is None:
        assert native_io.get_lib() is None
    else:
        assert native_io.get_lib() is not None
        assert native_io.lib_path().exists()


@pytest.mark.parametrize("values", ["finite", "non-finite"])
@pytest.mark.parametrize("zone", ["single", "c_rho"])
def test_tecplot_zone_native_python_and_jax_byte_equal(zone, values, tmp_path, monkeypatch):
    """The native writer (taken wherever g++ exists), the Python writer and
    the JAX package's writer give the same bytes. Non-finite values (a
    diverged run) against JAX's Python writer: its native one writes a NaN
    with the sign bit set as "-nan", Python and the port as "nan"."""
    rho, C, u, v = _fields(1)
    if values == "non-finite":
        rho[1, 2], C[2, 3], u[3, 4], v[4, 5] = np.inf, -np.inf, np.nan, -np.nan
        rho[5, 1] = -np.nan
        assert np.signbit(rho[5, 1])
        monkeypatch.setattr(jnative_io, "get_lib", lambda: None)
    if zone == "single":
        args = (rho, u, v)
        port, jax_ = tio.dump_2d_plt_file_single, jio.dump_2d_plt_file_single
        native_fn = "write_single"
    else:
        args = (C, rho, u, v)
        port, jax_ = tio.dump_2d_plt_file_C_rho, jio.dump_2d_plt_file_C_rho
        native_fn = "write_c_rho"
    taken = []
    real = getattr(native_io, native_fn)
    monkeypatch.setattr(native_io, native_fn, lambda *a: taken.append(real(*a)) or taken[-1])
    port(str(tmp_path / "native.plt"), *args)
    if shutil.which("g++") is not None:
        assert taken == [True], "the native writer was not the one taken"
    monkeypatch.setattr(native_io, "get_lib", lambda: None)
    port(str(tmp_path / "python.plt"), *args)
    jax_(str(tmp_path / "jax.plt"), *args)
    want = _read(tmp_path / "jax.plt")
    assert _read(tmp_path / "python.plt") == want
    assert _read(tmp_path / "native.plt") == want
    assert len(want.splitlines()) == rho.size + 4


@pytest.mark.parametrize("path", ["native", "python"])
def test_read_c_rho_round_trips_and_reads_jax_files(path, tmp_path, request):
    if path == "python":
        request.getfixturevalue("python_path")
    rho, C, u, v = _fields(2)
    ours, theirs = str(tmp_path / "port.dat"), str(tmp_path / "jax.dat")
    tio.dump_2d_plt_file_C_rho(ours, C, rho, u, v)
    jio.dump_2d_plt_file_C_rho(theirs, C, rho, u, v)
    uc = 0.5 * (u[:, 1:] + u[:, :-1])
    vc = 0.5 * (v[1:] + v[:-1])
    for fn in (ours, theirs):
        got = tio.read_2d_plt_file_C_rho(fn)
        for g, w in zip(got, (C, rho, uc, vc)):
            assert g.shape == (1, 1) + rho.shape and g.dtype == np.float32
            np.testing.assert_array_equal(g[0, 0], w)
    for g, w in zip(tio.read_2d_plt_file_C_rho(theirs), jio.read_2d_plt_file_C_rho(theirs)):
        np.testing.assert_array_equal(g, w)


def test_balance_zone_byte_equal_and_read_in_place(tmp_path):
    rng = np.random.default_rng(3)
    H, W = 6, 5
    C = rng.uniform(size=(H, W)).astype(np.float32)
    vel = rng.normal(size=(2, H, W)).astype(np.float32)
    h = rng.uniform(size=(9, H, W)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.dat"), str(tmp_path / "jax.dat")
    tio.dump_2d_plt_file_balance(ours, C, vel, h)
    jio.dump_2d_plt_file_balance(theirs, C, vel, h)
    assert _read(ours) == _read(theirs)
    bufs = [np.zeros((1, 1, H, W), np.float32), np.zeros((1, 2, H, W), np.float32),
            np.zeros((1, 9, H, W), np.float32)]
    got = tio.read_2d_plt_file_balance(ours, *bufs)
    assert all(g is b for g, b in zip(got, bufs)), "the reader fills the given arrays"
    for g, w in zip(bufs, (C, vel, h)):
        np.testing.assert_array_equal(g.reshape(w.shape), w)
    jbufs = [np.zeros_like(b) for b in bufs]
    jio.read_2d_plt_file_balance(theirs, *jbufs)
    for g, w in zip(bufs, jbufs):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["pbrt", "asset", "cylinder", "box"])
def test_pbrt_and_obj_exports_byte_equal(kind, tmp_path):
    rng = np.random.default_rng(4)
    if kind == "pbrt":
        d = rng.uniform(size=(1, 3, 4, 5)).astype(np.float32)
        call = lambda m, fn: m.dump_smoke_pbrt(fn, d)  # noqa: E731
    elif kind == "asset":
        verts = rng.normal(size=(6, 3))
        faces = rng.integers(0, 6, size=(4, 3))
        faces[0, 0] = 0
        call = lambda m, fn: m.export_asset(fn, verts, faces)  # noqa: E731
    elif kind == "cylinder":
        call = lambda m, fn: m.export_cylinder(fn, [0.1, 0.2, -0.3], [0.4, 1.5, 0.9], 0.25)  # noqa: E731
    else:
        call = lambda m, fn: m.export_box(fn, [40, 30, 20], width=0.02)  # noqa: E731
    call(tio, str(tmp_path / "port"))
    call(jio, str(tmp_path / "jax"))
    assert _read(tmp_path / "port") == _read(tmp_path / "jax")


def _png(pixels, filters):
    """An 8-bit grayscale PNG of ``pixels`` whose row j uses filter
    ``filters[j]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    H, W = pixels.shape
    raw, prior = bytearray(), np.zeros(W, np.int64)
    for j in range(H):
        row, ft = pixels[j].astype(np.int64), filters[j]
        left = np.concatenate([[0], row[:-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        if ft == 0:
            pred = np.zeros(W, np.int64)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            pa, pb, pc = (np.abs(prior - upleft), np.abs(left - upleft),
                          np.abs(left + prior - 2 * upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw += bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    head = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["1001.png", "2001.png", "filters"])
def test_png_reader_matches_pil(name, tmp_path):
    """The standard-library reader against PIL: the cylinder goldens (Sub
    rows, as cv2 writes them) and a PNG with rows of all five filters."""
    from PIL import Image

    if name == "filters":
        px = np.random.default_rng(5).integers(0, 256, size=(25, 17)).astype(np.uint8)
        fn = str(tmp_path / "filters.png")
        with open(fn, "wb") as fo:
            fo.write(_png(px, [j % 5 for j in range(25)]))
    else:
        fn = os.path.join(GOLD, "2d_LBM_cylinder", name)
    got = tio.read_png_gray(fn)
    want = np.asarray(Image.open(fn))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name == "filters":
        np.testing.assert_array_equal(got, px)


def test_frame_pixels_are_what_save_img_writes(tmp_path):
    from PIL import Image

    vort = np.random.default_rng(6).normal(size=(12, 8)).astype(np.float32)
    fn = str(tmp_path / "f.png")
    tio.save_img(vort, fn)
    px = tio.frame_pixels(vort)
    assert px.shape == (12, 8) and px.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(Image.open(fn)), px)
    np.testing.assert_array_equal(tio.read_png_gray(fn), px)
    jfn = str(tmp_path / "j.png")
    jio.save_img(vort, jfn)
    np.testing.assert_array_equal(np.asarray(Image.open(jfn)), px)


@pytest.mark.parametrize("fn", ["create_3d_meshgrid", "create_droplet_2d", "get_staggered_z",
                                "dot", "dot_e_vel", "dot_vel_vel"])
def test_grid_functions_match_jax(fn):
    rng = np.random.default_rng(7)
    tol = dict(rtol=0, atol=0)
    if fn == "create_3d_meshgrid":
        got, want = tgrid.create_3d_meshgrid((4, 5, 6)), jgrid.create_3d_meshgrid((4, 5, 6))
        assert got.shape == (3, 4, 5, 6)
    elif fn == "create_droplet_2d":
        rho = rng.uniform(size=(20, 16)).astype(np.float32)
        args = ((7.3, 9.6), 4.5, 2.0)
        got = tgrid.create_droplet_2d(*args, torch.as_tensor(rho))
        want = jgrid.create_droplet_2d(*args, jnp.asarray(rho))
    elif fn == "get_staggered_z":
        a = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
        got, want = tgrid.get_staggered_z(torch.as_tensor(a)), jgrid.get_staggered_z(jnp.asarray(a))
        assert got.shape == (2, 6, 4, 3)
    elif fn == "dot":
        x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
        y = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
        tol = dict(rtol=1e-6, atol=1e-6)  # a sum of three
        for dim, keep in ((3, False), (3, True), (2, True), (1, False)):
            g = tgrid.dot(dim, torch.as_tensor(x), torch.as_tensor(y), keep_dim=keep)
            w = jgrid.dot(dim, jnp.asarray(x), jnp.asarray(y), keep_dim=keep)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
        return
    elif fn == "dot_e_vel":
        e = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [-1, 1], [-1, -1],
                      [1, -1]], np.float32)
        vel = rng.normal(size=(2, 6, 5)).astype(np.float32)
        got, want = tgrid.dot_e_vel(e, torch.as_tensor(vel)), jgrid.dot_e_vel(e, jnp.asarray(vel))
    else:
        a = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
        b = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
        tol = dict(rtol=1e-6, atol=1e-6)  # a sum of three
        for keep in (False, True):
            g = tgrid.dot_vel_vel(torch.as_tensor(a), torch.as_tensor(b), keep_dim=keep)
            w = jgrid.dot_vel_vel(jnp.asarray(a), jnp.asarray(b), keep_dim=keep)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
        return
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_obstype_and_exported_names_match_jax():
    assert {k.name: int(k) for k in ttypes.ObsType} == {k.name: int(k) for k in jtypes.ObsType}
    from jrl_lbm_tpu import utils as jutils

    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    assert all(hasattr(tutils, n) for n in tutils.__all__)


def test_force_sync_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(size=(9, 16, 12)).astype(np.float32)
    b = rng.uniform(size=(2, 16, 12)).astype(np.float32)
    want = jmetrics.force_sync(jnp.asarray(a))
    assert tmetrics.force_sync(torch.as_tensor(a)) == pytest.approx(want, rel=1e-6)
    # a dict's first leaf is its first key in sorted order, as JAX flattens it
    jstate = {"vel": jnp.asarray(b), "f": jnp.asarray(a)}
    tstate = {"vel": torch.as_tensor(b), "f": torch.as_tensor(a)}
    assert tmetrics.force_sync(tstate) == pytest.approx(jmetrics.force_sync(jstate), rel=1e-6)
    assert tmetrics.force_sync([torch.as_tensor(b), torch.as_tensor(a)]) == pytest.approx(
        jmetrics.force_sync([jnp.asarray(b), jnp.asarray(a)]), rel=1e-6)
