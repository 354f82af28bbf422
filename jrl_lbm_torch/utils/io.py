"""Artifact writers and readers (counterpart of the JAX package's
`utils/io.py`, in its file formats byte for byte): normalized PNG frames
and the mp4 of them, the Tecplot zones 'X Y RHO U V', 'X Y C RHO U V
NormX NormY' (through the native writer of `native_io` where it builds,
else in Python) and 'X Y C U V F0..F8', the HDF5 contracts ``Re_*.h5``
(dataset "vel") and ``C_balance*.h5`` ("C", "h"), pbrt smoke volumes and
OBJ meshes. ``h5py``, ``cv2`` and ``imageio`` are imported inside the
functions, so the compute path needs none of them. Inputs are numpy
arrays (or anything ``np.asarray`` takes); the caller brings a card's
tensors to the host.
"""

from __future__ import annotations

import math
import os
import zlib

import numpy as np

from jrl_lbm_torch.utils import native_io


def _np2d(a, B=0, C=0):
    """Accept [H,W], [C,H,W] or [B,C,H,W]; return [H,W] numpy."""
    a = np.asarray(a)
    if a.ndim == 4:
        return a[B, C]
    if a.ndim == 3:
        return a[C]
    return a


def tensor2numpy_2d_(img) -> np.ndarray:
    """Normalize to [0, 255] ([H, W] -> [H, W, 1])."""
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 4:
        img = np.transpose(img[0], (1, 2, 0))
    elif img.ndim == 2:
        img = img[..., None]
    mn, mx = img.min(), img.max()
    rng = mx - mn if mx > mn else 1.0
    return (img - mn) / rng * 255.0


def frame_pixels(img) -> np.ndarray:
    """The pixels `save_img` writes: normalized to [0, 255], cut to uint8,
    rows flipped (y up); ``[H, W]`` for one channel."""
    px = tensor2numpy_2d_(img).astype(np.uint8)[::-1]
    if px.shape[-1] == 1:
        px = px[..., 0]
    return np.ascontiguousarray(px)


def save_img(img, filename: str):
    """Normalized, y-flipped PNG."""
    import cv2

    cv2.imwrite(filename, frame_pixels(img))


def read_png_gray(filename) -> np.ndarray:
    """``[H, W]`` uint8 pixels of an 8-bit grayscale, non-interlaced PNG
    (what `save_img` writes), read with the standard library alone."""
    with open(filename, "rb") as fo:
        data = fo.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{filename}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None or not idat:
        raise ValueError(f"{filename}: no IHDR or IDAT chunk")
    W, H = int.from_bytes(head[0:4], "big"), int.from_bytes(head[4:8], "big")
    depth, color, interlace = head[8], head[9], head[12]
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(f"{filename}: bit depth {depth}, color type {color}, interlace "
                         f"{interlace}; only 8-bit grayscale without interlace is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, W + 1)
    out = np.zeros((H, W), np.uint8)
    prior = np.zeros(W, np.int64)
    for j in range(H):
        kind, row = raw[j, 0], raw[j, 1:].astype(np.int64)
        if kind == 1:  # Sub
            row = np.cumsum(row) % 256
        elif kind == 2:  # Up
            row = (row + prior) % 256
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before
            for i in range(W):
                a = int(row[i - 1]) if i else 0
                b = int(prior[i])
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prior[i - 1]) if i else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pred) % 256
        elif kind != 0:
            raise ValueError(f"{filename}: row {j} has filter type {kind}")
        out[j] = row
        prior = row
    return out


def write_video(file_list, out_path, fps=25):
    """An mp4 of the frames, as the reference writes it, or an animated GIF
    beside it where imageio has no mp4 writer."""
    import imageio

    if not file_list:
        return
    try:
        writer = imageio.get_writer(out_path, fps=fps)
    except Exception:
        out_path = os.path.splitext(str(out_path))[0] + ".gif"
        writer = imageio.get_writer(out_path, duration=1000.0 / fps)
    for im in file_list:
        writer.append_data(imageio.imread(im))
    writer.close()


def mkdir(path: str):
    if not os.path.exists(path):
        os.makedirs(path)


def _stagger_to_center(np_u, np_v, ref_shape):
    # float32 kept: the values are formatted as numpy float32 scalars
    np_u = np.asarray(np_u, dtype=np.float32)
    np_v = np.asarray(np_v, dtype=np.float32)
    if np_u.shape[-1] == ref_shape[-1] + 1:
        np_u = 0.5 * (np_u[..., 1:] + np_u[..., :-1])
    if np_v.shape[-2] == ref_shape[-2] + 1:
        np_v = 0.5 * (np_v[..., 1:, :] + np_v[..., :-1, :])
    return np_u, np_v


def dump_2d_plt_file_single(filename, np_density, np_u, np_v, B=0, C=0):
    """Tecplot ASCII zone 'X Y RHO U V' of a density and a staggered
    velocity (u ``[.., H, W + 1]``, v ``[.., H + 1, W]``, averaged to the
    cells)."""
    rho = _np2d(np_density, B, C).astype(np.float32)
    H, W = rho.shape
    u = np.asarray(np_u, dtype=np.float32)
    v = np.asarray(np_v, dtype=np.float32)
    u = _np2d(0.5 * (u[..., 1:] + u[..., :-1]), B, C)
    v = _np2d(0.5 * (v[..., 1:, :] + v[..., :-1, :]), B, C)
    if native_io.write_single(str(filename), rho, u, v):
        return
    with open(filename, "w") as fo:
        fo.write('TITLE ="Magnetic internal force"\n')
        fo.write('VARIABLES = "X" "Y" "RHO" "U" "V" \n')
        fo.write("ZONE I={}, J={}\n".format(W, H))
        fo.write("F=POINT\n")
        for j in range(H):
            for i in range(W):
                fo.write("{} {} {} {} {}\n".format(i, j, rho[j, i], u[j, i], v[j, i]))


def dump_2d_plt_file_C_rho(filename, np_C, np_density, np_u, np_v, B=0, C=0):
    """Tecplot ASCII zone 'X Y C RHO U V NormX NormY' (`io.py:308-333`)."""
    c_f = _np2d(np_C, B, C).astype(np.float32)
    rho = _np2d(np_density, B, C).astype(np.float32)
    H, W = rho.shape
    u, v = _stagger_to_center(np_u, np_v, rho.shape)
    u = _np2d(u, B, C)
    v = _np2d(v, B, C)
    if native_io.write_c_rho(str(filename), c_f, rho, u, v):
        return
    with open(filename, "w") as fo:
        fo.write('TITLE ="Magnetic internal force"\n')
        fo.write('VARIABLES = "X" "Y" "C" "RHO" "U" "V" "NormX" "NormY"\n')
        fo.write("ZONE I={}, J={}\n".format(W, H))
        fo.write("F=POINT\n")
        for j in range(H):
            for i in range(W):
                fo.write(
                    "{} {} {} {} {} {} {} {}\n".format(
                        i, j, c_f[j, i], rho[j, i], u[j, i], v[j, i], i / 12.5, j / 12.5,
                    )
                )


def read_2d_plt_file_C_rho(filename):
    """``[np_C, np_density, np_u, np_v]`` of a 'X Y C RHO U V ...' zone,
    each ``[1, 1, H, W]`` float32 (the reference reader's shape)."""
    native = native_io.read_c_rho(str(filename))
    if native is not None:
        return native
    with open(filename) as fo:
        fo.readline()
        fo.readline()
        line = fo.readline()
        i1 = line.find("I=")
        i2 = line.find(", J=")
        W = int(line[i1 + 2 : i2])
        H = int(line[i2 + 4 : -1])
        fo.readline()
        out = [np.zeros((1, 1, H, W), np.float32) for _ in range(4)]
        for j in range(H):
            for i in range(W):
                parts = fo.readline().rstrip("\n").split(" ")
                for a, p in zip(out, parts[2:6]):
                    a[0, 0, j, i] = float(p)
    return out


def dump_2d_plt_file_balance(filename, np_C, np_vel, np_h, B=0):
    """Tecplot ASCII zone 'X Y C U V F0..F8'.

    The reference writer reads vel channels 1 and 2 of a [B,3,H,W]-shaped
    array (`io.py:238-239`); here vel is [2,H,W] (or the reference layout)
    and channels 0/1 are written, which is what the matching reader
    (`read_2d_plt_file_balance`) restores.
    """
    c_f = _np2d(np_C, B, 0)
    H, W = c_f.shape
    vel = np.asarray(np_vel, dtype=np.float64)
    if vel.ndim == 4:
        vel = vel[B]
    h = np.asarray(np_h, dtype=np.float64)
    if h.ndim == 4:
        h = h[B]
    with open(filename, "w") as fo:
        fo.write('TITLE ="Magnetic internal force"\n')
        fo.write(
            'VARIABLES = "X" "Y" "C" "U" "V" "F0" "F1" "F2" "F3" "F4" "F5" "F6" "F7" "F8"\n'
        )
        fo.write("ZONE I={}, J={}\n".format(W, H))
        fo.write("F=POINT\n")
        for j in range(H):
            for i in range(W):
                vals = [i, j, c_f[j, i], vel[0, j, i], vel[1, j, i]] + [
                    h[q, j, i] for q in range(9)
                ]
                fo.write(" ".join(str(x) for x in vals) + "\n")


def read_2d_plt_file_balance(filename, np_C, np_vel, np_h, B=0):
    """Fill the given arrays (C ``[.., H, W]``, vel ``[.., 2, H, W]``, h
    ``[.., 9, H, W]``) in place from a balance zone; returns them."""
    H, W = np_C.shape[-2:]
    with open(filename) as fo:
        for _ in range(4):
            fo.readline()
        for j in range(H):
            for i in range(W):
                parts = fo.readline().split(" ")
                np_C[..., j, i] = float(parts[2])
                np_vel[..., 0, j, i] = float(parts[3])
                np_vel[..., 1, j, i] = float(parts[4])
                for q in range(9):
                    np_h[..., q, j, i] = float(parts[5 + q])
    return [np_C, np_vel, np_h]


def save_fluid_h5(filename: str, vel_field):
    """Fluid-phase artifact: dataset 'vel' = [N, 2, H, W] normalized
    velocity history."""
    import h5py

    with h5py.File(filename, "w") as h5:
        h5.create_dataset("vel", data=np.asarray(vel_field))


def load_fluid_h5(filename: str) -> np.ndarray:
    import h5py

    with h5py.File(filename, "r") as h5:
        return np.asarray(h5["vel"])


def save_balance_h5(filename: str, C, h):
    """C balance checkpoint: datasets 'C', 'h'."""
    import h5py

    with h5py.File(filename, "w") as h5:
        h5.create_dataset("C", data=np.asarray(C))
        h5.create_dataset("h", data=np.asarray(h))


def load_balance_h5(filename: str):
    import h5py

    with h5py.File(filename, "r") as h5:
        return np.asarray(h5["C"]), np.asarray(h5["h"])


# ---------------------------------------------------------------------------
# pbrt / OBJ export
# ---------------------------------------------------------------------------

def dump_smoke_pbrt(filename: str, density, B: int = 0, C: int = 0):
    """Heterogeneous-smoke pbrt volume of a ``[D, H, W]`` density (or
    ``[C, D, H, W]``, ``[B, C, D, H, W]``)."""
    d = np.asarray(density)
    if d.ndim == 5:
        d = d[B, C]
    elif d.ndim == 4:
        d = d[C]
    D, H, W = d.shape
    with open(filename, "w") as fo:
        fo.write('MakeNamedMedium "smoke"\n')
        fo.write(f'        "integer nx" [ {W} ] \n')
        fo.write(f'        "integer ny" [ {H} ] \n')
        fo.write(f'        "integer nz" [ {D} ] \n')
        scale = 1.0 / max(D, H, W)
        fo.write(
            f' "point p0" [ 0.0 0.0 0.0 ] "point p1" [{W * scale} {H * scale} {D * scale} ] \n'
        )
        fo.write('        "float density" [')
        for k in range(D):
            for j in range(H):
                for i in range(W):
                    fo.write(" {:.5f}".format(d[k, j, i]))
        fo.write(' ]\n        "string type" [ "heterogeneous" ] \n')


def export_asset(save_path: str, vertices, faces):
    """Triangle mesh as OBJ (1-based face indices)."""
    np_faces = np.asarray(faces).reshape(-1, 3).astype(np.int64)
    np_vertices = np.asarray(vertices).reshape(-1, 3)
    if np_faces.min() == 0:
        np_faces = np_faces + 1
    with open(save_path, "w") as f:
        f.write("# OBJ file\n")
        for vtx in np_vertices:
            f.write("v {} {} {}\n".format(vtx[0], vtx[1], vtx[2]))
        for fc in np_faces:
            f.write("f {} {} {}\n".format(fc[0], fc[1], fc[2]))


def export_cylinder(save_path: str, floor_center, ceil_center, radius: float):
    """Closed cylinder mesh (40 segments, 5 rings) as OBJ."""
    floor_center = np.asarray(floor_center, dtype=np.float64).reshape(3)
    ceil_center = np.asarray(ceil_center, dtype=np.float64).reshape(3)
    n_circle, n_z = 40, 5
    z_axis = (ceil_center - floor_center) / np.linalg.norm(ceil_center - floor_center)
    y_axis = np.array([1.0, 2.0, 5.0])
    x_axis = np.cross(y_axis, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    dh = np.linalg.norm(ceil_center - floor_center) / (n_z - 1.0)

    verts = np.zeros((n_circle * n_z + 2, 3))
    for i in range(n_z):
        layer = floor_center + (i * dh) * z_axis
        for j in range(n_circle):
            phi = j / n_circle * 2.0 * math.pi
            verts[i * n_circle + j] = (
                radius * math.cos(phi) * x_axis + radius * math.sin(phi) * y_axis + layer
            )
    verts[n_circle * n_z] = floor_center
    verts[n_circle * n_z + 1] = ceil_center

    faces = []
    for j in range(n_circle):
        faces.append([n_circle * n_z, (j + 1) % n_circle, j])
    for j in range(n_circle):
        faces.append(
            [n_circle * n_z + 1, j + n_circle * (n_z - 1), (j + 1) % n_circle + n_circle * (n_z - 1)]
        )
    for i in range(n_z - 1):
        for j in range(n_circle):
            jp = (j + 1) % n_circle
            faces.append([i * n_circle + j, i * n_circle + jp, (i + 1) * n_circle + j])
            faces.append([i * n_circle + jp, (i + 1) * n_circle + jp, (i + 1) * n_circle + j])
    export_asset(save_path, verts, np.asarray(faces, np.int64))


def export_box(save_path: str, res, width: float = 0.01):
    """Wireframe box (12 edge beams) of a ``res`` grid, scaled to [-1, 1],
    as OBJ."""
    dtype = np.float64
    res = list(res)
    aabb = np.array([[0, 0, 0], [res[0], res[1], res[2]]], dtype=dtype)
    aabb = (aabb - np.array([res], dtype=dtype) / 2.0) * (2.0 / max(res))

    corners = {}
    for ix, xl in enumerate("xX"):
        for iy, yl in enumerate("yY"):
            for iz, zl in enumerate("zZ"):
                corners[xl + yl + zl] = np.array(
                    [aabb[ix, 0], aabb[iy, 1], aabb[iz, 2]], dtype=dtype
                )

    def add_box(p0, p1, verts, faces):
        eps = 0.01
        d = np.linalg.norm(p1 - p0)
        n = (p1 - p0) / d
        if n.sum() < 0.0:
            p0, p1 = p1, p0
            n = -n
        if abs(n[0]) >= eps:
            t, b = np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0])
        elif abs(n[1]) >= eps:
            t, b = np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0])
        else:
            t, b = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
        p0 = p0 - width * t - width * b
        p1 = p1 + width * t + width * b
        x_, y_, z_ = p0
        X_, Y_, Z_ = p1
        nv = np.array(
            [
                [x_, y_, z_], [X_, y_, z_], [X_, Y_, z_], [x_, Y_, z_],
                [x_, y_, Z_], [X_, y_, Z_], [X_, Y_, Z_], [x_, Y_, Z_],
            ],
            dtype=dtype,
        )
        nf = np.array(
            [
                [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
                [2, 3, 7], [2, 7, 4], [3, 0, 4], [3, 4, 7],
            ],
            dtype=np.int64,
        )
        off = verts.shape[0]
        return np.concatenate([verts, nv]), np.concatenate([faces, nf + off])

    edges = [
        ("xyz", "Xyz"), ("Xyz", "XYz"), ("xYz", "XYz"), ("xyz", "xYz"),
        ("xyZ", "XyZ"), ("XyZ", "XYZ"), ("xYZ", "XYZ"), ("xyZ", "xYZ"),
        ("xyz", "xyZ"), ("Xyz", "XyZ"), ("xYz", "xYZ"), ("XYz", "XYZ"),
    ]
    verts = np.zeros((0, 3), dtype)
    faces = np.zeros((0, 3), np.int64)
    for a, b in edges:
        verts, faces = add_box(corners[a], corners[b], verts, faces)
    export_asset(save_path, verts, faces)
