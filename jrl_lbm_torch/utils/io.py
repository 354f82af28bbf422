"""Artifact writers of the JRL case (counterpart of the JAX package's
`utils/io.py`): normalized PNG, the Tecplot 'X Y C RHO U V NormX NormY'
zone (pure-Python writer), and the HDF5 contracts ``Re_*.h5`` (dataset
"vel") and ``C_balance*.h5`` ("C", "h"). ``h5py`` and ``cv2`` are
imported inside the functions, so the compute path needs neither.
Inputs are numpy arrays (or anything ``np.asarray`` takes).
"""

from __future__ import annotations

import os

import numpy as np


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


def save_img(img, filename: str):
    """Normalized, y-flipped PNG."""
    import cv2

    np_img = tensor2numpy_2d_(img).astype(np.uint8)
    cv2.imwrite(filename, cv2.flip(np_img, 0))


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


def dump_2d_plt_file_C_rho(filename, np_C, np_density, np_u, np_v, B=0, C=0):
    """Tecplot ASCII zone 'X Y C RHO U V NormX NormY' (`io.py:308-333`)."""
    c_f = _np2d(np_C, B, C).astype(np.float32)
    rho = _np2d(np_density, B, C).astype(np.float32)
    H, W = rho.shape
    u, v = _stagger_to_center(np_u, np_v, rho.shape)
    u = _np2d(u, B, C)
    v = _np2d(v, B, C)
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
