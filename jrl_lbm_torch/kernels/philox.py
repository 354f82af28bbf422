"""Philox4x32-10, the counter-based generator of the stochastic-rounding
stores (plain PyTorch twin of `csrc/philox.cuh`).

Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC 2011),
as Random123 defines it: ten rounds of two 32x32->64 multiplies
(multipliers ``0xD2511F53``, ``0xCD9E8D57``) over a 4-word counter, with
the 2-word key bumped by ``0x9E3779B9``, ``0xBB67AE85`` between rounds.
The same (counter, key) gives the same four words here, in the kernels
and in Random123.

Words are held in int64 tensors with values in [0, 2**32), on any
device. torch has no unsigned 32x32->64 multiply, and the product of a
multiplier near 3.5e9 with a 32-bit word overflows int64, so the counter
word is split into 16-bit limbs: each partial product stays under 2**48.

How the stochastic-rounding stores draw (`kernels/cylinder.py`, the
kernels in `csrc/cyl_common.cuh::f_store`): key = (seed, launch number);
a cell with flat index ``c = y * W + x`` takes two calls, counter
``(c, 0, 0, 0)`` for populations 0-7 (population 2i the low 16 bits of
word i, 2i+1 the high 16 bits) and counter ``(c, 1, 0, 0)`` for
population 8 (the low 16 bits of word 0; the rest of that call is not
used). No (counter, key) pair repeats within a launch or across the
launches of one seed.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
BUMP0, BUMP1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * x`` for a 32-bit constant ``m``
    and an int64 tensor ``x`` of 32-bit words."""
    a = m * (x & 0xFFFF)         # < 2**48
    b = m * (x >> 16)            # < 2**48; the product is a + b * 2**16
    t = a + ((b & 0xFFFF) << 16)  # < 2**49
    return ((b >> 16) + (t >> 32)) & MASK32, t & MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 of ``ctr`` (four int64 tensors or ints of 32-bit
    words, broadcast together) under ``key`` (two ints); four int64
    tensors."""
    dev = next((w.device for w in ctr if isinstance(w, torch.Tensor)), None)
    c0, c1, c2, c3 = (torch.as_tensor(w, dtype=torch.int64, device=dev) for w in ctr)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + BUMP0) & MASK32, (k1 + BUMP1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def sr_bits(n_cells: int, key, device="cpu") -> torch.Tensor:
    """The 16 random bits each population of each cell adds in a
    stochastic-rounding store: int64 ``[9, n_cells]`` in [0, 2**16), in
    the counter layout of the module note."""
    c = torch.arange(n_cells, dtype=torch.int64, device=device)
    w = philox4x32((c, 0, 0, 0), key)
    w8 = philox4x32((c, 1, 0, 0), key)[0]
    planes = []
    for i in range(4):
        planes += [w[i] & 0xFFFF, w[i] >> 16]
    planes.append(w8 & 0xFFFF)
    return torch.stack(planes)
