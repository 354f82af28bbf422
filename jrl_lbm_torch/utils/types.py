"""Cell-flag and axisymmetry enums (copy of the JAX package's
`utils/types.py`; the integer values are the reference's
`src/LBM/utils/types.py:5-79`)."""

from __future__ import annotations

from enum import IntEnum


class CellType(IntEnum):
    NOTHING = 0
    FLUID = 1
    OBSTACLE = 2
    EMPTY = 4
    INFLOW = 8
    OUTFLOW = 16
    INFLOW_2 = 32


class KBCType(IntEnum):
    LBGK = 0
    KBC_A = 0b10000101
    KBC_B = 0b10000110
    KBC_C = 0b10001001
    KBC_D = 0b10001010


def is_KBC(value) -> bool:
    return value is not None and (int(value) & 0b10000000) > 0


def is_KBC_AC(value) -> bool:
    return value is not None and (int(value) & 0b10000001) > 0


def is_KBC_BD(value) -> bool:
    return value is not None and (int(value) & 0b10000010) > 0


def is_KBC_AB(value) -> bool:
    return value is not None and (int(value) & 0b10000100) > 0


def is_KBC_CD(value) -> bool:
    return value is not None and (int(value) & 0b10001000) > 0


class ObsType(IntEnum):
    BOX = 0
    SPHERE = 1


class AxiSymmetricType(IntEnum):
    NOT = 0
    LINE_X_EQ_0 = 1
    LINE_Y_EQ_0 = 2
    LINE_Z_EQ_0 = 3
