"""D2Q9 lattice constants.

Speed numbering follows the reference's layout diagram (d2q9-bgk.c:7-13):

        6 2 5
        3 0 1        1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE
        7 4 8

Axis convention used throughout this package: distribution arrays are
``(9, ny, nx)`` — axis 1 is y (``jj``, north = +1), axis 2 is x (``ii``,
east = +1).  This planes-of-speeds (SoA) layout is the vector-friendly
replacement for the reference's array-of-structs ``t_speed`` (d2q9-bgk.c:75-79),
whose AoS layout defeated the reference compiler's vectorizer
(e000/hs000/vectorization.advisum: is_vectorized=0).
"""

from __future__ import annotations

import numpy as np

NSPEEDS = 9

# Lattice velocities: CX[k], CY[k] = x/y displacement per step of speed k.
CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)

# Quadrature weights (d2q9-bgk.c:984-986): w0=4/9 rest, w1=1/9 axes, w2=1/36
# diagonals.
W = np.array(
    [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float32
)

# Opposite-speed permutation for bounce-back (pairs swapped by `rebound`,
# d2q9-bgk.c:2199-2228): 1<->3, 2<->4, 5<->7, 6<->8.
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Square of the lattice speed of sound (d2q9-bgk.c:983).
C_SQ = np.float32(1.0 / 3.0)

# Index groups used by the moment computations (d2q9-bgk.c:1002-1016):
# u_x = (f1+f5+f8 - f3-f6-f7)/rho ; u_y = (f2+f5+f6 - f4-f7-f8)/rho.
EAST_SPEEDS = (1, 5, 8)
WEST_SPEEDS = (3, 6, 7)
NORTH_SPEEDS = (2, 5, 6)
SOUTH_SPEEDS = (4, 7, 8)

assert all(CX[OPP] == -CX) and all(CY[OPP] == -CY)
assert np.isclose(W.sum(), 1.0)
