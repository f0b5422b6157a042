"""ctypes bridge to the native fast-I/O codec (native/fastio.c).

The reference's only native artifact is its C binary; here the compute
tier is XLA-compiled, so the native tier that remains host-side is I/O: formatting a 1024x1024 final_state.dat is ~1M printf
lines (d2q9-bgk.c:2935-2980), which is worth a C codec.  The library is
optional — every caller falls back to pure Python when it is absent.

Build: ``python -m advanced_hpc_lbm_tpu.utils.native`` (invokes cc), or
``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "fastio.c"
_LIB = _REPO_ROOT / "native" / "libfastio.so"

_lib: ctypes.CDLL | None = None
_load_failed = False


def _try_load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB.exists():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
        lib.fastio_write_final_state.restype = ctypes.c_int
        lib.fastio_write_final_state.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.fastio_write_av_vels.restype = ctypes.c_int
        lib.fastio_write_av_vels.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.fastio_parse_obstacles.restype = ctypes.c_long
        lib.fastio_parse_obstacles.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _try_load() is not None


def build(verbose: bool = False) -> bool:
    """Compile native/fastio.c with the system cc. Returns success."""
    if not _SRC.exists():
        return False
    cmd = [
        os.environ.get("CC", "cc"),
        "-O2",
        "-shared",
        "-fPIC",
        "-o",
        str(_LIB),
        str(_SRC),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        return False
    if verbose and res.returncode != 0:
        sys.stderr.write(res.stderr)
    global _load_failed
    _load_failed = False
    return res.returncode == 0 and _try_load() is not None


def write_final_state(
    path: str | os.PathLike,
    coords: np.ndarray,
    fields: np.ndarray,
    obs_col: np.ndarray,
) -> None:
    lib = _try_load()
    assert lib is not None
    n = coords.shape[0]
    rc = lib.fastio_write_final_state(
        str(path).encode(),
        np.ascontiguousarray(coords, dtype=np.int64),
        np.ascontiguousarray(fields, dtype=np.float64),
        np.ascontiguousarray(obs_col, dtype=np.int64),
        n,
    )
    if rc != 0:
        raise OSError(f"fastio_write_final_state failed with rc={rc} ({path})")


def write_av_vels(path: str | os.PathLike, av: np.ndarray) -> None:
    lib = _try_load()
    assert lib is not None
    av = np.ascontiguousarray(av, dtype=np.float64)
    rc = lib.fastio_write_av_vels(str(path).encode(), av, av.size)
    if rc != 0:
        raise OSError(f"fastio_write_av_vels failed with rc={rc} ({path})")


_PARSE_ERRORS = {
    -2: "expected 3 values per line in obstacle file",
    -3: "obstacle x-coord out of range",
    -4: "obstacle y-coord out of range",
    -5: "obstacle blocked value should be 1",
}


def parse_obstacles(
    path: str | os.PathLike, nx: int, ny: int
) -> np.ndarray | None:
    """C fast path for the obstacle deck parser.  Returns a (ny, nx) bool
    mask, None if the library is unavailable, or raises ValueError with
    the reference's die() message on malformed decks."""
    lib = _try_load()
    if lib is None:
        return None
    mask = np.zeros(ny * nx, dtype=np.uint8)
    err_line = ctypes.c_long(0)
    rc = lib.fastio_parse_obstacles(
        str(path).encode(), nx, ny, mask, ctypes.byref(err_line)
    )
    if rc == -1:
        raise OSError(f"could not open input obstacles file: {path}")
    if rc < 0:
        msg = _PARSE_ERRORS.get(int(rc), "malformed obstacle file")
        raise ValueError(f"{msg} ({path}:{err_line.value})")
    return mask.reshape(ny, nx).astype(bool)


if __name__ == "__main__":
    ok = build(verbose=True)
    print(f"libfastio: {'built ' + str(_LIB) if ok else 'build FAILED'}")
    sys.exit(0 if ok else 1)
