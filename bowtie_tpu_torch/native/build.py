"""Compile and load the host SA-IS library (native/sais.cpp) with g++.

The library is built at first use into ``native/build/`` beside this
file (listed in .gitignore) and rebuilt when the source is newer.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sais.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB = os.path.join(_BUILD_DIR, "libbtsais.so")

_cached = None


def build_sais(force: bool = False) -> str:
    """g++ sais.cpp -> native/build/libbtsais.so; returns the path.
    Raises RuntimeError with the compiler's output if the build fails."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {_SRC}:\n{proc.stderr}")
    os.replace(tmp, _LIB)   # atomic: concurrent builders never see a torn file
    return _LIB


def load_sais():
    """The SA-IS library, built on first use."""
    global _cached
    if _cached is None:
        lib = ctypes.CDLL(build_sais())
        lib.sais_bowtie32.restype = ctypes.c_int
        lib.sais_bowtie32.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                      ctypes.c_void_p]
        lib.sais_bowtie.restype = ctypes.c_int
        lib.sais_bowtie.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
        _cached = lib
    return _cached
