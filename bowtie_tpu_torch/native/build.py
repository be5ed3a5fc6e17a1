"""Compile and load the host libraries of native/ with g++: SA-IS and the
streaming writer's extraction pass (sais.cpp) for the builder, and the
FASTQ parser (fastio.cpp) for the reader.

Each library is built at first use into ``native/build/`` beside this file
(listed in .gitignore) and rebuilt when its source is newer.  A failed
build raises: no caller falls back to a slower path behind it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "build")

_lock = threading.Lock()
_cached: dict = {}


def _build(src_name: str, lib_name: str, force: bool = False) -> str:
    """g++ native/<src_name> -> native/build/<lib_name>; returns the path.
    Raises RuntimeError with the compiler's output if the build fails."""
    src = os.path.join(_HERE, src_name)
    lib = os.path.join(_BUILD_DIR, lib_name)
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {src}:\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never see a torn file
    return lib


def build_sais(force: bool = False) -> str:
    """g++ sais.cpp -> native/build/libbtsais.so; returns the path."""
    return _build("sais.cpp", "libbtsais.so", force)


def build_fastio(force: bool = False) -> str:
    """g++ fastio.cpp -> native/build/libbtfastio.so; returns the path."""
    return _build("fastio.cpp", "libbtfastio.so", force)


def load_sais():
    """The SA-IS library (with stream_extract), built on first use."""
    with _lock:
        if "sais" not in _cached:
            lib = ctypes.CDLL(build_sais())
            lib.sais_bowtie32.restype = ctypes.c_int
            lib.sais_bowtie32.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                          ctypes.c_void_p]
            lib.sais_bowtie.restype = ctypes.c_int
            lib.sais_bowtie.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
            lib.stream_extract.restype = None
            lib.stream_extract.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]
            _cached["sais"] = lib
        return _cached["sais"]


def load_fastio():
    """The FASTQ parser library, built on first use."""
    with _lock:
        if "fastio" not in _cached:
            lib = ctypes.CDLL(build_fastio())
            i64, p = ctypes.c_int64, ctypes.c_void_p
            lib.parse_fastq.restype = i64
            lib.parse_fastq.argtypes = [ctypes.c_char_p, i64, i64] + [p] * 6
            _cached["fastio"] = lib
        return _cached["fastio"]
