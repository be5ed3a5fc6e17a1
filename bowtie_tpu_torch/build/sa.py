"""Suffix-array construction on the host, by SA-IS (native/sais.cpp).

The reference builds its SA with a blockwise Kärkkäinen scheme
(blockwise_sa.h:183) so the whole SA never resides in memory; here the
whole SA is built at once by the linear-time native SA-IS.  Ordering is
bowtie's: the implicit terminal sentinel sorts AFTER every character,
so the empty suffix is the last SA row (Ebwt::restore, ebwt.h:2767).
"""
from __future__ import annotations

import numpy as np

from ..native.build import load_sais


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Bowtie-order SA of `codes` (uint8 0..3) plus the empty suffix:
    int64 [n+1], last entry n."""
    lib = load_sais()
    n = len(codes)
    c = np.ascontiguousarray(codes, dtype=np.uint8)
    if n < 2**31 - 2:
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sais_bowtie32(c.ctypes.data, n, sa.ctypes.data)
    else:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.sais_bowtie(c.ctypes.data, n, sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"sais failed with code {rc}")
    return sa.astype(np.int64)
