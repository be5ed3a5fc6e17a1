"""ctypes front end of the native FASTQ parser (native/fastio.cpp).

A copy of bowtie_tpu/native/fastq_native.py without the per-base code
matrix (the port's reader derives codes from the sequence).  The library
is built with g++ at first use (native/build.py); a failed build raises.
"""
from __future__ import annotations

import numpy as np

from .build import load_fastio


def parse_fastq_bytes(buf: bytes, batch: int = 1 << 20):
    """All FASTQ records of `buf` as (names, seqs, quals), lists of bytes,
    or None when the parser stops before the end of the buffer (a
    malformed record, or a quality layout it does not read): the caller
    then parses the whole buffer in pure Python, so the read stream is
    never cut short."""
    lib = load_fastio()
    name_off = np.zeros(batch, np.int64)
    name_len = np.zeros(batch, np.int32)
    seq_off = np.zeros(batch, np.int64)
    seq_len = np.zeros(batch, np.int32)
    qual_off = np.zeros(batch, np.int64)
    consumed = np.zeros(1, np.int64)
    names, seqs, quals = [], [], []
    view = buf
    while view:
        n = lib.parse_fastq(view, len(view), batch, name_off.ctypes.data,
                            name_len.ctypes.data, seq_off.ctypes.data,
                            seq_len.ctypes.data, qual_off.ctypes.data,
                            consumed.ctypes.data)
        if n <= 0:
            break
        for no, nl, so, sl, qo in zip(
                name_off[:n].tolist(), name_len[:n].tolist(),
                seq_off[:n].tolist(), seq_len[:n].tolist(),
                qual_off[:n].tolist()):
            names.append(view[no:no + nl])
            seqs.append(view[so:so + sl])
            quals.append(view[qo:qo + sl])
        view = view[int(consumed[0]):]
    if view.strip():
        return None
    return names, seqs, quals
