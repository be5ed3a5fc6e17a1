"""Suffix-array construction: SA-IS on the host (native/sais.cpp), or
prefix doubling on the device, one K16 launch a round (csrc/sa.cu).

The reference builds its SA with a blockwise Kärkkäinen scheme
(blockwise_sa.h:183) so the whole SA never resides in memory; here the
whole SA is built at once, by the linear-time native SA-IS, or by
`suffix_array_doubling` on the card (`bowtie-build --jax-sa`; the
bounded-memory route is build/blockwise.py).  Ordering is bowtie's: the
implicit terminal sentinel sorts AFTER every character, so the empty
suffix is the last SA row (Ebwt::restore, ebwt.h:2767).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..native.build import load_sais
from ..utils.device import resolve_device


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


def initial_ranks(codes: np.ndarray) -> tuple[np.ndarray, int]:
    """(r, BIG): the first-character rank of every suffix, int32 [n+1]
    (code + 1; the empty suffix BIG), and BIG = max(n+2, 6), which
    exceeds every rank, so that a suffix shorter than its extension
    sorts after it (bowtie's order)."""
    n = len(codes)
    big = max(n + 2, 6)
    r = np.full(n + 1, big, dtype=np.int32)
    r[:n] = np.asarray(codes, dtype=np.int32) + 1
    return r, big


def sa_round_plain(r: torch.Tensor, k: int, big: int):
    """One prefix-doubling round in plain torch (the function K16
    computes): sort suffixes stably by (r[i], r[i+k]) — r[i+k] is BIG
    when i+k > n — and renumber the groups.  -> (nr int32 [n+1], order
    int32 [n+1], maxg: 0-d int32, the largest new rank)."""
    n1 = r.numel()
    r2 = torch.full_like(r, big)
    if k < n1:
        r2[:n1 - k] = r[k:]
    key = r.long() * (big + 1) + r2.long()
    skey, order = torch.sort(key, stable=True)
    grp = torch.zeros(n1, dtype=torch.int32, device=r.device)
    grp[1:] = torch.cumsum(skey[1:] != skey[:-1], 0)
    nr = torch.empty_like(r)
    nr[order] = grp
    return nr, order.to(torch.int32), grp[-1]


def sa_round(r: torch.Tensor, k: int, big: int):
    """K16 (csrc/sa.cu bt_sa_round): one prefix-doubling round, as
    `sa_round_plain`.  CPU tensors take the plain version; a CUDA tensor
    launches the kernel or raises."""
    if kernels.all_on_cpu(r):
        return sa_round_plain(r, k, big)
    kernels.check(r, "r", torch.int32, 1, r.device)
    n1 = r.numel()
    if not 1 <= n1 < 2**31 - 1 or not n1 + 1 <= big < 2**31:
        raise ValueError(f"sa_round: {n1} ranks with BIG={big}")
    nr = torch.empty_like(r)
    order = torch.empty_like(r)
    maxg = torch.empty((), dtype=torch.int32, device=r.device)
    scratch = torch.empty(kernels.lib().bt_sa_scratch_bytes(n1),
                          dtype=torch.uint8, device=r.device)
    kernels.launch("sa_round", "bt_sa_round", r.data_ptr(), n1,
                   min(k, n1), big, nr.data_ptr(), order.data_ptr(),
                   maxg.data_ptr(), scratch.data_ptr(), device=r.device)
    return nr, order, maxg


def suffix_array_doubling(codes: np.ndarray, device=None) -> np.ndarray:
    """Bowtie-order SA by prefix doubling on `device` (CUDA unless the
    caller asks for the CPU): rounds of `sa_round` with k = 1, 2, 4, ...
    until the n+1 ranks are distinct, reading the largest rank once a
    round.  Equals `suffix_array` element for element; int64 [n+1]."""
    dev = resolve_device(device)
    n = len(codes)
    if n >= 2**31 - 2:
        raise ValueError("suffix_array_doubling supports n < 2**31-2")
    r0, big = initial_ranks(codes)
    r = torch.from_numpy(r0).to(dev)
    k = 1
    while True:
        r, order, maxg = sa_round(r, min(k, n + 1), big)
        if int(maxg) == n:
            return order.cpu().numpy().astype(np.int64)
        k *= 2
