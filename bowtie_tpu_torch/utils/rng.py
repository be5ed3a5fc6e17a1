"""Bowtie's pseudo-random generator and per-read seeds, vectorized.

Bit-exact re-implementation of:
- RandomSource (random_source.h:15-55): LCG a=1664525 c=1013904223;
  nextU32 = step, take high 16 as low bits... precisely:
      last = a*last + c ; ret = last >> 16
      last = a*last + c ; ret ^= last
- genRandSeed (pat.cpp:21-56): per-read seed from sequence codes,
  quality chars, name chars and the global --seed.

Reproducing these exactly is required for output parity: they decide
which row of a BWT range gets reported under -k 1, random tie-breaks in
backtracking, and -M sampling (sam.cpp:270-312).
"""
from __future__ import annotations

import numpy as np

_A = np.uint32(1664525)
_C = np.uint32(1013904223)
_M32 = np.uint64(0xFFFFFFFF)


def next_u32(state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One RandomSource::nextU32 step.  state: uint32 array (or scalar).
    Returns (new_state, value)."""
    with np.errstate(over="ignore"):
        s1 = (_A * state + _C).astype(np.uint32)
        ret = s1 >> np.uint32(16)
        s2 = (_A * s1 + _C).astype(np.uint32)
        return s2, (ret ^ s2).astype(np.uint32)


class BtRandom:
    """Scalar convenience wrapper matching RandomSource usage."""

    def __init__(self, seed: int):
        self.state = np.uint32(seed)

    def next_u32(self) -> int:
        self.state, v = next_u32(self.state)
        return int(v)


def gen_rand_seeds(reads, seed: int) -> np.ndarray:
    """Batched genRandSeed (pat.cpp:21) over a list of ReadRecords —
    one concatenate + bitwise_xor.reduceat per field instead of ~8
    small-array allocations per read (the per-read version costs
    ~29 us; this is ~0.5 us/read, which matters when a device engine
    pushes tens of thousands of reads/s through one host core)."""
    n = len(reads)
    K = np.uint64(59 * 61 * 67 * 71 * 73 * 79 * 83)
    base = np.uint32((np.uint64(seed + 101) * K) & np.uint64(_M32))
    out = np.full(n, base, np.uint32)

    def fold(arrs, mask, sh):
        lens = np.fromiter((len(a) for a in arrs), np.int64, n)
        nz = lens > 0
        if not nz.any():
            return
        cat = np.concatenate([
            np.frombuffer(a, np.uint8) if isinstance(a, (bytes,
                                                         bytearray))
            else np.asarray(a, np.uint8)
            for a, ln in zip(arrs, lens) if ln]).astype(np.uint32)
        lnz = lens[nz]
        starts = np.zeros(len(lnz), np.int64)
        np.cumsum(lnz[:-1], out=starts[1:])
        i = (np.arange(len(cat), dtype=np.int64)
             - np.repeat(starts, lnz)).astype(np.uint32)
        with np.errstate(over="ignore"):
            vals = cat << ((i & mask) << sh)
            out[nz] ^= np.bitwise_xor.reduceat(vals, starts)

    fold([r.codes_fw for r in reads], np.uint32(15), np.uint32(1))
    fold([r.qual for r in reads], np.uint32(3), np.uint32(3))
    fold([r.name for r in reads], np.uint32(3), np.uint32(3))
    return out


def fill_seed_caches(reads, global_seed: int) -> np.ndarray:
    """Compute (or reuse) every read's per-read seed in one batched
    pass, populating ReadRecord._seed_cache so later scalar .seed()
    calls (writers, -M sampling) are free."""
    missing = [r for r in reads
               if r._seed_cache is None or
               r._seed_cache[0] != global_seed]
    if missing:
        for r, s in zip(missing, gen_rand_seeds(missing, global_seed)):
            r._seed_cache = (global_seed, np.uint32(s))
    return np.array([r._seed_cache[1] for r in reads], np.uint32)


def gen_rand_seed(seq_codes: np.ndarray, qual: bytes | np.ndarray,
                  name: bytes | np.ndarray, seed: int) -> np.uint32:
    """Per-read seed (genRandSeed, pat.cpp:21).

    seq_codes: uint8 codes (0..4) of the *forward* read.
    qual/name: ASCII bytes.
    """
    with np.errstate(over="ignore"):
        rseed = np.uint32(np.uint64((seed + 101)) *
                          np.uint64(59 * 61 * 67 * 71 * 73 * 79 * 83) & _M32)
        sc = np.asarray(seq_codes, dtype=np.uint32)
        i = np.arange(len(sc), dtype=np.uint32)
        rseed ^= np.bitwise_xor.reduce(sc << ((i & 15) << 1)) if len(sc) else 0
        q = np.frombuffer(bytes(qual), dtype=np.uint8).astype(np.uint32) \
            if not isinstance(qual, np.ndarray) else qual.astype(np.uint32)
        i = np.arange(len(q), dtype=np.uint32)
        rseed ^= np.bitwise_xor.reduce(q << ((i & 3) << 3)) if len(q) else 0
        nm = np.frombuffer(bytes(name), dtype=np.uint8).astype(np.uint32) \
            if not isinstance(name, np.ndarray) else name.astype(np.uint32)
        i = np.arange(len(nm), dtype=np.uint32)
        rseed ^= np.bitwise_xor.reduce(nm << ((i & 3) << 3)) if len(nm) else 0
        return np.uint32(rseed)
