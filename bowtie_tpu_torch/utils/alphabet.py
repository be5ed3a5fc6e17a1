"""DNA alphabet maps (reference: alphabet.cpp asc2dna / dnacomp tables).

Codes: A=0, C=1, G=2, T=3, N/other=4.  Matches bowtie's 2-bit encoding
(bitpack.h: low bit-pair first within a byte).
"""
from __future__ import annotations

import numpy as np

# char -> 2-bit code (4 = ambiguous). IUPAC ambiguity codes collapse to 4,
# matching asc2dna in alphabet.cpp for the purposes of alignment (bowtie
# randomly resolves IUPAC at *build* time; at search time N-like chars = 4).
ASC2DNA = np.full(256, 4, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    ASC2DNA[ord(ch)] = i
    ASC2DNA[ord(ch.lower())] = i

# code -> char
DNA_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement of a 2-bit code; 4 stays 4
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 code array (A=0,C=1,G=2,T=3,N=4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return ASC2DNA[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII string."""
    return DNA_CHARS[np.minimum(codes, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array."""
    return COMP[codes[::-1]]
