"""Batched exact-match search (-v 0): K2 exact search and K3 resolve
(and K3 masked by a valid flag, bwt_rows_offsets), and the walk table
that K3's and K4's walk-left steps read.

Replaces the per-thread recursive path of search_exact.c +
GreedyDFSRangeSource::backtrack (ebwt_search_backtrack.h:237-297) with a
batch: every strand of every read is one lane.

Reads are RIGHT-ALIGNED into a [B, L] uint8 matrix (pad code 4 on the
left): backward search consumes columns L-1 .. L-qlen, so the ftab jump
(last ftabChars characters) reads fixed columns [L-fc, L) for the whole
batch.

Each kernel has a wrapper and a plain version.  The wrapper launches the
CUDA kernel (csrc/exact.cu) on CUDA tensors and takes the plain version
only for CPU tensors; the plain version is torch ops, step for step the
reference's lockstep formulation, and is what the kernel is held to.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..index.arrays import FMIndexArrays, u32
from ..ops.fm import (lf_plain, lf_row_compact_plain, walk_words_needed,
                      words_needed)

MAX_WALK = 1024   # walk-left bound (ok=False past this)
WALK_ROWS = 64    # rows per walk-table entry (csrc/fm.cuh kWalkRows)


def right_align(reads: list[np.ndarray], pad_to: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length code arrays into [B, L] right-aligned (pad=4
    on the left).  Returns (mat, lens)."""
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    L = int(pad_to or (lens.max() if len(lens) else 0))
    mat = np.full((len(reads), L), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        if len(r):
            mat[i, L - len(r):] = r[:L]
    return mat, lens


def exact_ranges_plain(fm: FMIndexArrays, reads: torch.Tensor,
                       lens: torch.Tensor, work: torch.Tensor | None = None):
    """[B, L] right-aligned codes + [B] lens -> (top[B], bot[B]), int64.

    The whole batch in lockstep over the L columns with per-lane
    masking, as bowtie_tpu/align/exact.py:37 scans them.  If `work` is
    given ([2, B] int64), each lane's LF steps (two ranks each, top and
    bot) are added to work[0] and the words those ranks popcount
    (ops.fm.words_needed) to work[1]."""
    B, L = reads.shape
    fc = fm.ftab_chars
    dev = reads.device
    q = reads.long()
    lens = lens.long()
    if L >= fc:
        ftab_codes = q[:, L - fc:]
        ftab_ok = (lens >= fc) & (ftab_codes < 4).all(dim=1)
        weights = 4 ** torch.arange(fc - 1, -1, -1, device=dev)
        foff = (torch.where(ftab_codes < 4, ftab_codes, 0) * weights).sum(1)
        top = torch.where(ftab_ok, u32(fm.ftab_hi[foff]), 0)
        bot = torch.where(ftab_ok, u32(fm.ftab_lo[foff + 1]), fm.bwt_len)
        start = torch.where(ftab_ok, L - fc, L)
    else:
        # every read is shorter than ftabChars: LF from the full range
        top = torch.zeros(B, dtype=torch.int64, device=dev)
        bot = torch.full((B,), fm.bwt_len, dtype=torch.int64, device=dev)
        start = torch.full((B,), L, dtype=torch.int64, device=dev)
    stop = L - lens
    for col in range(L - 1, -1, -1):
        active = (col < start) & (col >= stop) & (bot > top)
        c = q[:, col]
        is_n = c > 3
        cc = torch.where(is_n, 0, c)
        ntop = torch.where(is_n, 0, lf_plain(fm, top, cc))
        nbot = torch.where(is_n, 0, lf_plain(fm, bot, cc))
        top = torch.where(active, ntop, top)
        bot = torch.where(active, nbot, bot)
        if work is not None:
            work[0] += active
            work[1] += active * (words_needed(top) + words_needed(bot))
    ok = bot > top
    return torch.where(ok, top, 0), torch.where(ok, bot, 0)


def exact_ranges(fm: FMIndexArrays, reads: torch.Tensor, lens: torch.Tensor):
    """K2: (top[B], bot[B]) int64 BWT ranges of the right-aligned uint8
    reads [B, L] with int32 lengths [B]; (0, 0) where a read is absent.
    Launches csrc/exact.cu's kernel on CUDA tensors."""
    if kernels.on_cpu(fm, reads, lens):
        return exact_ranges_plain(fm, reads, lens)
    kernels.check(reads, "reads", torch.uint8, 2, fm.device)
    kernels.check(lens, "lens", torch.int32, 1, fm.device)
    n, L = reads.shape
    if lens.shape[0] != n:
        raise ValueError(f"lens has {lens.shape[0]} entries for {n} reads")
    top = torch.empty(n, dtype=torch.int64, device=fm.device)
    bot = torch.empty(n, dtype=torch.int64, device=fm.device)
    if n:
        kernels.launch("exact_ranges", "bt_exact_ranges", kernels.fm_view(fm),
                       reads.data_ptr(), lens.data_ptr(), n, L,
                       top.data_ptr(), bot.data_ptr(), device=fm.device)
    return top, bot


def resolve_rows_plain(fm: FMIndexArrays, rows: torch.Tensor,
                       work: torch.Tensor | None = None):
    """[N] BWT rows -> ([N] joined offsets int64, [N] ok flags).

    With a dense SA (fm.sa) this is one gather.  Otherwise the batch
    walks left in lockstep until each row reaches a marked row or zoff
    (reportChaseOne, ebwt.h:2727-2746), as bowtie_tpu/align/exact.py:99
    does; ok=False past MAX_WALK steps, with the offset computed from
    wherever the walk stopped.  If `work` is given ([2, N] int64), each
    row's walk steps (one rank each) are added to work[0] and the words
    those ranks popcount on the walk table (ops.fm.walk_words_needed) to
    work[1]."""
    rows = rows.long()
    if fm.sa is not None:
        return u32(fm.sa[rows]), torch.ones_like(rows, dtype=torch.bool)
    mask = (1 << fm.off_rate) - 1
    i = rows
    jumps = torch.zeros_like(rows)
    done = torch.zeros_like(rows, dtype=torch.bool)
    for _ in range(MAX_WALK):
        done = done | ((i & mask) == 0) | (i == fm.zoff)
        if bool(done.all()):
            break
        ni = lf_row_compact_plain(fm, torch.where(done, 0, i))
        if work is not None:
            work[1] += torch.where(done, 0, walk_words_needed(i))
        i = torch.where(done, i, ni)
        jumps = torch.where(done, jumps, jumps + 1)
    at_z = i == fm.zoff
    finished = at_z | ((i & mask) == 0)
    off = torch.where(at_z, jumps, u32(fm.offs[i >> fm.off_rate]) + jumps)
    if work is not None:
        work[0] += jumps
    return off, finished


def walk_table_plain(fm: FMIndexArrays) -> torch.Tensor:
    """The walk table (int32 [2 * nblocks, 8]) that the kernels' walk-left
    step reads (csrc/fm.cuh lf_walk): entry e holds the counts of codes
    A, C, G, T in BWT rows [0, 64e), '$' at zoff counted as an A as occ
    counts it, then the BWT words 4e..4e+3, the codes of rows
    [64e, 64e + 64).  It depends on bwt, occ and zoff only."""
    nb = fm.occ.shape[0] - 1
    words = fm.bwt[:8 * nb].view(2 * nb, 4)
    shifts = 2 * torch.arange(16, device=fm.bwt.device)
    codes = (u32(words[0::2])[..., None] >> shifts) & 3   # first 64 rows
    half = torch.stack([(codes == c).sum((1, 2)) for c in range(4)], 1)
    occ = u32(fm.occ[:nb])
    counts = torch.stack([occ, occ + half], 1).view(2 * nb, 4)
    counts = torch.where(counts > 0x7FFFFFFF, counts - (1 << 32), counts)
    return torch.cat([counts.to(torch.int32), words], 1)


def walk_table(fm: FMIndexArrays) -> torch.Tensor:
    """fm's walk table (walk_table_plain), built at first use by
    csrc/exact.cu's walk_table_kernel on the card (the plain version for
    an index on the CPU) and kept as fm.walk."""
    if fm.walk is None or fm.walk.device != fm.device:
        if kernels.on_cpu(fm):
            fm.walk = walk_table_plain(fm)
        else:
            n = 2 * (fm.occ.shape[0] - 1)
            walk = torch.empty((n, 8), dtype=torch.int32, device=fm.device)
            kernels.launch("walk_table", "bt_walk_table", fm.bwt.data_ptr(),
                           fm.occ.data_ptr(), n, walk.data_ptr(),
                           device=fm.device)
            fm.walk = walk
    return fm.walk


def walk_ptr(fm: FMIndexArrays):
    """The walk table's device pointer for a kernel that walks on fm, or
    None where fm has a dense SA (the kernel then gathers)."""
    return None if fm.sa is not None else walk_table(fm).data_ptr()


def walk_shape(n: int) -> dict:
    """K3 walk's launch for n rows (csrc/exact.cu walk_shape): blocks
    sized to the card, threads a block, and the rows of a warp's first
    run (stripe)."""
    out = (ctypes.c_int * 3)()
    rc = kernels.lib().bt_walk_shape(n, out)
    if rc != 0:
        raise RuntimeError(f"bt_walk_shape: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "stripe"), out))


def _resolve(name: str, fm: FMIndexArrays, rows: torch.Tensor,
             iters: torch.Tensor | None = None):
    """Launch K3 on int64 rows [n] (n > 0), counted under `name`: the
    dense-SA gather or the walk, whose warps' iterations go to `iters`
    if given."""
    n = rows.shape[0]
    off = torch.empty(n, dtype=torch.int64, device=fm.device)
    ok = torch.empty(n, dtype=torch.bool, device=fm.device)
    if fm.sa is not None:
        kernels.launch(name, "bt_resolve_sa", kernels.fm_view(fm),
                       rows.data_ptr(), n, off.data_ptr(), ok.data_ptr(),
                       device=fm.device)
    else:
        counter = torch.zeros(1, dtype=torch.int32, device=fm.device)
        kernels.launch(name, "bt_resolve_walk", kernels.fm_view(fm),
                       walk_ptr(fm), rows.data_ptr(), n, counter.data_ptr(),
                       off.data_ptr(), ok.data_ptr(),
                       None if iters is None else iters.data_ptr(),
                       device=fm.device)
    return off, ok


def resolve_rows(fm: FMIndexArrays, rows: torch.Tensor):
    """K3: joined-text offsets (int64) and ok flags (bool) of int64 BWT
    rows [N], through the dense SA when fm has one, else by walking
    left.  Launches csrc/exact.cu's kernel on CUDA tensors."""
    if kernels.on_cpu(fm, rows):
        return resolve_rows_plain(fm, rows)
    kernels.check(rows, "rows", torch.int64, 1, fm.device)
    n = rows.shape[0]
    if not n:
        return (torch.empty(0, dtype=torch.int64, device=fm.device),
                torch.empty(0, dtype=torch.bool, device=fm.device))
    return _resolve("resolve_rows_sa" if fm.sa is not None
                    else "resolve_rows_walk", fm, rows)


def resolve_rows_lanes(fm: FMIndexArrays, rows: torch.Tensor):
    """resolve_rows's walk on the card, with each warp's iterations
    (int32 [warps of walk_shape]): (off, ok, iters).  The rows' walk
    steps over 32 lane slots times the warps' iterations is the warp
    efficiency of its schedule."""
    if fm.sa is not None or kernels.on_cpu(fm, rows):
        raise ValueError("resolve_rows_lanes: the walk kernel on the card "
                         "only")
    kernels.check(rows, "rows", torch.int64, 1, fm.device)
    n = rows.shape[0]
    s = walk_shape(max(n, 1))
    iters = torch.zeros(s["blocks"] * s["threads"] // 32, dtype=torch.int32,
                        device=fm.device)
    if not n:
        return (torch.empty(0, dtype=torch.int64, device=fm.device),
                torch.empty(0, dtype=torch.bool, device=fm.device), iters)
    return (*_resolve("resolve_rows_walk", fm, rows, iters), iters)


def bwt_rows_offsets_plain(fm: FMIndexArrays, rows: torch.Tensor,
                           valid: torch.Tensor):
    """resolve_rows_plain of the rows where `valid`, as
    bowtie_tpu/align/exact.py:142-148 masks it: row 0 is resolved in
    place of an invalid row, whose offset is then 0 and ok False."""
    off, ok = resolve_rows_plain(fm, torch.where(valid, rows.long(), 0))
    return torch.where(valid, off, 0), ok & valid


def bwt_rows_offsets(fm: FMIndexArrays, rows: torch.Tensor,
                     valid: torch.Tensor):
    """K3 masked by `valid` (bool [N]): joined-text offsets (int64) and
    ok flags of the int64 BWT rows [N] where valid, 0 and False
    elsewhere.  Launches K3's kernel of csrc/exact.cu on CUDA tensors,
    counted as its own."""
    if kernels.on_cpu(fm, rows, valid):
        return bwt_rows_offsets_plain(fm, rows, valid)
    kernels.check(rows, "rows", torch.int64, 1, fm.device)
    kernels.check(valid, "valid", torch.bool, 1, fm.device)
    if valid.shape != rows.shape:
        raise ValueError(f"valid has shape {tuple(valid.shape)}, rows "
                         f"{tuple(rows.shape)}")
    masked = torch.where(valid, rows, 0)
    if not rows.shape[0]:
        return masked, valid.clone()
    off, ok = _resolve("bwt_rows_offsets", fm, masked)
    return torch.where(valid, off, 0), ok & valid
