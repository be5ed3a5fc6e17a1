"""The GreedyDFS machine for -v 1/2 (and the -n launches), on the card.

A port of bowtie_tpu/align/dfs_device.py: bowtie's quality-aware,
randomized, depth-first mismatch search (GreedyDFSRangeSource,
ebwt_search_backtrack.h:23-1787) over the fw and mirror indexes, for a
batch of reads.  Each read is one lane; each lane runs a sequence of
"jobs" (one per search phase and strand, as search_1mm_phase1/2.c and
search_23mm_phase1/2/3.c order them; align/dfs_jobs.py builds them).

Kernels, each with a wrapper that launches it on CUDA tensors and runs its
plain PyTorch version (in this module) on CPU tensors:

  K6 derive_rows  <- dfs_device.py:496 derive_rows_jit (:412
                     _derive_rows_impl): the by-depth query/qual/penalty
                     rows and the N-tally gates of every (lane, job), a
                     warp per row (csrc/jobs.cu)
  K7 run_machine  <- dfs_device.py:1484 run_machine, :1812 run_chunk
                     (:1445 _machine_step): the state machine; K5
                     (:261 _rank4, :303 _lf4pair) is inlined in it as
                     csrc/fm.cuh rank4 / lf4pair
  K8 pack_hits    <- dfs_device.py:1874 _gather_rows, :1927
                     _fuse_parts_jit, :1954 _pack_all, :2011
                     decode_hit_cols's hit gather: the per-lane hit and
                     partial rows packed densely for one download, in one
                     launch and one host sync

The CUDA kernel of K7 runs one thread per lane through that lane's
transitions to M_DONE, one warp a block (machine_shape), the lane's
state in registers and shared memory; a pass of its loop applies the
lane's transitions in a fixed order of modes (csrc/dfs.cu).  Its plain
version is the lockstep translation of _machine_step (RETF, JOB, ADV
x3, POP, REP, BR per iteration, the same gates), held array for array
to the JAX run_machine, iteration count included.  A lane's sequence of transitions depends only on its own
state, so both reach the same per-lane result.

Modes of the per-lane state machine:
  DONE  lane finished (read fully resolved or flagged for host re-run)
  JOB   load next job; top-level backtrack() entry incl. ftab jump
        (ebwt_search_backtrack.h:237-297)
  ADV   consume one position: quartet LF, elims/eligibility updates,
        cur==0 / half-and-half checks (:363-741)
  BR    branch-loop head: condition check, mismatch pick (RNG), frame
        push (:743-982)
  POP   post-child bookkeeping: eliminate tried edge, eligibility
        rescan (:984-1058)
  REP   one row chase of a report: SA resolve (dense, or one walk-left
        step) + joinedToTextOff + sink policy (reportFullAlignment
        :1521; reportChaseOne ebwt.h:2693; hit.h:937-992)
  RETF  deferred frame pop after a frame returned False

Frames: the JAX version keeps the current frame's pairs/elims rows in
registers and copies the whole frame to the stack at a push.  Here each
stack level has its own [L, 8] pairs and [L] elims slice, and the current
frame is level sd.  A frame reads only positions >= its own depth, which
it wrote itself, so a push copies only the 28 frame registers (REGS).

Lanes that exceed a fixed bound (stack depth S_MAX, H_MAX hits, P_MAX
partials, MM_SLOTS mismatches, the step budget) raise `overflow` and are
re-run on the host oracle (align/drivers.py OracleAligner); the per-read
RNG makes that re-run bit-identical.

Step budget: the plain version, like the JAX one, stops after max_steps
lockstep iterations.  An iteration applies at most 8 transitions to a
lane, so the CUDA kernel gives each lane 8 * max_steps transitions: a
lane that the lockstep version finishes within budget also finishes in
the kernel.  A lane that only the lockstep version flags (by budget) and
the kernel completes gets the machine's answer from the kernel and the
oracle's from the plain version; the two agree, so the CLI's bytes do.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..index.arrays import (OCC_BLOCK, FMIndexArrays, U32, from_ebwt,
                            from_jax_arrays, u32)
from ..index.ebwt_io import EbwtIndex
from ..ops.fm import lf4pair_plain, lf_row_compact_plain, words_needed
from ..utils.device import resolve_device
from ..utils.rng import fill_seed_caches
from .pipeline import ExactAligner
from .types import Hit

# state-machine modes
M_DONE, M_JOB, M_ADV, M_BR, M_POP, M_REP, M_RETF = 0, 1, 2, 3, 4, 5, 6

INF32 = 0x7FFFFFFF          # stand-in for the oracle's 0xFFFFFFFF

# resource bounds (per lane); overflow -> host-oracle re-run
S_MAX = 6                   # stack frames (mismatch depth)
H_MAX = 8                   # buffered hit slots
MM_SLOTS = 8                # mismatch slots per stored hit
P_MAX = 32                  # partial-alignment slots (-n phases 2/3)
HIT_W = 8 + 2 * MM_SLOTS    # hit record width
PART_W = 8                  # fused partial record: n, job, pos[3], refc[3]

_LCG_A = 1664525
_LCG_C = 1013904223

# lanes re-run on the host oracle by any DeviceDFSAligner since the
# caller last set it to 0 (the one count of them, read as
# kernels.LAUNCHES is: the CLI builds its aligner inside main())
FALLBACKS = {"lanes": 0}


# ---------------------------------------------------------------------------
# The fw + mirror index pair (the counterpart of FMCat, dfs_device.py:121)
# ---------------------------------------------------------------------------

@dataclass
class FMPair:
    """The fw and mirror indexes on one device, each an FMIndexArrays
    (dense SA when `dense`, else the sampled SA and walk-left), plus the
    fragment table of the joined text (rstarts: [nfrag, 3] int64 rows of
    start, tidx, toff)."""
    fw: FMIndexArrays
    bw: FMIndexArrays
    rstarts: torch.Tensor
    length: int
    dense: bool

    @property
    def device(self) -> torch.device:
        return self.fw.device

    @property
    def nfrag(self) -> int:
        return self.rstarts.shape[0]

    @property
    def ftab_chars(self) -> int:
        return self.fw.ftab_chars


def build_fmpair(idx_fw: EbwtIndex, idx_bw: EbwtIndex, device=None,
                 dense_sa: bool = True) -> FMPair:
    """Both indexes on `device` (default CUDA), with dense SAs or the
    sampled SA for walk-left (build_fmcat, dfs_device.py:170)."""
    dev = resolve_device(device)
    if idx_fw.length >= (1 << 32) - 2:
        raise ValueError(f"the machine carries rows as uint32; length "
                         f"{idx_fw.length:,} needs the large index")
    rs = torch.from_numpy(np.asarray(idx_fw.rstarts, np.int64)).to(dev)
    return FMPair(fw=from_ebwt(idx_fw, dev, dense_sa=dense_sa),
                  bw=from_ebwt(idx_bw, dev, dense_sa=dense_sa),
                  rstarts=rs, length=int(idx_fw.length), dense=dense_sa)


def pair_from_jax(cat: dict, meta: dict, device=None) -> FMPair:
    """The reference package's FMCat (its fields as numpy arrays, keyed
    by name; `meta` holds ftab_chars, off_rate, occ_every and dense) ->
    the port's FMPair, so one index pair can feed both packages.  FMCat
    concatenates the two indexes; the bases it keeps split them again."""
    if meta["occ_every"] != 128:
        raise ValueError("only the 128-row checkpoint layout is ported")
    occ_b = int(np.asarray(cat["occ_base"])[1])
    sa_b = int(np.asarray(cat["sa_base"])[1])
    ft_b = int(np.asarray(cat["ftab_base"])[1])
    words = np.asarray(cat["bwt"]).reshape(-1)
    blk_b = int(np.asarray(cat["blk_base"])[1])
    zoff = np.asarray(cat["zoff"])
    sa = np.asarray(cat["sa"]).astype(np.int64) & U32
    dense = bool(meta["dense"])
    bwt_len = int(np.asarray(cat["bwt_len"]).astype(np.int64) & U32)

    def half(k: int, lo: slice, sa_part: np.ndarray) -> FMIndexArrays:
        d = {"bwt": words[lo], "occ": np.asarray(cat["occ"])[
                 slice(0, occ_b) if k == 0 else slice(occ_b, None)],
             "fchr": cat["fchr"], "zoff": zoff[k], "bwt_len": bwt_len,
             "ftab_hi": np.asarray(cat["ftab_hi"])[
                 slice(0, ft_b) if k == 0 else slice(ft_b, None)],
             "ftab_lo": np.asarray(cat["ftab_lo"])[
                 slice(0, ft_b) if k == 0 else slice(ft_b, None)]}
        if dense:
            d["sa"] = sa_part
            d["offs"] = sa_part[::1 << meta["off_rate"]]
        else:
            d["offs"] = sa_part
        return from_jax_arrays(d, meta, device)

    fw = half(0, slice(0, blk_b * 8), sa[:sa_b])
    bw = half(1, slice(blk_b * 8, None), sa[sa_b:])
    rs = np.stack([np.asarray(cat[k]).astype(np.int64) & U32 for k in
                   ("rstarts_start", "rstarts_tidx", "rstarts_toff")], 1)
    return FMPair(fw=fw, bw=bw, rstarts=torch.from_numpy(rs).to(fw.device),
                  length=int(np.asarray(cat["length"]).astype(np.int64)
                             & U32), dense=dense)


# ---------------------------------------------------------------------------
# Job descriptors
# ---------------------------------------------------------------------------

JOB_FIELDS = [
    # int32 per (lane, job)
    "valid",          # 1 if this job exists for the lane
    "qlen",           # search query length (after set_qlen)
    "ebwt_fw",        # 1 = forward index, 0 = mirror
    "fw",             # strand flag for reporting
    "d5", "d3", "unrev", "rev1", "rev2", "rev3",   # setOffs
    "ham0",           # entry ham (partial-extension prior cost)
    "report_exacts",  # bool
    "report_partials",  # 0 or seedMms
    "half_and_half",  # bool
    "max_bts",        # backtrack ceiling (INF32 = none)
    "consider_quals",  # bool
    "qual_thresh",    # -e budget (INF32 for -v modes)
    "reset_rng",      # 1: rng <- read seed at job load
    "ns_gate",        # 1: backtrack() returns False immediately (N tally)
    "ns_ftab",        # count of Ns in the first ftabChars depths
    "maq_round",      # Maq penalty rounding for derived pend rows
    "npremut",        # seed-stage mutations already applied (phase 3/4)
    "premut_pos0", "premut_pos1", "premut_pos2",
    "premut_refc0", "premut_refc1", "premut_refc2",
    "collect_partials",  # 1: partials go to the lane partial buffer
]
NJF = len(JOB_FIELDS)
_FIDX = {f: i for i, f in enumerate(JOB_FIELDS)}


def _check_layout() -> None:
    """Raise unless csrc/dfs_layout.cuh lays out as many job fields as
    JOB_FIELDS (the kernels index scal rows by NJF)."""
    if kernels.lib().bt_dfs_njf() != NJF:
        raise RuntimeError("csrc/dfs_layout.cuh and align/dfs_device.py "
                           "disagree on the job fields")


def _len_bucket(n: int, buckets=(40, 64, 128, 256, 512, 1024, 2048,
                                 4096)) -> int:
    """Row width L for reads of at most n bases (the reference caps
    reported mismatch masks at 1024 positions, hit.h:66, but still
    processes longer reads)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"read length {n} unsupported")


# ---------------------------------------------------------------------------
# K6: by-depth rows and N gates
# ---------------------------------------------------------------------------

def derive_rows_plain(scal: torch.Tensor, base_codes: torch.Tensor,
                      base_qual: torch.Tensor, base_plen: torch.Tensor,
                      fc: int):
    """set_query semantics for every (lane, job), as
    bowtie_tpu/align/dfs_device.py:412 _derive_rows_impl computes them:
    the by-depth row is a reversed and/or shifted take of the base read
    (dfs_jobs.py identities), complemented for fw == 0, with the seed
    mutations substituted; quals Maq-rounded into penalties; the N tally
    (_tally_ns, ebwt_search_backtrack.h:1306-1343) gives ns_gate and
    ns_ftab.  scal int32 [B, J, NJF], base_codes/base_qual int8 [B, L],
    base_plen int32 [B] -> (scal with the gates, qqp int8 [B, J, 3L])."""
    B, J, _ = scal.shape
    L = base_codes.shape[1]
    dev = scal.device
    s2 = scal.reshape(B * J, NJF).long()

    def f(name):
        return s2[:, _FIDX[name]][:, None]

    plen = base_plen.long().repeat_interleave(J)[:, None]
    qs = f("qlen")
    di = torch.arange(L, device=dev)[None, :]
    rev = f("fw") == f("ebwt_fw")
    take = torch.where(rev, qs - 1 - di, plen - qs + di) % L
    codes = base_codes.long().repeat_interleave(J, 0).gather(1, take)
    qv = base_qual.long().repeat_interleave(J, 0).gather(1, take)
    in_q = di < qs
    qd = torch.where((f("fw") == 0) & (codes < 4), 3 - codes, codes)
    qd = torch.where(in_q, qd, 4)
    qv = torch.where(in_q, qv, 0)
    for k in range(3):
        at = (di == qs - 1 - f(f"premut_pos{k}")) & (f("npremut") > k)
        qd = torch.where(at, f(f"premut_refc{k}"), qd)
    pend = torch.where(f("maq_round") > 0,
                       torch.clamp(((qv + 5) // 10) * 10, max=30), qv)
    isn = (qd == 4) & in_q & (di < f("rev3"))
    nsc = torch.cumsum(isn.long(), dim=1)

    def kth(k):
        at = isn & (nsc == k)
        return at.any(dim=1), at.long().argmax(dim=1)

    (h1, p1), (h2, p2), (h3, p3) = kth(1), kth(2), kth(3)
    gate = ((h1 & (p1 < f("unrev")[:, 0])) | (h2 & (p2 < f("rev1")[:, 0]))
            | (h3 & (p3 < f("rev2")[:, 0])) | (nsc[:, -1] > 3))
    ns_ftab = ((qd[:, :fc] == 4) & in_q[:, :fc]).sum(dim=1)
    out = scal.reshape(B * J, NJF).clone()
    out[:, _FIDX["ns_gate"]] = gate.int()
    out[:, _FIDX["ns_ftab"]] = ns_ftab.int()
    qqp = torch.cat([qd, qv.clamp(0, 127), pend.clamp(0, 127)], dim=1)
    return out.reshape(B, J, NJF), qqp.to(torch.int8).reshape(B, J, 3 * L)


# K6's launch shape (csrc/jobs.cu kRowWarps, kRowsPerWarp): a warp a
# (lane, job) row, ROWS_A_WARP consecutive rows in turn, ROW_WARPS warps a
# block.  (Four rows a warp were 8 % faster than one on launch B's table
# and equal elsewhere: PERF.md, K6's run B.)
ROW_WARPS = 8
ROWS_A_WARP = 4


def derive_rows_shape(B: int, J: int) -> dict:
    """K6's launch for a [B, J] job table, as csrc/jobs.cu bt_derive_rows
    makes it: threads a block, rows a warp, rows a block and blocks."""
    rows = B * J
    if B < 0 or J < 0 or rows >= 1 << 40:
        raise ValueError(f"K6 takes no table of {B} x {J} rows")
    per = ROW_WARPS * ROWS_A_WARP
    return dict(threads=ROW_WARPS * 32, rows_a_warp=ROWS_A_WARP,
                rows_a_block=per, blocks=-(-rows // per))


@functools.cache
def _check_rows_shape(so) -> None:
    """Raise unless the library `so`'s K6 launches the shape
    derive_rows_shape describes (once a library)."""
    if (so.bt_jobs_row_warps() != ROW_WARPS
            or so.bt_jobs_rows_per_warp() != ROWS_A_WARP):
        raise RuntimeError("csrc/jobs.cu and align/dfs_device.py disagree "
                           "on K6's launch shape")


def jobs_local_bytes() -> dict:
    """The local memory (stack) per thread of csrc/jobs.cu's K6 and K9
    (cudaFuncGetAttributes)."""
    so = kernels.lib()
    return {"derive_rows": so.bt_jobs_local_bytes(0),
            "derive_b_jobs": so.bt_jobs_local_bytes(1)}


def derive_rows(scal: torch.Tensor, base_codes: torch.Tensor,
                base_qual: torch.Tensor, base_plen: torch.Tensor, fc: int):
    """K6: (scal with ns_gate/ns_ftab filled, qqp int8 [B, J, 3L]) from
    the job table and the base read arrays.  Launches csrc/jobs.cu's
    derive_rows_kernel on CUDA tensors, a warp per (lane, job) row
    (derive_rows_shape)."""
    dev = scal.device
    if kernels.all_on_cpu(scal, base_codes, base_qual, base_plen):
        return derive_rows_plain(scal, base_codes, base_qual, base_plen, fc)
    kernels.check(scal, "scal", torch.int32, 3, dev)
    kernels.check(base_codes, "base_codes", torch.int8, 2, dev)
    kernels.check(base_qual, "base_qual", torch.int8, 2, dev)
    kernels.check(base_plen, "base_plen", torch.int32, 1, dev)
    B, J, nf = scal.shape
    L = base_codes.shape[1]
    if (nf != NJF or base_qual.shape != base_codes.shape
            or base_codes.shape[0] != B or base_plen.shape[0] != B):
        raise ValueError("scal, base_codes, base_qual and base_plen "
                         "disagree on their shapes")
    derive_rows_shape(B, J)
    out = torch.empty_like(scal)
    qqp = torch.empty((B, J, 3 * L), dtype=torch.int8, device=dev)
    if B * J:
        _check_layout()
        _check_rows_shape(kernels.lib())
        kernels.launch("derive_rows", "bt_derive_rows", scal.data_ptr(),
                       base_codes.data_ptr(), base_qual.data_ptr(),
                       base_plen.data_ptr(), B, J, L, fc, out.data_ptr(),
                       qqp.data_ptr(), device=dev)
    return out, qqp


def upload_jobs(jobs_np: dict, fc: int, device) -> dict:
    """A host job table (per-field [B, J] int32 arrays plus base_codes,
    base_qual, base_plen, as align/dfs_jobs.py builds it and as the
    reference's upload_jobs takes it) -> {"scal", "qqp"} on `device`,
    the rows derived there by K6."""
    dev = torch.device(device)
    scal = np.stack([jobs_np[f] for f in JOB_FIELDS], axis=-1)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
         (("scal", scal.astype(np.int32)),
          ("codes", np.asarray(jobs_np["base_codes"], np.int8)),
          ("qual", np.asarray(jobs_np["base_qual"], np.int8)),
          ("plen", np.asarray(jobs_np["base_plen"], np.int32)))}
    scal_d, qqp = derive_rows(t["scal"], t["codes"], t["qual"], t["plen"],
                              fc)
    return {"scal": scal_d, "qqp": qqp}


# ---------------------------------------------------------------------------
# K7 plain: the lockstep machine on [B] tensors
# ---------------------------------------------------------------------------

# frame registers saved/restored across push/pop, in stack-slot order
REGS = ("depth", "unrev", "rev1", "rev2", "rev3", "ham", "d", "top",
        "bot", "alt", "elnum", "elsz", "eli", "eltop", "elbot",
        "elham", "elcint", "elignore", "lowq", "btdm", "mustbt",
        "invhh", "invex", "reppart", "dftab", "bi", "bj", "bspread")
NREG = len(REGS)

OUT_KEYS = ("result", "overflow", "count", "nhits", "hits", "npart",
            "part_n", "part_job", "part_pos", "part_refc", "rng", "mode")

# what a run reads, counted as distinct items into `work` (for bounds):
# occ checkpoints and bwt blocks (128 rows each) that ranks and walk
# steps need, SA entries (dense SA, or the sampled offs) that resolves
# load and ftab offsets (a hi and a lo word each) that job entries and
# mid-recursion lookups read, all per index; job field rows loaded and
# by-depth rows read, per lane and job
TOUCHED = ("occ_entries", "bwt_blocks", "sa_entries", "ftab_entries",
           "job_fields", "job_rows")

# the job fields each JOB step loads into a lane register
_JOB_REGS = (("qlen", "qlen"), ("ebwt_fw", "ebwt_fw"), ("fwflag", "fw"),
             ("jd5", "d5"), ("jd3", "d3"), ("jrev2", "rev2"),
             ("jrev3", "rev3"), ("rep_exacts", "report_exacts"),
             ("rep_partials", "report_partials"),
             ("hh", "half_and_half"), ("maxbts", "max_bts"),
             ("cons_quals", "consider_quals"), ("qthresh", "qual_thresh"),
             ("npremut", "npremut"), ("collect", "collect_partials"))


def _rng_next(state):
    """RandomSource::nextU32 (random_source.h:36-42) on uint32 values
    held in int64: (new state, value)."""
    s1 = (_LCG_A * state + _LCG_C) & U32
    s2 = (_LCG_A * s1 + _LCG_C) & U32
    return s2, (s1 >> 16) ^ s2


def _g(a, i):
    """a[b, i[b]] for a [B, N] tensor and [B] indices."""
    return a.gather(1, i[:, None])[:, 0]


class _Plain:
    """The state of one plain run (st: name -> [B, ...] int64 tensors,
    bool for overflow/bailed) and the sub-steps of _machine_step, each a
    masked update of every lane in its mode, transcribed from
    bowtie_tpu/align/dfs_device.py:599-1476.  Rows are uint32 values in
    int64; pairs/elims live in a [B, S_MAX, L, ...] stack indexed by sd."""

    def __init__(self, pair: FMPair, jobs: dict, seeds, count0, n_k: int,
                 m_max: int, work: dict | None = None):
        self.pair, self.n_k, self.m_max = pair, n_k, m_max
        self.work = work
        self.touched = {k: [] for k in TOUCHED}
        self.scal = jobs["scal"].long()
        self.qqp_r = jobs["qqp"].long()
        B, self.J, _ = self.scal.shape
        L = self.L = self.qqp_r.shape[2] // 3
        dev = self.dev = self.scal.device
        self.ar = torch.arange(B, device=dev)
        self.fchr = pair.fw.fchr
        z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)  # noqa
        st = dict(
            mode=torch.full((B,), M_JOB, dtype=torch.int64, device=dev),
            job=z(B), result=z(B),
            overflow=torch.zeros(B, dtype=torch.bool, device=dev),
            rng=seeds.long() & U32, seed=seeds.long() & U32,
            count=count0.long(), qqp=z(B, 3 * L),
            premut_pos=z(B, 3), premut_refc=z(B, 3),
            num_bts=z(B),
            bailed=torch.zeros(B, dtype=torch.bool, device=dev),
            pairs=z(B, S_MAX, L, 8), elims=z(B, S_MAX, L),
            stk=z(B, S_MAX, NREG), sd=z(B),
            mms=z(B, S_MAX), refcs=z(B, S_MAX), mmd=z(B, S_MAX),
            nhits=z(B), hits=z(B, H_MAX, HIT_W),
            npart=z(B), part_n=z(B, P_MAX), part_job=z(B, P_MAX),
            part_pos=z(B, P_MAX, 3), part_refc=z(B, P_MAX, 3))
        for r, _f in _JOB_REGS:
            st[r] = z(B)
        for r in ("r_top", "r_bot", "r_sd", "r_ham", "r_stratum", "r_k",
                  "r_r", "r_resume", "r_row", "r_jumps", "r_walk"):
            st[r] = z(B)
        for r in REGS:
            st["c_" + r] = z(B)
        self.st = st

    # -- helpers ----------------------------------------------------------
    def w(self, name, mask, val):
        self.st[name] = torch.where(mask, val, self.st[name])

    def efw(self):
        return self.st["ebwt_fw"] > 0

    def touch(self, kind, items, mask, per_index=True):
        """Record the items of array `kind` the lanes in `mask` read
        (each lane's own index unless per_index is False), when counting
        work."""
        if self.work is not None:
            key = items * 2 + self.efw().long() if per_index else items
            self.touched[kind].append(key[mask])

    def by_index(self, fn):
        """fn(fm) evaluated on both indexes, each lane taking its own."""
        a, b = fn(self.pair.fw), fn(self.pair.bw)
        e = self.efw()
        return torch.where(e.view(-1, *([1] * (a.dim() - 1))), a, b)

    def ret_false(self, mask):
        """A frame returns False (dfs_device.py:678 _ret_false)."""
        st = self.st
        job_fail = mask & ((st["sd"] == 0) | st["bailed"])
        pop = mask & ~job_fail
        self.w("mode", job_fail, M_JOB)
        self.w("job", job_fail, st["job"] + 1)
        self.w("mode", pop, M_RETF)

    def init_regs(self, mask, depth, unrev, rev1, rev2, rev3, ham, top, bot,
                  dftab):
        """Frame entry (:703 _init_regs)."""
        st = self.st
        zer = torch.zeros_like(depth)
        vals = dict(depth=depth, unrev=unrev, rev1=rev1, rev2=rev2,
                    rev3=rev3, ham=ham, d=depth, top=top, bot=bot,
                    elham=ham, elignore=zer + 1, lowq=zer + 0xFF,
                    dftab=dftab)
        for r in REGS:
            self.w("c_" + r, mask, vals.get(r, zer))
        hh = st["hh"] > 0
        bail = mask & hh & (st["maxbts"] > 0) & (st["num_bts"] ==
                                                 st["maxbts"])
        self.w("num_bts", mask & hh & ~bail, st["num_bts"] + 1)
        st["bailed"] = st["bailed"] | bail
        self.w("mode", mask & ~bail, M_ADV)
        self.ret_false(bail)

    def store_partial(self, mask, n):
        """_report_partial (:781 _store_partial)."""
        st = self.st
        over = mask & ((st["npart"] >= P_MAX) | (n > 3))
        st["overflow"] = st["overflow"] | over
        self.w("mode", over, M_DONE)
        ok = (mask & ~over).nonzero()[:, 0]
        if ok.numel():
            slot = st["npart"][ok]
            st["part_n"][ok, slot] = n[ok]
            st["part_job"][ok, slot] = st["job"][ok]
            st["part_pos"][ok, slot] = st["mms"][ok, :3]
            st["part_refc"][ok, slot] = st["refcs"][ok, :3]
            st["npart"][ok] += 1

    def enter_report(self, mask, sd_r, top, bot, ham, resume):
        """reportFullAlignment entry (:735 _enter_report)."""
        st = self.st
        pmask = mask & (st["rep_partials"] > 0)
        self.store_partial(pmask & (sd_r > 0), sd_r)
        self.w("r_resume", pmask, resume)
        self.report_fail(pmask)
        mask = mask & ~pmask
        ii = torch.arange(S_MAX, device=self.dev)[None, :]
        in_seed = (ii < sd_r[:, None]) & (st["mmd"] < st["jrev3"][:, None])
        stratum = in_seed.sum(1) + st["npremut"]
        spread = (bot - top) & U32
        rng, v = _rng_next(st["rng"])
        self.w("rng", mask, rng)
        r = (top + v % spread.clamp(min=1)) & U32
        zer = torch.zeros_like(top)
        for name, val in (("r_top", top), ("r_bot", bot), ("r_sd", sd_r),
                          ("r_ham", ham), ("r_stratum", stratum),
                          ("r_k", zer), ("r_r", r), ("r_resume", resume),
                          ("r_walk", zer)):
            self.w(name, mask, val)
        self.w("mode", mask, M_REP)

    def report_fail(self, mask):
        """The row loop ended without a sink stop (:768 _report_fail)."""
        st = self.st
        res = st["r_resume"]
        r0, r1, r2 = mask & (res == 0), mask & (res == 1), mask & (res == 2)
        self.w("c_top", r0, st["c_bot"])
        self.w("mode", r0, M_BR)
        self.w("mode", r1, M_POP)
        self.ret_false(r2)

    # -- sub-steps --------------------------------------------------------
    def step_retf(self):
        """Deferred frame pop (:693 _step_retf)."""
        st = self.st
        m = st["mode"] == M_RETF
        self.w("sd", m, st["sd"] - 1)
        rec = st["stk"][self.ar, st["sd"]]
        for k, r in enumerate(REGS):
            self.w("c_" + r, m, rec[:, k])
        self.w("mode", m, M_POP)

    def step_job(self):
        """Top-level backtrack() entry (:922 _step_job)."""
        st, J, fc = self.st, self.J, self.pair.ftab_chars
        m = st["mode"] == M_JOB
        jidx = st["job"].clamp(max=J - 1)
        vals = self.scal[self.ar, jidx]

        def jf(name):
            return vals[:, _FIDX[name]]

        valid = (jf("valid") > 0) & (st["job"] < J)
        self.w("mode", m & ~valid, M_DONE)
        m = m & valid
        self.touch("job_fields", self.ar * J + jidx, m, per_index=False)
        for reg, f in _JOB_REGS:
            self.w(reg, m, jf(f))
        for reg, f in (("premut_pos", "premut_pos"),
                       ("premut_refc", "premut_refc")):
            v = torch.stack([jf(f"{f}{k}") for k in range(3)], 1)
            self.w(reg, m[:, None], v)
        self.w("rng", m & (jf("reset_rng") > 0), st["seed"])
        self.w("num_bts", m, 0)
        st["bailed"] = torch.where(m, False, st["bailed"])
        self.w("sd", m, 0)
        rows = self.qqp_r[self.ar, jidx]
        self.w("qqp", m[:, None], rows)
        gate = m & (jf("ns_gate") > 0)
        self.w("mode", gate, M_JOB)
        self.w("job", gate, st["job"] + 1)
        m = m & ~gate
        self.touch("job_rows", self.ar * J + jidx, m, per_index=False)

        qlen, unrev, ns_ftab, ham0 = (jf("qlen"), jf("unrev"), jf("ns_ftab"),
                                      jf("ham0"))
        use_ftab = (ns_ftab == 0) & (torch.minimum(unrev, qlen) >= fc)
        qd_fc = rows[:, :fc]
        qf = torch.where(qd_fc > 3, 0, qd_fc)
        foff = (qf << (2 * torch.arange(fc, device=self.dev))).sum(1)
        ft = self.by_index(lambda fm: u32(fm.ftab_hi[foff]))
        fb = self.by_index(lambda fm: u32(fm.ftab_lo[foff + 1]))
        self.touch("ftab_entries", foff, m & use_ftab)
        z = torch.zeros_like(qlen)
        ok = ft < fb
        rp = jf("report_partials")
        rep_now = m & use_ftab & (qlen == fc) & ok & (rp == 0)
        self.enter_report(rep_now, z, ft, fb, ham0, z + 2)
        ent0p = m & use_ftab & (qlen == fc) & ok & (rp > 0)
        entf = m & use_ftab & (qlen > fc) & ok
        cfail = m & use_ftab & ~ok
        self.w("mode", cfail, M_JOB)
        self.w("job", cfail, st["job"] + 1)
        ent0 = m & ~use_ftab
        offs = (unrev, jf("rev1"), jf("rev2"), jf("rev3"))
        self.init_regs(entf, z + fc, *offs, ham0, ft, fb, z)
        dftab = torch.where(ent0, (ns_ftab > 0).long(), 0)
        self.init_regs(ent0 | ent0p, z, *offs, ham0, z, z, dftab)

    def branch_exit(self, mask):
        """Fall-through after the branch loop (:1025 _branch_exit)."""
        st = self.st
        top, bot, alt, d = st["c_top"], st["c_bot"], st["c_alt"], st["c_d"]
        fail = mask & ((st["c_mustbt"] > 0) | (st["c_invhh"] > 0)
                       | (st["c_invex"] > 0) | ((top == bot) & (alt == 0)))
        self.ret_false(fail)
        cont = mask & ~fail
        consumed = cont & (d + 1 > st["qlen"] - 1)
        adv = cont & ~consumed
        self.w("c_d", adv, d + 1)
        self.w("mode", adv, M_ADV)
        rep = consumed & (st["sd"] >= st["rep_partials"])
        self.enter_report(rep, st["sd"], top, bot, st["c_ham"],
                          torch.full_like(top, 2))
        self.ret_false(consumed & ~rep)

    def step_adv(self):
        """Consume one position (:1050 _step_adv)."""
        st, L = self.st, self.L
        m = st["mode"] == M_ADV
        d, sd, qlen = st["c_d"], st["sd"], st["qlen"]
        hh = st["hh"] > 0
        ii = torch.arange(S_MAX, device=self.dev)[None, :]
        mm_mask = ii < sd[:, None]
        mmd, jd5, jd3 = st["mmd"], st["jd5"][:, None], st["jd3"][:, None]
        hi_n = (mm_mask & (mmd < jd5)).sum(1)
        lo_n = (mm_mask & (mmd >= jd5) & (mmd < jd3)).sum(1)
        req = st["jrev2"] == st["jrev3"]
        fail5 = (d == st["jd5"]) & torch.where(req, sd == 0, sd < 1)
        fail3 = (d == st["jd3"]) & torch.where(req, sd < 2, lo_n == 0)
        hh_fail = m & hh & (fail5 | fail3)
        self.ret_false(hh_fail)
        m = m & ~hh_fail

        dc = d.clamp(0, L - 1)
        qqp = st["qqp"]
        c, q, pen = _g(qqp, dc), _g(qqp, dc + L), _g(qqp, dc + 2 * L)
        unrev, ham, lowq = st["c_unrev"], st["c_ham"], st["c_lowq"]
        top, bot = st["c_top"], st["c_bot"]
        cq = st["cons_quals"] > 0
        cur_is_alt = (d >= unrev) & (~cq | (ham + pen <= st["qthresh"]))
        cur_is_eligible = cur_is_alt & torch.where(cq, q <= lowq, True)
        cur_overrides = cur_is_alt & cq & (q < lowq)

        pt, pb = top, bot
        nhack = (c == 4) & (d > 0)
        top = torch.where(nhack, 1, top)
        bot = torch.where(nhack, 1, bot)
        zero_case = (top == 0) & (bot == 0)
        lf4t, lf4b = self.by_index(lambda fm: torch.stack(lf4pair_plain(
            fm, torch.where(m, pt, 0), torch.where(m, pb, 0)), 1)).unbind(1)
        zc = zero_case[:, None]
        row_t = torch.where(zc, self.fchr[None, 0:4], lf4t)
        row_b = torch.where(zc, self.fchr[None, 1:5], lf4b)
        wp = (m & (zero_case | cur_is_alt)).nonzero()[:, 0]
        if wp.numel():
            st["pairs"][wp, sd[wp], d[wp]] = torch.cat([row_t, row_b],
                                                       1)[wp]
        cK = c.clamp(0, 3)
        is_n = c > 3
        if self.work is not None:
            self.count_ranks(m & ~zero_case & (cur_is_alt | ~is_n),
                             cur_is_alt, pt, pb)
        top = torch.where(m & ~is_n, _g(row_t, cK), top)
        bot = torch.where(m & ~is_n, _g(row_b, cK), bot)

        spreads = row_b - row_t
        jar = torch.arange(4, device=self.dev)[None, :]
        elim0 = torch.where(is_n, 0, 1 << cK)
        zero_elim = torch.where(cur_is_alt[:, None] & (jar != c[:, None])
                                & (spreads == 0), 1 << jar, 0).sum(1)
        wm = m.nonzero()[:, 0]
        if wm.numel():
            st["elims"][wm, sd[wm], d[wm]] = (elim0 | zero_elim)[wm]
        live = (jar != c[:, None]) & (spreads != 0)
        nlive = live.sum(1)
        szlive = torch.where(live, spreads, 0).sum(1)
        alt = st["c_alt"] + torch.where(m & cur_is_alt, nlive, 0)
        el_upd = m & cur_is_alt & cur_is_eligible & (nlive > 0)
        ovr = el_upd & cur_overrides
        jstar = live.long().argmax(1)
        elnum = torch.where(ovr, 0, st["c_elnum"])
        elsz = torch.where(ovr, 0, st["c_elsz"])
        elnum = torch.where(el_upd, elnum + nlive, elnum)
        elsz = torch.where(el_upd, elsz + szlive, elsz)
        self.w("c_lowq", ovr, q)
        self.w("c_eli", ovr, d)
        self.w("c_eltop", ovr, _g(row_t, jstar))
        self.w("c_elbot", ovr, _g(row_b, jstar))
        self.w("c_elham", ovr, pen)
        self.w("c_elcint", ovr, jstar)
        self.w("c_elignore", ovr, 0)
        self.w("c_elnum", m, elnum)
        self.w("c_elsz", m, elsz)
        self.w("c_alt", m, alt)

        cur0 = d == qlen - 1
        rp = st["rep_partials"]
        partial_c = m & cur0 & (top != bot) & (rp > 0) & (sd < rp)
        btdm = partial_c & (alt > 0)
        self.store_partial(partial_c & (sd > 0), sd)
        reported_partial = partial_c & (sd > 0)
        invex = m & cur0 & (sd == 0) & (bot != top) & (st["rep_exacts"] == 0)
        btdm = btdm | invex
        b5 = m & hh & (d == st["jd5"] - 1) & (top != bot)
        invhh = b5 & (sd == 0)
        mustbt = b5 & (sd == 0) & (alt > 0)
        btdm = btdm | mustbt
        die5 = b5 & (sd == 0) & (alt == 0)
        b3 = m & hh & (d == st["jd3"] - 1) & (top != bot)
        inv3 = (lo_n == 0) | (hi_n == 0)
        invhh = invhh | (b3 & inv3)
        mb3 = b3 & ((sd < 2) | inv3) & (alt > 0)
        mustbt = mustbt | mb3
        btdm = btdm | mb3
        die3 = b3 & (sd < 2) & (alt == 0)
        self.ret_false(die5 | die3)
        m = m & ~(die5 | die3)

        self.w("c_top", m, top)
        self.w("c_bot", m, bot)
        for r, v in (("btdm", btdm), ("mustbt", mustbt), ("invhh", invhh),
                     ("invex", invex), ("reppart", reported_partial)):
            self.w("c_" + r, m, v.long())
        rep = m & cur0 & (bot != top) & ~invhh & ~invex & ~reported_partial
        self.enter_report(rep, sd, top, bot, ham, torch.zeros_like(d))
        m = m & ~rep
        branch = m & ((top == bot) | btdm) & (alt > 0)
        self.w("mode", branch, M_BR)
        self.branch_exit(m & ~branch)

    def step_br(self):
        """Branch-loop head: pick a mismatch, push a frame (:1206)."""
        st, L, fc = self.st, self.L, self.pair.ftab_chars
        m = st["mode"] == M_BR
        sd = st["sd"]
        cond = (((st["c_top"] == st["c_bot"]) | (st["c_btdm"] > 0))
                & (st["c_alt"] > 0))
        self.branch_exit(m & ~cond)
        m = m & cond

        depth, d, ham = st["c_depth"], st["c_d"], st["c_ham"]
        cq = st["cons_quals"] > 0
        scan = m & ((st["c_elnum"] > 1) | (st["c_elignore"] > 0))
        er = st["elims"][self.ar, sd]                     # [B, L]
        li = torch.arange(L, device=self.dev)[None, :]
        qqp = st["qqp"]
        qual_ok = torch.where(cq[:, None], qqp[:, L:2 * L]
                              == st["c_lowq"][:, None], True)
        elig = ((li >= depth[:, None]) & (li <= d[:, None]) & (er != 15)
                & qual_ok)
        istar_s = torch.where(elig, li, -1).amax(1)
        no_pos = scan & (istar_s < 0)
        ist = istar_s.clamp(min=0)
        p8 = st["pairs"][self.ar, sd, ist]                # [B, 8]
        jar = torch.arange(4, device=self.dev)[None, :]
        nonelim = ((_g(er, ist)[:, None] >> jar) & 1) == 0
        msp = torch.where(nonelim, p8[:, 4:] - p8[:, :4], 0)
        pos_sz = msp.sum(1)
        no_sz = scan & (pos_sz == 0)
        bad = no_pos | no_sz
        st["overflow"] = st["overflow"] | bad
        self.w("mode", bad, M_DONE)
        m, scan = m & ~bad, scan & ~bad
        rng, v = _rng_next(st["rng"])
        self.w("rng", scan, rng)
        r = v % (pos_sz & U32).clamp(min=1)
        cum = msp.cumsum(1) - msp
        pickj = nonelim & (cum <= r[:, None]) & (r[:, None] < cum + msp)
        jstar_s = pickj.long().argmax(1)

        use_cache = m & ~scan
        istar = torch.where(use_cache, st["c_eli"], ist)
        jstar = torch.where(use_cache, st["c_elcint"], jstar_s)
        bttop = torch.where(use_cache, st["c_eltop"], _g(p8[:, :4], jstar_s))
        btbot = torch.where(use_cache, st["c_elbot"], _g(p8[:, 4:], jstar_s))
        btham = ham + torch.where(use_cache, st["c_elham"],
                                  _g(qqp, ist + 2 * L))

        rev1, rev2, rev3 = st["c_rev1"], st["c_rev2"], st["c_rev3"]
        lt1 = istar < rev1
        lt2 = ~lt1 & (istar < rev2)
        lt3 = ~lt1 & ~lt2 & (istar < rev3)
        bt_unrev = torch.where(lt1, rev1, st["c_unrev"])
        bt_rev1 = torch.where(lt1 | lt2, rev2, rev1)
        bt_rev2 = torch.where(lt1 | lt2 | lt3, rev3, rev2)

        qlen = st["qlen"]
        mi = m.nonzero()[:, 0]
        if mi.numel():
            for name, val in (("mms", qlen - 1 - istar), ("refcs", jstar),
                              ("mmd", istar)):
                st[name][mi, sd[mi]] = val[mi]
        self.w("c_bi", m, istar)
        self.w("c_bj", m, jstar)
        self.w("c_bspread", m, btbot - bttop)

        caseA = m & (istar + 1 == qlen)
        self.enter_report(caseA, sd + 1, bttop, btbot, btham,
                          torch.ones_like(sd))
        rest = m & ~caseA
        midftab = (rest & (st["hh"] > 0) & (st["c_dftab"] == 0)
                   & (st["jrev2"] == st["jrev3"]) & (istar + 1 < fc)
                   & (fc <= st["jd5"]))
        ft = fb = torch.zeros_like(istar)
        if bool(midftab.any()):
            k = torch.arange(fc, device=self.dev)[None, :]
            sub = torch.where(k == istar[:, None], jstar[:, None],
                              qqp[:, :fc])
            sub = torch.where(sub > 3, 0, sub)
            foff = (sub << (2 * k)).sum(1)
            ft = self.by_index(lambda fm: u32(
                fm.ftab_hi[torch.where(midftab, foff, 0)]))
            fb = self.by_index(lambda fm: u32(
                fm.ftab_lo[torch.where(midftab, foff + 1, 0)]))
            self.touch("ftab_entries", foff, midftab)
        ft_empty = midftab & (ft == fb)
        self.w("mode", ft_empty, M_POP)
        push = (rest & ~midftab) | (midftab & ~ft_empty)
        s_over = push & (sd + 1 >= S_MAX)
        st["overflow"] = st["overflow"] | s_over
        self.w("mode", s_over, M_DONE)
        push = push & ~s_over
        pi = push.nonzero()[:, 0]
        if pi.numel():
            regs = torch.stack([st["c_" + r] for r in REGS], 1)
            st["stk"][pi, sd[pi]] = regs[pi]
        self.w("sd", push, sd + 1)
        self.init_regs(push, torch.where(midftab, fc, istar + 1), bt_unrev,
                       bt_rev1, bt_rev2, rev3, btham,
                       torch.where(midftab, ft, bttop),
                       torch.where(midftab, fb, btbot), torch.zeros_like(sd))

    def step_pop(self):
        """Post-child bookkeeping and eligibility rescan (:1346)."""
        st, L = self.st, self.L
        m = st["mode"] == M_POP
        bts_hit = ((st["hh"] > 0) & (st["maxbts"] > 0)
                   & (st["num_bts"] >= st["maxbts"]))
        bail = m & (st["bailed"] | bts_hit)
        st["bailed"] = st["bailed"] | bail
        self.ret_false(bail)
        m = m & ~bail
        sd = st["sd"]
        mi = m.nonzero()[:, 0]
        if mi.numel():
            st["elims"][mi, sd[mi], st["c_bi"][mi]] |= 1 << st["c_bj"][mi]
        elnum = st["c_elnum"] - 1
        alt = st["c_alt"] - 1
        self.w("c_elsz", m, st["c_elsz"] - st["c_bspread"])
        self.w("c_elnum", m, elnum)
        self.w("c_elignore", m, 1)
        self.w("c_alt", m, alt)
        dead = m & (alt == 0)
        self.ret_false(dead)
        m = m & ~dead
        rescan = m & (elnum == 0) & (st["cons_quals"] > 0)
        if bool(rescan.any()):
            self.rescan(rescan)
        self.w("mode", m, M_BR)

    def rescan(self, rescan):
        """Eligibility rescan (ebwt_search_backtrack.h:1004-1058)."""
        st, L = self.st, self.L
        sd = st["sd"]
        li = torch.arange(L, device=self.dev)[None, :]
        er = st["elims"][self.ar, sd]                     # [B, L]
        pf = st["pairs"][self.ar, sd]                     # [B, L, 8]
        spread = pf[..., 4:] - pf[..., :4]                # [B, L, 4]
        jar = torch.arange(4, device=self.dev)
        live = (((er[..., None] >> jar) & 1) == 0) & (spread != 0)
        in_rng = ((li >= torch.maximum(st["c_depth"], st["c_unrev"])[:, None])
                  & (li <= st["c_d"][:, None]))
        qqp = st["qqp"]
        pend, quald = qqp[:, 2 * L:], qqp[:, L:2 * L]
        k_alt = st["c_ham"][:, None] + pend <= st["qthresh"][:, None]
        nlive = live.sum(2)
        szs = torch.where(live, spread, 0).sum(2)
        valid_k = in_rng & k_alt & (nlive > 0)
        low = torch.where(valid_k, quald, 0x7FFF).amin(1)
        at_low = valid_k & (quald == low[:, None])
        kstar = torch.where(at_low, li, -1).amax(1)
        has = kstar >= 0
        ks = kstar.clamp(min=0)
        n_el = torch.where(at_low, nlive, 0).sum(1)
        s_el = torch.where(at_low, szs, 0).sum(1)
        lstar = live[self.ar, ks].long().argmax(1)
        p8k = pf[self.ar, ks]
        mm = rescan & has
        self.w("c_lowq", mm, low)
        self.w("c_eli", mm, ks)
        self.w("c_eltop", mm, _g(p8k[:, :4], lstar))
        self.w("c_elbot", mm, _g(p8k[:, 4:], lstar))
        self.w("c_elham", mm, _g(pend, ks))
        self.w("c_elcint", mm, lstar)
        self.w("c_elignore", mm, 0)
        self.w("c_elnum", mm, n_el)
        self.w("c_elsz", mm, s_el)
        mn = rescan & ~has
        self.w("c_lowq", mn, 0xFF)
        self.w("c_elnum", mn, 0)
        self.w("c_elsz", mn, 0)

    def step_rep(self):
        """One row chase of a report (:803 _step_rep)."""
        st, pair = self.st, self.pair
        m = st["mode"] == M_REP
        spread = (st["r_bot"] - st["r_top"]) & U32
        ri = (st["r_r"] + st["r_k"]) & U32
        ri = torch.where(st["r_bot"] <= ri, (ri - spread) & U32, ri)
        ri_safe = torch.where(m, ri, 0)
        if pair.dense:
            off = self.by_index(lambda fm: u32(fm.sa[ri_safe]))
            self.touch("sa_entries", ri_safe, m)
        else:
            # walk left to a marked row, one LF per step
            # (reportChaseOne, ebwt.h:2727-2746)
            start = m & (st["r_walk"] == 0)
            row = torch.where(start, ri_safe, st["r_row"])
            jumps = torch.where(start, 0, st["r_jumps"])
            omask = (1 << pair.fw.off_rate) - 1
            zoff = torch.where(self.efw(), pair.fw.zoff, pair.bw.zoff)
            at_z = row == zoff
            marked = ((row & omask) == 0) | at_z
            resolved = m & marked
            sidx = torch.where(m, row >> pair.fw.off_rate, 0)
            off = torch.where(
                at_z, jumps,
                (self.by_index(lambda fm: u32(fm.offs[sidx])) + jumps) & U32)
            walkers = m & ~marked
            if self.work is not None:
                self.work["walk_steps"] += int(walkers.sum())
                self.work["rank_codes"] += int(walkers.sum())
                self.work["word_codes"] += int(words_needed(row)[walkers]
                                               .sum())
                self.work["sa_loads"] += int(resolved.sum())
            self.touch("sa_entries", sidx, resolved & ~at_z)
            self.touch("occ_entries", row // OCC_BLOCK, walkers)
            self.touch("bwt_blocks", row // OCC_BLOCK, walkers)
            wrow = torch.where(walkers, row, 0)
            lf = self.by_index(lambda fm: lf_row_compact_plain(fm, wrow))
            self.w("r_row", m, torch.where(walkers, lf, row))
            self.w("r_jumps", m, torch.where(walkers, jumps + 1, jumps))
            self.w("r_walk", m, (~resolved).long())
            m = resolved
        if self.work is not None and pair.dense:
            self.work["sa_loads"] += int(m.sum())
        qlen = st["qlen"]
        rs = pair.rstarts
        nfrag = rs.shape[0]
        if nfrag == 1:
            elt = torch.zeros_like(off)
        else:
            elt = torch.searchsorted(rs[:, 0].contiguous(), off,
                                     right=True) - 1
        start = rs[:, 0][elt]
        upper = torch.where(elt + 1 < nfrag,
                            rs[:, 0][(elt + 1).clamp(max=nfrag - 1)],
                            pair.length)
        valid = ((off + qlen) & U32) <= upper
        fragoff = off - start
        fragoff = torch.where(st["ebwt_fw"] == 0,
                              (upper - start) - fragoff - 1 - (qlen - 1),
                              fragoff)
        toff = fragoff + rs[:, 2][elt]

        hit = m & valid
        newcount = st["count"] + 1
        maxed = hit & (newcount > self.m_max)
        stored = hit & ~maxed
        nmms = st["r_sd"] + st["npremut"]
        slot = torch.arange(MM_SLOTS, device=self.dev)[None, :]
        from_mm = slot < st["r_sd"][:, None]
        pm_i = (slot - st["r_sd"][:, None]).clamp(0, 2)
        pad = (0, MM_SLOTS - S_MAX)
        mm_v = torch.where(from_mm, torch.nn.functional.pad(st["mms"], pad),
                           st["premut_pos"].gather(1, pm_i))
        rc_v = torch.where(from_mm,
                           torch.nn.functional.pad(st["refcs"], pad),
                           st["premut_refc"].gather(1, pm_i))
        cost = st["r_ham"] | (st["r_stratum"] << 14)
        rec = torch.cat([torch.stack(
            [rs[:, 1][elt], toff, st["fwflag"] | (st["ebwt_fw"] << 1),
             st["r_bot"] - st["r_top"] - 1, st["r_stratum"], cost, nmms,
             qlen], 1), mm_v, rc_v], 1)
        over = stored & ((st["nhits"] >= H_MAX) | (nmms > MM_SLOTS))
        st["overflow"] = st["overflow"] | over
        self.w("mode", over, M_DONE)
        do_store = stored & ~over
        si = do_store.nonzero()[:, 0]
        if si.numel():
            st["hits"][si, st["nhits"][si]] = rec[si]
            st["nhits"][si] += 1
        self.w("count", hit, newcount)
        self.w("result", maxed, 2)
        self.w("mode", maxed, M_DONE)
        n_k, m_max = self.n_k, self.m_max
        stop = do_store & (newcount == n_k) & ((m_max == INF32)
                                               or (m_max < n_k))
        self.w("result", stop, 1)
        self.w("mode", stop, M_DONE)
        go_on = m & ~maxed & ~stop & ~over
        nk = st["r_k"] + 1
        self.w("r_k", go_on, nk)
        self.report_fail(go_on & (nk >= spread))

    def count_ranks(self, act, four, top, bot):
        """Add the rank work the active lanes' LF step needs to
        self.work: ranks at both range ends, of all four codes where the
        position is an alternative (mapLFEx) and of the read's code
        alone elsewhere, each over the words its row needs
        (ops.fm.words_needed)."""
        codes = torch.where(four, 4, 1)[act]
        w = self.work
        w["rank_ends"] += 2 * int(act.sum())
        w["rank_codes"] += 2 * int(codes.sum())
        w["word_codes"] += int(((words_needed(top) + words_needed(bot))[act]
                                * codes).sum())
        for row in (top, bot):
            blk = row // OCC_BLOCK
            self.touch("occ_entries", blk, act)
            self.touch("bwt_blocks", blk, act & (words_needed(row) > 0))

    def step(self):
        """One lockstep iteration (:1445 _machine_step).  RETF, JOB, POP
        and REP run, as there, only if some lane was in their mode when
        the iteration began (a lane that enters one later waits for the
        next iteration); ADV and BR, ungated there, are skipped here only
        when no lane is in their mode at that point, where they change
        nothing."""
        mode = self.st["mode"]
        cnts = torch.bincount(mode, minlength=M_RETF + 1).tolist()
        if cnts[M_RETF]:
            self.step_retf()
        if cnts[M_JOB]:
            self.step_job()
        for _ in range(3):
            if bool((self.st["mode"] == M_ADV).any()):
                self.step_adv()
        if cnts[M_POP]:
            self.step_pop()
        if cnts[M_REP]:
            self.step_rep()
        if bool((self.st["mode"] == M_BR).any()):
            self.step_br()

    def outputs(self) -> dict:
        st = self.st
        B = st["mode"].shape[0]
        i32 = lambda t: t.to(torch.int32)  # noqa: E731
        return dict(
            result=i32(st["result"]), overflow=st["overflow"].clone(),
            count=i32(st["count"]), nhits=i32(st["nhits"]),
            hits=i32(st["hits"]).reshape(B, H_MAX * HIT_W),
            npart=i32(st["npart"]), part_n=i32(st["part_n"]),
            part_job=i32(st["part_job"]),
            part_pos=i32(st["part_pos"]).reshape(B, P_MAX * 3),
            part_refc=i32(st["part_refc"]).reshape(B, P_MAX * 3),
            rng=st["rng"].clone(), mode=i32(st["mode"]))


def run_machine_plain(pair: FMPair, jobs: dict, seeds: torch.Tensor,
                      count0: torch.Tensor, *, n_k: int, m_max: int,
                      max_steps: int, work: dict | None = None):
    """The lockstep machine (bowtie_tpu/align/dfs_device.py:1484
    run_machine): iterate until every lane is DONE or max_steps
    iterations have run; lanes still running are flagged `overflow`.
    -> (outputs by OUT_KEYS, iterations as a 0-dim int64 tensor).
    If `work` is given (a dict), the rank work, walk steps and SA loads
    the run needs are added to its keys rank_ends, rank_codes,
    word_codes, walk_steps and sa_loads, and the distinct items it reads
    to the keys of TOUCHED, for bounds."""
    if work is not None:
        for k in ("rank_ends", "rank_codes", "word_codes", "walk_steps",
                  "sa_loads") + TOUCHED:
            work.setdefault(k, 0)
    mach = _Plain(pair, jobs, seeds, count0, n_k, m_max, work)
    st = mach.st
    it = 0
    while it < max_steps and bool((st["mode"] != M_DONE).any()):
        mach.step()
        it += 1
    st["overflow"] = st["overflow"] | (st["mode"] != M_DONE)
    if work is not None:
        for k, keys in mach.touched.items():
            if keys:
                work[k] += int(torch.unique(torch.cat(keys)).numel())
    return mach.outputs(), torch.tensor(it)


_OUT_SHAPES = dict(result=(), overflow=(), count=(), nhits=(),
                   hits=(H_MAX * HIT_W,), npart=(), part_n=(P_MAX,),
                   part_job=(P_MAX,), part_pos=(P_MAX * 3,),
                   part_refc=(P_MAX * 3,), rng=(), mode=(), steps=())


# K7's launch shape (csrc/dfs.cu kMachineThreads, kOnchipL, lane_words):
# one warp a block, so that the CLI's 8,192 lanes make 256 blocks over
# the card's 132 SMs.  Every lane keeps its parents' frames in shared
# memory; up to ONCHIP_L positions also each level's elims, its mask of
# live positions and the job's by-depth row (the on-chip layout), and
# beyond that they stay in global memory (the global layout).
MACHINE_THREADS = 32
ONCHIP_L = 64
FRAME_WORDS = 26            # REGS less elsz and bspread
SHARED_LIMIT = 48 * 1024    # a block's shared memory without opting in


def lane_shared_bytes(L: int, onchip: bool) -> int:
    """K7's shared bytes a lane (csrc/dfs.cu lane_words): the parents'
    frames and eight pick words; on chip also each level's mask (two
    words), the job's by-depth row and each level's elims."""
    words = (S_MAX - 1) * FRAME_WORDS + 8
    if onchip:
        words += 2 * S_MAX + (3 * L + 3) // 4 + (S_MAX * L + 3) // 4
    return 4 * words


def machine_shape(B: int, L: int) -> dict:
    """K7's launch for B lanes of row width L: the layout (on chip up to
    ONCHIP_L, for rows of whole words), threads and blocks, and the
    block's shared bytes."""
    onchip = L <= ONCHIP_L and L % 4 == 0
    shared = MACHINE_THREADS * lane_shared_bytes(L, onchip)
    if shared > SHARED_LIMIT:
        raise ValueError(f"K7 needs {shared} shared bytes a block at L={L}")
    return dict(onchip=onchip, threads=MACHINE_THREADS,
                blocks=-(-B // MACHINE_THREADS), shared=shared)


def _check_machine(L: int) -> None:
    """Raise unless csrc/dfs.cu's K7 launches the shape machine_shape
    describes."""
    so = kernels.lib()
    if (so.bt_dfs_machine_threads() != MACHINE_THREADS
            or so.bt_dfs_onchip_l() != ONCHIP_L
            or any(so.bt_dfs_lane_bytes(L, oc) != lane_shared_bytes(L, oc)
                   for oc in (0, 1))):
        raise RuntimeError("csrc/dfs.cu and align/dfs_device.py disagree "
                           "on K7's launch shape")


def _with_a_job(jobs: dict) -> dict:
    """No jobs (--nofw with --norc): a table of one invalid job ends
    every lane at its first job load."""
    scal, qqp = jobs["scal"], jobs["qqp"]
    if scal.dim() == 3 and scal.shape[1] == 0:
        return {"scal": scal.new_zeros((scal.shape[0], 1, NJF)),
                "qqp": qqp.new_zeros((qqp.shape[0], 1, qqp.shape[2]))}
    return jobs


def run_machine(pair: FMPair, jobs: dict, seeds: torch.Tensor,
                count0: torch.Tensor, *, n_k: int, m_max: int,
                max_steps: int):
    """K7: run every lane's state machine to DONE.  jobs: {"scal" int32
    [B, J, NJF], "qqp" int8 [B, J, 3L]} (upload_jobs), seeds int64 [B]
    (uint32 values), count0 int32 [B]; n_k / m_max: the -k / -m limits
    (INF32 for none).  -> (outputs by OUT_KEYS, as run_machine_plain
    gives them; the most iterations (plain) or transitions (kernel) any
    lane took, as a 0-dim tensor).

    Launches csrc/dfs.cu's dfs_machine_kernel on CUDA tensors
    (run_machine_lanes); runs run_machine_plain on CPU tensors."""
    jobs = _with_a_job(jobs)
    if kernels.all_on_cpu(jobs["scal"], jobs["qqp"], seeds, count0,
                          device=pair.device):
        return run_machine_plain(pair, jobs, seeds, count0, n_k=n_k,
                                 m_max=m_max, max_steps=max_steps)
    out, steps = run_machine_lanes(pair, jobs, seeds, count0, n_k=n_k,
                                   m_max=m_max, max_steps=max_steps)
    return out, (steps.max() if steps.numel() else torch.tensor(0)).long()


def run_machine_lanes(pair: FMPair, jobs: dict, seeds: torch.Tensor,
                      count0: torch.Tensor, *, n_k: int, m_max: int,
                      max_steps: int):
    """K7 on CUDA tensors, as run_machine takes them: (outputs by
    OUT_KEYS, each lane's transitions as int32 [B]).  One thread per
    lane in machine_shape's blocks; each lane's budget 8 * max_steps
    transitions (see the module docstring); the pairs rows in a per-lane
    [S_MAX, L, 8] scratch allocated here, which no transition reads
    before writing it (and elims beside it in the global layout)."""
    jobs = _with_a_job(jobs)
    scal, qqp = jobs["scal"], jobs["qqp"]
    dev = pair.device
    if kernels.all_on_cpu(scal, qqp, seeds, count0, device=dev):
        raise ValueError("run_machine_lanes runs the kernel: CUDA tensors "
                         "only (run_machine takes CPU tensors)")
    kernels.check(scal, "scal", torch.int32, 3, dev)
    kernels.check(qqp, "qqp", torch.int8, 3, dev)
    kernels.check(seeds, "seeds", torch.int64, 1, dev)
    kernels.check(count0, "count0", torch.int32, 1, dev)
    kernels.check(pair.rstarts, "rstarts", torch.int64, 2, dev)
    B, J, nf = scal.shape
    L = qqp.shape[2] // 3
    if (nf != NJF or qqp.shape[:2] != (B, J) or qqp.shape[2] != 3 * L
            or seeds.shape[0] != B or count0.shape[0] != B):
        raise ValueError("scal, qqp, seeds and count0 disagree on shapes")
    shape = machine_shape(B, L)
    out = {k: torch.empty((B,) + s, dtype=torch.int32, device=dev)
           for k, s in _OUT_SHAPES.items()}
    pairs = torch.empty((B, S_MAX, L, 8), dtype=torch.int32, device=dev)
    elims = (None if shape["onchip"] else
             torch.zeros((B, S_MAX, L), dtype=torch.uint8, device=dev))
    if B:
        _check_layout()
        _check_machine(L)
        a = kernels.DfsArgs(
            fw=kernels.fm_view(pair.fw), bw=kernels.fm_view(pair.bw),
            rstarts=pair.rstarts.data_ptr(), nfrag=pair.nfrag,
            length=pair.length, dense=int(pair.dense),
            scal=scal.data_ptr(), qqp=qqp.data_ptr(),
            seeds=seeds.data_ptr(), count0=count0.data_ptr(), B=B, J=J, L=L,
            n_k=n_k, m_max=m_max, max_transitions=8 * max_steps,
            pairs=pairs.data_ptr(),
            elims=None if elims is None else elims.data_ptr(),
            **{k: v.data_ptr() for k, v in out.items()})
        kernels.launch("dfs_machine", "bt_dfs_machine", ctypes.byref(a),
                       int(shape["onchip"]), device=dev)
    steps = out.pop("steps")
    out["overflow"] = out["overflow"] != 0
    out["rng"] = u32(out["rng"])
    return out, steps


# ---------------------------------------------------------------------------
# K8: dense packing of hit and partial rows
# ---------------------------------------------------------------------------

def _pack_index(counts: torch.Tensor):
    """(lane, slot) of every counted row, lane-major."""
    lanes = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts.long())
    first = torch.cumsum(counts.long(), 0) - counts.long()
    slots = torch.arange(lanes.shape[0], device=counts.device) - first[lanes]
    return lanes, slots


def _fused_parts(out: dict) -> torch.Tensor:
    """[B, P_MAX, 8] partial rows: n, job, pos[3], refc[3]."""
    B = out["npart"].shape[0]
    return torch.cat([out["part_n"][..., None], out["part_job"][..., None],
                      out["part_pos"].reshape(B, P_MAX, 3),
                      out["part_refc"].reshape(B, P_MAX, 3)], 2)


def pack_hits_plain(out: dict):
    """The hit rows of lanes without overflow and every lane's partial
    rows, packed lane by lane (as bowtie_tpu/align/dfs_device.py:2011
    decode_hit_cols gathers hits and :1953 _pack_all the partials).
    -> (hits [sum nh_eff, HIT_W] int32, parts [sum npart, 8] int32,
    nh_eff [B] int32: the hit count of each lane, 0 under overflow)."""
    B = out["nhits"].shape[0]
    nh_eff = torch.where(out["overflow"], 0, out["nhits"])
    lanes, slots = _pack_index(nh_eff)
    hits = out["hits"].reshape(B, H_MAX, HIT_W)[lanes, slots]
    lanes, slots = _pack_index(out["npart"])
    return hits, _fused_parts(out)[lanes, slots], nh_eff


# K8's scratch words by (device, stream): zeroed once, and left zeroed by
# every launch (csrc/dfs.cu dfs_pack_kernel)
_PACK_SCRATCH: dict = {}


def _pack_scratch(dev: torch.device, B: int) -> torch.Tensor:
    words = kernels.lib().bt_dfs_pack_scratch_words(B)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    scratch = _PACK_SCRATCH.get(key)
    if scratch is None or scratch.numel() < words:
        scratch = torch.zeros(words, dtype=torch.int64, device=dev)
        _PACK_SCRATCH[key] = scratch
    return scratch


def pack_hits(out: dict):
    """K8: pack_hits_plain's result from run_machine's outputs.  CPU
    tensors take the plain version; CUDA tensors launch csrc/dfs.cu's
    dfs_pack_kernel once (nh_eff, the scans and the copies) into outputs
    of the most rows B lanes can have, and read the two row totals back
    in one copy, the call's one host sync; the rows are views of them."""
    dev = out["nhits"].device
    if kernels.all_on_cpu(*out.values()):
        return pack_hits_plain(out)
    for k in ("hits", "nhits", "npart", "part_n", "part_job", "part_pos",
              "part_refc"):
        kernels.check(out[k], k, torch.int32, None, dev)
    kernels.check(out["overflow"], "overflow", torch.bool, 1, dev)
    if out["hits"].data_ptr() % 16:
        raise ValueError("hits is not 16-byte aligned")
    B = out["nhits"].shape[0]
    nh_eff = torch.empty(B, dtype=torch.int32, device=dev)
    hits = torch.empty((B * H_MAX, HIT_W), dtype=torch.int32, device=dev)
    parts = torch.empty((B * P_MAX, PART_W), dtype=torch.int32, device=dev)
    if not B:
        return hits, parts, nh_eff
    scratch = _pack_scratch(dev, B)
    kernels.launch("dfs_pack", "bt_dfs_pack", *(out[k].data_ptr() for k in (
        "hits", "nhits", "overflow", "npart", "part_n", "part_job",
        "part_pos", "part_refc")), B, nh_eff.data_ptr(), hits.data_ptr(),
        parts.data_ptr(), scratch.data_ptr(), device=dev)
    nh, npr = scratch[2:4].tolist()
    return hits[:nh], parts[:npr], nh_eff


def decode_hit_cols(recs: np.ndarray, nh_eff: np.ndarray):
    """Packed hit rows (pack_hits, on the host) and each read's count ->
    (per-read bounds list, and a Hit maker mk(read, j)), converting each
    column to a python list in one pass (as
    bowtie_tpu/align/dfs_device.py:2011 decode_hit_cols)."""
    acgt = (97, 99, 103, 116)
    fw_a = (recs[:, 2] & 1).astype(bool)
    efw_a = ((recs[:, 2] >> 1) & 1).astype(bool)
    offp = np.where((efw_a != fw_a)[:, None],
                    recs[:, 7:8] - recs[:, 8:8 + MM_SLOTS] - 1,
                    recs[:, 8:8 + MM_SLOTS])
    refc = recs[:, 8 + MM_SLOTS:8 + 2 * MM_SLOTS]
    cols = (recs[:, 0].tolist(), recs[:, 1].tolist(), fw_a.tolist(),
            recs[:, 3].tolist(), recs[:, 4].tolist(), recs[:, 5].tolist(),
            recs[:, 6].tolist(), offp.tolist(), refc.tolist())
    bounds = np.zeros(len(nh_eff) + 1, np.int64)
    np.cumsum(nh_eff, out=bounds[1:])

    def mk(read, j):
        ne = cols[6][j]
        mms = sorted((cols[7][j][k], acgt[cols[8][j][k]])
                     for k in range(ne)) if ne else []
        return Hit(read=read, fw=cols[2][j], tidx=cols[0][j],
                   toff=cols[1][j], oms=cols[3][j], stratum=cols[4][j],
                   cost=cols[5][j], mms=mms)
    return bounds.tolist(), mk


# ---------------------------------------------------------------------------
# The aligner
# ---------------------------------------------------------------------------

class DeviceDFSAligner:
    """-v 1/2 aligner running the DFS machine on `device` (default
    CUDA), with the per-read host-oracle re-run of overflowing lanes
    (the fresh per-read RNG makes the re-run bit-identical; FALLBACKS
    counts them)."""

    # above this genome length the dense SA (4 B/row per index) gives way
    # to the sampled SA and walk-left
    DENSE_LIMIT = 1 << 28

    def __init__(self, idx_fw: EbwtIndex, idx_bw: EbwtIndex, policy,
                 v: int = 1, nofw: bool = False, norc: bool = False,
                 global_seed: int = 0, max_steps: int = 20000,
                 compact: bool | None = None, device=None):
        self.idx_fw, self.idx_bw = idx_fw, idx_bw
        if compact is None:
            compact = idx_fw.length > self.DENSE_LIMIT
        self.pair = build_fmpair(idx_fw, idx_bw, device,
                                 dense_sa=not compact)
        self.policy = policy
        self.v = v
        self.nofw, self.norc = nofw, norc
        self.global_seed = global_seed
        self.max_steps = max_steps
        self._oracle = None
        self._exact = None

    def _oracle_aligner(self):
        if self._oracle is None:
            from .drivers import OracleAligner
            from .golden import GoldenFM
            self._oracle = OracleAligner(
                GoldenFM(self.idx_fw), GoldenFM(self.idx_bw), self.policy,
                v=self.v, nofw=self.nofw, norc=self.norc,
                global_seed=self.global_seed)
        return self._oracle

    def _exact_aligner(self) -> ExactAligner:
        if self._exact is None:
            self._exact = ExactAligner(self.pair.fw, self.idx_fw,
                                       self.policy, nofw=self.nofw,
                                       norc=self.norc,
                                       global_seed=self.global_seed)
        return self._exact

    def _exact_gate(self, reads, slow_path, min_len: int = 0):
        """Exact-hit fast path for the default first-1-good policy
        (bowtie_tpu/align/dfs_device.py:1724): every mode's phase 1
        searches the whole read exactly, fw then rc, and re-seeds the
        per-read LCG, so under -k 1 without -m a read with an exact hit
        reports what -v 0 reports.  Such reads take K4; only the rest,
        and reads shorter than min_len (which phase 1 may refuse), enter
        the machine."""
        if self.policy.n != 1 or self.policy.max < INF32:
            return slow_path(reads)
        res = self._exact_aligner().align_batch(reads)
        rest = [i for i, r in enumerate(res)
                if not r.hits or len(reads[i].seq) < min_len]
        if rest:
            for i, r in zip(rest, slow_path([reads[i] for i in rest])):
                res[i] = r
        return res

    def align_batch(self, reads) -> list:
        if not reads:
            return []
        return self._exact_gate(reads, self._align_batch_dfs)

    def _align_batch_dfs(self, reads) -> list:
        from .dfs_jobs import build_v_jobs_vec
        dev = self.pair.device
        L = _len_bucket(max(len(r.seq) for r in reads))
        jobs, _J = build_v_jobs_vec(reads, self.v, self.nofw, self.norc, L)
        seeds = fill_seed_caches(reads, self.global_seed)
        jobs_dev = upload_jobs(jobs, self.pair.ftab_chars, dev)
        n_k = min(self.policy.n, INF32)
        m_max = min(self.policy.max, INF32)
        out, _ = run_machine(
            self.pair, jobs_dev,
            torch.from_numpy(seeds.astype(np.int64)).to(dev),
            torch.zeros(len(reads), dtype=torch.int32, device=dev),
            n_k=n_k, m_max=m_max, max_steps=self.max_steps)
        hits, _parts, nh_eff = pack_hits(out)
        return self.assemble(reads, hits.cpu().numpy(),
                             nh_eff.cpu().numpy(), out["count"].tolist(),
                             out["overflow"].tolist(), seeds)

    def assemble(self, reads, hits, nh_eff, count_l, ovf_l, seeds) -> list:
        bounds_l, mk = decode_hit_cols(hits, nh_eff)
        seeds_l = seeds.tolist()
        finish = self.policy.finish
        results = []
        for b, read in enumerate(reads):
            if ovf_l[b]:
                FALLBACKS["lanes"] += 1
                results.append(self._oracle_aligner().align_read(read))
                continue
            results.append(finish(
                [mk(read, j) for j in range(bounds_l[b], bounds_l[b + 1])],
                count_l[b], seeds_l[b]))
        return results
