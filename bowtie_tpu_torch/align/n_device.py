"""Seeded -n mode (bowtie's default, Maq-like) on the DFS machine.

A port of bowtie_tpu/align/n_device.py: seededQualCutoffSearchFull and
search_seeded_phase1-4.c (ebwt_search.cpp:2735-2952) as two launches of
the -v 1/2 machine (align/dfs_device.py) per batch, on one stream:

  launch A  phase 1 (exact fw, seed cases on rc), phase 2 (seed cases on
            the mirror index, rc partial collection) and the phase-3 tail
            (fw partial collection): jobs known per read in advance
            (dfs_jobs.build_n_jobs_a_vec).
  launch B  phase 3/4 partial extensions (one job per partial collected
            by A, the seed mutations applied to the query, the qualities
            they cost as the entry ham) and the two half-and-half
            searches, with A's hit counts and the same seeds.

Kernel, with a wrapper that launches it on CUDA tensors and runs its plain
PyTorch version (in this module) on CPU tensors:

  K9 derive_b_jobs <- n_device.py:85 _derive_b_jobs_device (jit :593-607)
                      without its tail, _derive_rows_impl (:202-207),
                      which is K6 (dfs_device.derive_rows); a warp per
                      lane, the lane's table built in shared memory
                      (csrc/jobs.cu)

K9 reads launch A's outputs where K7 left them, so nothing is downloaded
between the launches: the one download is of both launches' packed hits.
Launch B's table always has J_B = P_MAX + 4 = 36 jobs, as the JAX fused
path fixes it (:531).

Step budget: each launch gets max_steps (60,000) lockstep iterations in
the plain version and 8 * max_steps transitions per lane in the kernel,
the rule of align/dfs_device.py, for A and for B alike.

Left out of the JAX module, on purpose: _jobs_b and _jobs_b_vec, the host
twins of K9 that the JAX package runs on a CPU backend (the port always
derives launch B's jobs with K9 or its plain version); _poll_one,
_hits_slice, _poll_pair and _pack_hits2, which overlap transfers over the
TPU's host link; the chunked launch B with lane compaction (each K7
thread retires its own lane, so one launch replaces it); and the
BOWTIE_TPU_N2_UNFUSED and BOWTIE_TPU_PROF switches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..index.ebwt_io import EbwtIndex
from ..utils.rng import fill_seed_caches
from .backtrack_oracle import QUAL_ROUNDS
from .dfs_device import (_FIDX, FALLBACKS, INF32, M_DONE, NJF, P_MAX,
                         DeviceDFSAligner, _check_layout, _len_bucket,
                         decode_hit_cols, derive_rows, pack_hits,
                         run_machine, upload_jobs)
from .dfs_jobs import build_n_jobs_a_vec

J_B = P_MAX + 4                # launch B's jobs per lane
_A_KEYS = ("result", "overflow", "mode", "npart", "part_job", "part_n",
           "part_pos", "part_refc")


# ---------------------------------------------------------------------------
# K9: launch B's job table from launch A's outputs
# ---------------------------------------------------------------------------

def derive_b_jobs_plain(out_a: dict, gated: torch.Tensor,
                        base_qual: torch.Tensor, base_plen: torch.Tensor,
                        qual_rounds: torch.Tensor, *, J: int, jrc: int,
                        n: int, s: int, qt: int, maxbts: int, maq: bool,
                        norc: bool, nofw: bool) -> torch.Tensor:
    """The launch-B job table as bowtie_tpu/align/n_device.py:85
    _derive_b_jobs_device builds it, before K6 derives its rows.

    out_a: launch A's run_machine outputs (result, overflow, mode, npart,
    part_job, part_n [B, P_MAX], part_pos, part_refc [B, 3 P_MAX], slot
    major); gated bool [B] (phase 1's gate); base_qual int8 [B, L] and
    base_plen int32 [B] (A's base arrays); qual_rounds int32 [256] (Maq
    rounding).  Lanes take jobs when A finished them without a hit and
    without overflow, ungated, under n > 0: first one extension per rc
    partial (slots whose job is jrc) in slot order and, for n >= 2, the rc
    half-and-half search; then one extension per fw partial and the fw
    half-and-half search.  An extension's entry ham is the summed penalty
    of the qualities at the partial's raw stored positions; its
    premutations are those positions mirrored to plen-1-pos.
    -> scal int32 [B, J, NJF] (ns_gate and ns_ftab 0: K6 fills them)."""
    dev = base_plen.device
    B, L = base_qual.shape
    ovf = out_a["overflow"].bool() | (out_a["mode"] != M_DONE)
    npart = out_a["npart"].long()
    active = (out_a["result"] == 0) & ~ovf & ~gated.bool() & (n > 0)
    plen = base_plen.long()
    qs = torch.clamp(plen, max=s)
    pj = out_a["part_job"].long()                     # [B, P]
    P = pj.shape[1]
    ppos = out_a["part_pos"].long().reshape(B, P, 3)
    prefc = out_a["part_refc"].long().reshape(B, P, 3)
    pn = out_a["part_n"].long()
    slot = torch.arange(P, device=dev)[None, :]
    vpart = (slot < npart[:, None]) & active[:, None]
    rc = vpart & (pj == jrc)
    fw = vpart & ~rc
    nrc = rc.sum(1)
    nfw = fw.sum(1)
    hh_on = n >= 2
    hh_rc_on = hh_on and not norc
    hh_fw_on = hh_on and not nofw
    fw_base = nrc + int(hh_rc_on) * active.long()

    qpad = torch.nn.functional.pad(base_qual.long(), (0, 4))
    mutq = qpad.gather(1, ppos.reshape(B, -1).clamp(0, L + 3)).reshape(B, P, 3)
    pens = qual_rounds.long()[mutq.clamp(0, 255)] if maq else mutq
    kmask = torch.arange(3, device=dev)[None, None, :] < pn[:, :, None]
    ham0 = (pens * kmask).sum(2)
    tpos = plen[:, None, None] - 1 - ppos

    # column J collects the writes the JAX scatter drops (mode="drop")
    jobs = torch.zeros((B, J + 1, NJF), dtype=torch.int64, device=dev)

    def put(rows, cols, f, val):
        jobs[rows, cols, _FIDX[f]] = torch.as_tensor(
            val, device=dev).expand(rows.shape)

    def extensions(mask, jj, is_rc_block):
        bb, pp = mask.nonzero(as_tuple=True)
        j = jj[bb, pp].clamp(max=J)
        put(bb, j, "valid", 1)
        put(bb, j, "qlen", plen[bb])
        put(bb, j, "fw", 0 if is_rc_block else 1)
        put(bb, j, "ebwt_fw", 1 if is_rc_block else 0)
        for f in ("unrev", "rev1", "rev2", "rev3"):
            put(bb, j, f, qs[bb])
        put(bb, j, "ham0", ham0[bb, pp])
        put(bb, j, "report_exacts", 1)
        put(bb, j, "max_bts", maxbts)
        put(bb, j, "consider_quals", 1)
        put(bb, j, "qual_thresh", qt)
        put(bb, j, "maq_round", int(maq))
        # reset_rng only on the first extension of the block
        first = jj[bb, pp] == (0 if is_rc_block else fw_base[bb])
        put(bb, j, "reset_rng", first.long())
        put(bb, j, "npremut", pn[bb, pp])
        for k in range(3):
            on = pn[bb, pp] > k
            put(bb, j, f"premut_pos{k}", torch.where(on, tpos[bb, pp, k], 0))
            put(bb, j, f"premut_refc{k}",
                torch.where(on, prefc[bb, pp, k], 0))

    rc_rank = rc.long().cumsum(1) - 1
    fw_rank = fw.long().cumsum(1) - 1 + fw_base[:, None]
    if not norc:
        extensions(rc, rc_rank, True)
    if not nofw:
        extensions(fw, fw_rank, False)

    q5 = (qs >> 1) + (qs & 1)
    z = torch.zeros_like(qs)
    hh_offs = (q5, qs, z, q5 if n <= 2 else z, qs if n < 3 else q5, qs)
    for on, jcol, isrc in ((hh_rc_on, nrc, True),
                           (hh_fw_on, fw_base + nfw, False)):
        if not on:
            continue
        bb = active.nonzero()[:, 0]
        j = jcol[bb].clamp(max=J)
        put(bb, j, "valid", 1)
        put(bb, j, "qlen", plen[bb])
        put(bb, j, "fw", 0 if isrc else 1)
        put(bb, j, "ebwt_fw", 1 if isrc else 0)
        for f, v in zip(("d5", "d3", "unrev", "rev1", "rev2", "rev3"),
                        hh_offs):
            put(bb, j, f, v[bb])
        put(bb, j, "half_and_half", 1)
        put(bb, j, "report_exacts", 1)
        put(bb, j, "max_bts", maxbts)
        put(bb, j, "consider_quals", 1)
        put(bb, j, "qual_thresh", qt)
        put(bb, j, "maq_round", int(maq))
        put(bb, j, "reset_rng", 1)
    return jobs[:, :J].to(torch.int32).contiguous()


# K9's launch shape (csrc/jobs.cu kLaneWarps, lane_stride, kMaxShared): a
# warp a lane, LANE_WARPS lanes a block, each lane's [J, NJF] table built
# in shared memory (shifted by up to 3 words to the output's 16-byte
# boundaries, rounded to whole 16 bytes), at most MAX_SHARED bytes a block.
LANE_WARPS = 4
MAX_SHARED = 48 * 1024


def derive_b_jobs_shape(B: int, J: int) -> dict:
    """K9's launch for B lanes of J jobs, as csrc/jobs.cu
    bt_derive_b_jobs makes it: threads a block, lanes a block, blocks and
    the block's dynamic shared bytes.  Raises ValueError on a J whose
    tables do not fit (J_B = 36 takes 16,768 bytes)."""
    if not 0 <= B < 1 << 31:
        raise ValueError(f"{B} lanes: K9 counts lanes in int32")
    shared = LANE_WARPS * 4 * ((J * NJF + 6) // 4 * 4)
    if J < 1 or shared > MAX_SHARED:
        raise ValueError(f"K9 holds {LANE_WARPS} tables of J jobs in "
                         f"{MAX_SHARED} bytes of shared memory: J = {J} "
                         "does not fit")
    return dict(threads=LANE_WARPS * 32, lanes_a_block=LANE_WARPS,
                blocks=-(-B // LANE_WARPS), dynamic_shared=shared)


@functools.cache
def _check_b_shape(so) -> None:
    """Raise unless the library `so`'s K9 launches the shape
    derive_b_jobs_shape describes (once a library)."""
    if (so.bt_jobs_lane_warps() != LANE_WARPS
            or so.bt_jobs_max_shared() != MAX_SHARED
            or so.bt_jobs_b_shared(J_B)
            != derive_b_jobs_shape(1, J_B)["dynamic_shared"]):
        raise RuntimeError("csrc/jobs.cu and align/n_device.py disagree on "
                           "K9's launch shape")


def derive_b_jobs(out_a: dict, gated: torch.Tensor, base_qual: torch.Tensor,
                  base_plen: torch.Tensor, qual_rounds: torch.Tensor, *,
                  J: int, jrc: int, n: int, s: int, qt: int, maxbts: int,
                  maq: bool, norc: bool, nofw: bool) -> torch.Tensor:
    """K9: derive_b_jobs_plain's table.  Launches csrc/jobs.cu's
    derive_b_jobs_kernel on CUDA tensors, a warp per lane
    (derive_b_jobs_shape), which builds the lane's J rows in shared memory,
    its jobs in slot order, and stores them in 16-byte stores."""
    a = {k: out_a[k] for k in _A_KEYS}
    if kernels.all_on_cpu(*a.values(), gated, base_qual, base_plen,
                          qual_rounds):
        return derive_b_jobs_plain(
            a, gated, base_qual, base_plen, qual_rounds, J=J, jrc=jrc, n=n,
            s=s, qt=qt, maxbts=maxbts, maq=maq, norc=norc, nofw=nofw)
    dev = base_plen.device
    B, L = base_qual.shape
    for k in ("result", "mode", "npart", "part_job", "part_n", "part_pos",
              "part_refc"):
        kernels.check(a[k], k, torch.int32, None, dev)
    kernels.check(a["overflow"], "overflow", torch.bool, 1, dev)
    kernels.check(gated, "gated", torch.bool, 1, dev)
    kernels.check(base_qual, "base_qual", torch.int8, 2, dev)
    kernels.check(base_plen, "base_plen", torch.int32, 1, dev)
    kernels.check(qual_rounds, "qual_rounds", torch.int32, 1, dev)
    if (any(a[k].shape[0] != B for k in _A_KEYS) or gated.shape[0] != B
            or base_plen.shape[0] != B or qual_rounds.shape[0] != 256
            or a["part_job"].shape[1:] != (P_MAX,)
            or a["part_n"].shape[1:] != (P_MAX,)
            or a["part_pos"].shape[1:] != (3 * P_MAX,)
            or a["part_refc"].shape[1:] != (3 * P_MAX,)):
        raise ValueError("launch A's outputs, gated and the base arrays "
                         "disagree on their shapes")
    derive_b_jobs_shape(B, J)
    out = torch.empty((B, J, NJF), dtype=torch.int32, device=dev)
    if B:
        _check_layout()
        _check_b_shape(kernels.lib())
        kernels.launch("derive_b_jobs", "bt_derive_b_jobs",
                       *(a[k].data_ptr() for k in _A_KEYS),
                       gated.data_ptr(), base_qual.data_ptr(),
                       base_plen.data_ptr(), qual_rounds.data_ptr(), B, L, J,
                       jrc, n, s, qt, maxbts, int(maq), int(norc),
                       int(nofw), out.data_ptr(), device=dev)
    return out


# ---------------------------------------------------------------------------
# The aligner
# ---------------------------------------------------------------------------

class DeviceNAligner(DeviceDFSAligner):
    """-n mode aligner: launches A and B of the DFS machine on `device`
    (default CUDA), K9 between them, one download at the end, and the
    per-read host-oracle re-run of lanes that overflow in either launch
    (counted in dfs_device.FALLBACKS)."""

    def __init__(self, idx_fw: EbwtIndex, idx_bw: EbwtIndex, policy,
                 seed_mms: int = 2, seed_len: int = 28,
                 qual_thresh: int = 70, maxbts: int = 125,
                 maq_round: bool = True, nofw: bool = False,
                 norc: bool = False, global_seed: int = 0,
                 max_steps: int = 60000, compact: bool | None = None,
                 device=None):
        super().__init__(idx_fw, idx_bw, policy, v=0, nofw=nofw, norc=norc,
                         global_seed=global_seed, max_steps=max_steps,
                         compact=compact, device=device)
        self.n_mms = seed_mms
        self.seed_len = seed_len
        self.qt = qual_thresh
        self.maxbts = maxbts
        self.maq = maq_round
        self.qual_rounds = torch.from_numpy(
            QUAL_ROUNDS.astype(np.int32)).to(self.pair.device)

    def _oracle_aligner(self):
        if self._oracle is None:
            from .drivers import OracleAligner
            from .golden import GoldenFM
            self._oracle = OracleAligner(
                GoldenFM(self.idx_fw), GoldenFM(self.idx_bw), self.policy,
                mode="n", nofw=self.nofw, norc=self.norc,
                global_seed=self.global_seed, seed_mms=self.n_mms,
                seed_len=self.seed_len, qual_thresh=self.qt,
                maxbts=self.maxbts, maq_round=self.maq)
        return self._oracle

    def align_batch(self, reads) -> list:
        """The exact gate, then the two launches.  Phase 1 of -n reports
        nothing for a read shorter than 4 bases (search_seeded_phase1.c;
        the host oracle's _run_n), so the gate leaves such reads to the
        launches, whose job table gates them.  The reference's device
        engine lets the gate report them (ROADMAP, queue 3)."""
        if not reads:
            return []
        return self._exact_gate(reads, self._align_batch_n, min_len=4)

    def _align_batch_n(self, reads) -> list:
        """n_device.py:486-591 _align_batch_fused on one stream: launch A
        (K6, K7), K9 and K6 on A's base arrays, launch B (K7) from A's
        counts, K8 on both, then one download."""
        dev = self.pair.device
        B = len(reads)
        L = _len_bucket(max(max(len(r.seq) for r in reads), self.seed_len))
        fc = self.pair.ftab_chars
        jobs_a, _J_A, gated, jrc, _jfw = build_n_jobs_a_vec(
            reads, self.n_mms, self.seed_len, self.qt, self.maxbts,
            self.maq, self.nofw, self.norc, L)
        seeds_np = fill_seed_caches(reads, self.global_seed)
        seeds = torch.from_numpy(seeds_np.astype(np.int64)).to(dev)
        kw = dict(n_k=min(self.policy.n, INF32),
                  m_max=min(self.policy.max, INF32),
                  max_steps=self.max_steps)
        out_a, _ = run_machine(
            self.pair, upload_jobs(jobs_a, fc, dev), seeds,
            torch.zeros(B, dtype=torch.int32, device=dev), **kw)
        hits_a, _pa, nh_a = pack_hits(out_a)
        lane = [out_a["overflow"], out_a["count"], out_a["result"]]
        hits_b = nh_b = None
        if self.n_mms > 0:
            base = [torch.from_numpy(np.ascontiguousarray(jobs_a[k])).to(dev)
                    for k in ("base_codes", "base_qual", "base_plen")]
            scal_b = derive_b_jobs(
                out_a, torch.from_numpy(gated).to(dev), base[1], base[2],
                self.qual_rounds, J=J_B, jrc=jrc, n=self.n_mms,
                s=self.seed_len, qt=self.qt, maxbts=self.maxbts,
                maq=self.maq, norc=self.norc, nofw=self.nofw)
            scal_b, qqp_b = derive_rows(scal_b, *base, fc)
            out_b, _ = run_machine(self.pair, {"scal": scal_b, "qqp": qqp_b},
                                   seeds, out_a["count"], **kw)
            hits_b, _pb, nh_b = pack_hits(out_b)
            lane += [out_b["overflow"], out_b["count"]]
        lane = torch.stack([t.to(torch.int64) for t in lane]).cpu().numpy()
        return self._assemble_n(reads, hits_a.cpu().numpy(),
                                nh_a.cpu().numpy(),
                                None if hits_b is None else
                                (hits_b.cpu().numpy(), nh_b.cpu().numpy()),
                                lane, seeds_np, gated)

    def _assemble_n(self, reads, hits_a, nh_a, b_hits, lane, seeds, gated):
        """n_device.py:609-644: gated reads report nothing; an overflow in
        either launch sends the read to the host oracle; otherwise A's hits
        and then, when A ended without a stop (result 0), B's, with B's
        count."""
        ovf = lane[0].astype(bool)
        if b_hits is not None:
            ovf = ovf | lane[3].astype(bool)
            bounds_b, mk_b = decode_hit_cols(*b_hits)
        bounds_a, mk_a = decode_hit_cols(hits_a, nh_a)
        count = lane[1].tolist()
        res_a = lane[2].tolist()
        count_b = lane[4].tolist() if b_hits is not None else None
        seeds_l = seeds.tolist()
        finish = self.policy.finish
        results = []
        for b, read in enumerate(reads):
            if gated[b]:
                results.append(finish([], 0, seeds_l[b]))
                continue
            if ovf[b]:
                FALLBACKS["lanes"] += 1
                results.append(self._oracle_aligner().align_read(read))
                continue
            hits = [mk_a(read, j) for j in range(bounds_a[b],
                                                 bounds_a[b + 1])]
            c = count[b]
            if b_hits is not None and res_a[b] == 0:
                hits += [mk_b(read, j) for j in range(bounds_b[b],
                                                      bounds_b[b + 1])]
                c = count_b[b]
            results.append(finish(hits, c, seeds_l[b]))
        return results
