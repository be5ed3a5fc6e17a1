"""Vectorized host-side job-table construction for the DFS machine.

A port of bowtie_tpu/align/dfs_jobs.py.  The host fills the scalar job
fields of every (lane, job) with numpy array ops and attaches the base
read arrays; the by-depth query/qual/penalty rows and the N gates are
always derived on the device (align/dfs_device.py derive_rows, K6), or on
the CPU by its plain version.

Coordinate identities the derivation uses (qd[d] = search-query char at
depth d, i.e. position qlen-1-d of the possibly-reversed/truncated query;
set_query semantics at backtrack_oracle.set_query):

  (ebwt_fw=1, fw=1): qd[d] = fw[qs-1-d]          quald[d] = q[qs-1-d]
  (ebwt_fw=1, fw=0): qd[d] = comp(fw[plen-qs+d]) quald[d] = q[plen-qs+d]
  (ebwt_fw=0, fw=1): qd[d] = fw[plen-qs+d]       quald[d] = q[plen-qs+d]
  (ebwt_fw=0, fw=0): qd[d] = comp(fw[qs-1-d])    quald[d] = q[qs-1-d]

(complement applies to the rc-based variants, i.e. fw=0.)

where qs = search qlen (min(plen, seed) for set_qlen jobs).
"""
from __future__ import annotations

import numpy as np

from .dfs_device import INF32, JOB_FIELDS


def read_matrices(reads, L: int):
    """Left-aligned fw-code and qual matrices + lengths."""
    B = len(reads)
    fwm = np.full((B, L), 4, dtype=np.int8)
    qm = np.zeros((B, L), dtype=np.int16)
    lens = np.zeros(B, dtype=np.int32)
    for b, r in enumerate(reads):
        n = len(r.seq)
        lens[b] = n
        fwm[b, :n] = r.codes_fw[:L]
        qm[b, :n] = np.frombuffer(r.qual, dtype=np.uint8)[:L]
    return fwm, qm - 33, lens


def empty_jobs_vec(B: int, J: int):
    """Scalar job table: one [B, J] int32 array per field."""
    return {f: np.zeros((B, J), dtype=np.int32) for f in JOB_FIELDS}


def attach_base(jobs, fwm, qm, lens):
    """Base read arrays for device-side row derivation."""
    jobs["base_codes"] = fwm
    jobs["base_qual"] = np.clip(qm, 0, 127).astype(np.int8)
    jobs["base_plen"] = lens
    return jobs


def fill_job_vec(jobs, j, lens, qs, *, fw, ebwt_fw, offs, valid=None,
                 report_exacts=True, report_partials=0,
                 half_and_half=False, max_bts=INF32, consider_quals=False,
                 qual_thresh=INF32, reset_rng=True, maq=True):
    """Fill job column j for every lane at once.

    offs: 6-tuple of per-lane int arrays (or scalars) —
    (d5, d3, unrev, rev1, rev2, rev3).  qs: per-lane search qlen.  The
    N gates (ns_gate, ns_ftab) stay 0: derive_rows computes them."""
    B = lens.shape[0]
    qs = np.broadcast_to(np.asarray(qs, np.int32), (B,))
    d5, d3, unrev, rev1, rev2, rev3 = [
        np.broadcast_to(np.asarray(o, np.int32), (B,)) for o in offs]
    jobs["valid"][:, j] = 1 if valid is None else valid.astype(np.int32)
    jobs["qlen"][:, j] = qs
    jobs["ebwt_fw"][:, j] = int(ebwt_fw)
    jobs["fw"][:, j] = int(fw)
    jobs["d5"][:, j] = d5
    jobs["d3"][:, j] = d3
    jobs["unrev"][:, j] = unrev
    jobs["rev1"][:, j] = rev1
    jobs["rev2"][:, j] = rev2
    jobs["rev3"][:, j] = rev3
    jobs["report_exacts"][:, j] = int(report_exacts)
    jobs["report_partials"][:, j] = report_partials
    jobs["half_and_half"][:, j] = int(half_and_half)
    jobs["max_bts"][:, j] = max_bts
    jobs["consider_quals"][:, j] = int(consider_quals)
    jobs["qual_thresh"][:, j] = qual_thresh
    jobs["reset_rng"][:, j] = int(reset_rng)
    jobs["maq_round"][:, j] = int(maq)
    jobs["collect_partials"][:, j] = int(report_partials > 0)


def build_v_jobs_vec(reads, v: int, nofw: bool, norc: bool, L: int):
    """Job tables for -v 1/2/3: the phases of search_1mm_phase1/2.c and
    search_23mm_phase1/2/3.c, one job per (phase, strand), in the order
    OracleAligner._run_v1 / _run_v23 runs them.  Returns (jobs, J)."""
    fwm, qm, lens = read_matrices(reads, L)
    s = lens
    s3 = s >> 1
    s5 = s3 + (s & 1)
    if v == 1:
        seq = []
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=True, offs=(0, 0, s, s, s, s)))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=True,
                            offs=(0, 0, s, s, s, s)))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=True,
                            offs=(0, 0, s5, s, s, s), report_exacts=False))
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=True,
                            offs=(0, 0, s5, s, s, s), report_exacts=False))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=False,
                            offs=(0, 0, s3, s, s, s), report_exacts=False))
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=False,
                            offs=(0, 0, s3, s, s, s), report_exacts=False))
    else:
        two = v == 2
        m2 = s if two else s5
        m3 = s if two else s3
        z = np.zeros_like(s)
        seq = []
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=True, offs=(0, 0, s, s, s, s)))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=True,
                            offs=(0, 0, s5, s5, m2, s)))
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=False,
                            offs=(0, 0, s5, s5, m2, s),
                            report_exacts=False))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=False,
                            offs=(0, 0, s3, s3, m3, s),
                            report_exacts=False))
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=True,
                            offs=(0, 0, s3, s3, m3, s),
                            report_exacts=False))
        if not nofw:
            seq.append(dict(fw=True, ebwt_fw=True, half_and_half=True,
                            offs=(s3, s, z, s3 if two else z,
                                  s if two else s3, s)))
        if not norc:
            seq.append(dict(fw=False, ebwt_fw=True, half_and_half=True,
                            offs=(s5, s, z, s5 if two else z,
                                  s if two else s5, s)))
    J = len(seq)
    jobs = empty_jobs_vec(len(reads), J)
    for j, spec in enumerate(seq):
        fill_job_vec(jobs, j, lens, lens, **spec)
    attach_base(jobs, fwm, qm, lens)
    return jobs, J


def build_n_jobs_a_vec(reads, n: int, s_seed: int, qt: int, mb: int,
                       maq: bool, nofw: bool, norc: bool, L: int):
    """Launch-A job tables for -n mode (phases 1, 2 and the phase-3
    tail of OracleAligner._run_n).  Returns (jobs, J, gated, j_pam_rc,
    j_pam_fw)."""
    B = len(reads)
    fwm, qm, lens = read_matrices(reads, L)
    plen = lens
    qs = np.minimum(plen, s_seed)
    eff = np.minimum(qs, s_seed)           # seed length actually used
    e5 = (eff >> 1) + (eff & 1)
    e3 = eff >> 1
    z = np.zeros_like(plen)

    def so(v, thr):                        # seed-offs helper
        return np.where(np.full(B, n) > thr, v, eff).astype(np.int32)

    offs15 = (z, z, so(e5, 0), so(e5, 1), so(e5, 2), so(e5, 3))
    offs3 = (z, z, so(e3, 0), so(e3, 1), so(e3, 2), so(e3, 3))

    # phase-1 gates
    slen = np.minimum(plen, s_seed)
    seed_n = (fwm == 4) & (np.arange(L)[None, :] < slen[:, None])
    gated = (plen < 4) | (seed_n.sum(axis=1) > n)
    ok = ~gated

    specs = []
    kw = dict(consider_quals=True, qual_thresh=qt, max_bts=mb, maq=maq)
    if not nofw:    # btf1: exact fw, quals off
        specs.append(dict(fw=True, ebwt_fw=True,
                          offs=(z, plen, plen, plen, plen, plen),
                          consider_quals=False, qual_thresh=qt,
                          max_bts=mb, maq=maq))
    if not norc:    # bt1
        specs.append(dict(fw=False, ebwt_fw=True, offs=offs15, **kw))
    if not nofw:    # btf2
        specs.append(dict(fw=True, ebwt_fw=False, offs=offs15,
                          report_exacts=False, **kw))
    j_pam_rc = j_pam_fw = -1
    if n > 0:
        if not norc:    # btr2: rc partial collection
            j_pam_rc = len(specs)
            specs.append(dict(fw=False, ebwt_fw=False, offs=offs3,
                              report_exacts=False, report_partials=n, **kw))
        if not nofw:    # btf3: fw partial collection
            j_pam_fw = len(specs)
            specs.append(dict(fw=True, ebwt_fw=True, offs=offs3,
                              report_partials=n, **kw))
    J = len(specs)
    jobs = empty_jobs_vec(B, J)
    for j, spec in enumerate(specs):
        qlen_j = qs if spec.get("report_partials", 0) > 0 else plen
        fill_job_vec(jobs, j, lens, qlen_j, valid=ok, **spec)
    attach_base(jobs, fwm, qm, lens)
    return jobs, J, gated, j_pam_rc, j_pam_fw
