"""The CUDA kernels (csrc/exact.cu, csrc/dfs.cu, csrc/jobs.cu, csrc/best.cu,
csrc/ilv.cu, csrc/sa.cu) against
their plain PyTorch versions, on the card: K2, K3 (walk and dense SA) and
K4 must agree element for element, also on an index whose SA sample is
thinned so that most walks pass MAX_WALK and end with ok=False, and on
the rows and strands of one CLI batch (K3 walk under -a -m 3, K4 under
-k 1); K15 (K2
and K3 fused, parallel/mesh.py) and the K3 remainder, also over a
two-entry mesh on one card; K12 (K2
with a per-lane choice of the forward or the mirror index); K6, K7 and
K8 (the DFS machine) on -v 1 / -v 2 / -n launch-A job tables, dense and
walk-left; K9 (the -n launch-B job table) and K6/K7 on the tables it
derives; K6 and K9 of csrc/jobs.cu with no stack, K6 on tables of 100
and 250 bp reads (L 128, 256), K9 on lanes that all take 32 partials at
-n 1-3, --norc and --nofw, on 1, 5, 33 and 8,192 lanes; K7 at the edges of its launch shape and layouts (lane counts
around the warp, every lane overflowing H_MAX, S_MAX or P_MAX, a long
walk-left lane, a budget that stops lanes mid-search, launch B with
launch A's counts, L = 128, two mesh shards); K10 and K11 (the best-first machine) under -v and seeded
policies, dense and walk-left; K10r (its record mode, the paired
recorder's fused fw-DAG + rc-DAG run) capped and uncapped, and at rec_cap
1 on the lanes the recorder's phase 0 (K12) leaves; K14 (its paired
record mode, the V2 recorder's merged-mate DAG) under -v 1, -n 2 and
-n 3, dense and walk-left; K13 (the V1
interleave, chase and rescue of csrc/ilv.cu) on the recorder's streams,
dense and walk-left, --fr and --ff, at 1, 31, 33, 133 and 8,192 pairs and
on windows staged in pieces, with no stack; K16 (the
prefix-doubling round of csrc/sa.cu) round for round on texts of thousands
of look-back tiles, at its tile edges, all-A and period 3, and on ranks
under BIG = 2^31 - 1, and the SA it builds against SA-IS; K8 on synthetic
machine outputs at its edges; and the CLI on the card (-v 0/1/2/3, -n,
--best, -M, --sanity, --stats, paired input with -p, and bowtie-build
--jax-sa) must write what it writes on the CPU.
These tests need an NVIDIA GPU with nvcc and skip without one; on the
card (where JAX, which tests/conftest.py imports, may be absent) run

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import contextlib
import dataclasses
import io
import os
import re

import numpy as np
import pytest
import torch

from bowtie_tpu_torch import kernels
from bowtie_tpu_torch.align import exact as tex
from bowtie_tpu_torch.align.pipeline import one_row, one_row_plain
from bowtie_tpu_torch.index.arrays import from_ebwt
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    kernels.build()
    idx = read_ebwt(BASE)
    refs = unpack_reference(*read_bitpair_reference(BASE))
    return idx, refs


def _reads(refs, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        r = refs[k % len(refs)]
        ln = int(rng.integers(1, 45))
        p = int(rng.integers(0, max(1, len(r) - ln)))
        q = r[p:p + ln].copy()
        if k % 4 == 1:
            q[int(rng.integers(len(q)))] = 4
        if k % 4 == 2:
            q = rng.integers(0, 4, ln).astype(np.uint8)
        out.append(np.minimum(q, 4).astype(np.uint8))
    return out


def thinned(fm, by=256):
    """fm with only every `by`-th SA sample kept (offRate raised by
    log2 `by`), so that most walks pass MAX_WALK."""
    return dataclasses.replace(
        fm, offs=fm.offs[::by].contiguous(),
        off_rate=fm.off_rate + by.bit_length() - 1, kernel_view=None)


@pytest.mark.parametrize("form", ["walk", "dense", "thin"])
def test_kernels_match_plain(card, form):
    idx, refs = card
    dense = form == "dense"
    fm = from_ebwt(idx, device="cuda", dense_sa=dense)
    if form == "thin":
        fm = thinned(fm)
    mat, lens = tex.right_align(_reads(refs, 20000, int(dense)))
    m, ln = torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda()
    kernels.reset_launches()
    top, bot = tex.exact_ranges(fm, m, ln)
    ptop, pbot = tex.exact_ranges_plain(fm, m, ln)
    assert torch.equal(top, ptop) and torch.equal(bot, pbot)
    rows = torch.arange(idx.bwt_len, device="cuda")
    off, ok = tex.resolve_rows(fm, rows)
    poff, pok = tex.resolve_rows_plain(fm, rows)
    assert torch.equal(off, poff) and torch.equal(ok, pok)
    assert bool(ok.all()) == (form != "thin")
    seeds = torch.randint(0, 2**32, (len(lens),), device="cuda")
    res = one_row(fm, m, ln, seeds)
    assert torch.equal(res, one_row_plain(fm, m, ln, seeds))
    if form == "thin":
        assert 0 < int(res[2][res[0] > 0].sum()) < int((res[0] > 0).sum())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["exact_ranges"] == 1
    assert kernels.LAUNCHES["one_row"] == 1
    assert kernels.LAUNCHES["resolve_rows_sa" if dense
                            else "resolve_rows_walk"] == 1


@pytest.mark.parametrize("form", ["walk", "dense", "thin"])
def test_align_step_matches_plain(card, form):
    """K15 (parallel/mesh.py align_step) against its plain version and
    against K2 followed by K3; the K3 remainder (bwt_rows_offsets)
    against its plain version; a mesh of two entries on cuda:0 against
    one launch."""
    from bowtie_tpu_torch.parallel import mesh as tm
    idx, refs = card
    fm = from_ebwt(idx, device="cuda", dense_sa=form == "dense")
    if form == "thin":
        fm = thinned(fm)
    reads = _reads(refs, 20001, 3)
    reads[::50] = [np.zeros(0, np.uint8)] * len(reads[::50])
    mat, lens = tex.right_align(reads)
    m, ln = torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda()
    kernels.reset_launches()
    got = tm.align_step(fm, m, ln)
    for a, b in zip(got, tm.align_step_plain(fm, m, ln)):
        assert torch.equal(a, b)
    top, bot = tex.exact_ranges(fm, m, ln)
    has = bot > top
    off, ok = tex.resolve_rows(fm, torch.where(has, top, 0))
    assert torch.equal(got[0], top) and torch.equal(got[1], bot)
    assert torch.equal(got[2], torch.where(has, off, 0xFFFFFFFF))
    assert torch.equal(got[3], ok & has)
    assert 1000 < int(has.sum()) < len(reads) - 1000
    valid = has & (torch.arange(len(reads), device="cuda") % 3 > 0)
    ro = tex.bwt_rows_offsets(fm, top, valid)
    for a, b in zip(ro, tex.bwt_rows_offsets_plain(fm, top, valid)):
        assert torch.equal(a, b)
    assert bool(ro[1].any()) and not bool(ro[1][~valid].any())
    mesh = tm.make_mesh(["cuda:0", "cuda:0"])
    reps = tm.replicate_index(fm, mesh)
    assert list(reps.values()) == [fm]
    shards, B = tm.shard_reads(mesh, mat, lens)
    sharded = tm.sharded_align_step(reps, shards)
    for a, b in zip(sharded, got):
        assert torch.equal(a[:B], b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["align_step"] == 3
    assert kernels.LAUNCHES["bwt_rows_offsets"] == 1


@pytest.mark.parametrize("short", [False, True], ids=["mixed", "short"])
def test_exact_cat_matches_plain(card, short):
    """K12 equals its plain version: lanes on the forward and the mirror
    index mixed in one launch, reads with Ns, reads shorter than
    ftabChars (short: every read, so that the matrix has no ftab
    columns)."""
    from bowtie_tpu_torch.align.dfs_device import build_fmpair
    from bowtie_tpu_torch.align.pe_device import (exact_ranges_cat,
                                                  exact_ranges_cat_plain)
    idx, refs = card
    pair = build_fmpair(idx, read_ebwt(BASE + ".rev"), "cuda")
    reads = _reads(refs, 20000, 5)
    rng = np.random.default_rng(6)
    efw = rng.integers(0, 2, len(reads)).astype(np.uint8)
    if short:
        reads = [q[:k % pair.ftab_chars] for k, q in enumerate(reads)]
    # a mirror lane consumes its read forward
    reads = [q if e else q[::-1].copy() for q, e in zip(reads, efw)]
    mat, lens = tex.right_align(reads)
    args = (torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda(),
            torch.from_numpy(efw).cuda())
    kernels.reset_launches()
    top, bot = exact_ranges_cat(pair, *args)
    ptop, pbot = exact_ranges_cat_plain(pair, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["exact_ranges_cat"] == 1
    assert torch.equal(top, ptop) and torch.equal(bot, pbot)
    hit = (bot > top).cpu().numpy()
    assert hit[efw == 1].sum() > 1000 and hit[efw == 0].sum() > 1000
    assert (~hit).sum() > 1000


@pytest.mark.parametrize("form", ["dense", "walk"])
def test_dfs_kernels_match_plain(card, tmp_path, form):
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.io.readers import ReadSource
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    pair = td.build_fmpair(idx, read_ebwt(BASE + ".rev"), "cuda",
                           dense_sa=form == "dense")
    fq = tmp_path / "r.fq"
    seqs = ["".join("ACGTN"[c] for c in q) for q in _reads(refs, 3000, 7)]
    fq.write_text("".join(
        f"@r{i}\n{s}\n+\n"
        + "".join(chr(33 + (5 * i + 3 * j) % 41) for j in range(len(s)))
        + "\n" for i, s in enumerate(seqs)))
    reads = list(ReadSource([str(fq)]).records())
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).cuda()
    c0 = torch.zeros(len(reads), dtype=torch.int32, device="cuda")
    runs = [(tj.build_v_jobs_vec(reads, 1, False, False, 64)[0], 1,
             td.INF32),
            (tj.build_v_jobs_vec(reads, 2, False, True, 64)[0], td.INF32, 3),
            (tj.build_n_jobs_a_vec(reads, 2, 28, 70, 125, True, False, False,
                                   64)[0], td.INF32, td.INF32)]
    kernels.reset_launches()
    for jobs, n_k, m_max in runs:
        dev = td.upload_jobs(jobs, idx.ftab_chars, "cuda")
        base = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
            np.stack([jobs[f] for f in td.JOB_FIELDS], -1).astype(np.int32),
            jobs["base_codes"], jobs["base_qual"], jobs["base_plen"])]
        want = td.derive_rows_plain(*base, idx.ftab_chars)
        assert torch.equal(dev["scal"], want[0])
        assert torch.equal(dev["qqp"], want[1])
        out, _ = td.run_machine(pair, dev, seeds, c0, n_k=n_k, m_max=m_max,
                                max_steps=20000)
        pout, _ = td.run_machine_plain(pair, dev, seeds, c0, n_k=n_k,
                                       m_max=m_max, max_steps=20000)
        assert bool((pout["mode"] == td.M_DONE).all())
        for k in td.OUT_KEYS:
            assert torch.equal(out[k], pout[k]), k
        for a, b in zip(td.pack_hits(out), td.pack_hits_plain(pout)):
            assert torch.equal(a, b)
        assert int(out["nhits"].sum()) > 0
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["derive_rows"] == 3
    assert kernels.LAUNCHES["dfs_machine"] == 3
    assert kernels.LAUNCHES["dfs_pack"] == 3


def _n_reads(refs, n, seed, path):
    """Reads of _reads' mix as FASTQ with varied qualities, read back."""
    from bowtie_tpu_torch.io.readers import ReadSource
    seqs = ["".join("ACGTN"[c] for c in q) for q in _reads(refs, n, seed)]
    path.write_text("".join(
        f"@r{i}\n{s}\n+\n"
        + "".join(chr(35 + (5 * i + 3 * j) % 39) for j in range(len(s)))
        + "\n" for i, s in enumerate(seqs)))
    return list(ReadSource([str(path)]).records())


@pytest.mark.parametrize("n,s,nofw,norc,maq", [
    (2, 28, False, False, True), (3, 20, False, False, False),
    (1, 28, True, False, True), (2, 15, False, True, True)],
    ids=["n2", "n3_l20_nomaq", "n1_nofw", "n2_l15_norc"])
def test_n_kernels_match_plain(card, tmp_path, n, s, nofw, norc, maq):
    """K9 and launch B's K6/K7 equal their plain versions on the card, on
    the outputs of launch A run on the card."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.align import n_device as tn
    from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    pair = td.build_fmpair(idx, read_ebwt(BASE + ".rev"), "cuda")
    reads = _n_reads(refs, 3000, 11, tmp_path / "r.fq")
    jobs, _J, gated, jrc, _jfw = tj.build_n_jobs_a_vec(
        reads, n, s, 70, 125, maq, nofw, norc, 64)
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).cuda()
    c0 = torch.zeros(len(reads), dtype=torch.int32, device="cuda")
    kw = dict(n_k=td.INF32, m_max=td.INF32, max_steps=60000)
    kernels.reset_launches()
    out_a, _ = td.run_machine(pair, td.upload_jobs(jobs, idx.ftab_chars,
                                                   "cuda"), seeds, c0, **kw)
    base = [torch.from_numpy(np.ascontiguousarray(jobs[k])).cuda()
            for k in ("base_codes", "base_qual", "base_plen")]
    bkw = dict(J=tn.J_B, jrc=jrc, n=n, s=s, qt=70, maxbts=125, maq=maq,
               norc=norc, nofw=nofw)
    args = (out_a, torch.from_numpy(gated).cuda(), base[1], base[2],
            torch.from_numpy(QUAL_ROUNDS.astype(np.int32)).cuda())
    scal = tn.derive_b_jobs(*args, **bkw)
    assert torch.equal(scal, tn.derive_b_jobs_plain(*args, **bkw))
    assert int(scal[..., td.JOB_FIELDS.index("npremut")].sum()) > 0
    scal, qqp = td.derive_rows(scal, *base, idx.ftab_chars)
    out_b, _ = td.run_machine(pair, {"scal": scal, "qqp": qqp}, seeds,
                              out_a["count"], **kw)
    pout, _ = td.run_machine_plain(pair, {"scal": scal, "qqp": qqp}, seeds,
                                   out_a["count"], **kw)
    assert bool((pout["mode"] == td.M_DONE).all())
    for k in td.OUT_KEYS:
        assert torch.equal(out_b[k], pout[k]), k
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["derive_b_jobs"] == 1
    assert kernels.LAUNCHES["dfs_machine"] == 2


@pytest.mark.parametrize("kw,pol,dense", [
    (dict(v=2, strata=True), (3, None, False), True),
    (dict(v=3), (1, 1, False), False),
    (dict(v=1, all_hits=True), (None, None, False), True),
    (dict(mode="n", seed_mms=2, seed_len=20), (1, 1, True), True),
    (dict(mode="n", seed_mms=3, strata=True, maxbts=2), (2, None, False),
     False)], ids=["v2_k3_strata", "v3_m1_walk", "v1_a", "n2_M1_l20",
                   "n3_strata_k2_maxbts2_walk"])
def test_best_kernels_match_plain(card, tmp_path, kw, pol, dense):
    """K10 equals its plain version on every lane the plain version
    finishes without overflow (a lane either flags for overflow is re-run
    on the host engine), overflow flags alike; K11 equals its plain
    version on K10's outputs."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.align.policy import INF, KPolicy
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    k, m, sample = pol
    policy = KPolicy(INF if k is None else k, INF if m is None else m,
                     sample_max=sample)
    reads = [r for r in _n_reads(refs, 600, 13, tmp_path / "r.fq")
             if 4 <= len(r.seq)]
    al = tbd.DeviceBestAligner(idx, read_ebwt(BASE + ".rev"), policy,
                               compact=not dense, device="cuda", **kw)
    L = 64
    seeds = fill_seed_caches(reads, 0)
    host = al.hostinit.build(reads, L, seeds)
    skw = dict(L=L, nd=al.nd, ndt=al.ndt, maxbts=al.maxbts,
               n_k=al._sink_n(), m_max=min(policy.max, tbd.INF32),
               strata=al.strata, qual_lim=al.qual_lim,
               qual_order=al.qual_order, bt_on=al.bt_on,
               has_seeded=al.mode == "n", max_steps=60000)
    kernels.reset_launches()
    out, _ = tbd.run_machine(al.pair, al.hostinit.cfg, host,
                             torch.from_numpy(seeds.astype(np.int64)).cuda(),
                             **skw)
    st = tbd.init_state(len(reads), L, al.nd, al.ndt, seeds, host,
                        al.maxbts, "cuda")
    cfg = {c: torch.from_numpy(v.astype(np.int64)).cuda()
           for c, v in al.hostinit.cfg.items()}
    skw.pop("max_steps")
    skw.pop("maxbts")
    st, _ = tbd.run_machine_plain(al.pair, cfg, st, chunk=60000,
                                  nfrag=al.pair.nfrag,
                                  fc=al.pair.ftab_chars, **skw)
    assert bool((st["mode"] == tbd.M_DONE).all())
    assert torch.equal(out["overflow"], st["overflow"])
    ok = ~st["overflow"]
    for key in tbd.OUT_KEYS:
        assert torch.equal(out[key][ok].long(), st[key][ok].long()), key
    assert int(out["nhits"].sum()) > 0
    packed = tbd.best_pack(out)
    assert torch.equal(packed, tbd.best_pack_plain(
        {key: v.cpu() for key, v in out.items()}).cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["best_machine"] == 1
    assert kernels.LAUNCHES["best_pack"] == 1


def _cli_batch(refs, tmp_path, n=8192, seed=9):
    """One CLI batch of n seeded reads of _reads' mix, as the CLI reads
    them (FASTQ through ReadSource)."""
    from bowtie_tpu_torch.io.readers import ReadSource
    path = tmp_path / "batch.fq"
    path.write_text("".join(
        f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(
            "".join("ACGTN"[c] for c in q) for q in _reads(refs, n, seed))))
    return list(ReadSource([str(path)]).records())


@pytest.mark.parametrize("form", ["walk", "thin"])
def test_walk_on_cli_a_batch(card, tmp_path, monkeypatch, form):
    """K3 walk on the rows ExactAligner hands it for one CLI batch under
    -a -m 3 (every row of every range, in chase order), equal to its
    plain version row for row; each warp's iterations cover the rows'
    steps (a lane slot a step and one a row)."""
    from bowtie_tpu_torch.align import pipeline
    from bowtie_tpu_torch.align.policy import INF, KPolicy
    idx, refs = card
    fm = from_ebwt(idx, device="cuda")
    if form == "thin":
        fm = thinned(fm)
    seen, real = [], pipeline.resolve_rows
    monkeypatch.setattr(pipeline, "resolve_rows", lambda f, rows: (
        seen.append(rows.clone()), real(f, rows))[1])
    al = pipeline.ExactAligner(fm, idx, KPolicy(khits=INF, mhits=3))
    al.align_batch(_cli_batch(refs, tmp_path))
    (rows,) = seen
    assert rows.numel() > 50_000
    off, ok = tex.resolve_rows(fm, rows)
    work = torch.zeros(2, rows.numel(), dtype=torch.int64, device="cuda")
    poff, pok = tex.resolve_rows_plain(fm, rows, work)
    assert torch.equal(off, poff) and torch.equal(ok, pok)
    assert bool(ok.all()) == (form == "walk")
    loff, lok, iters = tex.resolve_rows_lanes(fm, rows)
    assert torch.equal(loff, off) and torch.equal(lok, ok)
    assert 32 * int(iters.sum()) >= int(work[0].sum()) + rows.numel()


def test_one_row_on_cli_batch(card, tmp_path, monkeypatch):
    """K4 on the strands of one CLI -k 1 batch (8,192 reads, both
    strands, the reads' own seeds) equal to its plain version strand for
    strand, on the walk-left index and on the thinned one."""
    from bowtie_tpu_torch.align import pipeline
    from bowtie_tpu_torch.align.policy import KPolicy
    idx, refs = card
    fm = from_ebwt(idx, device="cuda")
    seen, real = [], pipeline.one_row
    monkeypatch.setattr(pipeline, "one_row", lambda *a: (
        seen.append([x.clone() for x in a[1:]]), real(*a))[1])
    pipeline.ExactAligner(fm, idx, KPolicy()).align_batch(
        _cli_batch(refs, tmp_path))
    (args,) = seen
    assert args[0].shape[0] == 16384
    for f in (fm, thinned(fm)):
        res = real(f, *args)
        assert torch.equal(res, one_row_plain(f, *args))
        assert int((res[0] > 0).sum()) > 5000


@pytest.mark.parametrize("args", [["-v", "0"], ["-v", "0", "-a", "-S"],
                                  ["-v", "1"], ["-v", "2", "-a", "-m", "3",
                                                "-S"],
                                  [], ["-n", "3", "-l", "20", "-a", "-m",
                                       "3", "-S"],
                                  ["-n", "1", "--nomaqround", "-e", "40",
                                   "--sanity", "--stats"],
                                  ["-v", "3", "-k", "2", "--best", "-S"],
                                  ["-n", "2", "-M", "1", "--best",
                                   "--sanity", "--stats"]],
                         ids=["k1", "a_S", "v1", "v2_a_m3_S", "n2_default",
                              "n3_l20_a_m3_S", "n1_sanity_stats",
                              "v3_k2_best_S", "n2_M1_sanity_stats"])
def test_cli_on_card_matches_cpu(card, tmp_path, args):
    from bowtie_tpu_torch.cli import align as cli
    idx, refs = card
    reads = tmp_path / "r.fq"
    reads.write_text("".join(
        f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(
            "".join("ACGTN"[c] for c in q) for q in _reads(refs, 500, 5))))
    outs = []
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"out.{dev}"
        with contextlib.redirect_stderr(io.StringIO()) as err:
            assert cli.main(args + [BASE, str(reads), str(out)],
                            device=dev) == 0
        body = [ln for ln in out.read_bytes().splitlines(keepends=True)
                if not ln.startswith(b"@PG")]   # @PG holds the argv
        outs.append((b"".join(body),
                     re.sub(r"wall time: .*", "", err.getvalue())))
    assert outs[0] == outs[1]


def _pairs(refs, n, seed, tmp_path, ff=False):
    """Seeded --fr pairs (with ff, --ff pairs) of _reads' genome:
    fragments of 60-200 bases, mates of 18-44 bases with 0-2 mismatches,
    every 6th pair with a random mate; written as -1/-2 FASTQ files and
    read back."""
    from bowtie_tpu_torch.io.readers import PairedReadSource
    rng = np.random.default_rng(seed)
    f1, f2 = [], []
    for k in range(n):
        r = refs[k % len(refs)]
        frag = int(rng.integers(60, min(201, len(r))))
        p = int(rng.integers(0, len(r) - frag + 1))
        l1, l2 = (int(x) for x in rng.integers(18, 45, 2))
        a = np.minimum(r[p:p + l1], 3).astype(np.uint8)
        b = np.minimum(r[p + frag - l2:p + frag], 3).astype(np.uint8)
        if not ff:
            b = (3 - b[::-1]).astype(np.uint8)
        if k % 6 == 5:
            b = rng.integers(0, 4, l2).astype(np.uint8)
        for q in (a, b):
            for _ in range(k % 3):
                q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        for f, q, m in ((f1, a, 1), (f2, b, 2)):
            qual = "".join(chr(33 + int(x)) for x in rng.integers(5, 41,
                                                                  len(q)))
            f.append(f"@p{k}/{m}\n{''.join('ACGTN'[c] for c in q)}\n+\n"
                     f"{qual}\n")
    m1, m2 = tmp_path / "m1.fq", tmp_path / "m2.fq"
    m1.write_text("".join(f1))
    m2.write_text("".join(f2))
    return list(PairedReadSource([str(m1)], [str(m2)]).pairs()), m1, m2


@pytest.mark.parametrize("kw,cap,dense", [
    (dict(mode="n", seed_mms=2), 12, True),
    (dict(mode="v", v=2), None, True),
    (dict(mode="n", seed_mms=3, seed_len=20), None, False),
    (dict(mode="v", v=3), 12, False),
    (dict(mode="n", seed_mms=2), 1, True)],
    ids=["n2_cap12", "v2_uncapped", "n3_l20_uncapped_walk",
         "v3_cap12_walk", "n2_cap1_after_phase0"])
def test_record_kernel_matches_plain(card, tmp_path, kw, cap, dense):
    """K10r equals its plain version on the recorder's fused lanes (every
    pair's four streams, fw-DAG and rc-DAG in one launch; at rec_cap 1 the
    lanes phase 0 leaves) on every lane the plain version finishes without
    overflow, overflow flags alike."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
    from bowtie_tpu_torch.align.policy import KPolicy
    idx, refs = card
    pairs, _m1, _m2 = _pairs(refs, 300, 17, tmp_path)
    # the -k 1 policy records at rec_cap 1, the lanes phase 0 leaves; the
    # other caps run every lane, as round 2 (uncapped) does
    al = DevicePairedBestAligner(idx, read_ebwt(BASE + ".rev"), refs,
                                 KPolicy(), compact=not dense, device="cuda",
                                 **kw)
    assert al.rec_cap == 1
    kernels.reset_launches()
    a = al.record_inputs(pairs, cap)
    assert kernels.LAUNCHES["exact_ranges_cat"] == (cap == 1)
    pair, cfg, host, seeds = a["args"]
    kernels.reset_launches()
    out, _ = tbd.run_machine(*a["args"], **a["kw"], rec_cap=cap)
    pkw = dict(a["kw"])
    maxbts = pkw.pop("maxbts")
    pkw.pop("max_steps")
    st = tbd.init_state(len(seeds), pkw["L"], pkw["nd"], pkw["ndt"],
                        seeds.cpu().numpy(), host, maxbts, "cuda")
    cfg_t = {c: torch.from_numpy(v.astype(np.int64)).cuda()
             for c, v in cfg.items()}
    st, _ = tbd.run_machine_plain(pair, cfg_t, st, chunk=60000,
                                  nfrag=pair.nfrag, fc=pair.ftab_chars,
                                  rec_cap=cap, **pkw)
    assert bool((st["mode"] == tbd.M_DONE).all())
    assert torch.equal(out["overflow"], st["overflow"])
    ok = ~st["overflow"]
    for key in ("hits", "nhits", "mode"):
        assert torch.equal(out[key][ok].long(), st[key][ok].long()), key
    assert int(out["nhits"].sum()) > 0
    if cap == 1:
        assert 0 < len(seeds) < 4 * len(pairs)
    else:
        assert len(seeds) == 4 * len(pairs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["best_record"] == 1
    assert kernels.LAUNCHES["best_machine"] == 0


@pytest.mark.parametrize("kw,cap", [
    (dict(mode="v", v=1), 8),
    (dict(mode="n", seed_mms=2), 8),
    (dict(mode="n", seed_mms=3), None)], ids=["v1_cap8", "n2_cap8",
                                              "n3_uncapped"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "walk"])
def test_pev2_kernel_matches_plain(card, tmp_path, kw, cap, dense):
    """K14 (best_machine_kernel's paired instantiation, the merged-mate
    DAG of the V2 recorder: 8, 12 and 16 outer drivers) equals its plain
    version on every lane the plain version finishes without overflow,
    overflow flags alike, and launches as "best_pev2" only; neither
    instantiation keeps a stack frame (the lane's state lives in
    registers, shared memory and the wrapper's scratch)."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.align.pev2_device import DevicePairedV2Aligner
    from bowtie_tpu_torch.align.policy import KPolicy
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    pairs, _m1, _m2 = _pairs(refs, 300, 31, tmp_path)
    al = DevicePairedV2Aligner(idx, read_ebwt(BASE + ".rev"), refs,
                               KPolicy(), compact=not dense, device="cuda",
                               better=True, **kw)
    s1 = fill_seed_caches([p[0] for p in pairs], 0)
    s2 = fill_seed_caches([p[1] for p in pairs], 0)
    a = al.machine.record_inputs(pairs, s1, s2)
    pair, cfg, host, seeds = a["args"]
    kernels.reset_launches()
    out, _ = tbd.run_machine(*a["args"], **a["kw"], rec_cap=cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["best_pev2"] == 1
    assert kernels.LAUNCHES["best_record"] == kernels.LAUNCHES[
        "best_machine"] == 0
    pkw = dict(a["kw"])
    maxbts = pkw.pop("maxbts")
    pkw.pop("max_steps")
    st = tbd.init_state(len(seeds), pkw["L"], pkw["nd"], pkw["ndt"],
                        seeds.cpu().numpy(), host, maxbts, "cuda")
    cfg_t = {c: torch.from_numpy(np.asarray(v).astype(np.int64)).cuda()
             for c, v in cfg.items()}
    st, _ = tbd.run_machine_plain(pair, cfg_t, st, chunk=60000,
                                  nfrag=pair.nfrag, fc=pair.ftab_chars,
                                  rec_cap=cap, **pkw)
    assert bool((st["mode"] == tbd.M_DONE).all())
    assert torch.equal(out["overflow"], st["overflow"])
    ok = ~st["overflow"]
    for key in ("hits", "nhits", "mode", "result", "count"):
        assert torch.equal(out[key][ok].long(), st[key][ok].long()), key
    assert int(out["nhits"].sum()) > 0
    assert len(seeds) == len(pairs)
    assert tbd.machine_local_bytes() == {"single": 0, "paired": 0}


def _pev2_against_plain(al, pairs, cap, budget):
    """K14 on the merged lanes of `pairs` and its plain version with
    `budget` iterations: equal on every lane the plain version finishes
    without overflow, overflow flags alike where it finishes.  -> (the
    kernel's outputs, the lanes compared)."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    s1 = fill_seed_caches([p[0] for p in pairs], 0)
    s2 = fill_seed_caches([p[1] for p in pairs], 0)
    a = al.machine.record_inputs(pairs, s1, s2)
    pair, cfg, host, seeds = a["args"]
    kernels.reset_launches()
    out, _ = tbd.run_machine(*a["args"], **a["kw"], rec_cap=cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["best_pev2"] == 1
    pkw = dict(a["kw"])
    maxbts = pkw.pop("maxbts")
    pkw.pop("max_steps")
    st = tbd.init_state(len(seeds), pkw["L"], pkw["nd"], pkw["ndt"],
                        seeds.cpu().numpy(), host, maxbts, "cuda")
    cfg_t = {c: torch.from_numpy(np.asarray(v).astype(np.int64)).cuda()
             for c, v in cfg.items()}
    st, _ = tbd.run_machine_plain(pair, cfg_t, st, chunk=budget,
                                  nfrag=pair.nfrag, fc=pair.ftab_chars,
                                  rec_cap=cap, **pkw)
    done = st["mode"] == tbd.M_DONE
    assert torch.equal(out["overflow"][done], st["overflow"][done])
    ok = done & ~st["overflow"]
    for key in ("hits", "nhits", "mode", "result", "count"):
        assert torch.equal(out[key][ok].long(), st[key][ok].long()), key
    return out, int(ok.sum())


def test_pev2_kernel_beyond_l2(card, tmp_path):
    """K14 on 8,192 pairs, the CLI's batch, whose lanes' scratch (the
    driver blocks' column and the branch pools' ptb) exceeds the 50 MB L2:
    equal to its plain version on every lane that finishes within 300
    plain iterations, over an eighth of them."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.align.pev2_device import DevicePairedV2Aligner
    from bowtie_tpu_torch.align.policy import KPolicy
    idx, refs = card
    pairs, _m1, _m2 = _pairs(refs, 8192, 37, tmp_path)
    al = DevicePairedV2Aligner(idx, read_ebwt(BASE + ".rev"), refs,
                               KPolicy(), device="cuda", better=True,
                               mode="n", seed_mms=2)
    out, compared = _pev2_against_plain(al, pairs, al.rec_cap, 300)
    shape = tbd.machine_shape(len(pairs), 64, al.machine.hostinit.nd,
                              al.machine.hostinit.ndt, True)
    assert shape["blocks"] >= 132 and shape["threads"] == tbd.MACHINE_LANES
    assert 4 * len(pairs) * (shape["scratch_words"] + tbd.NBR * 2 * 64) \
        > 50 * 2**20
    assert compared > len(pairs) // 8 and int(out["nhits"].sum()) > 0


@pytest.mark.parametrize("n", [1, 31, 133, 2113, 4225],
                         ids=["one", "under_a_warp", "sms_plus_one",
                              "16_a_block_plus", "32_a_block_plus"])
def test_best_lane_counts(card, tmp_path, n):
    """K10 at lane counts around its launch shape's edges (a block of one
    lane; 31 lanes, one a block; 132 SMs' worth and one more; 16 x 132
    and 32 x 132 lanes and one more, a partial last block) equals its
    plain version."""
    from bowtie_tpu_torch.align import best_device as tbd
    from bowtie_tpu_torch.align.policy import INF, KPolicy
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    reads = [r for r in _n_reads(refs, 2 * n + 40, 41, tmp_path / "r.fq")
             if 4 <= len(r.seq)][:n]
    assert len(reads) == n
    al = tbd.DeviceBestAligner(idx, read_ebwt(BASE + ".rev"),
                               KPolicy(3, INF), device="cuda", v=2,
                               strata=True)
    L = 64
    seeds = fill_seed_caches(reads, 0)
    host = al.hostinit.build(reads, L, seeds)
    skw = dict(L=L, nd=al.nd, ndt=al.ndt, maxbts=al.maxbts,
               n_k=al._sink_n(), m_max=tbd.INF32, strata=True,
               qual_lim=al.qual_lim, qual_order=al.qual_order,
               bt_on=al.bt_on, has_seeded=False, max_steps=60000)
    out, _ = tbd.run_machine(al.pair, al.hostinit.cfg, host,
                             torch.from_numpy(seeds.astype(np.int64)).cuda(),
                             **skw)
    st = tbd.init_state(n, L, al.nd, al.ndt, seeds, host, al.maxbts, "cuda")
    cfg = {c: torch.from_numpy(v.astype(np.int64)).cuda()
           for c, v in al.hostinit.cfg.items()}
    skw.pop("max_steps")
    skw.pop("maxbts")
    st, _ = tbd.run_machine_plain(al.pair, cfg, st, chunk=60000,
                                  nfrag=al.pair.nfrag,
                                  fc=al.pair.ftab_chars, **skw)
    assert bool((st["mode"] == tbd.M_DONE).all())
    assert torch.equal(out["overflow"], st["overflow"])
    ok = ~st["overflow"]
    for key in tbd.OUT_KEYS:
        assert torch.equal(out[key][ok].long(), st[key][ok].long()), key


@pytest.mark.parametrize("kw,dense", [({}, True), ({}, False),
                                      (dict(fw1=True, fw2=True), True)],
                         ids=["fr_dense", "fr_offrate13", "ff_dense"])
def test_ilv_kernel_matches_plain(card, tmp_path, kw, dense):
    """K13 equals its plain version on the card on small_index (five
    fragments), every output and each pair's iterations, on the streams
    of both rounds: rec_cap 1 after phase 0, and uncapped."""
    from bowtie_tpu_torch.align import pe_ilv_device as ilv
    from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
    from bowtie_tpu_torch.align.policy import KPolicy
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idx, refs = card
    idx_bw = read_ebwt(BASE + ".rev")
    if not dense:
        idx, idx_bw = (idx.with_off_rate(idx.off_rate + 8),
                       idx_bw.with_off_rate(idx_bw.off_rate + 8))
    al = DevicePairedBestAligner(idx, idx_bw, refs, KPolicy(),
                                 compact=not dense, device="cuda", **kw)
    assert al.use_ilv and al.pair.nfrag == 5
    pairs, _m1, _m2 = _pairs(refs, 300, 29, tmp_path, ff=kw.get("fw2"))
    idxs = list(range(len(pairs)))
    s1 = fill_seed_caches([p[0] for p in pairs], 0)
    found = 0
    for cap in (1, None):
        sts, ovd = al._record_all(al.plan(pairs), idxs, s1, cap)
        items = [(i, sts[i]) for i in idxs if not ovd[i]]
        S, st, lanes, host = al.ilv_inputs(pairs, items, s1)
        assert lanes and not host
        kernels.reset_launches()
        out, iters = ilv.run_ilv(al.pair, st, S)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["pe_ilv"] == 1
        pout, piters = ilv.run_ilv_plain(al.pair, {k: v.clone()
                                                   for k, v in st.items()}, S)
        for key in ilv.OUT_KEYS:
            assert torch.equal(out[key], pout[key]), (cap, key)
        assert torch.equal(iters, piters), cap
        found += int(out["res_found"].sum())
    assert found > 0


def _ilv_streams(al, pairs):
    """K13's inputs for round 1 of `pairs` (rec_cap 1 after phase 0)."""
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idxs = list(range(len(pairs)))
    s1 = fill_seed_caches([p[0] for p in pairs], 0)
    sts, ovd = al._record_all(al.plan(pairs), idxs, s1, 1)
    items = [(i, sts[i]) for i in idxs if not ovd[i]]
    S, st, lanes, host = al.ilv_inputs(pairs, items, s1)
    assert lanes and not host
    return S, st


def _ilv_hold(pair, S, st):
    """K13 against its plain version: every output and each pair's
    iterations.  -> the outputs."""
    from bowtie_tpu_torch.align import pe_ilv_device as ilv
    kernels.reset_launches()
    out, iters = ilv.run_ilv(pair, st, S)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pe_ilv"] == 1
    pout, piters = ilv.run_ilv_plain(pair, {k: v.clone()
                                            for k, v in st.items()}, S)
    for key in ilv.OUT_KEYS:
        assert torch.equal(out[key], pout[key]), key
    assert torch.equal(iters, piters)
    return out


def test_ilv_kernel_has_no_stack(card):
    """ptxas gives K13 no stack frame and no spills, and the runtime
    reserves no local memory for it."""
    from bowtie_tpu_torch.align import pe_ilv_device as ilv
    from bowtie_tpu_torch.utils.kdiag import ptxas_entry
    kernels.lib()
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "build", "ptxas.txt")) as f:
        lines = ptxas_entry(f.read(), "ilv_kernel")
    frames = [ln for ln in lines if "stack frame" in ln]
    assert len(frames) == 1, lines
    for ln in frames:
        assert ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads"), lines
    assert ilv.ilv_local_bytes() == 0


def test_ilv_pair_counts(card, tmp_path):
    """K13 equals its plain version on the first 1, 31, 33 and 133 pairs
    and on all 8,192 (the CLI's batch) of one recording on small_index:
    blocks partly filled, one pair, several blocks, more pairs than the
    card holds at once."""
    from test_torch_ilv_shape import first_pairs
    from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
    from bowtie_tpu_torch.align.policy import KPolicy
    idx, refs = card
    al = DevicePairedBestAligner(idx, read_ebwt(BASE + ".rev"), refs,
                                 KPolicy(), device="cuda")
    pairs, _m1, _m2 = _pairs(refs, 8192, 43, tmp_path)
    S, st = _ilv_streams(al, pairs)
    B = st["hits"].shape[0]
    assert B > 4096
    for n in (1, 31, 33, 133, B):
        _ilv_hold(al.pair, S, first_pairs(st, n) if n < B else st)


def test_ilv_windows_in_pieces(card, tmp_path):
    """K13 at -X 1000, whose rescue windows exceed a warp's reference
    pieces so that scans restage them, on 512 pairs of
    tests/test_torch_ilv_shape.py's genome (a tandem repeat, segment
    copies, Ns): equal to its plain version."""
    from test_torch_ilv_shape import _genome, _write_pairs
    from bowtie_tpu_torch.align import pe_ilv_device as ilv
    from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
    from bowtie_tpu_torch.align.policy import KPolicy
    from bowtie_tpu_torch.build.builder import build_index
    base = str(tmp_path / "g")
    build_index(_genome(np.random.default_rng(5)), ["a", "b"], base,
                off_rate=4, ftab_chars=6)
    idx = read_ebwt(base)
    refs = unpack_reference(*read_bitpair_reference(base), plen=idx.plen)
    al = DevicePairedBestAligner(idx, read_ebwt(base + ".rev"), refs,
                                 KPolicy(), device="cuda", max_insert=1000)
    pairs = _write_pairs(refs, 512, 17, (60, 900), tmp_path)
    S, st = _ilv_streams(al, pairs)
    assert ilv.ilv_window(S.SPAN, S.Lq)["in_pieces"]
    out = _ilv_hold(al.pair, S, st)
    assert int(out["res_found"].sum()) > 0


@pytest.mark.parametrize("args", [[], ["-v", "2", "-a", "-m", "3", "-S"],
                                  ["-n", "1", "-p", "2"],
                                  ["-n", "2", "-M", "1", "--sanity",
                                   "--stats"],
                                  ["-v", "1", "--best", "-k", "2"],
                                  ["-n", "2", "--best", "--stats"]],
                         ids=["n2_default", "v2_a_m3_S", "n1_p2",
                              "n2_M1_sanity_stats", "v1_best_k2_host_v2",
                              "n2_best_stats"])
def test_pe_cli_on_card_matches_cpu(card, tmp_path, args):
    """Paired runs on the card (the recorded V1 engine; --best, the V2
    engine over streams K14 records) write what they write on the CPU."""
    from bowtie_tpu_torch.cli import align as cli
    idx, refs = card
    _pairs_, m1, m2 = _pairs(refs, 400, 23, tmp_path)
    outs = []
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"out.{dev}"
        with contextlib.redirect_stderr(io.StringIO()) as err:
            assert cli.main(args + ["-1", str(m1), "-2", str(m2), BASE,
                                    str(out)], device=dev) == 0
        body = [ln for ln in out.read_bytes().splitlines(keepends=True)
                if not ln.startswith(b"@PG")]
        outs.append((b"".join(body),
                     re.sub(r"wall time: .*", "", err.getvalue())))
    assert outs[0] == outs[1]
    assert outs[0][0]


# csrc/sa.cu's tiles: 6,144 keys a digit pass takes, 4,096 a renumbering
SA_PASS_TILE, SA_RENUMBER_TILE = 6144, 4096


def _sa_text(kind):
    rng = np.random.default_rng(16)
    if kind.startswith("edge"):         # n1 = n + 1 at a tile boundary
        return rng.integers(0, 4, int(kind[4:]) - 1).astype(np.uint8)
    if kind == "random_1m":             # thousands of look-back tiles
        return rng.integers(0, 4, 1_000_000).astype(np.uint8)
    if kind == "random_4m":
        return rng.integers(0, 4, 4_000_000).astype(np.uint8)
    if kind == "all_a_1m":              # every pass's keys in one bin
        return np.zeros(1_000_000, np.uint8)
    if kind == "period3_1m":            # long ties over many rounds
        return np.tile(np.array([0, 1, 2], np.uint8), 333_334)[:1_000_000]
    if kind == "n1":
        return np.array([2], np.uint8)
    if kind == "empty":
        return np.zeros(0, np.uint8)
    if kind == "all_a":
        return np.zeros(70000, np.uint8)
    if kind == "planted":
        t = rng.integers(0, 4, 300000).astype(np.uint8)
        seg = rng.integers(0, 4, 2000).astype(np.uint8)
        for s in range(0, 298000, 4700):
            t[s:s + 2000] = seg
        return t
    return rng.integers(0, 4, 5000).astype(np.uint8)


SA_EDGES = [f"edge{t + d}" for t in (SA_PASS_TILE, 3 * SA_PASS_TILE,
                                     SA_RENUMBER_TILE)
            for d in (-1, 0, 1)]


@pytest.mark.parametrize("kind", ["n1", "empty", "small", "all_a",
                                  "planted", "random_1m", "random_4m",
                                  "all_a_1m", "period3_1m"] + SA_EDGES)
def test_sa_round_matches_plain(card, kind):
    """K16 against its plain version on the card, round for round (nr,
    order, maxg), and the whole doubling SA against SA-IS."""
    from bowtie_tpu_torch.build import sa as tsa
    codes = _sa_text(kind)
    n = len(codes)
    r0, big = tsa.initial_ranks(codes)
    r = torch.from_numpy(r0).cuda()
    kernels.reset_launches()
    k, rounds = 1, 0
    while True:
        nr, order, maxg = tsa.sa_round(r, min(k, n + 1), big)
        pnr, porder, pmaxg = tsa.sa_round_plain(r, min(k, n + 1), big)
        assert torch.equal(nr, pnr) and torch.equal(order, porder)
        assert int(maxg) == int(pmaxg)
        rounds += 1
        if int(maxg) == n:
            break
        r, k = nr, 2 * k
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sa_round"] == rounds
    sa = order.cpu().numpy().astype(np.int64)
    np.testing.assert_array_equal(sa, tsa.suffix_array(codes))
    np.testing.assert_array_equal(
        tsa.suffix_array_doubling(codes), tsa.suffix_array(codes))


@pytest.mark.parametrize("n1", [1, SA_PASS_TILE + 1, 3_000_000])
def test_sa_round_big_ranks(card, n1):
    """K16 on random ranks under BIG = 2^31 - 1 (tied in runs): 62-bit
    keys, 8 digit passes, counts that need the 64-bit look-back word's
    width; one launch a round."""
    from bowtie_tpu_torch.build import sa as tsa
    big = 2**31 - 1
    rng = np.random.default_rng(n1)
    r = rng.integers(1, big, n1).astype(np.int32)
    r[1::3] = r[::3][:len(r[1::3])]
    r = torch.from_numpy(r).cuda()
    kernels.reset_launches()
    for k in (1, 7, n1):
        got = tsa.sa_round(r, k, big)
        want = tsa.sa_round_plain(r, k, big)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sa_round"] == 3


def _machine_outputs(B, kind, seed):
    """Synthetic run_machine outputs on the card: random rows, counts
    per `kind` (random with 20 % overflow; every lane overflowed; every
    lane full; no partials)."""
    from bowtie_tpu_torch.align import dfs_device as td
    rng = np.random.default_rng(seed)

    def words(*shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()
    out = {"hits": words(B, td.H_MAX * td.HIT_W),
           "part_n": words(B, td.P_MAX), "part_job": words(B, td.P_MAX),
           "part_pos": words(B, 3 * td.P_MAX),
           "part_refc": words(B, 3 * td.P_MAX)}
    nh = rng.integers(0, td.H_MAX + 1, B)
    npart = rng.integers(0, td.P_MAX + 1, B)
    ovf = rng.random(B) < 0.2
    if kind == "overflow":
        ovf[:] = True
    elif kind == "full":
        nh[:], npart[:], ovf[:] = td.H_MAX, td.P_MAX, False
    elif kind == "no_parts":
        npart[:] = 0
    out["nhits"] = torch.from_numpy(nh.astype(np.int32)).cuda()
    out["npart"] = torch.from_numpy(npart.astype(np.int32)).cuda()
    out["overflow"] = torch.from_numpy(ovf).cuda()
    return out


@pytest.mark.parametrize("B,kind", [
    (1, "random"), (1, "full"), (1000, "overflow"), (1000, "full"),
    (1000, "no_parts"), (129, "random"), (16384, "random"),
    (200_000, "random")])
def test_dfs_kernels_pack_edges(card, B, kind):
    """K8 against its plain version on synthetic machine outputs: one
    lane, every lane overflowed (no hit rows), every lane full, no
    partials, lane counts off the 128-lane tile, and 200,000 lanes of
    many look-back tiles; twice in a row (the second call finds the
    scratch the first left), one dfs_pack launch a call."""
    from bowtie_tpu_torch.align import dfs_device as td
    kernels.reset_launches()
    for seed in (B, B + 1):
        out = _machine_outputs(B, kind, seed)
        got = td.pack_hits(out)
        want = td.pack_hits_plain(out)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dfs_pack"] == 2
    if kind == "overflow":
        assert got[0].shape[0] == 0 and int(got[2].sum()) == 0
    if kind == "full":
        assert got[0].shape[0] == B * td.H_MAX
        assert got[1].shape[0] == B * td.P_MAX


def test_cli_build_jax_sa_on_card(card, tmp_path):
    """bowtie-build --jax-sa on the card writes the committed index."""
    from bowtie_tpu_torch.cli import build as tbuild
    fasta = os.path.join(HERE, "golden", "small_genome.fa")
    kernels.reset_launches()
    assert tbuild.main(["--jax-sa", "-q", "-o", "5", "-t", "7", fasta,
                        str(tmp_path / "j")]) == 0
    assert kernels.LAUNCHES["sa_round"] > 0
    for ext in (".1.ebwt", ".2.ebwt", ".3.ebwt", ".4.ebwt", ".rev.1.ebwt",
                ".rev.2.ebwt"):
        assert ((tmp_path / ("j" + ext)).read_bytes()
                == open(BASE + ext, "rb").read()), ext


# K7 at the edges of its launch shape and layouts (csrc/dfs.cu: one warp
# a block, lane state and scan data in shared memory up to L = 64, the
# global layout beyond): lane counts around the warp, every lane
# overflowing H_MAX, S_MAX or P_MAX, one long walk-left lane among short
# ones, a budget that stops lanes mid-search, launch B with the counts of
# launch A, 100 bp reads (L = 128) and two mesh shards; each held to the
# plain version on every lane that finished within its budget.

@pytest.fixture(scope="module")
def k7_genome(tmp_path_factory):
    """A seeded 200 kb genome with 64 copies of a 2 kb segment, indexed
    at bowtie-build's defaults; its fw/mirror pair dense and thinned to
    offRate 9 (walks of up to 512 steps)."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.build.builder import build_index
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    seg = rng.integers(0, 4, 2000).astype(np.uint8)
    starts = np.arange(64) * 3125 + rng.integers(0, 1000, 64)
    for s in starts:
        g[s:s + 2000] = seg
    base = str(tmp_path_factory.mktemp("k7") / "rep")
    build_index([g], ["rep"], base, off_rate=5, ftab_chars=10)
    idx, idx_bw = read_ebwt(base), read_ebwt(base + ".rev")
    dense = td.build_fmpair(idx, idx_bw, "cuda", dense_sa=True)
    thin = td.build_fmpair(idx.with_off_rate(9), idx_bw.with_off_rate(9),
                           "cuda", dense_sa=False)
    return g, starts, dense, thin


def _k7_reads(path, rows):
    from bowtie_tpu_torch.io.readers import ReadSource
    path.write_text("".join(
        f"@r{i}\n{''.join('ACGTN'[c] for c in r)}\n+\n"
        + "".join(chr(35 + (7 * i + 3 * j) % 39) for j in range(len(r)))
        + "\n" for i, r in enumerate(rows)))
    return list(ReadSource([str(path)]).records())


def _k7_mix(g, starts, n, seed, length=36):
    """n reads: exact, one or two mismatches, of the repeat, random."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, len(g) - length, n)
    rep = rng.random(n) < 0.1
    pos[rep] = starts[rng.integers(0, 64, rep.sum())] + rng.integers(
        0, 2000 - length, rep.sum())
    rows = g[pos[:, None] + np.arange(length)].copy()
    k = np.arange(n)
    for m in range(2):
        sel = k % (3 + m) == 1
        col = rng.integers(0, length, n)
        rows[sel, col[sel]] = (rows[sel, col[sel]] + 1 + m) % 4
    rnd = rng.random(n) < 0.1
    rows[rnd] = rng.integers(0, 4, (rnd.sum(), length))
    return rows


def _k7_jobs(pair, reads, v, L, **fields):
    """-v job rows for `reads`, with each named field set on every valid
    job (crafted tables), derived on the card."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    jobs, _ = tj.build_v_jobs_vec(reads, v, False, False, L)
    for f, val in fields.items():
        jobs[f] = np.where(jobs["valid"] > 0, val, jobs[f]).astype(
            jobs[f].dtype)
    dev = td.upload_jobs(jobs, pair.ftab_chars, "cuda")
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).cuda()
    return dev, seeds, torch.zeros(len(reads), dtype=torch.int32,
                                   device="cuda")


def _k7_hold(pair, jobs, seeds, c0, n_k, m_max, max_steps):
    """K7 against the plain version on every lane the plain version
    finished; -> (K7's outputs, the plain version's done mask)."""
    from bowtie_tpu_torch.align import dfs_device as td
    kernels.reset_launches()
    out, steps = td.run_machine_lanes(pair, jobs, seeds, c0, n_k=n_k,
                                      m_max=m_max, max_steps=max_steps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dfs_machine"] == 1
    pout, _ = td.run_machine_plain(pair, jobs, seeds, c0, n_k=n_k,
                                   m_max=m_max, max_steps=max_steps)
    done = pout["mode"] == td.M_DONE
    for k in td.OUT_KEYS:
        assert torch.equal(out[k][done], pout[k][done]), k
    assert int(steps.max()) <= 8 * max_steps
    return out, done


@pytest.mark.parametrize("B", [1, 31, 33, 129, 8193])
def test_k7_lane_counts(card, k7_genome, tmp_path, B):
    from bowtie_tpu_torch.align import dfs_device as td
    g, starts, dense, _thin = k7_genome
    reads = _k7_reads(tmp_path / "r.fq", _k7_mix(g, starts, B, B))
    out, done = _k7_hold(dense, *_k7_jobs(dense, reads, 2, 40), td.INF32,
                         3, 20000)
    assert bool(done.all()) and int(out["nhits"].sum()) > 0


@pytest.mark.parametrize("case", ["h_max", "s_max", "p_max"])
def test_k7_every_lane_overflows(card, k7_genome, tmp_path, case):
    """Every lane overflows one bound: repeat reads under -a (H_MAX);
    random reads with every position revisitable at every level
    (S_MAX); 10-base queries of random reads, every position
    revisitable, reporting partials of up to 2 mismatches (P_MAX)."""
    from bowtie_tpu_torch.align import dfs_device as td
    g, starts, dense, _thin = k7_genome
    rng = np.random.default_rng(4)
    if case == "h_max":
        rows = np.stack([g[starts[0] + 100 + 7 * i:starts[0] + 136 + 7 * i]
                         for i in range(64)])
        fields = {}
    else:
        rows = rng.integers(0, 4, (64, 36)).astype(np.uint8)
        fields = dict(unrev=0, rev1=0, rev2=0, rev3=0)
        if case == "p_max":
            fields.update(qlen=10, report_partials=3)
    reads = _k7_reads(tmp_path / "r.fq", rows)
    out, done = _k7_hold(dense, *_k7_jobs(dense, reads, 2, 40, **fields),
                         td.INF32, td.INF32, 20000)
    assert bool(done.all()) and bool(out["overflow"].all())
    if case == "h_max":
        assert bool((out["nhits"] == td.H_MAX).all())
    if case == "p_max":
        assert bool((out["npart"] == td.P_MAX).all())


def test_k7_heavy_walk_lane(card, k7_genome, tmp_path):
    """One repeat read under -a (64 rows, each a walk of up to 512 LF
    steps) in a warp of random reads, on the thinned pair."""
    from bowtie_tpu_torch.align import dfs_device as td
    g, starts, _dense, thin = k7_genome
    rows = np.random.default_rng(5).integers(0, 4, (64, 36)).astype(
        np.uint8)
    rows[17] = g[starts[3] + 40:starts[3] + 76]
    reads = _k7_reads(tmp_path / "r.fq", rows)
    out, done = _k7_hold(thin, *_k7_jobs(thin, reads, 2, 40), td.INF32,
                         td.INF32, 20000)
    assert bool(done.all()) and int(out["nhits"][17]) == td.H_MAX


def test_k7_budget_mid_search(card, k7_genome, tmp_path):
    """A budget of 20 iterations (160 transitions) stops many lanes
    mid-search: those the plain version finished agree, the rest are
    flagged."""
    from bowtie_tpu_torch.align import dfs_device as td
    g, starts, dense, _thin = k7_genome
    reads = _k7_reads(tmp_path / "r.fq", _k7_mix(g, starts, 512, 6))
    out, done = _k7_hold(dense, *_k7_jobs(dense, reads, 2, 40), td.INF32,
                         3, 20)
    stopped = out["mode"] != td.M_DONE
    assert int(stopped.sum()) > 50 and bool(out["overflow"][stopped].all())
    assert int(done.sum()) > 0


def test_k7_launch_b_counts(card, k7_genome, tmp_path):
    """-n 2 -a -m 5: launch B on the card starts each lane at launch A's
    count (the repeat's lanes nonzero)."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.align import n_device as tn
    from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    g, starts, dense, _thin = k7_genome
    reads = _k7_reads(tmp_path / "r.fq", _k7_mix(g, starts, 2048, 8))
    jobs, _J, gated, jrc, _ = tj.build_n_jobs_a_vec(
        reads, 2, 28, 70, 125, True, False, False, 40)
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).cuda()
    c0 = torch.zeros(len(reads), dtype=torch.int32, device="cuda")
    kw = dict(n_k=td.INF32, m_max=5, max_steps=60000)
    out_a, _ = td.run_machine(dense, td.upload_jobs(jobs, 10, "cuda"), seeds,
                              c0, **kw)
    base = [torch.from_numpy(np.ascontiguousarray(jobs[k])).cuda()
            for k in ("base_codes", "base_qual", "base_plen")]
    scal = tn.derive_b_jobs(
        out_a, torch.from_numpy(gated).cuda(), base[1], base[2],
        torch.from_numpy(QUAL_ROUNDS.astype(np.int32)).cuda(), J=tn.J_B,
        jrc=jrc, n=2, s=28, qt=70, maxbts=125, maq=True, norc=False,
        nofw=False)
    scal, qqp = td.derive_rows(scal, *base, 10)
    assert int((out_a["count"] > 0).sum()) > 100
    out_b, done = _k7_hold(dense, {"scal": scal, "qqp": qqp}, seeds,
                           out_a["count"], td.INF32, 5, 60000)
    assert bool(done.all())


def test_k7_global_layout(card, k7_genome, tmp_path):
    """100 bp reads: L = 128, past the on-chip layout."""
    from bowtie_tpu_torch.align import dfs_device as td
    g, starts, dense, _thin = k7_genome
    assert not td.machine_shape(512, 128)["onchip"]
    reads = _k7_reads(tmp_path / "r.fq", _k7_mix(g, starts, 512, 9, 100))
    out, done = _k7_hold(dense, *_k7_jobs(dense, reads, 2, 128), td.INF32,
                         3, 20000)
    assert bool(done.all()) and int(out["nhits"].sum()) > 0


def test_k7_mesh_shards(card, k7_genome, tmp_path):
    """run_sharded over two entries on the card equals one run_machine."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.parallel import dfs_mesh
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    g, starts, dense, _thin = k7_genome
    reads = _k7_reads(tmp_path / "r.fq", _k7_mix(g, starts, 1000, 10))
    jobs, _ = tj.build_v_jobs_vec(reads, 2, False, False, 40)
    seeds = fill_seed_caches(reads, 0).astype(np.int64)
    c0 = np.zeros(len(reads), np.int32)
    kw = dict(n_k=td.INF32, m_max=3, max_steps=20000)
    kernels.reset_launches()
    got, _ = dfs_mesh.run_sharded(dense, jobs, seeds, c0,
                                  [torch.device("cuda")] * 2, **kw)
    assert kernels.LAUNCHES["dfs_machine"] == 2
    want, _ = td.run_machine(dense, td.upload_jobs(jobs, 10, "cuda"),
                             torch.from_numpy(seeds).cuda(),
                             torch.from_numpy(c0).cuda(), **kw)
    for k in td.OUT_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_jobs_kernels_have_no_stack(card):
    """ptxas gives K6 and K9 (csrc/jobs.cu) no stack frame and no spills,
    and the runtime reserves no local memory for them."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.utils.kdiag import ptxas_entry
    kernels.lib()
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "build", "ptxas.txt")) as f:
        report = f.read()
    for name in ("derive_rows", "derive_b_jobs"):
        lines = ptxas_entry(report, name)
        frames = [ln for ln in lines if "stack frame" in ln]
        assert len(frames) == 1, lines
        assert frames[0].startswith("0 bytes stack frame, 0 bytes spill "
                                    "stores, 0 bytes spill loads"), lines
    assert td.jobs_local_bytes() == {"derive_rows": 0, "derive_b_jobs": 0}


def _k6_hold(scal, codes, qual, plen, fc):
    """K6 against its plain version on the card, byte for byte."""
    from bowtie_tpu_torch.align import dfs_device as td
    kernels.reset_launches()
    got = td.derive_rows(scal, codes, qual, plen, fc)
    assert kernels.LAUNCHES["derive_rows"] == 1
    want = td.derive_rows_plain(scal, codes, qual, plen, fc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("length,L", [(100, 128), (250, 256)])
def test_k6_long_rows(card, k7_genome, tmp_path, length, L):
    """K6 on the -v 2 and -n 2 launch-A tables of 2,048 reads of 100 and
    250 bp with runs of Ns (L 128 and 256: the N tally crosses several
    32-position chunks)."""
    from bowtie_tpu_torch.align import dfs_device as td
    from bowtie_tpu_torch.align import dfs_jobs as tj
    g, starts, dense, _thin = k7_genome
    rows = _k7_mix(g, starts, 2048, 11, length)
    rng = np.random.default_rng(12)
    for b in range(0, len(rows), 3):
        s = int(rng.integers(0, length - 8))
        rows[b, s:s + int(rng.integers(1, 9))] = 4
    reads = _k7_reads(tmp_path / "r.fq", rows)
    for jobs in (tj.build_v_jobs_vec(reads, 2, False, False, L)[0],
                 tj.build_n_jobs_a_vec(reads, 2, 28, 70, 125, True, False,
                                       False, L)[0]):
        t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
            np.stack([jobs[f] for f in td.JOB_FIELDS], -1).astype(np.int32),
            jobs["base_codes"], jobs["base_qual"], jobs["base_plen"])]
        scal, _ = _k6_hold(*t, dense.ftab_chars)
        assert int(scal[..., td.JOB_FIELDS.index("ns_gate")].sum()) > 0


def _k9_full(B, L, seed):
    """Launch-A outputs on which every lane takes jobs, 32 partials each
    (job 3 or 4), 0-3 mutations inside 36-base reads."""
    from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS
    rng = np.random.default_rng(seed)
    P = 32
    a = {"result": np.zeros(B, np.int32), "overflow": np.zeros(B, bool),
         "mode": np.zeros(B, np.int32), "npart": np.full(B, P, np.int32),
         "part_job": rng.integers(3, 5, (B, P)).astype(np.int32),
         "part_n": rng.integers(0, 4, (B, P)).astype(np.int32),
         "part_pos": rng.integers(0, 36, (B, 3 * P)).astype(np.int32),
         "part_refc": rng.integers(0, 4, (B, 3 * P)).astype(np.int32)}
    a = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    qual = torch.from_numpy(rng.integers(2, 41, (B, L)).astype(
        np.int8)).cuda()
    codes = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(
        np.int8)).cuda()
    return (a, torch.zeros(B, dtype=torch.bool, device="cuda"), qual,
            torch.full((B,), 36, dtype=torch.int32, device="cuda"),
            torch.from_numpy(QUAL_ROUNDS.astype(np.int32)).cuda()), codes


@pytest.mark.parametrize("B,n,norc,nofw", [
    (8192, 1, False, False), (8192, 2, False, False), (8192, 3, False, False),
    (8192, 2, True, False), (8192, 2, False, True), (1, 2, False, False),
    (5, 3, False, False), (33, 2, False, False)])
def test_k9_full_lanes(card, B, n, norc, nofw):
    """K9 on lanes that all take jobs, 32 partials each (every row of J_B
    but the last used), then K6 on the table it builds, each equal to its
    plain version; B = 1, 5, 33 leave the last block partly used."""
    from bowtie_tpu_torch.align import n_device as tn
    args, codes = _k9_full(B, 40, B + n)
    kw = dict(J=tn.J_B, jrc=3, n=n, s=28, qt=70, maxbts=125, maq=True,
              norc=norc, nofw=nofw)
    kernels.reset_launches()
    got = tn.derive_b_jobs(*args, **kw)
    assert kernels.LAUNCHES["derive_b_jobs"] == 1
    want = tn.derive_b_jobs_plain(*args, **kw)
    assert torch.equal(got, want)
    assert int(got[..., 0].sum()) > 0
    _k6_hold(got, codes, args[2], args[3], 10)
    with pytest.raises(ValueError):
        tn.derive_b_jobs(*args, **dict(kw, J=200))
