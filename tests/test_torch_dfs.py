"""The DFS machine's plain versions against the reference package's JAX
functions, on an index built here from a seeded genome whose 300 bp
repeat has 12 copies (so -a reads overflow the 8 hit slots):

- K6 derive_rows_plain against derive_rows_jit;
- K7 run_machine_plain against run_machine, every OUT_KEYS array and the
  iteration count, on -v 1 / -v 2 job tables (with --nofw / --norc), on
  the dense and the walk-left (compact) layouts, and on -n launch-A
  tables (partial collection, quality budgets, max_bts);
- K8 pack_hits_plain against decode_hit_cols' hit gather and _pack_all's
  partial rows;
- DeviceDFSAligner(device="cpu") against the reference's
  DeviceDFSAligner, ReadResult for ReadResult, overflow re-runs included.

Exact equality throughout: this is integer code."""
from unittest import mock

import numpy as np
import pytest
import torch

from bowtie_tpu.align import dfs_device as jd
from bowtie_tpu.align import dfs_jobs as jj
from bowtie_tpu.align import policy as j_pol
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu.utils import rng as j_rng
from bowtie_tpu_torch.align import dfs_device as td
from bowtie_tpu_torch.align import dfs_jobs as tj
from bowtie_tpu_torch.align import policy as t_pol
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd
from bowtie_tpu_torch.utils import rng as t_rng
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

L = 40
INF = 0xFFFFFFFF


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dfs")
    rng = np.random.default_rng(77)
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    seqs = []
    for ln in (9000, 7000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.choice(np.arange(0, ln - 300, 400), 6, replace=False):
            s[p:p + 300] = rep
        seqs.append(s)
    base = str(d / "g")
    build_index(seqs, ["chrA", "chrB"], base)
    lines = []
    for k in range(160):
        s = seqs[k % 2]
        ln = int(rng.integers(24, 40))
        p = int(rng.integers(0, len(s) - ln))
        q = s[p:p + ln].copy()
        for _ in range(k % 3):                         # 0-2 mismatches
            q[int(rng.integers(ln))] = rng.integers(0, 4)
        if k % 11 == 5:
            q[int(rng.integers(ln))] = 4
        if k % 4 == 1:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
        lines.append(f"@r{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    fq = d / "r.fq"
    fq.write_text("".join(lines))
    jr = list(j_rd.ReadSource([str(fq)], "fastq").records())
    tr = list(t_rd.ReadSource([str(fq)], "fastq").records())
    ji, jb = j_io.read_ebwt(base), j_io.read_ebwt(base + ".rev")
    return dict(base=base, jr=jr, tr=tr, ji=ji, jb=jb,
                ti=t_io.read_ebwt(base), tb=t_io.read_ebwt(base + ".rev"),
                cats={}, fc=ji.ftab_chars)


def _cat(data, dense):
    if dense not in data["cats"]:
        data["cats"][dense] = jd.build_fmcat(data["ji"], data["jb"],
                                             occ_every=128, dense_sa=dense)
    return data["cats"][dense]


def _port_pair(cat):
    """The JAX index pair handed to the port through pair_from_jax."""
    fields = {k: np.asarray(getattr(cat, k)) for k in (
        "occ", "fchr", "ftab_hi", "ftab_lo", "sa", "bwt", "zoff",
        "rstarts_start", "rstarts_tidx", "rstarts_toff", "length",
        "bwt_len", "occ_base", "sa_base", "ftab_base", "blk_base")}
    meta = dict(ftab_chars=cat.ftab_chars, off_rate=cat.off_rate,
                occ_every=cat.occ_every, dense=cat.dense)
    return td.pair_from_jax(fields, meta, "cpu")


def _jobs(data, kind, nofw=False, norc=False):
    """(JAX job dict, port job dict, J) for -v 1/2 or -n launch A."""
    if kind == "n":
        # the reference derives rows on the host on a CPU backend; ask it
        # for the device derivation the port always uses
        with mock.patch.object(jj, "derive_rows_enabled", lambda: True):
            jjobs, J, *_ = jj.build_n_jobs_a_vec(
                data["jr"], 2, 20, 70, 30, True, nofw, norc, L, data["fc"])
        tjobs, TJ, *_ = tj.build_n_jobs_a_vec(data["tr"], 2, 20, 70, 30,
                                              True, nofw, norc, L)
    else:
        jjobs, J = jj.build_v_jobs_vec(data["jr"], kind, nofw, norc, L,
                                       data["fc"], rows=False)
        tjobs, TJ = tj.build_v_jobs_vec(data["tr"], kind, nofw, norc, L)
    assert J == TJ and set(jjobs) == set(tjobs)
    for k in jjobs:
        np.testing.assert_array_equal(jjobs[k], tjobs[k], err_msg=k)
    return jjobs, tjobs, J


@pytest.mark.parametrize("kind", [1, 2, "n"], ids=["v1", "v2", "n"])
def test_derive_rows_matches_jax(data, kind):
    jjobs, tjobs, J = _jobs(data, kind)
    jdev = jd.upload_jobs(jjobs, J, L, data["fc"])
    tdev = td.upload_jobs(tjobs, data["fc"], "cpu")
    np.testing.assert_array_equal(np.asarray(jdev["scal"]),
                                  tdev["scal"].numpy())
    np.testing.assert_array_equal(np.asarray(jdev["qqp_r"]),
                                  tdev["qqp"].numpy())
    assert int(tdev["scal"][..., td.JOB_FIELDS.index("ns_gate")].sum()) > 0


MACHINE_CASES = [
    # name, job kind, nofw, norc, dense, n_k, m_max
    ("v1_k1_dense", 1, False, False, True, 1, jd.INF32),
    ("v1_a_m3_compact_norc", 1, False, True, False, jd.INF32, 3),
    ("v2_k2_dense_nofw", 2, True, False, True, 2, jd.INF32),
    ("v2_a_compact", 2, False, False, False, jd.INF32, jd.INF32),
    ("n_launch_a_dense", "n", False, False, True, 1, jd.INF32),
    ("n_launch_a_compact_a", "n", False, False, False, jd.INF32,
     jd.INF32),
]


def _run_both(data, kind, nofw, norc, dense, n_k, m_max, max_steps=20000):
    jjobs, tjobs, J = _jobs(data, kind, nofw, norc)
    cat = _cat(data, dense)
    seeds = j_rng.fill_seed_caches(data["jr"], 0)
    np.testing.assert_array_equal(seeds,
                                  t_rng.fill_seed_caches(data["tr"], 0))
    B = len(seeds)
    jout, jit = jd.run_machine(
        cat, jd.upload_jobs(jjobs, J, L, data["fc"]), seeds,
        np.zeros(B, np.int32), J=J, L=L, nfrag=int(data["ji"].nfrag),
        n_k=n_k, m_max=m_max, max_steps=max_steps)
    tout, tit = td.run_machine(
        _port_pair(cat), td.upload_jobs(tjobs, data["fc"], "cpu"),
        torch.from_numpy(seeds.astype(np.int64)),
        torch.zeros(B, dtype=torch.int32), n_k=n_k, m_max=m_max,
        max_steps=max_steps)
    return {k: np.asarray(v) for k, v in jout.items()}, int(jit), tout, \
        int(tit)


@pytest.mark.parametrize("name,kind,nofw,norc,dense,n_k,m_max",
                         MACHINE_CASES, ids=[c[0] for c in MACHINE_CASES])
def test_machine_matches_jax(data, name, kind, nofw, norc, dense, n_k,
                             m_max):
    jout, jit, tout, tit = _run_both(data, kind, nofw, norc, dense, n_k,
                                     m_max)
    assert tit == jit
    for k in td.OUT_KEYS:
        want = jout[k].astype(np.int64)
        if k == "rng":
            want &= 0xFFFFFFFF
        np.testing.assert_array_equal(tout[k].numpy().astype(np.int64),
                                      want, err_msg=k)
    assert int(tout["nhits"].sum()) > 0
    if kind == "n":
        assert int(tout["npart"].sum()) > 0
    if m_max == jd.INF32 and n_k == jd.INF32:
        assert bool(tout["overflow"].any())          # > H_MAX hits


def test_machine_budget_matches_jax(data):
    """A budget too small for some lanes: the same lanes end not DONE
    and flagged, in both."""
    jout, jit, tout, tit = _run_both(data, 2, False, False, False,
                                     jd.INF32, 3, max_steps=100)
    assert tit == jit == 100
    for k in ("mode", "overflow", "nhits", "count"):
        np.testing.assert_array_equal(tout[k].numpy(), jout[k], err_msg=k)
    assert 0 < int((tout["mode"] != td.M_DONE).sum()) < len(data["tr"])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "compact"])
def test_machine_work_counts(data, dense):
    """The plain machine's work counter, which chip_smoke.py prices into
    bounds: counting changes no output, and the distinct items it counts
    lie within the accesses that read them."""
    _jj, tjobs, J = _jobs(data, 2)
    pair = td.build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=dense)
    jobs = td.upload_jobs(tjobs, data["fc"], "cpu")
    seeds = torch.from_numpy(
        t_rng.fill_seed_caches(data["tr"], 0).astype(np.int64))
    c0 = torch.zeros(len(seeds), dtype=torch.int32)
    kw = dict(n_k=td.INF32, m_max=3, max_steps=20000)
    work = {}
    out, it = td.run_machine_plain(pair, jobs, seeds, c0, work=work, **kw)
    ref, rit = td.run_machine_plain(pair, jobs, seeds, c0, **kw)
    assert int(it) == int(rit)
    for k in td.OUT_KEYS:
        assert torch.equal(out[k], ref[k]), k
    assert 0 < work["job_rows"] <= work["job_fields"] <= len(seeds) * J
    assert 0 < work["bwt_blocks"] <= work["occ_entries"] <= \
        work["rank_ends"] + work["walk_steps"]
    assert 0 < work["sa_entries"] <= work["sa_loads"]
    assert work["ftab_entries"] > 0
    assert (work["walk_steps"] > 0) == (not dense)


def test_pack_matches_decode(data):
    jout, _jit, tout, _tit = _run_both(data, "n", False, False, True,
                                       jd.INF32, jd.INF32)
    ovf = jout["overflow"]
    B = len(ovf)
    bounds_j, mk_j = jd.decode_hit_cols(
        {"nhits": jout["nhits"],
         "hits": jout["hits"].reshape(B, td.H_MAX, td.HIT_W)}, B, ovf)
    hits, parts, nh_eff = td.pack_hits_plain(tout)
    bounds_t, mk_t = td.decode_hit_cols(hits.numpy(), nh_eff.numpy())
    assert bounds_t == bounds_j and bounds_t[-1] > 0
    reads = data["tr"]
    for b in range(B):
        for j in range(bounds_j[b], bounds_j[b + 1]):
            hj, ht = mk_j(reads[b], j), mk_t(reads[b], j)
            assert (hj.fw, hj.tidx, hj.toff, hj.oms, hj.stratum, hj.cost,
                    hj.mms) == (ht.fw, ht.tidx, ht.toff, ht.oms, ht.stratum,
                                ht.cost, ht.mms)
    # the partial rows as _pack_all fuses them: [n, job, pos[3], refc[3]]
    npart = jout["npart"]
    lanes = np.repeat(np.arange(B), npart)
    slots = np.concatenate([np.arange(n) for n in npart])
    fused = np.concatenate([
        jout["part_n"][..., None], jout["part_job"][..., None],
        jout["part_pos"].reshape(B, td.P_MAX, 3),
        jout["part_refc"].reshape(B, td.P_MAX, 3)], axis=-1)
    np.testing.assert_array_equal(parts.numpy(), fused[lanes, slots])
    assert len(lanes) > 0


def test_fmpair_from_jax_equals_built(data):
    for dense in (True, False):
        a = _port_pair(_cat(data, dense))
        b = td.build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=dense)
        for half in ("fw", "bw"):
            fa, fb = getattr(a, half), getattr(b, half)
            for k in ("bwt", "occ", "fchr", "ftab_hi", "ftab_lo", "offs",
                      "sa"):
                x, y = getattr(fa, k), getattr(fb, k)
                assert (x is None) == (y is None) == (k == "sa" and
                                                      not dense)
                if x is not None:
                    assert torch.equal(x, y), (half, k)
            assert (fa.zoff, fa.bwt_len, fa.off_rate) == \
                (fb.zoff, fb.bwt_len, fb.off_rate)
        assert torch.equal(a.rstarts, b.rstarts) and a.length == b.length


def _key(r):
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost,
              tuple(h.mms)) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


@pytest.mark.parametrize("v,kh,mh,compact", [
    (1, 1, INF, False), (2, INF, INF, True), (2, 2, 3, False)],
    ids=["v1_k1", "v2_a_compact", "v2_k2_m3"])
def test_aligner_matches_jax(data, v, kh, mh, compact):
    jal = jd.DeviceDFSAligner(data["ji"], data["jb"],
                              j_pol.KPolicy(khits=kh, mhits=mh), v=v,
                              compact=compact)
    tal = td.DeviceDFSAligner(data["ti"], data["tb"],
                              t_pol.KPolicy(khits=kh, mhits=mh), v=v,
                              compact=compact, device="cpu")
    td.FALLBACKS["lanes"] = 0
    assert [_key(r) for r in tal.align_batch(data["tr"])] == \
        [_key(r) for r in jal.align_batch(data["jr"])]
    assert td.FALLBACKS["lanes"] == jal.fallbacks
    if kh == INF and mh == INF:
        assert jal.fallbacks > 0          # H_MAX overflow, oracle re-run
