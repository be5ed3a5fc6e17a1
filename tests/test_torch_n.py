"""The -n slice's plain versions against the reference package, on an index
built here from a seeded genome whose 300 bp repeat has 12 copies (so -a
reads overflow the 8 hit slots):

- K9 derive_b_jobs_plain against _derive_b_jobs_device (JIT on the CPU),
  field for field, fed the plain K7's launch-A outputs, for -n 1/2/3,
  --nofw, --norc, --nomaqround and -l 15, with P_MAX equal in both; then
  K6 on that table against the function's own row derivation;
- K6 + K7 on launch-B tables against derive_rows_jit and run_machine, every
  OUT_KEYS array and the iteration count, with lanes that overflow and a
  run cut by the budget;
- DeviceNAligner(device="cpu") against the reference's DeviceNAligner,
  result for result, overflow re-runs on the host oracle included.

Exact equality throughout: this is integer code."""
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.align import dfs_device as jd
from bowtie_tpu.align.backtrack_oracle import QUAL_ROUNDS
from bowtie_tpu.align import dfs_jobs as jj
from bowtie_tpu.align import n_device as jn
from bowtie_tpu.align import policy as j_pol
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu.utils import rng as j_rng
from bowtie_tpu_torch.align import dfs_device as td
from bowtie_tpu_torch.align import dfs_jobs as tj
from bowtie_tpu_torch.align import n_device as tn
from bowtie_tpu_torch.align import policy as t_pol
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

L = 40
INF = 0xFFFFFFFF
MAXBTS = 125


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_n")
    rng = np.random.default_rng(31)
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    seqs = []
    for ln in (8000, 6000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.choice(np.arange(0, ln - 300, 400), 6, replace=False):
            s[p:p + 300] = rep
        seqs.append(s)
    base = str(d / "g")
    build_index(seqs, ["chrA", "chrB"], base)
    lines = []
    for k in range(96):
        s = seqs[k % 2]
        ln = int(rng.integers(26, 40))
        p = int(rng.integers(0, len(s) - ln))
        q = s[p:p + ln].copy()
        for _ in range(k % 4):                       # 0-3 mismatches
            q[int(rng.integers(ln))] = rng.integers(0, 4)
        if k % 13 == 6:
            q[int(rng.integers(ln))] = 4
        if k % 4 == 1:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, ln))
        lines.append(f"@r{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    fq = d / "r.fq"
    fq.write_text("".join(lines))
    ji, jb = j_io.read_ebwt(base), j_io.read_ebwt(base + ".rev")
    cat = jd.build_fmcat(ji, jb, occ_every=128, dense_sa=True)
    fields = {k: np.asarray(getattr(cat, k)) for k in (
        "occ", "fchr", "ftab_hi", "ftab_lo", "sa", "bwt", "zoff",
        "rstarts_start", "rstarts_tidx", "rstarts_toff", "length",
        "bwt_len", "occ_base", "sa_base", "ftab_base", "blk_base")}
    meta = dict(ftab_chars=cat.ftab_chars, off_rate=cat.off_rate,
                occ_every=cat.occ_every, dense=cat.dense)
    return dict(jr=list(j_rd.ReadSource([str(fq)], "fastq").records()),
                tr=list(t_rd.ReadSource([str(fq)], "fastq").records()),
                ji=ji, jb=jb, ti=t_io.read_ebwt(base),
                tb=t_io.read_ebwt(base + ".rev"), cat=cat,
                pair=td.pair_from_jax(fields, meta, "cpu"),
                fc=cat.ftab_chars, nfrag=int(ji.nfrag))


# (id, n, seed length, -e, maq rounding, nofw, norc, -k, -m)
CFGS = [
    ("n1", 1, 28, 70, True, False, False, INF, INF),
    ("n2", 2, 28, 70, True, False, False, 1, INF),
    ("n3_a", 3, 28, 100, True, False, False, INF, INF),
    ("n2_nofw", 2, 28, 70, True, True, False, INF, INF),
    ("n2_norc", 2, 28, 70, True, False, True, INF, INF),
    ("n2_nomaqround", 2, 28, 70, False, False, False, INF, INF),
    ("n2_l15", 2, 15, 70, True, False, False, INF, 3),
]
_BY_ID = {c[0]: c for c in CFGS}


def _lim(x):
    return td.INF32 if x == INF else x


def _launch_a(data, cfg):
    """Launch A on the port's plain K7: (port A table, A outputs, gated,
    jrc, seeds)."""
    _id, n, s, qt, maq, nofw, norc, k, m = cfg
    jobs, _J, gated, jrc, _jfw = tj.build_n_jobs_a_vec(
        data["tr"], n, s, qt, MAXBTS, maq, nofw, norc, L)
    seeds = j_rng.fill_seed_caches(data["jr"], 0)
    out, _ = td.run_machine_plain(
        data["pair"], td.upload_jobs(jobs, data["fc"], "cpu"),
        torch.from_numpy(seeds.astype(np.int64)),
        torch.zeros(len(seeds), dtype=torch.int32), n_k=_lim(k),
        m_max=_lim(m), max_steps=60000)
    return jobs, out, gated, jrc, seeds


def _k9_both(data, cfg):
    """(port K9 table, port K6 (scal, qqp), JAX derive's scal/qqp_r as
    numpy, A outputs, port A table, seeds)."""
    _id, n, s, qt, maq, nofw, norc, _k, _m = cfg
    jobs, out, gated, jrc, seeds = _launch_a(data, cfg)
    t = {k: torch.from_numpy(np.ascontiguousarray(jobs[k]))
         for k in ("base_codes", "base_qual", "base_plen")}
    qr = torch.from_numpy(QUAL_ROUNDS.astype(np.int32))
    scal = tn.derive_b_jobs(out, torch.from_numpy(gated), t["base_qual"],
                            t["base_plen"], qr, J=tn.J_B, jrc=jrc, n=n, s=s,
                            qt=qt, maxbts=MAXBTS, maq=maq, norc=norc,
                            nofw=nofw)
    rows = td.derive_rows(scal, t["base_codes"], t["base_qual"],
                          t["base_plen"], data["fc"])
    st_a = {k: jnp.asarray(out[k].numpy()) for k in
            ("mode", "result", "overflow", "npart", "part_job", "part_pos",
             "part_refc", "part_n")}
    fn = jax.jit(partial(
        jn._derive_b_jobs_device, J=tn.J_B, jrc=jrc, n=n, s=s, qt=qt,
        maxbts=MAXBTS, maq=maq, norc=norc, nofw=nofw, L=L, fc=data["fc"]))
    ref = fn(st_a, jnp.asarray(gated), jnp.asarray(jobs["base_codes"]),
             jnp.asarray(jobs["base_qual"]), jnp.asarray(jobs["base_plen"]),
             jnp.asarray(QUAL_ROUNDS.astype(np.int32)))
    return scal, rows, {k: np.asarray(ref[k]) for k in ("scal", "qqp_r")}, \
        out, jobs, seeds


@pytest.mark.parametrize("cfg", CFGS, ids=[c[0] for c in CFGS])
def test_derive_b_jobs_matches_jax(data, cfg):
    assert tn.J_B == jn.P_MAX + 4 and td.P_MAX == jd.P_MAX
    scal, (scal6, qqp6), ref, out, _jobs, _seeds = _k9_both(data, cfg)
    B = len(data["tr"])
    want = ref["scal"].reshape(B, tn.J_B, td.NJF)
    keep = [i for i, f in enumerate(td.JOB_FIELDS)
            if f not in ("ns_gate", "ns_ftab")]
    for i in keep:
        np.testing.assert_array_equal(scal[..., i].numpy(), want[..., i],
                                      err_msg=td.JOB_FIELDS[i])
    np.testing.assert_array_equal(scal6.numpy(), want)
    np.testing.assert_array_equal(qqp6.numpy(), ref["qqp_r"])
    valid = scal[..., td.JOB_FIELDS.index("valid")]
    npremut = scal[..., td.JOB_FIELDS.index("npremut")]
    assert int(out["npart"].sum()) > 0 and int(valid.sum()) > 0
    if cfg[1] > 1:
        assert int((npremut > 1).sum()) > 0           # multi-mutation seeds


# (id, cfg id, max_steps)
MACHINE_B = [("n2_k1", "n2", 60000), ("n3_a", "n3_a", 60000),
             ("n2_norc_budget", "n2_norc", 60)]


@pytest.mark.parametrize("name,cfg_id,max_steps", MACHINE_B,
                         ids=[c[0] for c in MACHINE_B])
def test_launch_b_machine_matches_jax(data, name, cfg_id, max_steps):
    cfg = _BY_ID[cfg_id]
    scal, (scal6, qqp6), ref, out_a, jobs, seeds = _k9_both(data, cfg)
    k, m = _lim(cfg[7]), _lim(cfg[8])
    B = len(seeds)
    jdev = jd.upload_jobs({"scal": ref["scal"], "qqp_r": ref["qqp_r"]},
                          tn.J_B, L, data["fc"])
    jout, jit = jd.run_machine(
        data["cat"], jdev, seeds, out_a["count"].numpy(), J=tn.J_B, L=L,
        nfrag=data["nfrag"], n_k=k, m_max=m, max_steps=max_steps)
    tout, tit = td.run_machine(
        data["pair"], {"scal": scal6, "qqp": qqp6},
        torch.from_numpy(seeds.astype(np.int64)), out_a["count"], n_k=k,
        m_max=m, max_steps=max_steps)
    assert int(tit) == int(jit)
    for key in td.OUT_KEYS:
        want = np.asarray(jout[key]).astype(np.int64)
        if key == "rng":
            want &= 0xFFFFFFFF
        np.testing.assert_array_equal(tout[key].numpy().astype(np.int64),
                                      want, err_msg=key)
    done = tout["mode"] == td.M_DONE
    if max_steps < 60000:
        assert int(tit) == max_steps and 0 < int((~done).sum()) < B
    else:
        assert bool(done.all()) and int(tout["nhits"].sum()) > 0
    if cfg[7] == INF and cfg[8] == INF:
        assert bool(tout["overflow"].any())            # > H_MAX hits


def _key(r):
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost,
              tuple(h.mms)) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


@pytest.mark.parametrize("kw,kh,mh", [
    (dict(seed_mms=2), INF, INF),
    (dict(seed_mms=3, seed_len=20, qual_thresh=90), 2, INF),
    (dict(seed_mms=1, maq_round=False, norc=True), INF, 4)],
    ids=["n2_a", "n3_l20_e90_k2", "n1_nomaq_norc_a_m4"])
def test_aligner_matches_jax(data, kw, kh, mh):
    # the reference derives launch B on the host on a CPU backend, the
    # per-read _jobs_b: K9's plain version is held to that derivation too
    with mock.patch.object(jj, "derive_rows_enabled", lambda: False):
        jal = jn.DeviceNAligner(data["ji"], data["jb"],
                                j_pol.KPolicy(khits=kh, mhits=mh), **kw)
        want = [_key(r) for r in jal.align_batch(data["jr"])]
    tal = tn.DeviceNAligner(data["ti"], data["tb"],
                            t_pol.KPolicy(khits=kh, mhits=mh), device="cpu",
                            **kw)
    td.FALLBACKS["lanes"] = 0
    assert [_key(r) for r in tal.align_batch(data["tr"])] == want
    assert td.FALLBACKS["lanes"] == jal.fallbacks
    if kh == INF and mh == INF:
        assert jal.fallbacks > 0          # H_MAX overflow, oracle re-run
