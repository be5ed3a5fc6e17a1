"""The best-first engine's host side against the reference package, on an
index built here by the port's builder from a seeded genome whose 200 bp
repeat has 20 copies (so -a reads overflow the machine's 16 hit slots):

- the host engine (align/best.py, best_driver.py, best_factories.py, JAX-
  free copies) against bowtie_tpu's make_best_aligner and
  make_seeded_best_aligner, ReadResult for ReadResult, over the grid of
  GRID below;
- the machine's host part (HostInit.build, the driver config arrays,
  _outer_min_cost and _emulate_sort_actives) against the reference's,
  array for array;
- K11's plain version (best_pack_plain, unpacked) against the reference's
  _harvest, field for field, on a synthetic machine state.

Exact equality throughout: this is integer code."""
import numpy as np
import pytest
import torch

from bowtie_tpu.align import best_device as jbd
from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu.align import policy as j_pol
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu.utils import rng as j_rng
from bowtie_tpu_torch.align import best_device as tbd
from bowtie_tpu_torch.align import best_factories as tbf
from bowtie_tpu_torch.align import golden as tg
from bowtie_tpu_torch.align import policy as t_pol
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd
from bowtie_tpu_torch.utils.alphabet import codes_to_seq
from bowtie_tpu_torch.utils.rng import BtRandom

INF = 0xFFFFFFFF

# (id, mode kwargs, policy (khits, mhits, -M)): -v 0..3 under -k 1, -k 3
# --strata, -a and -M 2, and -n 1..3 under --best, -M 1 and --strata -k 2,
# with --nofw, --norc, --nomaqround and --maxbts 2 among them
GRID = [
    ("v0_k1", dict(v=0), (1, INF, False)),
    ("v0_k3_strata", dict(v=0, strata=True), (3, INF, False)),
    ("v0_a_norc", dict(v=0, all_hits=True, norc=True), (INF, INF, False)),
    ("v0_M2", dict(v=0), (1, 2, True)),
    ("v1_k1_nofw", dict(v=1, nofw=True), (1, INF, False)),
    ("v1_k3_strata", dict(v=1, strata=True), (3, INF, False)),
    ("v1_a", dict(v=1, all_hits=True), (INF, INF, False)),
    ("v1_M2_nomaqround", dict(v=1, maq=False), (1, 2, True)),
    ("v2_k1", dict(v=2), (1, INF, False)),
    ("v2_k3_strata_norc", dict(v=2, strata=True, norc=True),
     (3, INF, False)),
    ("v2_a", dict(v=2, all_hits=True), (INF, INF, False)),
    ("v2_M2", dict(v=2), (1, 2, True)),
    ("v3_k1_nomaqround", dict(v=3, maq=False), (1, INF, False)),
    ("v3_k3_strata", dict(v=3, strata=True), (3, INF, False)),
    ("v3_a_nofw", dict(v=3, all_hits=True, nofw=True), (INF, INF, False)),
    ("v3_M2", dict(v=3), (1, 2, True)),
    ("n1_best", dict(mode="n", seed_mms=1), (1, INF, False)),
    ("n1_M1_nofw", dict(mode="n", seed_mms=1, nofw=True), (1, 1, True)),
    ("n1_strata_k2", dict(mode="n", seed_mms=1, strata=True),
     (2, INF, False)),
    ("n2_best_l18_e200", dict(mode="n", seed_mms=2, seed_len=18,
                              qual_cutoff=200), (1, INF, False)),
    ("n2_M1", dict(mode="n", seed_mms=2), (1, 1, True)),
    ("n2_strata_k2_maxbts2", dict(mode="n", seed_mms=2, strata=True,
                                  maxbts=2), (2, INF, False)),
    ("n3_best_l18_norc", dict(mode="n", seed_mms=3, seed_len=18, norc=True),
     (1, INF, False)),
    ("n3_M1_nomaqround", dict(mode="n", seed_mms=3, maq=False), (1, 1, True)),
    ("n3_strata_k2_l18_e200", dict(mode="n", seed_mms=3, seed_len=18,
                                   qual_cutoff=200, strata=True),
     (2, INF, False)),
]


def make_best_data(d, n_reads=56, host_only=True):
    """The genome (two records, a 200 bp repeat planted 20 times), its
    index built by the port's builder, and seeded reads of 24-40 bases:
    exact, 1-3 mismatches, Ns, reverse complements, repeat copies, and
    (with host_only) one 3-base and one 300-base read, which the machine
    leaves to the host engine.  -> dict with the index base and both
    packages' reads and indexes."""
    rng = np.random.default_rng(11)
    rep = rng.integers(0, 4, 200).astype(np.uint8)
    seqs = []
    for ln in (9000, 7000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.choice(np.arange(0, ln - 200, 300), 10, replace=False):
            s[p:p + 200] = rep
        seqs.append(s)
    base = str(d / "g")
    build_index(seqs, ["chrA first", "chrB"], base)
    lines = []
    for k in range(n_reads):
        s = seqs[k % 2]
        ln = int(rng.integers(24, 41))
        if host_only and k in (7, 9):
            ln = 3 if k == 7 else 300
        p = int(rng.integers(0, len(s) - ln))
        q = (rep[:ln] if k % 7 == 3 else s[p:p + ln]).copy()
        for _ in range(k % 4):                         # 0-3 mismatches
            q[int(rng.integers(ln))] = rng.integers(0, 4)
        if k % 11 == 5:
            q[int(rng.integers(ln))] = 4
        if k % 4 == 1:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
        lines.append(f"@r{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    fq = d / "r.fq"
    fq.write_text("".join(lines))
    return dict(base=base,
                jr=list(j_rd.ReadSource([str(fq)], "fastq").records()),
                tr=list(t_rd.ReadSource([str(fq)], "fastq").records()),
                ji=j_io.read_ebwt(base), jb=j_io.read_ebwt(base + ".rev"),
                ti=t_io.read_ebwt(base), tb=t_io.read_ebwt(base + ".rev"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_best_data(tmp_path_factory.mktemp("torch_best_host"))


def policies(pol):
    k, m, sample = pol
    return (j_pol.KPolicy(k, m, sample_max=sample),
            t_pol.KPolicy(k, m, sample_max=sample))


def result_key(r):
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost, tuple(h.mms))
             for h in r.hits], r.maxed, r.nvalid, r.sampled, r.nbuffered)


def host_aligner(pkg, golden, idx, idx_bw, kw, policy, global_seed=0):
    """The package's host engine for a GRID row."""
    kw = dict(kw)
    mode = kw.pop("mode", "v")
    g = (golden.GoldenFM(idx), golden.GoldenFM(idx_bw))
    common = dict(strata=kw.pop("strata", False),
                  all_hits=kw.pop("all_hits", False),
                  global_seed=global_seed, **kw)
    if mode == "n":
        common.setdefault("maxbts", 800)
        return pkg.make_seeded_best_aligner(
            *g, common.pop("seed_mms"), common.pop("seed_len", 28),
            common.pop("qual_cutoff", 70), policy, **common)
    return pkg.make_best_aligner(*g, common.pop("v"), policy, **common)


@pytest.mark.parametrize("name,kw,pol", GRID, ids=[g[0] for g in GRID])
def test_host_engine_matches_jax(data, name, kw, pol):
    jp, tp = policies(pol)
    ja = host_aligner(jbf, jg, data["ji"], data["jb"], kw, jp)
    ta = host_aligner(tbf, tg, data["ti"], data["tb"], kw, tp)
    want = [result_key(r) for r in ja.align_batch(data["jr"])]
    got = [result_key(r) for r in ta.align_batch(data["tr"])]
    assert got == want
    assert any(w[0] for w in want)


def _outers(kw):
    if kw.get("mode") == "n":
        return ("seeded_mode_configs", (kw["seed_mms"], kw.get("nofw", False),
                                        kw.get("norc", False)),
                kw.get("seed_len", 28), kw.get("qual_cutoff", 70))
    return ("v_mode_configs", (kw["v"], kw.get("nofw", False),
                               kw.get("norc", False)), 0, jbd.INF32)


@pytest.mark.parametrize("name,kw,pol", GRID[::2], ids=[g[0] for g in
                                                       GRID[::2]])
def test_host_init_matches_jax(data, name, kw, pol):
    """HostInit.build, the config arrays, the initial outer costs and the
    set_query sort draws, for every other GRID row."""
    fn, args, sl, ql = _outers(kw)
    maq, qo = kw.get("maq", True), True
    jo, to = getattr(jbd, fn)(*args), getattr(tbd, fn)(*args)
    assert [repr(o) for o in jo] == [repr(o) for o in to]
    jh = jbd.HostInit(jo, data["ji"], data["jb"], maq, qo, ql, sl)
    th = tbd.HostInit(to, data["ti"], data["tb"], maq, qo, ql, sl)
    assert set(th.cfg) == set(jh.cfg)          # o_m1 included
    for k in th.cfg:
        np.testing.assert_array_equal(th.cfg[k], jh.cfg[k], err_msg=k)
    rows = [i for i, r in enumerate(data["tr"]) if 4 <= len(r.seq) <= 255]
    seeds = j_rng.fill_seed_caches([data["jr"][i] for i in rows], 0)
    jst = jh.build([data["jr"][i] for i in rows], 40, seeds)
    tst = th.build([data["tr"][i] for i in rows], 40, seeds)
    assert set(jst) == set(tst)
    for k in jst:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    for jr, tr, sd in zip([data["jr"][i] for i in rows],
                          [data["tr"][i] for i in rows], seeds):
        jc = [jbd._outer_min_cost(o, jr, sl, maq, qo) for o in jo]
        tc = [tbd._outer_min_cost(o, tr, sl, maq, qo) for o in to]
        assert tc == jc
        assert tbd._emulate_sort_actives(tc, BtRandom(int(sd))) == \
            jbd._emulate_sort_actives(jc, j_rng.BtRandom(int(sd)))


def test_best_pack_matches_harvest():
    """K11's plain version, unpacked, against the reference's _harvest on
    a synthetic state: lanes with 0..16 hits, overflow flags, and a subset
    of lanes harvested."""
    rng = np.random.default_rng(3)
    B = 37
    st = {"result": rng.integers(0, 3, B).astype(np.int32),
          "overflow": rng.random(B) < 0.2,
          "count": rng.integers(0, 40, B).astype(np.int32),
          "best_stratum": rng.integers(0, 4, B).astype(np.int32),
          "nhits": rng.integers(0, tbd.H_MAX + 1, B).astype(np.int32),
          "hits": rng.integers(-5, 1 << 20, (B, tbd.H_MAX * tbd.HIT_W))
          .astype(np.int32)}
    st["nhits"][:3] = (0, tbd.H_MAX, 1)
    idxs = np.arange(B)
    want = jbd._harvest({k: jbd.jnp.asarray(v) for k, v in st.items()},
                        idxs)
    out = {k: torch.from_numpy(v) for k, v in st.items()}
    packed = tbd.best_pack_plain(out)
    assert packed.dtype == torch.int32
    assert packed.numel() == 5 * B + tbd.HIT_W * int(st["nhits"].sum())
    got = tbd.unpack_harvest(packed.numpy(), B)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
