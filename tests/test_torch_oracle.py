"""The port's host oracle against the reference package's: GoldenFM,
GreedyDFS through OracleAligner for -v 1, -v 2 and -n, and the reporting
policy's finish, on the in-repo small index (fw + mirror, 5 fragments)
with reads made from a seed.  Exact equality throughout: this is integer
code."""
import os

import numpy as np
import pytest

from bowtie_tpu.align import drivers as j_drv
from bowtie_tpu.align import golden as j_gold
from bowtie_tpu.align import policy as j_pol
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu_torch.align import drivers as t_drv
from bowtie_tpu_torch.align import golden as t_gold
from bowtie_tpu_torch.align import policy as t_pol
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")
INF = 0xFFFFFFFF


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    refs = t_io.unpack_reference(*t_io.read_bitpair_reference(BASE))
    rng = np.random.default_rng(11)
    lines = []
    for k in range(120):
        r = refs[k % len(refs)]
        ln = int(rng.integers(20, 45))
        p = int(rng.integers(0, max(1, len(r) - ln)))
        q = np.minimum(r[p:p + ln], 4).copy()
        for _ in range(k % 4):                       # 0-3 mismatches
            q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        if k % 7 == 3:
            q[int(rng.integers(len(q)))] = 4
        if k % 2:
            q = np.where(q < 4, 3 - q, 4)[::-1]
        seq = "".join("ACGTN"[c] for c in q)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(q)))
        lines.append(f"@q{k}\n{seq}\n+\n{qual}\n")
    fq = tmp_path_factory.mktemp("oracle") / "reads.fq"
    fq.write_text("".join(lines))
    out = {}
    for tag, io_, rd, gold in (("jax", j_io, j_rd, j_gold),
                               ("torch", t_io, t_rd, t_gold)):
        fw, bw = io_.read_ebwt(BASE), io_.read_ebwt(BASE + ".rev")
        out[tag] = (gold.GoldenFM(fw), gold.GoldenFM(bw),
                    list(rd.ReadSource([str(fq)], "fastq").records()))
    return out


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "blocks"])
def test_golden_fm_equal(dense):
    for base in (BASE, BASE + ".rev"):
        jg = j_gold.GoldenFM(j_io.read_ebwt(base), dense=dense)
        tg = t_gold.GoldenFM(t_io.read_ebwt(base), dense=dense)
        n = jg.idx.bwt_len
        rows = list(range(0, n, 7)) + [n - 1, n]
        assert [jg.lf4(i) for i in rows] == [tg.lf4(i) for i in rows]
        assert [jg.rank(2, i) for i in rows] == [tg.rank(2, i) for i in rows]
        got = [tg.resolve_row(i) for i in range(0, n, 3)]
        assert [jg.resolve_row(i) for i in range(0, n, 3)] == got
        for off in range(0, jg.idx.length, 97):
            assert jg.joined_to_text_off(30, off, base == BASE) == \
                tg.joined_to_text_off(30, off, base == BASE)
        np.testing.assert_array_equal(jg.restore(), tg.restore())


def _key(r):
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost,
              tuple(h.mms)) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


ORACLE_CASES = [
    ("v1_k1", dict(v=1), (1, INF)),
    ("v1_a_m3", dict(v=1), (INF, 3)),
    ("v2_k2_nofw", dict(v=2, nofw=True), (2, INF)),
    ("v2_a_norc_seed", dict(v=2, norc=True, global_seed=9), (INF, INF)),
    ("n2", dict(mode="n"), (1, INF)),
    ("n3_l20_a", dict(mode="n", seed_mms=3, seed_len=20), (INF, 4)),
    ("n1_e40_nomaq", dict(mode="n", seed_mms=1, qual_thresh=40,
                          maq_round=False, maxbts=30), (3, INF)),
]


@pytest.mark.parametrize("name,kw,pol", ORACLE_CASES,
                         ids=[c[0] for c in ORACLE_CASES])
def test_oracle_aligner_equal(env, name, kw, pol):
    res = {}
    for tag, drv, polm in (("jax", j_drv, j_pol), ("torch", t_drv, t_pol)):
        g_fw, g_bw, reads = env[tag]
        policy = polm.KPolicy(khits=pol[0], mhits=pol[1])
        ora = drv.OracleAligner(g_fw, g_bw, policy, **kw)
        res[tag] = [_key(r) for r in ora.align_batch(reads)]
    assert res["jax"] == res["torch"]
    assert any(k[0] for k in res["torch"])            # some reads align


class _H:
    def __init__(self, stratum):
        self.stratum = stratum


FINISH_CASES = [
    ("maxed", dict(khits=INF, mhits=2), 3),
    ("maxed_k1", dict(khits=1, mhits=2), 4),
    ("k2", dict(khits=2), 1),
    ("k2_more", dict(khits=2), 5),
    ("a", dict(khits=INF), 4),
    ("m3_under", dict(khits=INF, mhits=3), 3),
]


@pytest.mark.parametrize("name,kw,count", FINISH_CASES,
                         ids=[c[0] for c in FINISH_CASES])
def test_policy_finish_equal(name, kw, count):
    hits = [_H(s) for s in (1, 1, 1, 2, 2)][:count]
    for seed in (0, 17, 123456789):
        j = j_pol.KPolicy(**kw).finish(list(hits), count, seed)
        t = t_pol.KPolicy(**kw).finish(list(hits), count, seed)
        assert (j.hits, j.maxed, j.nvalid, j.sampled, j.nbuffered) == \
            (t.hits, t.maxed, t.nvalid, t.sampled, t.nbuffered)
