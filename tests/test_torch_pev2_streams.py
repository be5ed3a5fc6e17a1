"""The merged streams the plain K14 records (PairedV2Machine.record on the
CPU) against the range sequences of the reference's live host V2 driver:
bowtie_tpu's make_paired_best_aligner_v2 driver factory, its merged
CostAware drained as a lane runs it (every range, with the driver's
done-at-emission flag), under -n 2 and -n 3, the merged DAGs of 12 and 16
outer drivers that only the host engine can judge (the JAX machine
compiles them for minutes).  Each range's top, bot, cost, stratum, strand,
index, mate, mismatches and done flag; uncapped streams in full, capped
ones (the V2 aligner's rec_cap 8) as prefixes whose done column says
whether the driver had more.  One difference is the reference machine's
and is allowed where it shows: a stream's last done flag 0 where the live
driver's post-sort mate elimination gives 1.  The pairs (make_pe_data,
mates of 20-48 bases) have random mates and mates of different lengths
and seeds; lanes that overflow are the host engine's and are not
compared."""
import numpy as np
import pytest

from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu.align.best import ADV_FOUND_RANGE
from bowtie_tpu.align.policy import KPolicy as JPolicy
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu_torch.align import pev2_device as tv2
from bowtie_tpu_torch.align.policy import KPolicy as TPolicy
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_machine import make_pe_data

N_PAIRS = 24


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_pe_data(tmp_path_factory.mktemp("torch_pev2_streams"), N_PAIRS,
                     max_len=48, seed=11)
    recs, packed = t_io.read_bitpair_reference(d["base"])
    d["trefs"] = t_io.unpack_reference(recs, packed, plen=d["ti"].plen)
    recs, packed = j_io.read_bitpair_reference(d["base"])
    d["jrefs"] = j_io.unpack_reference(recs, packed, plen=d["ji"].plen)
    return d


def _key(fr, done):
    return (fr.top, fr.bot, fr.cost, fr.stratum, bool(fr.fw),
            bool(fr.ebwt_fw), bool(fr.mate1), list(fr.mms), list(fr.refcs),
            bool(done))


def live_streams(data, kw, pairs):
    """Each pair's merged host driver, drained: the (range,
    done-at-emission) sequence."""
    host = jbf.make_paired_best_aligner_v2(
        jg.GoldenFM(data["ji"]), jg.GoldenFM(data["jb"]), data["jrefs"],
        JPolicy(), **kw)
    out = []
    for rd1, rd2 in pairs:
        d = host.driver_factory(rd1, rd2)
        seq = []
        while not d.done:
            d.advance(ADV_FOUND_RANGE)
            if d.found_range:
                d.found_range = False
                seq.append(_key(d.range(), d.done))
        out.append(seq)
    return out


STREAM_CASES = [
    ("n2_cap8", dict(mode="n", seed_mms=2, seed_len=28, qual_cutoff=70), 8),
    ("n3_uncapped", dict(mode="n", seed_mms=3, seed_len=28, qual_cutoff=70),
     None),
]


@pytest.mark.parametrize("kw,cap", [c[1:] for c in STREAM_CASES],
                         ids=[c[0] for c in STREAM_CASES])
def test_streams_match_live_driver(data, kw, cap):
    tp = data["tp"]
    al = tv2.DevicePairedV2Aligner(data["ti"], data["tb"], data["trefs"],
                                   TPolicy(), device="cpu", **kw)
    assert al.machine.hostinit.nd == 4 * (kw["seed_mms"] + 1)
    s1 = fill_seed_caches([p[0] for p in tp], 0)
    s2 = fill_seed_caches([p[1] for p in tp], 0)
    streams, ovf = al.machine.record(tp, s1, s2, rec_cap=cap)
    live = live_streams(data, kw, data["jp"])
    held = capped = mate2 = late = 0
    for i, rows in enumerate(streams):
        if rows is None:
            continue
        want = live[i]

        def qlen_of(m1, i=i):
            return len(tp[i][0].seq) if m1 else len(tp[i][1].seq)
        got = [_key(al.replayer.materialize(r, qlen_of), int(r[6]))
               for r in rows]
        held += 1
        mate2 += sum(1 for g in got if not g[6])
        if cap is not None and len(rows) and int(rows[-1][6]) == 2:
            capped += 1
            assert len(got) == cap, i
            assert [g[:-1] for g in got] == [w[:-1] for w in want[:cap]], i
            assert got[:-1] == want[:cap - 1] and not want[cap - 1][-1], i
        else:
            if (len(got) == len(want) and got[:-1] == want[:-1]
                    and not got[-1][-1] and want[-1][-1]):
                # the machine, as the reference's, learns one advance
                # late of a mate elimination that the live driver's
                # post-sort check finds right after an emission: the
                # stream ends at the same range, whose done column reads
                # 0 for the driver's 1 (ROADMAP queue 3)
                late += 1
                got[-1] = got[-1][:-1] + (True,)
            assert got == want, i
    assert held >= N_PAIRS // 2 and mate2 > 0
    assert (capped > 0) == (cap is not None)
    # pair 23 of this data under -n 2 (the reference machine records
    # done 0 on its fourth and last range too)
    assert late == (1 if kw["seed_mms"] == 2 else 0)
    assert np.asarray(ovf).sum() < N_PAIRS
