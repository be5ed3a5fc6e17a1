"""The paired recorder against the reference's V1 host engine, on 150
seeded pairs (300 mates, 600 anchor streams) plus two pairs with a 3-base
and a 300-base mate:

- the streams the plain K10r records (DevicePairedBestAligner._record_all
  on the CPU) against the range sequences the reference's live host
  drivers emit (bowtie_tpu's make_paired_best_aligner driver factory,
  each driver drained with its own --maxbts ceiling, as a machine lane
  runs it): every range's top, bot, cost, stratum, strand, index,
  mismatches and done-at-emission flag; uncapped streams in full, capped
  ones (rec_cap 12) as prefixes whose done column says whether the driver
  had more.

tests/test_torch_pe_aligner.py holds DevicePairedBestAligner(device="cpu")
to the reference's V1 host engine on the same pairs."""
import pytest

from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu.align.best import ADV_FOUND_RANGE
from bowtie_tpu.align.policy import KPolicy as JPolicy
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu_torch.align import pe_device as tpe
from bowtie_tpu_torch.align.policy import KPolicy as TPolicy
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_machine import make_pe_data

N_PAIRS = 150
INF = 0xFFFFFFFF


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_pe_data(tmp_path_factory.mktemp("torch_pe_streams"), N_PAIRS,
                     odd_mates=True)
    recs, packed = t_io.read_bitpair_reference(d["base"])
    d["trefs"] = t_io.unpack_reference(recs, packed, plen=d["ti"].plen)
    recs, packed = j_io.read_bitpair_reference(d["base"])
    d["jrefs"] = j_io.unpack_reference(recs, packed, plen=d["ji"].plen)
    return d


def _key(fr, done):
    return (fr.top, fr.bot, fr.cost, fr.stratum, bool(fr.fw),
            bool(fr.ebwt_fw), list(fr.mms), list(fr.refcs), bool(done))


def live_streams(data, kw, pairs):
    """Each pair's four live host drivers, drained in the factory's order
    [d1f, d1r, d2f, d2r]: the (range, done-at-emission) sequences."""
    host = jbf.make_paired_best_aligner(
        jg.GoldenFM(data["ji"]), jg.GoldenFM(data["jb"]), data["jrefs"],
        JPolicy(), **kw)
    out = []
    for rd1, rd2 in pairs:
        streams = []
        for d in host.driver_factory(rd1, rd2):
            if getattr(d, "bt_cell", None) is not None:
                d.bt_cell[0] = d.bt_init     # a lane's own ceiling
            seq = []
            while not d.done:
                d.advance(ADV_FOUND_RANGE)
                if d.found_range:
                    d.found_range = False
                    seq.append(_key(d.range(), d.done))
            streams.append(seq)
        out.append(streams)
    return out


STREAM_CASES = [
    ("n2_capped", dict(mode="n", seed_mms=2, seed_len=28, qual_cutoff=70),
     12),
    ("v2_uncapped", dict(mode="v", v=2), None),
]


@pytest.mark.parametrize("kw,cap", [c[1:] for c in STREAM_CASES],
                         ids=[c[0] for c in STREAM_CASES])
def test_streams_match_live_drivers(data, kw, cap):
    pairs_t = data["tp"][:N_PAIRS]
    tal = tpe.DevicePairedBestAligner(data["ti"], data["tb"], data["trefs"],
                                      TPolicy(), device="cpu", **kw)
    idxs = list(range(N_PAIRS))
    seeds = fill_seed_caches([p[0] for p in pairs_t], 0)
    sts, ovd = tal._record_all(tal.plan(pairs_t), idxs, seeds, cap)
    live = live_streams(data, kw, data["jp"][:N_PAIRS])
    held = capped = 0
    for i in idxs:
        if ovd[i]:
            continue
        for slot in range(4):
            s, want = sts[i][slot], live[i][slot]
            got = []
            for t in range(len(s)):
                fr, done = s.materialize(t)
                got.append(_key(fr, done))
            held += 1
            if s.capped:
                capped += 1
                assert len(got) == cap, (i, slot)
                # the capped record: done column 2, the driver not done
                assert [g[:-1] for g in got] == [w[:-1]
                                                 for w in want[:cap]]
                assert got[:-1] == want[:cap - 1] and not want[cap - 1][-1]
            else:
                assert got == want, (i, slot)
    assert held >= 2 * 200          # the streams of 200 mates or more
    assert (capped > 0) == (cap is not None)
    assert any(ovd.values())
