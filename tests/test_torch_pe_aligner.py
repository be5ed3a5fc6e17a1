"""DevicePairedBestAligner(device="cpu") (the anchor streams recorded by
the plain K10r, the interleave replayed on the host) against the
reference's V1 host engine, result for result, on the pairs of
tests/test_torch_pe_streams.py: the default -n 2 -k 1 policy, recorded
with phase 0 on the plain K12, then the plain K10r at rec_cap 1, whose
capped streams some pairs outrun, so that round 2 re-records them
(`escalations`), and pairs with an overflowing lane or a 3-base or
300-base mate re-run on the host drivers (`fallbacks`)."""
from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu.align.policy import KPolicy as JPolicy
from bowtie_tpu_torch.align import pe_device as tpe
from bowtie_tpu_torch.align.policy import KPolicy as TPolicy
from test_torch_pe_streams import INF, N_PAIRS, data  # noqa: F401


def pe_key(r):
    """A paired result's fields, each hit's mate fields included."""
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost, tuple(h.mms),
              h.mate, h.mfw, h.mtidx, h.mtoff, h.mlen) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


def test_aligner_matches_host_engine(data):
    kw = dict(mode="n", seed_mms=2, seed_len=28, qual_cutoff=70,
              sym_ceiling=INF)
    jal = jbf.make_paired_best_aligner(
        jg.GoldenFM(data["ji"]), jg.GoldenFM(data["jb"]), data["jrefs"],
        JPolicy(), **kw)
    tal = tpe.DevicePairedBestAligner(data["ti"], data["tb"], data["trefs"],
                                      TPolicy(), device="cpu", **kw)
    assert tal.rec_cap == 1
    want = [pe_key(r) for r in jal.align_batch(data["jp"])]
    got = [pe_key(r) for r in tal.align_batch(data["tp"])]
    assert got == want
    assert sum(1 for r in got if r[0]) > N_PAIRS // 2
    assert tal.escalations > 0 and tal.fallbacks >= 2
    assert tal.synthesized > 0
