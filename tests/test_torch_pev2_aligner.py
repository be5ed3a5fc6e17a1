"""DevicePairedV2Aligner(device="cpu") (the merged stream recorded by the
plain K14, the V2 control loop replayed on the host) against the
reference's V2 host engine (bowtie_tpu's make_paired_best_aligner_v2
product), ReadResult for ReadResult (tests/test_pev2_device.py's key), on
seeded pairs (make_pe_data: mates of 20-48 bases, random mates, repeats)
plus a pair with a 3-base mate and one with a 300-base mate, which the
machine leaves to the host engine (`fallbacks`).  Three configurations of
tests/test_pev2_device.py and -n 3 --best; at rec_cap 8 some pairs outrun
their capped stream and are recorded again uncapped (`escalations`).
With threads=2 a fork pool replays the streams and re-runs the host
engine's pairs.
tests/test_torch_pev2_aligner_policies.py holds the fourth and the other
policies."""
import pytest

from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu.align.policy import KPolicy as JPolicy
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu_torch.align import pev2_device as tv2
from bowtie_tpu_torch.align.policy import KPolicy as TPolicy
from bowtie_tpu_torch.index import ebwt_io as t_io
from test_pev2_device import _hits_key
from test_torch_pe_machine import make_pe_data

N_PAIRS = 30
INF = 0xFFFFFFFF


def pev2_data(d):
    data = make_pe_data(d, N_PAIRS, max_len=48, seed=5, odd_mates=True)
    recs, packed = t_io.read_bitpair_reference(data["base"])
    data["trefs"] = t_io.unpack_reference(recs, packed, plen=data["ti"].plen)
    recs, packed = j_io.read_bitpair_reference(data["base"])
    data["jrefs"] = j_io.unpack_reference(recs, packed, plen=data["ji"].plen)
    return data


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return pev2_data(tmp_path_factory.mktemp("torch_pev2_aligner"))


def aligner_case(data, cfg, k=1, m=INF, n_pairs=None, swap=False,
                 threads=1):
    """Both engines on the pairs (the odd two last; with swap, each pair's
    mates swapped, which turns make_pe_data's --fr pairs into the other
    pair orientation; threads: the port's replay pool); -> the port's
    aligner, after asserting equal results."""
    pairs_j, pairs_t = data["jp"], data["tp"]
    if n_pairs is not None:
        pairs_j = pairs_j[:n_pairs] + pairs_j[-2:]
        pairs_t = pairs_t[:n_pairs] + pairs_t[-2:]
    if swap:
        pairs_j = [(b, a) for a, b in pairs_j]
        pairs_t = [(b, a) for a, b in pairs_t]
    jal = jbf.make_paired_best_aligner_v2(
        jg.GoldenFM(data["ji"]), jg.GoldenFM(data["jb"]), data["jrefs"],
        JPolicy(k, m), **cfg)
    tal = tv2.DevicePairedV2Aligner(data["ti"], data["tb"], data["trefs"],
                                    TPolicy(k, m), device="cpu",
                                    threads=threads, **cfg)
    want = [_hits_key(jal.align_pair(a, b)) for a, b in pairs_j]
    got = [_hits_key(r) for r in tal.align_batch(pairs_t)]
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, cfg)
    assert len(got) == len(want)
    assert sum(1 for g in got if g[0]) > 0
    # the 3-base and the 300-base mate always run on the host engine
    assert tal.fallbacks >= 2 or not tal.use_device
    return tal


# (configuration, pairs taken besides the odd two, the port's threads)
CASES = [
    ("n2_best", dict(mode="n", seed_mms=2, better=True), N_PAIRS, 1),
    ("n2_best_p2", dict(mode="n", seed_mms=2, better=True), N_PAIRS, 2),
    ("n1", dict(mode="n", seed_mms=1, better=False), N_PAIRS, 1),
    ("v1_best", dict(mode="v", v=1, better=True), N_PAIRS, 1),
    ("n3_best", dict(mode="n", seed_mms=3, better=True), 20, 1),
]


@pytest.mark.parametrize("cfg,n,threads", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_pev2_aligner_matches_host(data, cfg, n, threads):
    tal = aligner_case(data, cfg, n_pairs=n, threads=threads)
    try:
        assert tal.rec_cap == 8
        assert (tal._pool is not None) == (threads > 1)
        if cfg["mode"] == "n" and cfg["seed_mms"] == 2:
            assert tal.escalations > 0
    finally:
        tal.close()
