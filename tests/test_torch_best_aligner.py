"""DeviceBestAligner(device="cpu") -- the exact gate on K2's plain
version, the plain K10 and K11, the host-engine re-run of overflowing
lanes -- against bowtie_tpu's host best-first engine, ReadResult for
ReadResult, over the -v rows of tests/test_torch_best_host.py's GRID
(tests/test_torch_best_seeded.py takes the -n rows), on its index: the
reference's DeviceBestAligner equals that host engine
(tests/test_best_device.py), and the port must too."""
import pytest

from bowtie_tpu.align import best_factories as jbf
from bowtie_tpu.align import golden as jg
from bowtie_tpu_torch.align import best_device as tbd
from test_torch_best_host import (GRID, INF, host_aligner,
                                  make_best_data, policies, result_key)

V_ROWS = [g for g in GRID if g[1].get("mode") != "n"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_best_data(tmp_path_factory.mktemp("torch_best_aligner"))


def check_aligner(data, kw, pol):
    """The port's DeviceBestAligner on the CPU against the reference's
    host engine; -> the aligner (for its counters)."""
    jp, tp = policies(pol)
    want = [result_key(r) for r in host_aligner(
        jbf, jg, data["ji"], data["jb"], kw, jp).align_batch(data["jr"])]
    dkw = dict(kw)
    if dkw.get("mode") == "n":
        dkw.setdefault("maxbts", 800)
    al = tbd.DeviceBestAligner(data["ti"], data["tb"], tp, device="cpu",
                               **dkw)
    got = [result_key(r) for r in al.align_batch(data["tr"])]
    assert got == want
    k, m, sample = pol
    if (k == 1 and m == INF and not sample and not kw.get("strata")
            and not kw.get("all_hits")):
        # first-1 policies: the exact gate answers the exact reads
        assert any(r is not None for r in al._exact_gate(data["tr"]))
    # the 3- and 300-base reads, and whatever overflowed, re-ran on the
    # host engine
    assert al.fallbacks >= 2
    return al


@pytest.mark.parametrize("name,kw,pol", V_ROWS, ids=[g[0] for g in V_ROWS])
def test_device_best_aligner_matches_host_engine(data, name, kw, pol):
    al = check_aligner(data, kw, pol)
    if kw.get("all_hits") and kw["v"] >= 1 and not kw.get("nofw"):
        # reads of the 20-copy repeat overflow the 16 hit slots
        assert al.fallbacks > 2
