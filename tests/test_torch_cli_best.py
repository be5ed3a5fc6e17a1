"""CLI parity of the best-first modes (--best, --strata, -M, -v 3) and of
--sanity, --stats and -p: the PyTorch port (on the CPU) against
bowtie_tpu.cli.align.main, byte for byte — hits file and stderr summary —
on the index of tests/torch_cli_common.py."""
import re

import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.cli import align as tcli

from torch_cli_common import _run, data  # noqa: F401  (data: a fixture)

# the best-first engine (align/best_device.py): -v's driver DAGs and -n's
# seeded one, with --strata, -M sampling (SAM and verbose) and -m
BEST_CASES = [
    ("v3_k2_S", ["-v", "3", "-k", "2", "-S", "-u", "150"]),
    ("v1_best_strata_m1", ["-v", "1", "--best", "--strata", "-m", "1",
                           "-u", "200"]),
    ("v2_M2_S", ["-v", "2", "-M", "2", "--best", "-S", "-u", "150"]),
    ("n2_M1", ["-n", "2", "-M", "1", "--best", "-u", "150"]),
    ("n3_l20_best_k2", ["-n", "3", "-l", "20", "--best", "-k", "2",
                        "-u", "100"]),
]


@pytest.mark.parametrize("name,args", BEST_CASES,
                         ids=[c[0] for c in BEST_CASES])
def test_cli_best_parity(data, name, args, monkeypatch):
    """The reference side runs its host best-first engine, which its
    device engine equals (tests/test_best_device.py), as the case table's
    rows do: each of its machine configurations is a ~20 s XLA compile."""
    base, reads, d = data
    full = args + [base, reads]
    monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE")
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) > 0


def _masked(err):
    """--stats' wall-time line, which differs from run to run, masked."""
    return re.sub(r"wall time: .*", "wall time: -", err)


@pytest.mark.parametrize("name,args", [
    ("sanity_n2", ["-n", "2", "--sanity", "-u", "150"]),
    ("sanity_v1_a", ["-v", "1", "-a", "--sanity", "-u", "150"]),
    ("sanity_v0", ["-v", "0", "-k", "2", "--sanity"]),
    ("stats_n2", ["-n", "2", "--stats", "-u", "200"]),
    ("stats_v0", ["-v", "0", "-a", "--stats"]),
    ("stats_sanity_v2", ["-v", "2", "--stats", "--sanity", "-u", "100"]),
    ("sanity_best_v2_k2", ["-v", "2", "--best", "-k", "2", "--sanity",
                           "-u", "150"]),
    ("stats_v3_a", ["-v", "3", "-a", "--stats", "-u", "150"]),
    ("sanity_n2_strata_a", ["-n", "2", "-a", "--best", "--strata",
                            "--sanity", "-u", "150"])],
    ids=lambda v: v if isinstance(v, str) else None)
def test_cli_sanity_stats_parity(data, name, args, monkeypatch):
    base, reads, d = data
    full = args + [base, reads]
    if name.startswith("sanity_") and "--best" in args:
        # the reference's host best-first engine (its --sanity is then a
        # no-op): only --stats reads its device engine's fallback count
        monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE", raising=False)
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1] and len(want[1]) > 0
    assert _masked(got[2]) == _masked(want[2])
    assert ("AlignerMetrics:" in want[2]) == ("--stats" in args)
    if name == "stats_v3_a":
        # the best-first machine's host-engine re-runs are counted
        assert re.search(r"fallbacks: [1-9]", want[2])


def test_cli_p_host_engine(data, monkeypatch):
    """-p 2 forks the host best-first engine (ParallelHostAligner) and
    writes what -p 1 writes, and what the reference CLI writes.  No CLI
    path on an index this small builds a host engine, so build_aligner is
    made to return it."""
    base, reads, d = data
    real = tcli.build_aligner
    monkeypatch.setattr(tcli, "build_aligner",
                        lambda args, idx, policy, dev, host_engine=False:
                        real(args, idx, policy, dev, host_engine=True))
    pools = []
    real_pool = tcli.ParallelHostAligner

    def pool(al, n):
        pools.append(n)
        return real_pool(al, n)
    monkeypatch.setattr(tcli, "ParallelHostAligner", pool)
    args = ["-v", "2", "--best", "-k", "2", "-u", "200", base, reads]
    want = _run(jcli.main, args, str(d / "p.jax"))
    one = _run(tcli.main, ["-p", "1"] + args, str(d / "p1.torch"),
               device="cpu")
    two = _run(tcli.main, ["-p", "2"] + args, str(d / "p2.torch"),
               device="cpu")
    assert pools == [2]
    assert one == two == want
    assert len(want[1]) > 0


def test_cli_sanity_raises_on_divergence(data, monkeypatch):
    """A device result that differs from its host twin's raises, naming
    the read; nothing catches it."""
    base, reads, d = data
    real = tcli.build_aligner

    def broken(args, idx, policy, dev, host_engine=False):
        al = real(args, idx, policy, dev, host_engine)
        if host_engine:
            return al
        align = al.align_batch

        def drop_hits(batch):
            res = align(batch)
            res[0].hits = []
            return res
        al.align_batch = drop_hits
        return al
    monkeypatch.setattr(tcli, "build_aligner", broken)
    with pytest.raises(AssertionError, match="divergence on read b'read0"):
        _run(tcli.main, ["-n", "2", "--sanity", "-u", "20", base, reads],
             str(d / "sanity_broken.torch"), device="cpu")
