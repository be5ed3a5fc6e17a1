"""The paired --best and --pev2 rows of tests/test_simple_cases.py's case
table (but --reportse, which runs on the V2 host engine and stays in
tests/test_torch_pe_cases.py) through both CLIs: the port's on the CPU,
whose V2 engine replays merged streams recorded by the plain K14
(align/pev2_device.py), against bowtie_tpu.cli.align.main with its V2 host
engine (BOWTIE_TPU_HOST_ENGINE=1); hits, every dump and the stderr
summary byte for byte, as tests/test_torch_pe_cases.py compares them.
Then --stats on the table's pairs: the same summary, plus the fallback
line the JAX CLI prints for its recorded V2 engine."""
import contextlib
import io
import re

import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.align.pev2_device import DevicePairedV2Aligner
from bowtie_tpu_torch.cli import align as tcli
from test_torch_pe_cases import (PE_ROWS, case_parity, make_pe_env,
                                 on_host_engine, on_v2_engine)

ROWS = [c for c in PE_ROWS if on_v2_engine(c[2]) and not on_host_engine(c[2])]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_pe_env(tmp_path_factory.mktemp("torch_pev2_cases"))


@pytest.fixture
def built(monkeypatch):
    """The aligners the port's CLI builds."""
    out = []
    real = tcli.build_aligner

    def build(*a, **k):
        out.append(real(*a, **k))
        return out[-1]
    monkeypatch.setattr(tcli, "build_aligner", build)
    return out


@pytest.mark.parametrize("cid,infmt,case_args", ROWS,
                         ids=[c[0] for c in ROWS])
def test_pev2_case_parity(cid, infmt, case_args, env, tmp_path, monkeypatch,
                          built):
    case_parity(case_args, infmt, env, tmp_path, monkeypatch)
    assert isinstance(built[0], DevicePairedV2Aligner)


def test_pev2_rows():
    """Every --best/--pev2 row but --reportse is here, and only those."""
    assert len(ROWS) == 16
    assert all("--reportse" not in c[2] for c in ROWS)


def _stderr(main, argv, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(argv, **kw) == 0
    return re.sub(r"wall time: .*", "wall time: -", err.getvalue())


@pytest.mark.parametrize("args", [["-n", "2", "--best"],
                                  ["--pev2", "-v", "1", "-k", "2"]],
                         ids=["n2_best", "pev2_v1_k2"])
def test_pev2_stats(args, env, tmp_path, monkeypatch, built):
    """--stats: the reference's summary on its host engine, and the line
    with the recorded engine's host re-runs, which the JAX CLI prints for
    its DevicePairedV2Aligner (bowtie_tpu/cli/align.py:914, 920)."""
    m1, m2 = env["files"]["pe1"][1], env["files"]["pe2"][1]
    argv = args + ["--stats", env["base"], "-1", m1, "-2", m2]
    monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    want = _stderr(jcli.main, argv + [str(tmp_path / "jax.out")])
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE")
    got = _stderr(tcli.main, argv + [str(tmp_path / "torch.out")],
                  device="cpu")
    al = built[0]
    assert isinstance(al, DevicePairedV2Aligner)
    line = re.search(r"  device-pool overflow fallbacks: (\d+) \(.*\n", got)
    assert "AlignerMetrics:" in want and line
    assert int(line.group(1)) == al.fallbacks
    assert got.replace(line.group(0), "", 1) == want
    assert (tmp_path / "torch.out").read_bytes() == \
        (tmp_path / "jax.out").read_bytes()
