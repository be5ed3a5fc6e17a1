"""The paired rows of tests/test_simple_cases.py's case table that the
port runs on its recorded V1 engine (align/pe_device.py: the anchor
streams recorded by the plain K10r on the CPU, the interleave replayed on
the host), byte for byte against bowtie_tpu.cli.align.main with its host
paired engines; tests/test_torch_pe_cases.py says how, and holds the rows
that run on host engines; tests/test_torch_pev2_cases.py the rows of the
recorded V2 engine."""
import pytest

from test_torch_pe_cases import PE_ROWS, case_parity, make_pe_env, \
    on_host_engine, on_v2_engine

ROWS = [c for c in PE_ROWS
        if not (on_host_engine(c[2]) or on_v2_engine(c[2]))]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_pe_env(tmp_path_factory.mktemp("torch_pe_recorded"))


@pytest.mark.parametrize("cid,infmt,case_args", ROWS,
                         ids=[c[0] for c in ROWS])
def test_pe_recorded_parity(cid, infmt, case_args, env, tmp_path,
                            monkeypatch):
    case_parity(case_args, infmt, env, tmp_path, monkeypatch)
