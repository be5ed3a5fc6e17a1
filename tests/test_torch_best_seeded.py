"""DeviceBestAligner(device="cpu", mode="n") -- the seeded driver DAG
with its extenders created on the machine -- against bowtie_tpu's host
best-first engine, ReadResult for ReadResult, over the -n rows of
tests/test_torch_best_host.py's GRID (tests/test_torch_best_aligner.py
takes the -v rows)."""
import pytest

from test_torch_best_aligner import check_aligner
from test_torch_best_host import GRID, make_best_data

N_ROWS = [g for g in GRID if g[1].get("mode") == "n"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_best_data(tmp_path_factory.mktemp("torch_best_seeded"))


@pytest.mark.parametrize("name,kw,pol", N_ROWS, ids=[g[0] for g in N_ROWS])
def test_device_best_aligner_matches_host_engine(data, name, kw, pol):
    check_aligner(data, kw, pol)
