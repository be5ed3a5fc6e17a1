"""K10's plain version against the reference's JAX machine for a seeded
configuration, -n 2 -M 1 -l 18 -e 200 --best (generators, extenders
created on the machine, the inner CostAware, the --maxbts ceiling), on the
dense and the compact layouts: every state array and the iteration count
chunk by chunk, K11 against _harvest, and DeviceBestAligner(device="cpu")
against the reference's DeviceBestAligner (tests/test_torch_best_machine.py
holds the -v configuration and says how)."""
import pytest

from test_torch_best_host import make_best_data
from test_torch_best_machine import CHUNK, machine_case

N_KW = dict(mode="n", seed_mms=2, seed_len=18, qual_cutoff=200)
N_POL = (1, 1, True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_best_data(tmp_path_factory.mktemp("torch_best_seeded_m"),
                          n_reads=256, host_only=False)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_plain_machine_matches_jax(data, compact, monkeypatch):
    _ovf, iters = machine_case(data, N_KW, N_POL, compact, monkeypatch)
    assert iters > CHUNK
