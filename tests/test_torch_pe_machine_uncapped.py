"""K10r against the reference's JAX machine for the seeded -n 2 DAG
(generators, extenders created on the machine, the inner CostAware, the
--maxbts ceiling) recorded uncapped, as the recorder runs it for -k > 1,
-a, -m and -M: every state array after each chunk, on the dense and the
compact layouts (tests/test_torch_pe_machine.py says how)."""
import pytest

from test_torch_pe_machine import make_pe_data, record_case


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_pe_data(tmp_path_factory.mktemp("torch_pe_machine_unc"), 4)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_record_machine_uncapped_matches_jax(data, compact):
    st, _ = record_case(data, dict(mode="n", v=0, seed_mms=2, seed_len=28,
                                   qual_cutoff=70), None, compact)
    # lanes that record several ranges, and lanes that overflow the
    # machine's bounds (their pairs re-run on the host engine)
    assert int(st["nhits"].max()) > 1
    assert bool(st["overflow"].any())
