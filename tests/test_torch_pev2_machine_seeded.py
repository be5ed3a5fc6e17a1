"""K14's plain version against the reference's JAX machine on the seeded
-n 1 merged DAG (8 outer / 24 flat drivers: generators, extenders created
on the machine, the inner CostAware), whose -n drVec order (m1fw, m2fw,
m1rc, m2rc) puts the other mate's outers between a range's strand and its
strandFix target: rec_cap 8 dense, uncapped walk-left, every state array
after each chunk (tests/test_torch_pev2_machine.py says how)."""
import pytest

from test_torch_pe_machine import make_pe_data
from test_torch_pev2_machine import paired_case

CASES = [
    ("n1_dense_cap8", ("n", 0, 1, 8, False)),
    ("n1_walk_uncapped", ("n", 0, 1, None, True)),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_pe_data(tmp_path_factory.mktemp("torch_pev2_seeded"), 16)


@pytest.mark.parametrize("case", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_paired_seeded_machine_matches_jax(data, case, monkeypatch):
    paired_case(data, case, monkeypatch)
