"""DevicePairedV2Aligner(device="cpu") against the reference's V2 host
engine (tests/test_torch_pev2_aligner.py says how) under the other
policies and switches: -v 2 --best without and with --strata (the best
sink), -k 2 and -a (recorded uncapped: the policy wants every row), -m 1,
--nofw and --norc (_pe_do_matrix drops two of the four mate/strand
groups: a merged DAG of half the outers) and --reportse, which runs whole
on the host engine."""
import pytest

from test_torch_pev2_aligner import INF, aligner_case, pev2_data


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return pev2_data(tmp_path_factory.mktemp("torch_pev2_policies"))


# (configuration, -k, -m, pairs taken besides the odd two)
CASES = [
    ("v2_best_nosink", dict(mode="v", v=2, better=True, best_sink=False),
     1, INF, 12),
    ("v2_best_strata", dict(mode="v", v=2, better=True, best_sink=True),
     1, INF, 12),
    ("n1_k2", dict(mode="n", seed_mms=1, better=True), 2, INF, 20),
    ("v1_a", dict(mode="v", v=1), INF, INF, 20),
    ("v1_m1", dict(mode="v", v=1), 1, 1, 20),
    ("n1_nofw", dict(mode="n", seed_mms=1, better=True, nofw=True), 1, INF,
     20),
    ("v1_norc", dict(mode="v", v=1, better=True, norc=True), 1, INF, 20),
    ("n1_reportse", dict(mode="n", seed_mms=1, better=True,
                         report_se=True), 1, INF, 12),
]


@pytest.mark.parametrize("cfg,k,m,n", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_pev2_policies_match_host(data, cfg, k, m, n):
    # --nofw keeps the pair orientation of mate 1 reverse, mate 2 forward:
    # make_pe_data's pairs with their mates swapped
    tal = aligner_case(data, cfg, k=k, m=m, n_pairs=n,
                       swap=cfg.get("nofw", False))
    assert tal.rec_cap == (None if k > 1 or m != INF else 8)
    assert tal.use_device == (not cfg.get("report_se"))
    if cfg.get("report_se"):
        assert tal.fallbacks == 0 and tal.escalations == 0
    if cfg.get("nofw") or cfg.get("norc"):
        # two of the four (mate, strand) groups: half the merged outers
        per = 1 + (cfg["seed_mms"] if cfg["mode"] == "n" else cfg["v"])
        assert len(tal.machine.o_mate1) == 2 * per
