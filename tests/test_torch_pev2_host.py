"""The host part of K14, the paired V2 recorder: the port's
PairedV2Machine against the reference's (bowtie_tpu/align/pev2_device.py
:54), array for array: the merged outer list in drVec order with the
groups --nofw/--norc drop, each outer's and flat driver's mate (o_m1,
flat_m1), the branch-slot map, the driver config tables, and
build_paired's host arrays (both mates' HostInit.build spliced by driver
mate, the merged initial sortActives on mate 1's seed, qlen_o, seed_o and
rng_rs by mate) on seeded pairs whose mates differ in length and seed,
under -v 1, -n 2 and -n 3, --fr/--ff/--rf and --nofw/--norc.  No XLA
compile: the reference's machine is built without its index pair."""
import numpy as np
import pytest

from bowtie_tpu.align import pev2_device as jv2
from bowtie_tpu_torch.align import pev2_device as tv2
from bowtie_tpu_torch.align.dfs_device import _len_bucket, build_fmpair
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_machine import make_pe_data

# (mode, v, seed_mms, nofw, norc, fw1, fw2)
CASES = [
    ("v1_fr", ("v", 1, 0, False, False, True, False)),
    ("n2_fr", ("n", 0, 2, False, False, True, False)),
    ("n3_fr", ("n", 0, 3, False, False, True, False)),
    ("n2_ff", ("n", 0, 2, False, False, True, True)),
    ("v1_rf", ("v", 1, 0, False, False, False, True)),
    ("n2_nofw", ("n", 0, 2, True, False, True, False)),
    ("v2_norc_ff", ("v", 2, 0, False, True, True, True)),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_pe_data(tmp_path_factory.mktemp("torch_pev2_host"), 24,
                     max_len=48)
    d["pair"] = build_fmpair(d["ti"], d["tb"], "cpu")
    return d


def machines(data, case):
    mode, v, sm, nofw, norc, fw1, fw2 = case
    rest = (28, 70, True, True, 800, 60000, nofw, norc, fw1, fw2)
    jm = jv2.PairedV2Machine(None, data["ji"], data["jb"], mode, v, sm,
                             *rest)
    tm = tv2.PairedV2Machine(data["pair"], data["ti"], data["tb"], mode, v,
                             sm, *rest)
    return jm, tm


@pytest.mark.parametrize("case", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_build_paired_matches_jax(data, case):
    jm, tm = machines(data, case)
    assert tm.o_mate1 == jm.o_mate1
    np.testing.assert_array_equal(tm.flat_m1, jm.flat_m1)
    np.testing.assert_array_equal(tm.out_m1, jm.out_m1)
    assert tm.slot_flat == jm.slot_flat
    assert (tm.qual_lim, tm.bt_on, tm.has_seeded) == (jm.qual_lim, jm.bt_on,
                                                      jm.has_seeded)
    jc, tc = jm.hostinit.cfg, tm.hostinit.cfg
    assert set(jc) == set(tc)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    # the merged DAG: both mates' outers, four groups but those dropped
    ngroups = 4 - 2 * (case[3] + case[4])
    assert len(tm.o_mate1) % ngroups == 0
    assert sum(tm.o_mate1) * 2 == len(tm.o_mate1)
    jp, tp = data["jp"], data["tp"]
    L = _len_bucket(max(max(len(a.seq), len(b.seq)) for a, b in tp))
    s1 = fill_seed_caches([p[0] for p in tp], 0)
    s2 = fill_seed_caches([p[1] for p in tp], 0)
    assert (s1 != s2).all()
    assert any(len(a.seq) != len(b.seq) for a, b in tp)
    hj = jm.build_paired([p[0] for p in jp], [p[1] for p in jp], L, s1, s2)
    ht = tm.build_paired([p[0] for p in tp], [p[1] for p in tp], L, s1, s2)
    assert set(ht) == set(hj)
    for k in hj:
        assert ht[k].dtype == hj[k].dtype, k
        np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
    # each outer reads its own mate's length and seed
    q2 = np.array([len(b.seq) for _a, b in tp])
    np.testing.assert_array_equal(ht["qlen_o"][:, ~tm.out_m1],
                                  np.repeat(q2[:, None], (~tm.out_m1).sum(),
                                            1))
    assert (ht["rng_rs"][:, tm.flat_m1] == s1[:, None]).all()
    assert (ht["seed_o"][:, ~tm.out_m1] == s2[:, None]).all()


def test_record_inputs_take(tmp_path):
    """The machine takes the pairs whose mates have 4-255 bases: the
    3-base and 300-base mates of make_pe_data's odd pairs are left to the
    host engine, and the kept lanes carry the paired columns."""
    odd = make_pe_data(tmp_path, 2, odd_mates=True)
    odd["pair"] = build_fmpair(odd["ti"], odd["tb"], "cpu")
    _jm, tm = machines(odd, CASES[1][1])
    tp = odd["tp"]
    assert [min(len(a.seq), len(b.seq)) for a, b in tp][2] == 3
    assert max(len(a.seq) for a, _b in tp) == 300
    s = fill_seed_caches([p[0] for p in tp], 0)
    a = tm.record_inputs(tp, s, s)
    assert a["take"].tolist() == [0, 1]
    assert a["kw"]["paired"] and a["kw"]["record"]
    host = a["args"][2]
    assert host["qlen_o"].shape == (2, tm.hostinit.nd)
    assert host["rng_rs"].shape == (2, tm.hostinit.ndt)
