"""K14's plain version, the best-first machine in paired record mode,
against the reference's JAX machine, array for array:
init_state + run_machine_plain(record=True, paired=True) against
_init_state_jit + run_chunk(record=True, paired=True) on the merged-mate
DAG of 16 pairs (one lane each), every state array after each chunk (the
per-outer qlen_o/seed_o registers included), under -v 0 (4 outer / 4 flat
drivers), -v 1 (8 / 8) and the seeded -n 1 (8 / 24), capped at the V2
aligner's rec_cap 8 and uncapped, on the dense and the compact
(walk-left) layouts (the -n 1 cases in
tests/test_torch_pev2_machine_seeded.py).  The pairs (make_pe_data) have
mates of different lengths and seeds, and random mates, whose lanes end
by mate elimination; the sub-steps are watched to show that some lanes
end so and that the same-mate test moves some strandFix scans.  The JAX machine is driven only
on merged DAGs of 8 outers or fewer: each configuration is one XLA
compile, and the nd 12 and 16 DAGs compile for minutes
(tests/test_torch_pev2_streams.py holds those to the host driver)."""
import numpy as np
import pytest
import torch

from bowtie_tpu.align import best_device as jbd
from bowtie_tpu.align import pev2_device as jv2
from bowtie_tpu_torch.align import best_device as tbd
from bowtie_tpu_torch.align import pev2_device as tv2
from bowtie_tpu_torch.align.dfs_device import build_fmpair
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_machine import assert_states_equal, make_pe_data

CHUNK = 32
L = 32

# (mode, v, seed_mms, rec_cap, walk-left)
CASES = [
    ("v0_dense_uncapped", ("v", 0, 0, None, False)),
    ("v0_walk_cap8", ("v", 0, 0, 8, True)),
    ("v1_dense_cap8", ("v", 1, 0, 8, False)),
    ("v1_walk_uncapped", ("v", 1, 0, None, True)),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_pe_data(tmp_path_factory.mktemp("torch_pev2_machine"), 16)


def watch(monkeypatch, nd):
    """Count, as the plain machine runs, the lanes its CADV sub-step ends
    by mate elimination while outers are still active, and the strandFix
    scans whose target the same-mate test moves."""
    seen = dict(elim=0, sfx=0)
    cadv, cpost = tbd._step_cadv, tbd._step_cpost

    def step_cadv(st, cx):
        m = ((st["mode"] == tbd.M_CADV) & (st["dl_valid"] == 0)
             & (st["act_n"] > 0))
        o_m1 = cx.cfg["o_m1"][None, :nd] > 0
        alive = st["od_done"] == 0
        both = (alive & o_m1).any(1) & (alive & ~o_m1).any(1)
        seen["elim"] += int((m & ~both).sum())
        cadv(st, cx)

    def step_cpost(st, cx):
        cur = st["cur_o"]
        pf = ((st["mode"] == tbd.M_CPOST)
              & (tbd._sel(st["od_found"], cur) > 0))
        ii = torch.arange(nd)[None, :]
        fw, m1 = cx.cfg["o_fw"][None, :nd], cx.cfg["o_m1"][None, :nd]
        cand = (ii >= 1) & (fw != fw[0, cur][:, None]) & \
            (ii < st["act_n"][:, None])
        same = cand & (m1 == m1[0, cur][:, None])
        moved = (cand.any(1) != same.any(1)) | (
            same.any(1) & (cand.long().argmax(1) != same.long().argmax(1)))
        seen["sfx"] += int((pf & moved).sum())
        cpost(st, cx)
    monkeypatch.setattr(tbd, "_step_cadv", step_cadv)
    monkeypatch.setattr(tbd, "_step_cpost", step_cpost)
    return seen


@pytest.mark.parametrize("case", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_paired_machine_matches_jax(data, case, monkeypatch):
    paired_case(data, case, monkeypatch)


def paired_case(data, case, monkeypatch):
    """Both machines from the same host arrays, chunk by chunk."""
    mode, v, sm, cap, walk = case
    args = (mode, v, sm, 28, 70, True, True, 800, 60000, False, False,
            True, False)
    jcat = jbd.build_fmcat(data["ji"], data["jb"], occ_every=128,
                           dense_sa=not walk)
    jm = jv2.PairedV2Machine(jcat, data["ji"], data["jb"], *args)
    pair = build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=not walk)
    tm = tv2.PairedV2Machine(pair, data["ti"], data["tb"], *args)
    jp, tp = data["jp"], data["tp"]
    assert max(max(len(a.seq), len(b.seq)) for a, b in tp) <= L
    s1 = fill_seed_caches([p[0] for p in tp], 0)
    s2 = fill_seed_caches([p[1] for p in tp], 0)
    hj = jm.build_paired([p[0] for p in jp], [p[1] for p in jp], L, s1, s2)
    ht = tm.build_paired([p[0] for p in tp], [p[1] for p in tp], L, s1, s2)
    hi = tm.hostinit
    nd, ndt, B = hi.nd, hi.ndt, len(tp)
    assert (nd, ndt) == {("v", 0): (4, 4), ("v", 1): (8, 8),
                         ("n", 0): (8, 24)}[(mode, v)]
    static = dict(nd=nd, ndt=ndt, L=L, nfrag=int(data["ji"].nfrag),
                  n_k=jbd.INF32, m_max=jbd.INF32, strata=False,
                  qual_lim=jm.qual_lim, qual_order=True, bt_on=jm.bt_on,
                  fc=jcat.ftab_chars, has_seeded=jm.has_seeded, record=True,
                  rec_cap=cap, paired=True)
    jst = jbd._init_state_jit(s1.astype(np.uint32), hj, B=B, L=L, nd=nd,
                              ndt=ndt, maxbts=800)
    tst = tbd.init_state(B, L, nd, ndt, s1, ht, 800, "cpu")
    assert_states_equal(jst, tst, "init")
    cfg = {k: torch.from_numpy(np.asarray(x).astype(np.int64))
           for k, x in hi.cfg.items()}
    seen = watch(monkeypatch, nd)
    rounds = 0
    while True:
        jst, _ = jbd.run_chunk(jcat, jm.cfgj, jst, chunk=CHUNK, **static)
        tst, it = tbd.run_machine_plain(pair, cfg, tst, chunk=CHUNK,
                                        **static)
        rounds += 1
        assert_states_equal(jst, tst, f"after chunk {rounds}")
        if not bool((tst["mode"] != tbd.M_DONE).any()):
            break
        assert it == CHUNK
    assert rounds > 1
    assert int(tst["nhits"].sum()) > 0
    # the two mates' outers read their own lengths: some pairs differ
    assert bool((tst["qlen_o"].min(1).values
                 != tst["qlen_o"].max(1).values).any())
    assert seen["elim"] > 0
    if nd > 4:
        assert seen["sfx"] > 0
    if cap is not None:
        # a lane frozen by the cap marks its last record (done column 2)
        # unless its driver ended there
        nh = tst["nhits"]
        hits = tst["hits"].view(B, tbd.H_MAX, tbd.HIT_W)
        assert int(nh.max()) <= cap
        for b in (nh == cap).nonzero()[:, 0].tolist():
            assert int(hits[b, cap - 1, 6]) in (1, 2)
