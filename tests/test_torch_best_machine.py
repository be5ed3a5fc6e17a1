"""K10's plain version against the reference's JAX machine, array for
array: init_state + run_machine_plain against _init_state_jit + run_chunk
on 256 lanes under -v 2 --best --strata -a (reads of the 20-copy repeat
overflow the 16 hit slots), on the dense and the compact (walk-left)
layouts, every state array and the iteration count, after a first chunk
that cuts the run and at its end; K11's plain version against _harvest
on the final state; and DeviceBestAligner(device="cpu") against the
reference's DeviceBestAligner on the same 256 reads, its chunk schedule
held at that one compiled chunk.  tests/test_torch_best_seeded_machine.py
does the same for a seeded configuration.

Each JAX machine configuration is one XLA compile (~20 s here), so a
module holds two: the dense and the compact layout of one policy."""
import numpy as np
import pytest
import torch

from bowtie_tpu.align import best_device as jbd
from bowtie_tpu_torch.align import best_device as tbd
from bowtie_tpu_torch.align.dfs_device import build_fmpair
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_best_host import INF, make_best_data, policies, result_key

CHUNK = 96                       # the reference schedule's first chunk
L = 40
# registers of the reference's state that the port leaves out: none
# (the per-outer read length and seed qlen_o/seed_o are compared,
# each outer's the lane's own here)
JAX_ONLY = set()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_best_data(tmp_path_factory.mktemp("torch_best_machine"),
                          n_reads=256, host_only=False)


def assert_states_equal(jst, tst, tag):
    assert set(jst) - JAX_ONLY == set(tst), tag
    for k in tst:
        want = np.asarray(jst[k]).astype(np.int64)
        got = tst[k].numpy().astype(np.int64)
        assert got.shape == want.shape, (tag, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag}: {k}")


def machine_case(data, kw, pol, compact, monkeypatch):
    """Both machines from the same HostInit arrays, chunk by chunk; then
    both aligners.  -> (lanes flagged overflow, iterations)."""
    jp, tp = policies(pol)
    jal = jbd.DeviceBestAligner(data["ji"], data["jb"], jp, compact=compact,
                                **kw)
    tal = tbd.DeviceBestAligner(data["ti"], data["tb"], tp, compact=compact,
                                device="cpu", **kw)
    reads_j, reads_t = data["jr"], data["tr"]
    B = len(reads_t)
    seeds = fill_seed_caches(reads_t, 0).astype(np.uint32)
    host_j = jal.hostinit.build(reads_j, L, seeds)
    host_t = tal.hostinit.build(reads_t, L, seeds)
    for k in host_j:
        np.testing.assert_array_equal(host_t[k], host_j[k], err_msg=k)
    static = dict(nd=jal.nd, ndt=jal.ndt, L=L, nfrag=jal.nfrag,
                  n_k=jal._sink_n(), m_max=min(jp.max, jbd.INF32),
                  strata=jal.strata, qual_lim=jal.qual_lim,
                  qual_order=jal.qual_order, bt_on=jal.bt_on,
                  fc=jal.cat.ftab_chars, has_seeded=jal.mode == "n")
    jst = jbd._init_state_jit(seeds, host_j, B=B, L=L, nd=jal.nd,
                              ndt=jal.ndt, maxbts=jal.maxbts)
    tst = tbd.init_state(B, L, tal.nd, tal.ndt, seeds, host_t, tal.maxbts,
                         "cpu")
    assert_states_equal(jst, tst, "init")
    pair = build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=not compact)
    assert pair.dense == (not compact)
    cfg = {k: torch.from_numpy(v.astype(np.int64))
           for k, v in tal.hostinit.cfg.items()}
    total, rounds = 0, 0
    while True:
        jst, _ = jbd.run_chunk(jal.cat, jal.cfgj, jst, chunk=CHUNK, **static)
        tst, it = tbd.run_machine_plain(pair, cfg, tst, chunk=CHUNK,
                                        **static)
        total += it
        rounds += 1
        assert_states_equal(jst, tst, f"after chunk {rounds}")
        if not bool((tst["mode"] != tbd.M_DONE).any()):
            break
    assert rounds > 1 and total > CHUNK        # the first chunk cut the run
    assert total == it + CHUNK * (rounds - 1)
    # K11 on the final state
    want = jbd._harvest(jst, np.arange(B))
    got = tbd.unpack_harvest(tbd.best_pack_plain(
        {k: tst[k] for k in tbd.OUT_KEYS}).numpy(), B)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # the aligners on the same reads: the reference's chunk schedule held
    # at the compiled chunk (it changes which lanes it compacts, never a
    # lane's result)
    orig = jbd.run_compacting
    monkeypatch.setattr(jbd, "run_compacting", lambda *a, **k: orig(
        *a, **{**k, "chunk": CHUNK}))
    jres = [result_key(r) for r in jal.align_batch(reads_j)]
    tres = [result_key(r) for r in tal.align_batch(reads_t)]
    assert tres == jres
    assert tal.fallbacks == jal.fallbacks
    return int(tst["overflow"].sum()), total


V_KW = dict(v=2, strata=True, all_hits=True)
V_POL = (INF, INF, False)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_plain_machine_matches_jax(data, compact, monkeypatch):
    ovf, iters = machine_case(data, V_KW, V_POL, compact, monkeypatch)
    assert ovf > 0
