"""The host side of K10, K10r and K14 (csrc/best.cu best_machine_kernel):
its launch shape, shared memory and scratch for every lane count, row
width and driver DAG that the single-end, V1-record and V2 aligners
produce, and the wrapper's CPU path.  The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py phases best, pe, pev2)."""
import os

import numpy as np
import pytest
import torch

from bowtie_tpu_torch.align import best_device as bd
from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
from bowtie_tpu_torch.align.pev2_device import DevicePairedV2Aligner
from bowtie_tpu_torch.align.policy import INF, KPolicy
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)
from bowtie_tpu_torch.io.readers import ReadSource
from bowtie_tpu_torch.utils.rng import fill_seed_caches

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")
H100_SMS = 132
H100_SHARED_PER_SM = 228 * 1024
BLOCK_RESERVED = 1024                 # the runtime's shared bytes a block
WIDTHS = (40, 64, 128, 256, 512, 1024, 2048, 4096)   # _len_bucket's
LANES = (0, 1, 31, 131, 132, 133, 2048, 4224, 4225, 8192, 24966, 2 ** 20)
# (mode kwargs) of each aligner family's policies
SE_MODES = [dict(v=v) for v in range(4)] + [
    dict(mode="n", seed_mms=n) for n in range(4)]
PE_MODES = [dict(mode="v", v=v) for v in range(4)] + [
    dict(mode="n", seed_mms=n) for n in range(4)]


@pytest.fixture(scope="module")
def index():
    idx, idx_bw = read_ebwt(BASE), read_ebwt(BASE + ".rev")
    refs = unpack_reference(*read_bitpair_reference(BASE), plen=idx.plen)
    return idx, idx_bw, refs


@pytest.fixture(scope="module")
def dags(index):
    """{(nd, ndt, paired)}: the driver DAGs of the single-end best-first
    aligner (-v 0-3, -n 0-3, with --nofw / --norc), the V1 recorder's
    fused fw-DAG + rc-DAG run (K10r) and the V2 recorder's merged-mate
    DAG (K14)."""
    idx, idx_bw, refs = index
    out = set()
    for kw in SE_MODES:
        for strand in ({}, {"nofw": True}, {"norc": True}):
            al = bd.DeviceBestAligner(idx, idx_bw, KPolicy(), device="cpu",
                                      **kw, **strand)
            out.add((al.nd, al.ndt, False))
    for kw in PE_MODES:
        v1 = DevicePairedBestAligner(idx, idx_bw, refs, KPolicy(),
                                     device="cpu", **kw)
        out.add((v1.m_fw.hostinit.nd, v1.m_fw.hostinit.ndt, False))
        v2 = DevicePairedV2Aligner(idx, idx_bw, refs, KPolicy(),
                                   device="cpu", better=True, **kw)
        out.add((v2.machine.hostinit.nd, v2.machine.hostinit.ndt, True))
    return sorted(out)


def test_dags_within_the_tables(dags):
    """Every aligner's DAG fits the config tables; the CLI's paired
    --best DAG (-n 2) is 12 / 28, the largest (-n 3) 16 / 48."""
    assert all(0 < nd <= bd.ND_MAX and 0 < ndt <= bd.NDT_MAX
               for nd, ndt, _p in dags)
    assert (12, 28, True) in dags and (16, 48, True) in dags
    assert any(not p for _nd, _ndt, p in dags)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("B", LANES)
def test_machine_shape(dags, B, L):
    for nd, ndt, paired in dags:
        shape = bd.machine_shape(B, L, nd, ndt, paired)
        assert shape["onchip"] == (L <= bd.ONCHIP_L)
        assert 1 <= shape["threads"] <= bd.MACHINE_LANES <= 32
        assert shape["blocks"] * shape["threads"] >= B
        assert (shape["blocks"] - 1) * shape["threads"] < max(B, 1)
        # every SM gets lanes once there are as many lanes as SMs
        assert shape["blocks"] >= min(B, H100_SMS)
        assert shape["threads"] == min(bd.MACHINE_LANES,
                                       max(1, B // H100_SMS))
        assert shape["dynamic_shared"] == 4 * shape["threads"] * \
            bd.lane_shared_words(L, nd, shape["onchip"])
        assert shape["shared"] <= bd.SHARED_LIMIT
        # two blocks fit one SM
        assert 2 * (shape["shared"] + BLOCK_RESERVED) <= H100_SHARED_PER_SM
        assert shape["scratch_words"] == bd.scratch_words(nd, ndt, paired)


def test_cli_batch_fills_the_card(dags):
    """The CLI's batch (8,192 lanes, or pairs) runs 16 lanes a block in
    512 blocks, four to an SM, all resident at once; 2,048 lanes run 15
    a block in 137."""
    for nd, ndt, paired in dags:
        shape = bd.machine_shape(8192, 64, nd, ndt, paired)
        assert (shape["threads"], shape["blocks"]) == (16, 512)
        per_sm = H100_SHARED_PER_SM // (shape["shared"] + BLOCK_RESERVED)
        assert per_sm >= 4 and per_sm * H100_SMS >= shape["blocks"]
        assert bd.machine_shape(2048, 40, nd, ndt, paired)["blocks"] == 137


def test_lane_words():
    """A lane's shared words: 13 scalar words, d0-d3 in 2, 3 words of
    edit depths and one of edit codes a pool slot, 8 pick words, nd
    active-list words, and on chip each slot's 2-word live mask and the
    meta's 16 x L 16-bit words; its scratch: 34 words a flat driver, 47
    an outer (49 paired: its mate's length and seed)."""
    assert bd.lane_shared_words(4096, 12, False) == 19 * 16 + 8 + 12
    assert bd.lane_shared_words(40, 6, True) == 19 * 16 + 8 + 6 + 32 + 320
    assert bd.lane_shared_words(64, 16, True) == 19 * 16 + 8 + 16 + 32 + 512
    assert bd.scratch_words(12, 28, True) == 34 * 28 + 49 * 12
    assert bd.scratch_words(6, 6, False) == 34 * 6 + 47 * 6
    # the paired DAG no longer pays for the tables' bounds: 12 / 28 is
    # under two thirds of 16 / 48
    assert 3 * bd.scratch_words(12, 28, True) < 2 * bd.scratch_words(
        16, 48, True)


def test_machine_shape_refuses():
    with pytest.raises(ValueError, match="exceed"):
        bd.machine_shape(100, 64, 17, 48, True)
    with pytest.raises(ValueError, match="exceed"):
        bd.machine_shape(100, 64, 16, 49, True)


@pytest.fixture(scope="module")
def tiny_run(index, tmp_path_factory):
    """-v 1 --best on 24 reads of the small index, on the CPU."""
    idx, idx_bw, refs = index
    rng = np.random.default_rng(5)
    path = tmp_path_factory.mktemp("best_shape") / "r.fq"
    lines = []
    for i in range(24):
        r = refs[i % len(refs)]
        p = int(rng.integers(0, len(r) - 30))
        q = np.minimum(r[p:p + 30], 3).copy()
        q[int(rng.integers(30))] = rng.integers(0, 4)
        lines.append(f"@r{i}\n{''.join('ACGT'[c] for c in q)}\n+\n"
                     f"{'I' * 30}\n")
    path.write_text("".join(lines))
    reads = list(ReadSource([str(path)]).records())
    al = bd.DeviceBestAligner(idx, idx_bw, KPolicy(1, INF), device="cpu",
                              v=1)
    seeds = fill_seed_caches(reads, 0)
    host = al.hostinit.build(reads, 40, seeds)
    kw = dict(L=40, nd=al.nd, ndt=al.ndt, maxbts=al.maxbts,
              n_k=al._sink_n(), m_max=bd.INF32, strata=False,
              qual_lim=al.qual_lim, qual_order=al.qual_order,
              bt_on=al.bt_on, has_seeded=False, max_steps=2000)
    return al, host, seeds, kw


def test_run_machine_lanes_wants_the_card(tiny_run):
    al, host, seeds, kw = tiny_run
    with pytest.raises(ValueError, match="CUDA"):
        bd.run_machine_lanes(al.pair, al.hostinit.cfg, host,
                             torch.from_numpy(seeds.astype(np.int64)), **kw)


def test_run_machine_cpu_is_plain(tiny_run):
    """On CPU tensors the wrapper runs init_state + run_machine_plain."""
    al, host, seeds, kw = tiny_run
    out, it = bd.run_machine(al.pair, al.hostinit.cfg, host,
                             torch.from_numpy(seeds.astype(np.int64)), **kw)
    st = bd.init_state(len(seeds), kw["L"], kw["nd"], kw["ndt"], seeds,
                       host, kw["maxbts"], "cpu")
    cfg = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in al.hostinit.cfg.items()}
    pkw = {k: v for k, v in kw.items() if k not in ("maxbts", "max_steps")}
    st, pit = bd.run_machine_plain(al.pair, cfg, st, chunk=kw["max_steps"],
                                   nfrag=al.pair.nfrag,
                                   fc=al.pair.ftab_chars, **pkw)
    assert int(it) == int(pit)
    assert torch.equal(out["overflow"],
                       st["overflow"] | (st["mode"] != bd.M_DONE))
    for k in bd.OUT_KEYS:
        if k != "overflow":
            assert torch.equal(out[k], st[k]), k
    assert int(out["nhits"].sum()) > 0


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_pack_init_bit_patterns(paired):
    """pack_init's row: each column of init_layout in order, integers of
    any width as their low 32 bits (uint32 seeds, negative costs), absent
    columns zero."""
    nd, ndt, B = 12, 28, 37
    rng = np.random.default_rng(3)
    host, want = {}, []
    for i, (k, w) in enumerate(bd.init_layout(nd, ndt, paired)):
        if i % 7 == 3:                          # absent: zeros
            want.append(np.zeros((B, w), np.int64))
            continue
        dtype = (np.uint32, np.int32, np.int64, bool)[i % 4]
        v = (rng.integers(0, 2, (B, w)) if dtype is bool else
             rng.integers(0, 2 ** 32, (B, w)) if dtype is np.uint32 else
             rng.integers(-2 ** 31, 2 ** 31, (B, w)))
        host[k] = v.astype(dtype)
        want.append(v.astype(np.int64) & 0xFFFFFFFF)
    host.setdefault("qlen", np.zeros(B, np.int32))
    got = bd.pack_init(host, nd, ndt, paired)
    assert got.dtype == np.int32 and got.flags["C_CONTIGUOUS"]
    assert np.array_equal(got.view(np.uint32),
                          np.concatenate(want, 1).astype(np.uint32))
