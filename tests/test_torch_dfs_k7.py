"""The host side of K7 (csrc/dfs.cu dfs_machine_kernel): its launch shape
for every lane count and row width the aligners produce, the wrapper's
CPU path, and the diagnostics helpers (utils/kdiag.py) on synthetic
arrays.  The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase dfs)."""
import numpy as np
import pytest
import torch

from bowtie_tpu_torch.align import dfs_device as td
from bowtie_tpu_torch.utils.kdiag import lane_stats, ptxas_entry

H100_SMS = 132
H100_SHARED_PER_SM = 228 * 1024
WIDTHS = (40, 64, 128, 256, 512, 1024, 2048, 4096)   # _len_bucket's
LANES = (0, 1, 31, 32, 33, 129, 4096, 8192, 8193, 16384, 2 ** 21)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("B", LANES)
def test_machine_shape(B, L):
    shape = td.machine_shape(B, L)
    assert shape["onchip"] == (L <= td.ONCHIP_L and L % 4 == 0)
    assert shape["threads"] == td.MACHINE_THREADS == 32
    assert shape["blocks"] * shape["threads"] >= B
    assert (shape["blocks"] - 1) * shape["threads"] < max(B, 1)
    assert shape["shared"] == 32 * td.lane_shared_bytes(L, shape["onchip"])
    assert 0 < shape["shared"] <= td.SHARED_LIMIT
    # at least one block fits an SM alongside another
    assert 2 * shape["shared"] <= H100_SHARED_PER_SM


@pytest.mark.parametrize("B", (8192, 16384))
def test_machine_shape_fills_the_card(B):
    """The CLI's batch, and chip_smoke.py's, give every SM lanes."""
    assert td.machine_shape(B, 40)["blocks"] >= H100_SMS


def test_lane_shared_bytes():
    """Parents' frames (5 x 26 words) and 8 pick words for every
    layout; on chip also each level's mask (2 words), the job's by-depth
    row (3L bytes) and each level's elims (L bytes), rounded up to
    words."""
    assert td.lane_shared_bytes(40, False) == td.lane_shared_bytes(
        4096, False) == 4 * (5 * 26 + 8)
    assert td.lane_shared_bytes(40, True) == 4 * (138 + 12 + 30 + 60)
    assert td.lane_shared_bytes(64, True) == 4 * (138 + 12 + 48 + 96)


@pytest.mark.parametrize("L", (37, 41, 62))
def test_machine_shape_whole_words(L):
    """Rows that are not whole words take the global layout (the job's
    by-depth row is copied a word at a time)."""
    assert not td.machine_shape(100, L)["onchip"]
    assert td.machine_shape(100, L + (-L) % 4)["onchip"]


def test_run_machine_lanes_wants_the_card(tiny_pair_and_jobs):
    pair, jobs, seeds, c0 = tiny_pair_and_jobs
    with pytest.raises(ValueError, match="CUDA"):
        td.run_machine_lanes(pair, jobs, seeds, c0, n_k=1, m_max=td.INF32,
                             max_steps=100)


def test_run_machine_cpu_is_plain(tiny_pair_and_jobs):
    pair, jobs, seeds, c0 = tiny_pair_and_jobs
    kw = dict(n_k=td.INF32, m_max=3, max_steps=2000)
    out, it = td.run_machine(pair, jobs, seeds, c0, **kw)
    pout, pit = td.run_machine_plain(pair, jobs, seeds, c0, **kw)
    assert int(it) == int(pit)
    for k in td.OUT_KEYS:
        assert torch.equal(out[k], pout[k]), k
    # no jobs at all: every lane ends at its first job load
    empty = {"scal": jobs["scal"][:, :0], "qqp": jobs["qqp"][:, :0]}
    out, _ = td.run_machine(pair, empty, seeds, c0, **kw)
    assert bool((out["mode"] == td.M_DONE).all())
    assert int(out["nhits"].sum()) == 0


@pytest.fixture(scope="module")
def tiny_pair_and_jobs(tmp_path_factory):
    import os
    from bowtie_tpu_torch.align import dfs_jobs as tj
    from bowtie_tpu_torch.index.ebwt_io import read_ebwt
    from bowtie_tpu_torch.io.readers import ReadSource
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    base = os.path.join(os.path.dirname(__file__), "golden", "small_index",
                        "small_oracle")
    idx, idx_bw = read_ebwt(base), read_ebwt(base + ".rev")
    pair = td.build_fmpair(idx, idx_bw, "cpu")
    rng = np.random.default_rng(1)
    fq = tmp_path_factory.mktemp("k7") / "r.fq"
    fq.write_text("".join(
        f"@r{i}\n{''.join('ACGT'[c] for c in rng.integers(0, 4, 30))}\n+\n"
        + "I" * 30 + "\n" for i in range(8)))
    reads = list(ReadSource([str(fq)]).records())
    jobs, _ = tj.build_v_jobs_vec(reads, 2, False, False, 40)
    dev = td.upload_jobs(jobs, idx.ftab_chars, "cpu")
    seeds = torch.from_numpy(fill_seed_caches(reads, 0).astype(np.int64))
    return pair, dev, seeds, torch.zeros(len(reads), dtype=torch.int32)


def test_lane_stats_uniform():
    st = lane_stats(np.full(64, 10))
    assert st["warp_efficiency"] == 1.0
    assert (st["max"], st["p50"], st["p99"], st["mean"]) == (10, 10, 10, 10)
    assert st["histogram"] == {"8": 64}


def test_lane_stats_one_long_lane():
    """One lane of 100 in a warp of lanes of 1; a second warp of 4s."""
    s = np.concatenate([np.ones(32, np.int64), np.full(32, 4)])
    s[5] = 100
    st = lane_stats(s)
    assert st["slowest_lane"] == 5 and st["slowest_warp"] == 0
    assert st["total"] == 31 + 100 + 128
    assert st["warp_efficiency"] == pytest.approx(259 / (32 * 100 + 32 * 4))
    assert st["histogram"] == {"1": 31, "4": 32, "64": 1}


def test_lane_stats_partial_warp_and_zeros():
    """A last warp of 8 lanes counts as 32; lanes of 0 transitions."""
    s = np.zeros(40, np.int64)
    s[32:] = 3
    st = lane_stats(s)
    assert st["warp_efficiency"] == pytest.approx(24 / (32 * 3))
    assert st["histogram"] == {"0": 32, "2": 8}
    assert st["slowest_warp"] == 32
    assert lane_stats(np.zeros(0))["lanes"] == 0
    assert lane_stats(np.zeros(5))["warp_efficiency"] == 1.0
    with pytest.raises(ValueError):
        lane_stats(np.array([1, -1]))


def test_lane_stats_percentiles():
    s = np.arange(1, 101)
    st = lane_stats(s)
    assert st["p50"] == pytest.approx(50.5)
    assert st["p99"] == pytest.approx(99.01)
    assert st["mean"] == pytest.approx(50.5)


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18dfs_machine_kernelILb1EEv7DfsArgs' for 'sm_90a'
ptxas info    : Function properties for _Z18dfs_machine_kernelILb1EEv7DfsArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z18derive_rows_kernelPKi' for 'sm_90a'
ptxas info    : Function properties for _Z18derive_rows_kernelPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18dfs_machine_kernelILb0EEv7DfsArgs' for 'sm_90a'
ptxas info    : Function properties for _Z18dfs_machine_kernelILb0EEv7DfsArgs
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
"""


def test_ptxas_entry():
    lines = ptxas_entry(REPORT, "dfs_machine")
    assert len(lines) == 8
    assert lines[2].startswith("0 bytes stack frame")
    assert lines[6].startswith("16 bytes stack frame")
    assert not any("derive_rows" in x for x in lines)
    assert ptxas_entry(REPORT, "derive_rows")[-1].endswith("30 registers")
    assert ptxas_entry(REPORT, "absent") == []
