"""K3's walk-left, K4, K15 and the K3 remainder (csrc/exact.cu walk_kernel,
one_row_kernel, align_step_kernel) and the walk table they walk on
(walk_table_kernel) on the CPU:

- the kernel source itself, built with g++ against
  tests/cuda_stub/cuda_runtime.h (a block's threads as fibers,
  __ballot_sync and __any_sync through a per-warp exchange array;
  launches rewritten to emu_launch; a device of emu_sms SMs holding
  emu_blocks_per_sm blocks each, so that a few thousand rows make more
  than one grid's worth of lanes), and driven through the port's own
  wrappers (align/exact.py, align/pipeline.py, parallel/mesh.py) with
  kernels.launch pointed at it: every output equal to the plain
  version's on tests/golden/small_index and on a seeded index built by
  build_index with a tandem repeat and a repeated segment.  K3 walk on
  every row of the index (rows already marked, 0 steps, and the row at
  zoff among them), on a thinned offRate where walks pass MAX_WALK, on
  0, 1, 31, 33 and more than one grid's worth of rows, and on a
  permutation of the rows (the outputs permuted); each warp's
  iterations against the rows' steps; K4, K15 and the K3 remainder on
  seeded reads, walk-left, thinned and dense; the walk table against
  walk_table_plain;
- the wrappers' CPU paths, which are the plain versions and launch
  nothing.

Skipped only without g++.
"""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bowtie_tpu_torch import kernels
from bowtie_tpu_torch.align import exact as tex
from bowtie_tpu_torch.align import pipeline
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index.arrays import from_ebwt
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)
from bowtie_tpu_torch.ops import fm as tfm
from bowtie_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "bowtie_tpu_torch", "csrc")
STUB = os.path.join(HERE, "cuda_stub")
SMALL = os.path.join(HERE, "golden", "small_index", "small_oracle")
HARNESS = """#include "exact_emu.cu"
extern "C" void emu_set(int sms, int blocks_per_sm) {
    emu_sms = sms;
    emu_blocks_per_sm = blocks_per_sm;
}
"""
ENTRIES = ("bt_exact_ranges", "bt_resolve_walk", "bt_walk_shape",
           "bt_resolve_sa", "bt_walk_table", "bt_one_row", "bt_align_step")
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the plain versions are
    many small ops, whose threads wait on each other on a busy machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/exact.cu built with g++ against the stub header, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/exact.cu against the CUDA stub")
    d = tmp_path_factory.mktemp("exact_emu")
    with open(os.path.join(CSRC, "exact.cu")) as f:
        src = f.read()
    src, n = re.subn(r"([\w<>]+)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\1, \2, \3);", src, flags=re.S)
    assert n == 9
    (d / "exact_emu.cu").write_text(src)
    shutil.copy(os.path.join(CSRC, "fm.cuh"), d / "fm.cuh")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libexact_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-Wno-unused-function", "-I", STUB, "-I", str(d),
                    "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = kernels._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.emu_set.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@pytest.fixture
def emu(emulated, monkeypatch):
    """The port's wrappers launching the emulated kernels on CPU tensors:
    kernels.lib() is the CPU build, kernels.launch calls it without a
    stream and counts, and no tensor counts as on the CPU."""
    emulated.emu_set(1, 2)
    monkeypatch.setattr(kernels, "_lib", emulated)

    def launch(name, entry, *args, device):
        assert getattr(emulated, entry)(*args, None) == 0
        kernels.LAUNCHES[name] += 1
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "on_cpu", lambda fm, *t: False)
    kernels.reset_launches()
    return emulated


def fresh(fm):
    """fm without its cached kernel view and walk table, its BWT words and
    occ rows in torch's own (aligned) allocations, as on the card."""
    return dataclasses.replace(fm, bwt=fm.bwt.clone(), occ=fm.occ.clone(),
                               kernel_view=None, walk=None)


def thinned(fm, by=256):
    return dataclasses.replace(
        fm, offs=fm.offs[::by].contiguous(),
        off_rate=fm.off_rate + by.bit_length() - 1, kernel_view=None)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{name: (FMIndexArrays on the CPU, its references)}: the small
    index, and a seeded 40 kbp genome in two records with a 300 bp
    segment planted 12 times and a tandem repeat of period 7, built by
    build_index at offRate 5 (offRate 3 for its dense twin)."""
    small = read_ebwt(SMALL)
    out = {"small": (from_ebwt(small, device="cpu"),
                     unpack_reference(*read_bitpair_reference(SMALL)),
                     small)}
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 40_000).astype(np.uint8)
    seg = rng.integers(0, 4, 300).astype(np.uint8)
    for s in rng.choice(np.arange(0, 39_000, 1_000), 12, replace=False):
        g[s:s + 300] = seg
    g[20_500:21_200] = np.tile(rng.integers(0, 4, 7), 100)
    base = str(tmp_path_factory.mktemp("walk_idx") / "seeded")
    build_index([g[:25_000], g[25_000:]], ["a", "b"], base, off_rate=5,
                ftab_chars=8)
    idx = read_ebwt(base)
    out["seeded"] = (from_ebwt(idx, device="cpu"),
                     unpack_reference(*read_bitpair_reference(base),
                                      plen=idx.plen), idx)
    return out


def strands(refs, n, seed):
    """n seeded reads of 1-40 bases, right-aligned: substrings of either
    strand, one-mismatch and N copies, and random reads."""
    rng = np.random.default_rng(seed)
    reads = []
    for k in range(n):
        r = refs[k % len(refs)]
        ln = int(rng.integers(1, 41))
        p = int(rng.integers(0, max(1, len(r) - ln)))
        q = np.minimum(r[p:p + ln], 4).astype(np.uint8)
        if k % 5 == 1:
            q = COMP[q[::-1]]
        elif k % 5 == 2:
            q[int(rng.integers(len(q)))] = int(rng.integers(5))
        elif k % 5 == 3:
            q = rng.integers(0, 4, ln).astype(np.uint8)
        reads.append(q)
    mat, lens = tex.right_align(reads, 40)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    return (torch.from_numpy(mat), torch.from_numpy(lens),
            torch.from_numpy(seeds))


def check_resolve(fm, rows, lanes=False):
    """K3 through the wrapper (resolve_rows_lanes if `lanes`) against the
    plain version, one launch; -> (ok, the rows' walk steps, and the
    warps' iterations if `lanes`)."""
    got = (tex.resolve_rows_lanes if lanes else tex.resolve_rows)(fm, rows)
    work = torch.zeros(2, rows.numel(), dtype=torch.int64)
    poff, pok = tex.resolve_rows_plain(fm, rows, work)
    assert torch.equal(got[0], poff) and torch.equal(got[1], pok)
    return got[1], work[0], *got[2:]


# ---------------------------------------------------------------- the table

@pytest.mark.parametrize("name", ["small", "seeded"])
def test_walk_table_matches_plain(emu, indexes, name):
    """walk_table_kernel equals walk_table_plain word for word, built
    once a view (fm.walk) and carried by dataclasses.replace."""
    fm = fresh(indexes[name][0])
    got = tex.walk_table(fm)
    assert torch.equal(got, tex.walk_table_plain(fm))
    assert kernels.LAUNCHES["walk_table"] == 1
    assert got.shape == (2 * (fm.occ.shape[0] - 1), 8)
    assert tex.walk_table(thinned(fm)) is got
    assert kernels.LAUNCHES["walk_table"] == 1


@pytest.mark.parametrize("name", ["small", "seeded"])
def test_walk_table_counts_rows_below_each_entry(indexes, name):
    """The plain table's counts are the stored codes of the rows below
    each entry ('$' at zoff stored as an A), and its words the codes of
    the entry's own 64 rows."""
    fm, _, idx = indexes[name]
    t = tex.walk_table_plain(fm)
    codes = torch.from_numpy(idx.bwt.astype(np.int64))
    assert int(codes[fm.zoff]) == 0
    for e in list(range(0, t.shape[0], 7)) + [t.shape[0] - 1]:
        below = codes[:64 * e]
        assert t[e, :4].tolist() == [int((below == c).sum())
                                     for c in range(4)]
    assert torch.equal(t[:, 4:].reshape(-1), fm.bwt[:t.shape[0] * 4])


def test_walk_step_words_counted_for_bounds(indexes):
    """The words that resolve_rows_plain counts for a walk step (for the
    bounds) are those of the step's walk-table entry that hold rows below
    it, ceil((i mod 64) / 16) (ops.fm.walk_words_needed): lf_walk keeps
    word k whole for k < (i mod 64) / 16, in part for the word of i."""
    i = torch.arange(0, 256)
    want = [sum(16 * k < r for k in range(4)) for r in (i % 64).tolist()]
    assert tfm.walk_words_needed(i).tolist() == want
    fm = fresh(indexes["seeded"][0])
    rows = torch.arange(1, fm.bwt_len, 997)
    work = torch.zeros(2, rows.numel(), dtype=torch.int64)
    tex.resolve_rows_plain(fm, rows, work)
    mask = (1 << fm.off_rate) - 1
    for j, r in enumerate(rows.tolist()):
        steps = words = 0
        while r & mask and r != fm.zoff and steps < tex.MAX_WALK:
            words += (r % 64 + 15) // 16
            r = int(tfm.lf_row_compact_plain(fm, torch.tensor([r]))[0])
            steps += 1
        assert work[:, j].tolist() == [steps, words]
    assert int(work[0].sum()) > rows.numel()


# ---------------------------------------------------------------- K3 walk

@pytest.mark.parametrize("name,thin", [("small", False), ("seeded", False),
                                       ("small", True)])
def test_walk_every_row(emu, indexes, name, thin):
    """Every 8th row of the small index (the seeded one: every 64th;
    thinned: 31 rows, one warp's lanes), rows already marked and
    the row at zoff among them; on the thinned index most walks pass
    MAX_WALK and end with ok=False."""
    fm = fresh(indexes[name][0])
    if thin:
        fm = thinned(fm)
    rows = torch.arange(0, fm.bwt_len,
                        fm.bwt_len // 29 if thin
                        else {"small": 8, "seeded": 64}[name])
    rows = torch.cat([rows, torch.tensor([fm.zoff])])
    ok, steps = check_resolve(fm, rows)
    assert kernels.LAUNCHES["resolve_rows_walk"] == 1
    assert int((steps == 0).sum()) > 0
    if thin:
        assert int(steps.max()) == tex.MAX_WALK
        assert 0 < int((~ok).sum()) < rows.numel()
    else:
        assert bool(ok.all())


@pytest.mark.parametrize("n", [0, 1, 31, 33, 600, 1500])
def test_walk_row_counts(emu, indexes, n):
    """n random rows (600 and 1,500: more than the lanes of the emulated
    device's grid, so each warp refills its lanes from its run and takes
    further runs by atomicAdd), and the warps' iterations: a lane slot a
    walk step, plus one for the iteration that loads a row; a warp whose
    lanes hold one row each runs its longest walk plus two."""
    fm = fresh(indexes["seeded"][0])
    rows = torch.from_numpy(np.random.default_rng(n).integers(
        0, fm.bwt_len, n)).long()
    _, steps, iters = check_resolve(fm, rows, lanes=True)
    shape = tex.walk_shape(max(n, 1))
    full = tex.walk_shape(1 << 20)
    fill = full["blocks"] * full["threads"] // 32    # the grid's warps
    assert full["stripe"] == 64 and full["threads"] == shape["threads"]
    assert shape["stripe"] == min(64, max(32, -(-n // fill)))
    warps = min(fill, -(-n // shape["stripe"]))
    assert shape["blocks"] * shape["threads"] // 32 >= warps
    assert int((iters > 0).sum()) == warps
    assert 32 * int(iters.sum()) >= int(steps.sum()) + n
    if 0 < n <= 32 * fill:
        for w in range(warps):
            s = steps[w * 32:(w + 1) * 32]
            assert int(iters[w]) == int(s.max()) + 2
    if n > 32 * fill:
        eff = int(steps.sum()) / (32 * int(iters.sum()))
        one_a_thread = int(steps.sum()) / (
            32 * int(torch.nn.functional.pad(steps, (0, (-n) % 32))
                     .view(-1, 32).max(1).values.sum()))
        assert eff > one_a_thread


def test_walk_permuted_rows(emu, indexes):
    """A permutation of the rows gives the permuted outputs: a row's
    result does not depend on which lane or iteration walks it."""
    fm = fresh(indexes["seeded"][0])
    rows = torch.from_numpy(np.random.default_rng(5).integers(
        0, fm.bwt_len, 300)).long()
    perm = torch.from_numpy(np.random.default_rng(6).permutation(300))
    off, ok = tex.resolve_rows(fm, rows)
    poff, pok = tex.resolve_rows(fm, rows[perm])
    assert torch.equal(poff, off[perm]) and torch.equal(pok, ok[perm])


# ---------------------------------------------------------------- K4, K15

@pytest.mark.parametrize("name,form", [("small", "walk"), ("seeded", "walk"),
                                       ("small", "thin"),
                                       ("seeded", "dense")])
def test_one_row_align_step_remainder(emu, indexes, name, form):
    """K4 (one_row), K15 (align_step) and the K3 remainder
    (bwt_rows_offsets) against their plain versions, K2 among them."""
    fm, refs, idx = indexes[name]
    if form == "dense":
        fm = from_ebwt(idx, device="cpu", dense_sa=True)
    fm = fresh(fm)
    if form == "thin":
        fm = thinned(fm)
    n = 120 if form == "thin" else 700     # thinned walks are 1,024 long
    mat, lens, seeds = strands(refs, n, len(name) + len(form))
    res = pipeline.one_row(fm, mat, lens, seeds)
    assert torch.equal(res, pipeline.one_row_plain(fm, mat, lens, seeds))
    hit = res[0] > 0
    assert n // 7 < int(hit.sum()) < n
    if form == "thin":
        assert 0 < int(res[2][hit].sum()) < int(hit.sum())
    got = mesh.align_step(fm, mat, lens)
    for a, b in zip(got, mesh.align_step_plain(fm, mat, lens)):
        assert torch.equal(a, b)
    valid = got[1] > got[0]
    valid[::3] = False
    ro = tex.bwt_rows_offsets(fm, got[0], valid)
    for a, b in zip(ro, tex.bwt_rows_offsets_plain(fm, got[0], valid)):
        assert torch.equal(a, b)
    assert (kernels.LAUNCHES["one_row"], kernels.LAUNCHES["align_step"],
            kernels.LAUNCHES["bwt_rows_offsets"]) == (1, 1, 1)
    assert kernels.LAUNCHES["walk_table"] == (form != "dense")


def test_wrappers_on_cpu_are_the_plain_versions(indexes):
    """CPU tensors take the plain versions and launch nothing; the walk
    table of an index on the CPU is the plain one."""
    kernels.reset_launches()
    fm, refs, _ = indexes["small"]
    fm = fresh(fm)
    mat, lens, seeds = strands(refs, 50, 1)
    assert torch.equal(pipeline.one_row(fm, mat, lens, seeds),
                       pipeline.one_row_plain(fm, mat, lens, seeds))
    rows = torch.arange(0, fm.bwt_len, 5)
    for a, b in zip(tex.resolve_rows(fm, rows),
                    tex.resolve_rows_plain(fm, rows)):
        assert torch.equal(a, b)
    assert torch.equal(tex.walk_table(fm), tex.walk_table_plain(fm))
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        tex.resolve_rows_lanes(fm, rows)
