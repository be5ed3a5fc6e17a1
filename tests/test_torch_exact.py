"""K2 (exact search), K3 (offset resolve, walk and dense SA) and K4 (the
fused one-row path) of the PyTorch port against the JAX package's
exact_ranges, resolve_rows and _one_row_kernel, on the same index (carried
across with from_jax_arrays) and the same seeded reads.  Results must be
exactly equal, element for element.  Here on the CPU the port's wrappers
run their plain versions; tests/test_torch_cuda.py holds the kernels to
those plain versions on the card."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.align import exact as jex
from bowtie_tpu.align.pipeline import _one_row_kernel
from bowtie_tpu.index.arrays import from_ebwt as j_from_ebwt
from bowtie_tpu.index.ebwt_io import (read_bitpair_reference, read_ebwt,
                                      unpack_reference)
from bowtie_tpu_torch.align import exact as tex
from bowtie_tpu_torch.align.pipeline import one_row
from bowtie_tpu_torch.index.arrays import from_jax_arrays
from bowtie_tpu_torch.ops import fm as tfm

from test_torch_fm import jax_fields

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")


def make_reads(refs, n, seed, max_len=40):
    """Seeded reads: exact substrings of either strand, one-mismatch
    copies, reads with Ns, reads shorter than ftabChars (7 here) and
    random reads, all mixed in one batch."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ln = int(rng.integers(1, max_len + 1))
        r = refs[int(rng.integers(len(refs)))]
        p = int(rng.integers(0, max(1, len(r) - ln)))
        q = r[p:p + ln].copy()
        kind = k % 6
        if kind == 1:
            q = (3 - q[::-1]).astype(np.uint8)      # reverse complement
        elif kind == 2:
            q[int(rng.integers(len(q)))] = rng.integers(4)
        elif kind == 3:
            q[int(rng.integers(len(q)))] = 4
        elif kind == 4:
            q = q[:int(rng.integers(1, 7))]
        elif kind == 5:
            q = rng.integers(0, 4, size=ln).astype(np.uint8)
        out.append(np.minimum(q, 4).astype(np.uint8))
    return out


def thinned(j, by=256):
    """The JAX index with only every `by`-th SA sample kept (offRate
    raised by log2 `by`): on the small index most walks then pass
    MAX_WALK and end with ok=False."""
    return dataclasses.replace(j, offs=j.offs[::by],
                               off_rate=j.off_rate + by.bit_length() - 1)


@pytest.fixture(scope="module")
def setup():
    idx = read_ebwt(BASE)
    refs = unpack_reference(*read_bitpair_reference(BASE))
    fms = {"walk": j_from_ebwt(idx), "dense": j_from_ebwt(idx, dense_sa=True)}
    fms["thin"] = thinned(fms["walk"])
    return idx, refs, {k: (j, from_jax_arrays(*jax_fields(j), device="cpu"))
                       for k, j in fms.items()}


@pytest.mark.parametrize("seed,max_len", [(0, 40), (1, 12), (2, 6), (3, 36)])
def test_exact_ranges_equal(setup, seed, max_len):
    _idx, refs, fms = setup
    jw, tw = fms["walk"]
    mat, lens = tex.right_align(make_reads(refs, 600, seed, max_len))
    jt, jb = jex.exact_ranges(jw, jnp.asarray(mat), jnp.asarray(lens))
    tt, tb = tex.exact_ranges(tw, torch.from_numpy(mat),
                              torch.from_numpy(lens))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tb > tt).sum() > 100     # real work: many reads hit


def test_right_align_equal(setup):
    _idx, refs, _fms = setup
    reads = make_reads(refs, 50, 7)
    for a, b in zip(jex.right_align(reads), tex.right_align(reads)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jex.right_align(reads, 45), tex.right_align(reads, 45)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["walk", "dense", "thin"])
def test_resolve_rows_equal(setup, form):
    idx, _refs, fms = setup
    j, t = fms[form]
    rng = np.random.default_rng(11)
    rows = np.concatenate([np.arange(0, 300), [idx.zoff, idx.bwt_len - 1],
                           rng.integers(0, idx.bwt_len, 700)])
    jo, jok = jex.resolve_rows(j, jnp.asarray(rows, jnp.int32))
    to, tok = tex.resolve_rows(t, torch.from_numpy(rows))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    if form == "thin":     # walks past MAX_WALK, and walks that end
        assert 100 < int((~tok).sum()) < len(rows) - 100
    else:
        assert bool(tok.all())


def test_resolve_walk_agrees_with_dense(setup):
    idx, _refs, fms = setup
    rows = torch.arange(idx.bwt_len)
    wo, wok = tex.resolve_rows(fms["walk"][1], rows)
    do, dok = tex.resolve_rows(fms["dense"][1], rows)
    assert bool(wok.all()) and bool(dok.all())
    assert torch.equal(wo, do)


@pytest.mark.parametrize("form,seed", [("walk", 0), ("walk", 1),
                                       ("dense", 2), ("thin", 3)])
def test_one_row_equal(setup, form, seed):
    _idx, refs, fms = setup
    j, t = fms[form]
    reads = make_reads(refs, 500, seed)
    mat, lens = tex.right_align(reads)
    seeds = np.random.default_rng(seed).integers(0, 2**32, len(reads),
                                                 dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    want = np.asarray(_one_row_kernel(j, jnp.asarray(mat),
                                      jnp.asarray(lens), jnp.asarray(seeds)))
    got = one_row(t, torch.from_numpy(mat), torch.from_numpy(lens),
                  torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if form == "thin":
        hit_ok = got[2][got[0] > 0]
        assert 0 < int(hit_ok.sum()) < len(hit_ok)


def test_plain_step_counts(setup):
    """The work counts chip_smoke.py derives its bounds from: one step
    per active column for K2, one per LF for K3, and the words each of
    those ranks must popcount, ceil((row mod 128) / 16)."""
    _idx, refs, fms = setup
    t = fms["walk"][1]
    mat, lens = tex.right_align([refs[0][100:130], refs[0][:3]])
    work = torch.zeros(2, 2, dtype=torch.int64)
    tex.exact_ranges_plain(t, torch.from_numpy(mat), torch.from_numpy(lens),
                           work)
    assert work[0].tolist() == [30 - t.ftab_chars, 3]
    assert bool((work[1] <= 2 * 8 * work[0]).all()) and int(work[1, 0]) > 0
    assert tfm.words_needed(torch.tensor([0, 1, 16, 17, 127, 128, 129])
                            ).tolist() == [0, 1, 1, 2, 8, 0, 1]
    rows = torch.tensor([0, 1, 2])
    walk = torch.zeros(2, 3, dtype=torch.int64)
    off, _ok = tex.resolve_rows_plain(t, rows, walk)
    assert walk[0, 0] == 0 and bool((walk[0, 1:] > 0).all())
    assert walk[1, 0] == 0 and bool((walk[1] <= 8 * walk[0]).all())
