"""K12 (exact search with a per-lane index) and the paired recorder's
phase 0 that launches it, on the CPU:

- exact_ranges_cat_plain against the JAX package's exact_ranges_cat, on
  one index pair (tests/golden/small_index, the reference's build_fmcat
  and the port's FMPair of the same files) and seeded lanes that mix the
  forward and the mirror index in one call: exact substrings of either
  strand, one-mismatch copies, Ns, lengths 0-3 (below ftabChars, 7 here),
  36 and 50, and random misses.  Results must be equal, array for array.
  On the .ebwtl index of the same genome the port must give what it gives
  on the .ebwt one (the reference's ftab escape fault, ROADMAP queue 3).
- the synthesis invariant (the reference's
  test_synth_stream_matches_recording): every lane phase 0 settles on the
  first 50 pairs of tests/test_torch_pe_streams.py, under -n 2 and -v 1,
  must equal the first range the plain K10r records uncapped for it.

tests/test_torch_cuda.py holds the kernel to exact_ranges_cat_plain on
the card."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.align import pe_device as jpe
from bowtie_tpu.align.dfs_device import build_fmcat
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu_torch.align import pe_device as tpe
from bowtie_tpu_torch.align.dfs_device import build_fmpair
from bowtie_tpu_torch.align.exact import right_align
from bowtie_tpu_torch.align.policy import KPolicy as TPolicy
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_streams import INF, data  # noqa: F401

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")
BASE_L = os.path.join(HERE, "golden", "small_index_l", "small_oracle")
SYNTH_PAIRS = 50


def make_lanes(refs, n, seed):
    """n seeded lanes as the recorder builds them: a read (a substring of
    either strand, a one-mismatch copy, one with an N, one of 0-3 bases,
    or random), taken fw or rc, on the forward index or reversed on the
    mirror; lengths 0-3, 36, 50 and 4-50 at random.  -> (codes, efw)."""
    rng = np.random.default_rng(seed)
    codes, efw = [], []
    for k in range(n):
        ln = int(rng.choice([36, 50, int(rng.integers(4, 51))]))
        r = refs[int(rng.integers(len(refs)))]
        p = int(rng.integers(0, max(1, len(r) - ln)))
        q = np.minimum(r[p:p + ln], 4).astype(np.uint8)
        kind = k % 6
        if kind == 1:
            q = (3 - q[::-1]).astype(np.uint8)      # reverse complement
        elif kind == 2:
            q[int(rng.integers(ln))] = rng.integers(4)
        elif kind == 3:
            q[int(rng.integers(ln))] = 4
        elif kind == 4:
            q = q[:(k // 6) % 4]                    # 0-3 bases
        elif kind == 5:
            q = rng.integers(0, 4, ln).astype(np.uint8)
        if rng.integers(2):                         # the rc orientation
            q = np.where(q < 4, 3 - q, 4)[::-1].astype(np.uint8)
        e = int(rng.integers(2))
        codes.append(q if e else q[::-1].copy())
        efw.append(e)
    return codes, np.array(efw, np.uint8)


@pytest.fixture(scope="module")
def index():
    ji, jb = j_io.read_ebwt(BASE), j_io.read_ebwt(BASE + ".rev")
    ti, tb = t_io.read_ebwt(BASE), t_io.read_ebwt(BASE + ".rev")
    refs = t_io.unpack_reference(*t_io.read_bitpair_reference(BASE))
    return dict(cat=build_fmcat(ji, jb, occ_every=128, dense_sa=True),
                pair=build_fmpair(ti, tb, "cpu"), refs=refs)


def run_both(index, codes, efw, pad_to=None):
    mat, lens = right_align(codes, pad_to=pad_to)
    jt, jb = jpe._exact_ranges_cat_jit()(
        index["cat"], jnp.asarray(mat), jnp.asarray(lens),
        jnp.asarray(efw.astype(np.int32)))
    want = (np.asarray(jt).astype(np.int64) & 0xFFFFFFFF,
            np.asarray(jb).astype(np.int64) & 0xFFFFFFFF)
    tt, tb = tpe.exact_ranges_cat_plain(
        index["pair"], torch.from_numpy(mat), torch.from_numpy(lens),
        torch.from_numpy(efw))
    return (tt.numpy(), tb.numpy()), want


def test_exact_cat_matches_jax(index):
    codes, efw = make_lanes(index["refs"], 3000, 12)
    got, want = run_both(index, codes, efw)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    hit = got[1] > got[0]
    lens = np.array([len(c) for c in codes])
    has_n = np.array([bool((c > 3).any()) for c in codes])
    # the cases the lanes were made for all occur, on both indexes
    for e in (0, 1):
        on = efw == e
        assert hit[on & (lens >= 36)].sum() > 100
        assert (~hit[on & (lens >= 36)]).sum() > 100
        assert not hit[on & has_n].any()
        assert hit[on & (lens < 4) & ~has_n].all()  # 0-3 bases: found
    assert {0, 1, 2, 3, 36, 50} <= set(lens.tolist())
    # a lane read on the other index mostly misses: the choice matters
    other = run_both(index, codes, 1 - efw)[0]
    long_hit = hit & (lens >= 36)
    assert (other[1][long_hit] > other[0][long_hit]).mean() < 0.5


def test_exact_cat_short_matrix_matches_jax(index):
    """Every read shorter than ftabChars: no ftab jump in the matrix."""
    codes, efw = make_lanes(index["refs"], 200, 13)
    codes = [c[:int(k % 7)] for k, c in enumerate(codes)]
    got, want = run_both(index, codes, efw)
    assert index["pair"].ftab_chars == 7
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert (got[1] > got[0]).sum() > len(codes) // 2


def test_exact_cat_work_and_empty(index):
    codes, efw = make_lanes(index["refs"], 300, 14)
    mat, lens = right_align(codes)
    args = (torch.from_numpy(mat), torch.from_numpy(lens),
            torch.from_numpy(efw))
    work = torch.zeros(2, len(codes), dtype=torch.int64)
    top, bot = tpe.exact_ranges_cat(index["pair"], *args)
    pt, pb = tpe.exact_ranges_cat_plain(index["pair"], *args, work)
    assert torch.equal(top, pt) and torch.equal(bot, pb)
    assert int(work[0].sum()) > 0 and int(work[1].sum()) > int(work[0].sum())
    assert bool((work[0] <= torch.from_numpy(lens).long()).all())
    e = tpe.exact_ranges_cat(index["pair"],
                             torch.zeros((0, 8), dtype=torch.uint8),
                             torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.uint8))
    assert e[0].numel() == 0 and e[1].numel() == 0


def test_exact_cat_ebwtl_equals_ebwt(index):
    """The .ebwtl index of the same genome gives the .ebwt result: the
    port compares the 64-bit ftab's escapes unsigned (the JAX package
    does not; ROADMAP queue 3)."""
    pair_l = build_fmpair(t_io.read_ebwt(BASE_L),
                          t_io.read_ebwt(BASE_L + ".rev"), "cpu")
    codes, efw = make_lanes(index["refs"], 1000, 15)
    mat, lens = (torch.from_numpy(a) for a in right_align(codes))
    e = torch.from_numpy(efw)
    want = tpe.exact_ranges_cat_plain(index["pair"], mat, lens, e)
    got = tpe.exact_ranges_cat_plain(pair_l, mat, lens, e)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _row(fr):
    return (fr.top, fr.bot, fr.cost, fr.stratum, fr.fw, fr.ebwt_fw,
            list(fr.mms))


@pytest.mark.parametrize("kw", [
    dict(mode="n", seed_mms=2, seed_len=28, qual_cutoff=70),
    dict(mode="v", v=1)], ids=["n2", "v1"])
def test_synth_stream_matches_recording(data, kw):
    """Every lane phase 0 synthesizes materializes to the first range the
    plain K10r records for it uncapped: the exact range, cost 0, stratum
    0, the first driver's strand and index, no mismatches."""
    pairs = data["tp"][:SYNTH_PAIRS]
    al = tpe.DevicePairedBestAligner(data["ti"], data["tb"], data["trefs"],
                                     TPolicy(), device="cpu", **kw)
    assert al.rec_cap == 1
    idxs = list(range(len(pairs)))
    plan = al.plan(pairs)
    synth = {i: [None] * 4 for i in idxs}
    keep = al._synthesize(plan, idxs, synth)
    assert keep.shape == (4, len(pairs)) and (~keep).sum() > 0
    seeds = fill_seed_caches([p[0] for p in pairs], 0)
    rec, ovd = al._record_all(plan, idxs, seeds, None)
    checked = 0
    for i in idxs:
        for slot in range(4):
            s = synth[i][slot]
            if s is None:
                continue
            assert len(s) == 1 and s.capped
            r = rec[i][slot]
            if ovd[i] or r is None or len(r) == 0:
                continue
            fr_s, done = s.materialize(0)
            assert _row(fr_s) == _row(r.materialize(0)[0]), (kw, i, slot)
            assert not done and fr_s.cost == 0 and fr_s.num_mms == 0
            checked += 1
    assert checked >= 20        # the invariant was actually tested
    assert al.synthesized == 0  # _synthesize alone counts nothing


@pytest.mark.parametrize("khits,mhits,sample", [
    (1, None, False), (2, None, False), (None, None, False),
    (1, 1, False), (1, 1, True)], ids=["k1", "k2", "a", "m1", "M1"])
def test_rec_cap_follows_policy(data, khits, mhits, sample):
    """-k 1 without -m records at rec_cap 1 after phase 0; -k 2, -a, -m
    and -M record every range uncapped, with no phase 0."""
    pol = TPolicy(khits=INF if khits is None else khits,
                  mhits=INF if mhits is None else mhits, sample_max=sample)
    al = tpe.DevicePairedBestAligner(data["ti"], data["tb"], data["trefs"],
                                     pol, device="cpu", mode="v", v=1)
    first = khits == 1 and mhits is None
    assert al.rec_cap == (1 if first else None)
    al.align_batch(data["tp"][:8])
    assert (al.synthesized > 0) == first
