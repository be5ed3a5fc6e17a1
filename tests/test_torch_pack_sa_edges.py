"""The plain versions that the card holds K16 and K8 to, at the edges
where a one-sweep sort and a look-back would break, against numpy and the
reference package's JAX functions:

- K16 sa_round_plain against a numpy stable lexsort of (r[i], r[i+k]) on
  ranks under BIG = 2^31 - 1 (62-bit packed keys, 8 digit passes on the
  card), which the JAX round_fn never reaches (its BIG follows n), and
  against round_fn round for round on all-A texts (every key in one bin)
  and period-3 texts (long ties over many rounds) at test_torch_sa.py's
  sizes;
- K8 pack_hits_plain against the JAX _pack_all (the hit rows and the
  fused partial rows) and decode_hit_cols (the hit gather by nh_eff) on
  synthetic machine outputs: one lane, every lane overflowed, every lane
  full, no partials.

Exact equality throughout: this is integer code."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bowtie_tpu.align import dfs_device as jd
from bowtie_tpu.build import sa as j_sa
from bowtie_tpu_torch.align import dfs_device as td
from bowtie_tpu_torch.build import sa as t_sa

SIZES = [1, 2, 33, 50, 1000]            # test_torch_sa.py's
BIG_MAX = 2**31 - 1


def _lexsort_round(r: np.ndarray, k: int, big: int):
    """One doubling round by numpy's stable lexsort on (r[i], r[i+k])."""
    n1 = len(r)
    r1 = r.astype(np.int64)
    r2 = np.full(n1, big, np.int64)
    if k < n1:
        r2[:n1 - k] = r1[k:]
    order = np.lexsort((r2, r1))
    s1, s2 = r1[order], r2[order]
    grp = np.zeros(n1, np.int64)
    grp[1:] = np.cumsum((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]))
    nr = np.empty(n1, np.int64)
    nr[order] = grp
    return nr, order, grp[-1]


@pytest.mark.parametrize("k", [1, 3, "n1"])
@pytest.mark.parametrize("n1", [1, 2, 1000, 6145])
def test_sa_round_plain_big_ranks_equals_lexsort(n1, k):
    rng = np.random.default_rng(n1)
    r = rng.integers(1, BIG_MAX, n1).astype(np.int32)
    r[1::3] = r[::3][:len(r[1::3])]            # ties in runs
    r[-1] = BIG_MAX - 1
    k = n1 if k == "n1" else min(k, n1)
    nr, order, maxg = t_sa.sa_round_plain(torch.from_numpy(r), k, BIG_MAX)
    want = _lexsort_round(r, k, BIG_MAX)
    assert nr.dtype == order.dtype == maxg.dtype == torch.int32
    np.testing.assert_array_equal(nr.numpy(), want[0])
    np.testing.assert_array_equal(order.numpy(), want[1])
    assert int(maxg) == int(want[2])


def _jax_rounds(codes, monkeypatch):
    """suffix_array_jax(codes), recording each round_fn call's inputs and
    outputs as numpy arrays."""
    calls = []
    real_jit = jax.jit

    def recording_jit(fn):
        jitted = real_jit(fn)

        def run(r, k):
            out = jitted(r, k)
            calls.append((np.array(r), int(k),
                          tuple(np.asarray(o) for o in out)))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    sa = j_sa.suffix_array_jax(codes)
    monkeypatch.setattr(jax, "jit", real_jit)
    return sa, calls


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["all_a", "period3"])
def test_sa_round_plain_repetitive_equals_jax(kind, n, monkeypatch):
    codes = (np.zeros(n, np.uint8) if kind == "all_a" else
             np.tile(np.array([0, 1, 2], np.uint8), n // 3 + 1)[:n])
    sa_jax, calls = _jax_rounds(codes, monkeypatch)
    _r0, big = t_sa.initial_ranks(codes)
    for r, k, (nr, order, maxg) in calls:
        got = t_sa.sa_round_plain(torch.from_numpy(r), k, big)
        np.testing.assert_array_equal(got[0].numpy(), nr)
        np.testing.assert_array_equal(got[1].numpy(), order)
        assert int(got[2]) == int(maxg)
    np.testing.assert_array_equal(
        t_sa.suffix_array_doubling(codes, device="cpu"), sa_jax)


def _machine_outputs(B, kind, seed):
    """Synthetic run_machine outputs (numpy): hit rows whose mismatch
    count and reference codes decode_hit_cols can read, random partial
    rows, and counts per `kind`."""
    rng = np.random.default_rng(seed)
    hits = rng.integers(0, 1 << 20, (B, td.H_MAX, td.HIT_W)).astype(np.int32)
    hits[..., 2] = rng.integers(0, 4, (B, td.H_MAX))          # fw, efw bits
    hits[..., 6] = rng.integers(0, td.MM_SLOTS + 1, (B, td.H_MAX))
    hits[..., 8 + td.MM_SLOTS:] = rng.integers(
        0, 4, (B, td.H_MAX, td.MM_SLOTS))
    out = {"hits": hits.reshape(B, -1)}
    for k, w in (("part_n", 1), ("part_job", 1), ("part_pos", 3),
                 ("part_refc", 3)):
        out[k] = rng.integers(-2**31, 2**31, (B, w * td.P_MAX),
                              dtype=np.int64).astype(np.int32)
    nh = rng.integers(0, td.H_MAX + 1, B)
    npart = rng.integers(0, td.P_MAX + 1, B)
    ovf = rng.random(B) < 0.2
    if kind == "overflow":
        ovf[:] = True
    elif kind == "full":
        nh[:], npart[:], ovf[:] = td.H_MAX, td.P_MAX, False
    elif kind == "no_parts":
        npart[:] = 0
    out["nhits"] = nh.astype(np.int32)
    out["npart"] = npart.astype(np.int32)
    out["overflow"] = ovf
    return out


def _lanes_slots(counts):
    lanes = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    slots = (np.concatenate([np.arange(c) for c in counts]).astype(np.int32)
             if lanes.size else np.zeros(0, np.int32))
    return lanes, slots


@pytest.mark.parametrize("B,kind", [(1, "random"), (1, "full"),
                                    (64, "overflow"), (64, "full"),
                                    (64, "no_parts"), (300, "random")])
def test_pack_plain_equals_jax_pack_all(B, kind):
    out = _machine_outputs(B, kind, B)
    hits, parts, nh_eff = td.pack_hits_plain(
        {k: torch.from_numpy(v) for k, v in out.items()})
    want_nh = np.where(out["overflow"], 0, out["nhits"])
    np.testing.assert_array_equal(nh_eff.numpy(), want_nh)
    # _pack_all: the hit rows of nh_eff (decode_hit_cols' gather) and the
    # partial rows of npart, fused and padded to the hit width
    st = {k: jnp.asarray(v) for k, v in out.items()}
    la_h, sl_h = _lanes_slots(want_nh)
    la_p, sl_p = _lanes_slots(out["npart"])
    packed = np.asarray(jd._pack_all(st, jnp.asarray(la_h),
                                     jnp.asarray(sl_h), jnp.asarray(la_p),
                                     jnp.asarray(sl_p)))
    np.testing.assert_array_equal(hits.numpy(), packed[:len(la_h)])
    np.testing.assert_array_equal(parts.numpy(),
                                  packed[len(la_h):, :td.PART_W])
    assert hits.shape == (int(want_nh.sum()), td.HIT_W)
    assert parts.shape == (int(out["npart"].sum()), td.PART_W)
    # decode_hit_cols: the same bounds and hits, lane for lane
    bounds_j, mk_j = jd.decode_hit_cols(
        {"nhits": out["nhits"],
         "hits": out["hits"].reshape(B, td.H_MAX, td.HIT_W)}, B,
        out["overflow"])
    bounds_t, mk_t = td.decode_hit_cols(hits.numpy(), nh_eff.numpy())
    assert bounds_t == bounds_j
    for j in range(bounds_j[-1]):
        hj, ht = mk_j(None, j), mk_t(None, j)
        assert (hj.fw, hj.tidx, hj.toff, hj.oms, hj.stratum, hj.cost,
                hj.mms) == (ht.fw, ht.tidx, ht.toff, ht.oms, ht.stratum,
                            ht.cost, ht.mms)
