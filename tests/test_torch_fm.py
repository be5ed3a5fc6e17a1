"""K1 (rank/LF helpers) of the PyTorch port against bowtie_tpu/ops/fm.py.

Both packages get the very same index: the JAX package's FMIndexArrays
are carried into the port with from_jax_arrays.  Rows cover zoff, the
checkpoint-block edges and bwt_len.  All results must be exactly equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.index.arrays import from_ebwt as j_from_ebwt
from bowtie_tpu.index.ebwt_io import read_ebwt
from bowtie_tpu.ops import fm as jfm
from bowtie_tpu_torch.index.arrays import (from_ebwt as t_from_ebwt,
                                           from_jax_arrays)
from bowtie_tpu_torch.ops import fm as tfm

HERE = os.path.dirname(__file__)
BASES = [os.path.join(HERE, "golden", "small_index", "small_oracle"),
         os.path.join(HERE, "golden", "small_index", "small_oracle.rev"),
         os.path.join(HERE, "golden", "small_index_l", "small_oracle")]
JAX_FIELDS = ["bwt", "occ", "fchr", "ftab_hi", "ftab_lo", "offs", "zoff",
              "bwt_len", "sa"]


def jax_fields(j):
    d = {f: np.asarray(getattr(j, f)) for f in JAX_FIELDS
         if getattr(j, f) is not None}
    meta = dict(ftab_chars=j.ftab_chars, off_rate=j.off_rate,
                occ_every=j.occ_every)
    return d, meta


@pytest.fixture(scope="module", params=BASES, ids=os.path.relpath)
def pair(request):
    idx = read_ebwt(request.param)
    j = j_from_ebwt(idx)
    t = from_jax_arrays(*jax_fields(j), device="cpu")
    return idx, j, t


def edge_rows(idx, n_random=300, seed=0):
    n = idx.bwt_len
    rng = np.random.default_rng(seed)
    edges = [0, 1, 15, 16, 17, 127, 128, 129, 255, 256, n - 1, n,
             idx.zoff - 1, idx.zoff, idx.zoff + 1,
             (n // 128) * 128, (n // 128) * 128 - 1]
    rows = np.concatenate([rng.integers(0, n + 1, n_random), edges])
    return np.clip(rows, 0, n).astype(np.int64)


def test_from_ebwt_matches_from_jax_arrays(pair):
    idx, _j, t = pair
    own = t_from_ebwt(idx, device="cpu")
    for f in ["bwt", "occ", "fchr", "ftab_hi", "ftab_lo", "offs"]:
        assert torch.equal(getattr(own, f), getattr(t, f)), f
    assert (own.zoff, own.bwt_len, own.ftab_chars, own.off_rate) == \
        (t.zoff, t.bwt_len, t.ftab_chars, t.off_rate)


def test_dense_sa_matches_reference(pair):
    idx, _j, _t = pair
    jd = j_from_ebwt(idx, dense_sa=True)
    own = t_from_ebwt(idx, device="cpu", dense_sa=True)
    np.testing.assert_array_equal(np.asarray(jd.sa).astype(np.int64),
                                  own.sa.numpy().astype(np.int64))


@pytest.mark.parametrize("c", [0, 1, 2, 3])
def test_rank1_equal(pair, c):
    idx, j, t = pair
    rows = edge_rows(idx)
    want = np.asarray(jax.vmap(lambda i: jfm.rank1(j, jnp.int32(c), i))(
        jnp.asarray(rows, jnp.int32)))
    got = tfm.rank1_plain(t, c, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_rank4_lf4_equal(pair):
    idx, j, t = pair
    rows = jnp.asarray(edge_rows(idx), jnp.int32)
    tr = torch.from_numpy(edge_rows(idx))
    np.testing.assert_array_equal(
        tfm.rank4_plain(t, tr).numpy(),
        np.asarray(jax.vmap(lambda i: jfm.rank4(j, i))(rows)))
    np.testing.assert_array_equal(
        tfm.lf4_plain(t, tr).numpy(),
        np.asarray(jax.vmap(lambda i: jfm.lf4(j, i))(rows)))


@pytest.mark.parametrize("c", [0, 1, 2, 3])
def test_lf_equal(pair, c):
    idx, j, t = pair
    rows = edge_rows(idx, seed=c + 1)
    want = np.asarray(jfm.lf(j, jnp.asarray(rows, jnp.int32),
                             jnp.full(len(rows), c, jnp.int32)))
    got = tfm.lf_plain(t, torch.from_numpy(rows),
                       torch.full((len(rows),), c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bwt_char_and_lf_row_equal(pair):
    idx, j, t = pair
    rows = edge_rows(idx, seed=9)
    rows = rows[(rows < idx.bwt_len) & (rows != idx.zoff)]
    jr = jnp.asarray(rows, jnp.int32)
    tr = torch.from_numpy(rows)
    np.testing.assert_array_equal(tfm.bwt_char_plain(t, tr).numpy(),
                                  np.asarray(jfm.bwt_char(j, jr)))
    np.testing.assert_array_equal(tfm.bwt_char_plain(t, tr).numpy(),
                                  idx.bwt[rows])
    np.testing.assert_array_equal(
        tfm.lf_row_compact_plain(t, tr).numpy(),
        np.asarray(jfm.lf_row_compact(j, jr)))


def test_ftab_jump_equal(pair):
    idx, j, t = pair
    rng = np.random.default_rng(4)
    fc = idx.ftab_chars
    for codes in rng.integers(0, 4, size=(40, fc)):
        jt, jb = jfm.ftab_jump(j, jnp.asarray(codes, jnp.int32))
        tt, tb = tfm.ftab_jump_plain(t, torch.from_numpy(codes))
        assert (int(tt), int(tb)) == (int(jt), int(jb))
