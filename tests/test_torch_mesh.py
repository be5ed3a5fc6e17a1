"""K15 (parallel/mesh.py: the exact step over reads split across a mesh)
and the K3 remainder (align/exact.py bwt_rows_offsets) of the PyTorch port
against the JAX package's sharded_align_step and bwt_rows_offsets.

The JAX side runs on conftest's 8-device virtual CPU mesh; the port's on
a mesh of ["cpu"] * 8, where each shard runs K15's plain version.  Both
pad the batch to a multiple of 8 and give every array over the padded
batch: they must be equal element for element, padding rows included,
with the offsets the reference carries as int32 or uint32 read as
uint32 values.  On tests/golden/small_index (walk-left and dense SA) and
small_index_l (the .ebwtl layout's large-index offsets), with exact,
reverse-complement, mismatched, N-bearing, short, random and empty
strands.  tests/test_torch_cuda.py holds the kernels to these plain
versions on the card."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.align import exact as jex
from bowtie_tpu.index.arrays import from_ebwt as j_from_ebwt
from bowtie_tpu.index.ebwt_io import (read_bitpair_reference, read_ebwt,
                                      unpack_reference)
from bowtie_tpu.parallel import mesh as jm
from bowtie_tpu_torch.align import exact as tex
from bowtie_tpu_torch.index.arrays import from_jax_arrays
from bowtie_tpu_torch.parallel import mesh as tm

from test_torch_exact import make_reads, thinned
from test_torch_fm import jax_fields

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")
BASE_L = os.path.join(HERE, "golden", "small_index_l", "small_oracle")
U32 = 0xFFFFFFFF

FORMS = [("small", "walk"), ("small", "dense"), ("small", "thin"),
         ("large", "walk")]


@pytest.fixture(scope="module")
def indexes():
    refs = unpack_reference(*read_bitpair_reference(BASE))
    out = {}
    for name, base in (("small", BASE), ("large", BASE_L)):
        idx = read_ebwt(base)
        walk = j_from_ebwt(idx)
        fms = {"walk": walk, "thin": thinned(walk)}
        if name == "small":
            fms["dense"] = j_from_ebwt(idx, dense_sa=True)
        out[name] = (idx, {k: (j, from_jax_arrays(*jax_fields(j),
                                                  device="cpu"))
                           for k, j in fms.items()})
    return refs, out


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & U32


def _strands(refs, seed, n=333):
    """make_reads' mix plus empty strands, right-aligned; 333 is not a
    multiple of 8, so the mesh pads."""
    reads = make_reads(refs, n, seed)
    for k in range(0, n, 37):
        reads[k] = np.zeros(0, np.uint8)
    return tex.right_align(reads)


@pytest.mark.parametrize("index,form", FORMS,
                         ids=[f"{a}_{b}" for a, b in FORMS])
def test_sharded_align_step_matches_jax(indexes, index, form):
    refs, by_index = indexes
    j, t = by_index[index][1][form]
    mat, lens = _strands(refs, 5 + len(form))
    jmesh = jm.make_mesh(jax.devices())
    assert jmesh.devices.size == 8
    jr, jl, jB = jm.shard_reads(jmesh, mat, lens)
    want = jm.sharded_align_step(jm.replicate_index(j, jmesh), jr, jl)

    mesh = tm.make_mesh(["cpu"] * 8)
    shards, B = tm.shard_reads(mesh, mat, lens)
    got = tm.sharded_align_step(tm.replicate_index(t, mesh), shards)
    assert B == jB == len(lens)
    assert [s[0].shape[0] for s in shards] == [42] * 8
    for name, g, w in zip(("top", "bot", "off", "ok"), got, want):
        w = np.asarray(w)
        w = w if w.dtype == bool else _u32(w)
        assert g.shape[0] == 336
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    top, bot, off, ok = got
    has = bot > top
    assert int(has.sum()) > 100 and int((~has).sum()) > 50
    assert bool((off[~has] == U32).all()) and not bool(ok[~has].any())
    # the padding rows, like the empty strands, search nothing: the
    # whole range, resolved at its top row
    empty = torch.cat([torch.from_numpy(lens) == 0,
                       torch.ones(336 - B, dtype=torch.bool)])
    assert bool((top[empty] == 0).all())
    assert bool((bot[empty] == t.bwt_len).all())
    if form == "thin":                                # walks past MAX_WALK
        assert 0 < int(ok.sum()) < int(has.sum())
    else:
        assert bool(ok[has].all())
    # one shard, one call: the same arrays
    one = tm.align_step_plain(t, torch.from_numpy(mat),
                              torch.from_numpy(lens))
    for g, o in zip(got, one):
        assert torch.equal(g[:B], o)


@pytest.mark.parametrize("index,form", FORMS,
                         ids=[f"{a}_{b}" for a, b in FORMS])
def test_bwt_rows_offsets_matches_jax(indexes, index, form):
    _refs, by_index = indexes
    idx, fms = by_index[index]
    j, t = fms[form]
    rng = np.random.default_rng(17)
    rows = np.concatenate([np.arange(0, 200), [idx.zoff, idx.bwt_len - 1],
                           rng.integers(0, idx.bwt_len, 500)])
    valid = rng.random(len(rows)) < 0.7
    rows_j = jnp.asarray(rows.astype(np.uint32).view(np.int32)
                         if j.fchr.dtype != jnp.uint32 else rows, j.fchr.dtype)
    jo, jok = jex.bwt_rows_offsets(j, rows_j, jnp.asarray(valid))
    to, tok = tex.bwt_rows_offsets(t, torch.from_numpy(rows),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(to.numpy(), _u32(jo))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not bool(tok[~torch.from_numpy(valid)].any())
    assert bool((to[~torch.from_numpy(valid)] == 0).all())
    if form == "thin":
        assert 0 < int(tok.sum()) < int(valid.sum())
    else:
        assert bool(tok.numpy()[valid].all())


def test_mesh_helpers():
    """make_mesh, replicate_index and shard_reads on the CPU: one index
    copy per distinct device, contiguous chunks, code-4 padding."""
    mesh = tm.make_mesh(["cpu", "cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 3
    mat = np.arange(20, dtype=np.uint8).reshape(10, 2) % 4
    lens = np.arange(10, dtype=np.int32)
    shards, B = tm.shard_reads(mesh, mat, lens)
    assert B == 10 and [s[0].shape[0] for s in shards] == [4, 4, 4]
    np.testing.assert_array_equal(
        torch.cat([s[0] for s in shards])[:10].numpy(), mat)
    assert bool((shards[2][0][2:] == 4).all())
    assert shards[2][1][2:].tolist() == [0, 0]
    with pytest.raises(ValueError):
        tm.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tm.make_mesh()
