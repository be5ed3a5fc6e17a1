"""The DFS machine over lanes split across a mesh (parallel/dfs_mesh.py
run_sharded) against the JAX package's run_sharded, on a mesh of ["cpu"]
* 4 for the port (each shard runs K6's and K7's plain versions) and on 4
of conftest's 8 virtual CPU devices for the reference (its GSPMD
partition of the jitted machine compiles in seconds at this size: 16
lanes, L 32), on tests/golden/small_index: -v 1 jobs (dense SA) and -n 2
launch-A jobs (walk-left).  Every output array must be equal, and equal
to one unsharded run_machine of the port.

The iteration count: the port runs each shard on its own and gives the
most any shard took; the reference's one sharded loop counts the whole
batch's lockstep iterations.  A lane's outputs do not depend on its
batch, but the plain (lockstep) machine's count can: an iteration runs a
sub-step only where its batch-wide gate opens, so a shard alone can take
an iteration more than the whole batch (15 against 14 in the -v 1
case).  So the port's count is held to the most the JAX run_machine takes
on any shard alone, and its unsharded count to the JAX run_sharded's.  The
kernel counts each lane's own transitions, which no batch changes
(chip_smoke.py phase mesh holds the sharded count to one launch's)."""
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from bowtie_tpu.align import dfs_device as jd
from bowtie_tpu.align import dfs_jobs as jj
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu.parallel import dfs_mesh as jdm
from bowtie_tpu.utils import rng as j_rng
from bowtie_tpu_torch.align import dfs_device as td
from bowtie_tpu_torch.align import dfs_jobs as tj
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd
from bowtie_tpu_torch.parallel import dfs_mesh as tdm
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

HERE = os.path.dirname(__file__)
BASE = os.path.join(HERE, "golden", "small_index", "small_oracle")
L = 32
B = 16


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    refs = j_io.unpack_reference(*j_io.read_bitpair_reference(BASE))
    rng = np.random.default_rng(31)
    lines = []
    for k in range(B):
        r = refs[k % len(refs)]
        ln = int(rng.integers(20, L + 1))
        p = int(rng.integers(0, len(r) - ln))
        q = np.minimum(r[p:p + ln], 4).astype(np.uint8)
        for _ in range(k % 3):                         # 0-2 mismatches
            q[int(rng.integers(ln))] = rng.integers(0, 4)
        if k % 5 == 4:
            q[int(rng.integers(ln))] = 4
        if k % 2:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, ln))
        lines.append(f"@r{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    fq = tmp_path_factory.mktemp("dfs_mesh") / "r.fq"
    fq.write_text("".join(lines))
    jr = list(j_rd.ReadSource([str(fq)], "fastq").records())
    tr = list(t_rd.ReadSource([str(fq)], "fastq").records())
    ji, jb = j_io.read_ebwt(BASE), j_io.read_ebwt(BASE + ".rev")
    return dict(jr=jr, tr=tr, ji=ji, jb=jb, ti=t_io.read_ebwt(BASE),
                tb=t_io.read_ebwt(BASE + ".rev"), fc=ji.ftab_chars)


def _jobs(data, kind):
    if kind == "n2":
        with mock.patch.object(jj, "derive_rows_enabled", lambda: True):
            jjobs, J, *_ = jj.build_n_jobs_a_vec(
                data["jr"], 2, 28, 70, 125, True, False, False, L,
                data["fc"])
        tjobs, TJ, *_ = tj.build_n_jobs_a_vec(data["tr"], 2, 28, 70, 125,
                                              True, False, False, L)
    else:
        jjobs, J = jj.build_v_jobs_vec(data["jr"], 1, False, False, L,
                                       data["fc"], rows=False)
        tjobs, TJ = tj.build_v_jobs_vec(data["tr"], 1, False, False, L)
    assert J == TJ
    return jjobs, tjobs, J


CASES = [("v1_dense", "v1", True, 1, jd.INF32),
         ("n2_walk", "n2", False, jd.INF32, 3)]


@pytest.mark.parametrize("name,kind,dense,n_k,m_max", CASES,
                         ids=[c[0] for c in CASES])
def test_run_sharded_matches_jax(data, name, kind, dense, n_k, m_max):
    jjobs, tjobs, J = _jobs(data, kind)
    seeds = j_rng.fill_seed_caches(data["jr"], 0)
    c0 = np.zeros(B, np.int32)
    kw = dict(n_k=n_k, m_max=m_max, max_steps=20000)
    cat = jd.build_fmcat(data["ji"], data["jb"], occ_every=128,
                         dense_sa=dense)
    jmesh = jdm.make_dp_mesh(jax.devices()[:4])
    jout, jit = jdm.run_sharded(cat, jjobs, seeds, c0, jmesh, J=J, L=L,
                                nfrag=int(data["ji"].nfrag), **kw)

    pair = td.build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=dense)
    mesh = tdm.make_dp_mesh(["cpu"] * 4)
    tout, tit = tdm.run_sharded(pair, tjobs, seeds, c0, mesh, **kw)
    jshard = max(int(jd.run_machine(
        cat, jd.upload_jobs({k: v[i:i + B // 4] for k, v in jjobs.items()},
                            J, L, data["fc"]),
        seeds[i:i + B // 4], c0[i:i + B // 4], J=J, L=L,
        nfrag=int(data["ji"].nfrag), **kw)[1]) for i in range(0, B, B // 4))
    assert tit == jshard
    for k in td.OUT_KEYS:
        want = np.asarray(jout[k]).astype(np.int64)
        if k == "rng":
            want &= 0xFFFFFFFF
        np.testing.assert_array_equal(tout[k].numpy().astype(np.int64),
                                      want, err_msg=k)
    assert int(tout["nhits"].sum()) > 0
    if kind == "n2":
        assert int(tout["npart"].sum()) > 0

    # one unsharded launch of the port, and the shards from rows derived
    # already: the same arrays and count
    dev = td.upload_jobs(tjobs, data["fc"], "cpu")
    one, oit = td.run_machine(pair, dev, torch.from_numpy(
        seeds.astype(np.int64)), torch.from_numpy(c0), **kw)
    again, ait = tdm.run_sharded(pair, dev, seeds, c0, mesh, **kw)
    assert int(oit) == jit and ait == tit
    for k in td.OUT_KEYS:
        assert torch.equal(one[k], tout[k]), k
        assert torch.equal(again[k], tout[k]), k


def test_shard_lanes_and_replicas():
    mesh = tdm.make_dp_mesh(["cpu"] * 4)
    parts = tdm.shard_lanes(mesh, np.arange(8), torch.arange(8) * 2)
    assert [p[0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                              [6, 7]]
    assert parts[3][1].tolist() == [12, 14]
    with pytest.raises(ValueError, match="not divisible"):
        tdm.shard_lanes(mesh, np.arange(6))
    idx = t_io.read_ebwt(BASE)
    pair = td.build_fmpair(idx, t_io.read_ebwt(BASE + ".rev"), "cpu")
    reps = tdm.replicate_cat(pair, mesh)
    assert list(reps) == [torch.device("cpu")] and reps[mesh[0]] is pair
