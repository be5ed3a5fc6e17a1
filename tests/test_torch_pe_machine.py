"""K10r, the best-first machine in record mode, against the reference's
JAX machine, array for array: init_state + run_machine_plain(record=True)
against _init_state_jit + run_chunk(record=True) on one fused run of 16
lanes (4 pairs x (mate, orientation)) whose fw-DAG and rc-DAG lanes read
their own config tables through cfg0f/cfg0o, every state array after each
chunk (the iteration count with it), under -v 2 with rec_cap 12 (lanes
of the repeat reach the cap), on the dense and the compact (walk-left)
layouts.  The fused host arrays (pe_device.fused_host_init) are held to
the reference's too.  tests/test_torch_pe_machine_uncapped.py does the
same for the seeded -n 2 DAG uncapped.

Each JAX machine configuration is one XLA compile, so the run is kept
tiny (B = 16, L = 32) and a module holds one policy."""
import numpy as np
import pytest
import torch

from bowtie_tpu.align import best_device as jbd
from bowtie_tpu.align import pe_device as jpe
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.io import readers as j_rd
from bowtie_tpu_torch.align import best_device as tbd
from bowtie_tpu_torch.align import pe_device as tpe
from bowtie_tpu_torch.align.dfs_device import build_fmpair
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.io import readers as t_rd
from bowtie_tpu_torch.utils.alphabet import codes_to_seq
from bowtie_tpu_torch.utils.rng import fill_seed_caches

CHUNK = 24
L = 32
# registers of the reference's state that the port leaves out: none
# (the per-outer read length and seed qlen_o/seed_o are compared,
# each outer's the lane's own here)
JAX_ONLY = set()


def make_pe_data(d, n_pairs, max_len=32, seed=7, odd_mates=False):
    """A two-record genome with a 60 bp repeat planted 20 times, each copy
    with two substitutions of its own (so a read of the repeat has many
    ranges of distinct mismatches), its index built by the port's
    builder, and seeded pairs of 20..max_len-base mates, fragments of
    100-250 bases in --fr orientation: exact, 1-2 mismatches per mate,
    Ns, one random mate (every 5th pair), a repeat mate (every 2nd), both
    mates from the repeat, never concordant (every 6th).  With odd_mates,
    two more pairs with a 3-base and a 300-base mate, which the machine
    leaves to the host engine.  -> dict with the index base, the mate
    files and both packages' pairs and indexes."""
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, 4, 60).astype(np.uint8)
    seqs = []
    for ln in (9000, 7000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.choice(np.arange(0, ln - 60, 300), 10, replace=False):
            cp = rep.copy()
            for j in rng.choice(60, 2, replace=False):
                cp[j] = (cp[j] + rng.integers(1, 4)) % 4
            s[p:p + 60] = cp
        seqs.append(s)
    base = str(d / "g")
    build_index(seqs, ["chrA first", "chrB"], base)

    def mutate(q, n):
        q = q.copy()
        for _ in range(n):
            q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        return q

    def fq(name, q):
        qual = "".join(chr(33 + int(x)) for x in rng.integers(5, 41, len(q)))
        return f"@{name}\n{codes_to_seq(q)}\n+\n{qual}\n"

    f1, f2 = [], []
    for k in range(n_pairs):
        s = seqs[k % 2]
        ln1, ln2 = (int(x) for x in rng.integers(20, max_len + 1, 2))
        frag = int(rng.integers(100, 251))
        p = int(rng.integers(0, len(s) - frag))
        m1 = s[p:p + ln1]
        m2 = (3 - s[p + frag - ln2:p + frag][::-1]).astype(np.uint8)
        if k % 2 == 1:
            off = int(rng.integers(0, 60 - ln1 + 1))
            m1 = rep[off:off + ln1]
        if k % 5 == 1:
            m2 = rng.integers(0, 4, ln2).astype(np.uint8)
        if k % 6 == 5:
            off = int(rng.integers(0, 60 - ln2 + 1))
            m2 = (3 - rep[off:off + ln2][::-1]).astype(np.uint8)
        m1, m2 = mutate(m1, k % 3), mutate(m2, (k // 3) % 3)
        if k % 11 == 6:
            m2 = m2.copy()
            m2[int(rng.integers(ln2))] = 4
        f1.append(fq(f"p{k}/1", m1))
        f2.append(fq(f"p{k}/2", m2))
    if odd_mates:
        for k, ln in ((n_pairs, 3), (n_pairs + 1, 300)):
            f1.append(fq(f"p{k}/1", seqs[0][1000:1000 + ln]))
            f2.append(fq(f"p{k}/2", (3 - seqs[0][1100:1130][::-1])
                         .astype(np.uint8)))
    (d / "m1.fq").write_text("".join(f1))
    (d / "m2.fq").write_text("".join(f2))
    paths = ([str(d / "m1.fq")], [str(d / "m2.fq")])
    return dict(base=base, m1=paths[0][0], m2=paths[1][0],
                jp=list(j_rd.PairedReadSource(*paths).pairs()),
                tp=list(t_rd.PairedReadSource(*paths).pairs()),
                ji=j_io.read_ebwt(base), jb=j_io.read_ebwt(base + ".rev"),
                ti=t_io.read_ebwt(base), tb=t_io.read_ebwt(base + ".rev"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_pe_data(tmp_path_factory.mktemp("torch_pe_machine"), 4)


def assert_states_equal(jst, tst, tag):
    assert set(jst) - JAX_ONLY == set(tst), tag
    for k in tst:
        want = np.asarray(jst[k]).astype(np.int64)
        got = tst[k].numpy().astype(np.int64)
        assert got.shape == want.shape, (tag, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag}: {k}")


def fused_lanes(pairs):
    """The recorder's lanes of the pairs under --fr, in its order
    (pe_device.py:1056-1066, :695): (group, read, seed-of-pair index)."""
    m1 = [p[0] for p in pairs]
    m2 = [p[1] for p in pairs]
    plan = ((0, m1), (1, m2), (1, m1), (0, m2))   # fw: 0, rc: 1
    need = sorted(((plan[sk][0], sk, k) for sk in range(4)
                   for k in range(len(pairs))))
    return ([plan[sk][1][k] for _g, sk, k in need],
            np.array([g for g, _sk, _k in need], np.int32),
            np.array([k for _g, _sk, k in need], np.int64))


def record_case(data, kw, cap, compact):
    """Both machines from the same fused host arrays, chunk by chunk.
    -> the final port state and the number of chunks."""
    jcat = jbd.build_fmcat(data["ji"], data["jb"], occ_every=128,
                           dense_sa=not compact)
    skw = dict(kw, maq=True, qual_order=True, maxbts=800, max_steps=60000)
    jm = [jpe._StrandMachine(jcat, data["ji"], data["jb"], fw=fw, **skw)
          for fw in (True, False)]
    tm = [tpe._StrandMachine(data["ti"], data["tb"], fw=fw, **skw)
          for fw in (True, False)]
    reads_j, grp, which = fused_lanes(data["jp"])
    reads_t, _, _ = fused_lanes(data["tp"])
    assert max(len(r.seq) for r in reads_t) <= L
    # mate 1's seed for the outer CostAware, each lane's own for the rest
    # (pe_device._record_fused)
    seeds = fill_seed_caches([p[0] for p in data["tp"]], 0)[which]
    own = fill_seed_caches(reads_t, 0)
    host_t = tpe.fused_host_init(tm, reads_t, grp, seeds, L)
    host_j = {}
    for g in (0, 1):
        sel = np.flatnonzero(grp == g)
        part = jm[g].hostinit.build([reads_j[j] for j in sel], L, seeds[sel])
        for k, v in part.items():
            host_j.setdefault(k, np.zeros((len(grp),) + v.shape[1:],
                                          v.dtype))[sel] = v
    host_j["cfg0f"] = grp * jm[0].hostinit.ndt
    host_j["cfg0o"] = grp * jm[0].hostinit.nd
    assert set(host_t) == set(host_j)
    for k in host_j:
        np.testing.assert_array_equal(host_t[k], host_j[k], err_msg=k)
    nd, ndt, B = tm[0].hostinit.nd, tm[0].hostinit.ndt, len(grp)
    static = dict(nd=nd, ndt=ndt, L=L, nfrag=int(data["ji"].nfrag),
                  n_k=jbd.INF32, m_max=jbd.INF32, strata=False,
                  qual_lim=jm[0].qual_lim, qual_order=True,
                  bt_on=jm[0].bt_on, fc=jcat.ftab_chars,
                  has_seeded=jm[0].has_seeded, record=True, rec_cap=cap)
    import jax.numpy as jnp
    cfg_j = {k: jnp.concatenate([jm[0].cfgj[k], jm[1].cfgj[k]])
             for k in jm[0].cfgj}
    cfg_t = {k: torch.from_numpy(np.concatenate(
        [tm[0].hostinit.cfg[k], tm[1].hostinit.cfg[k]]).astype(np.int64))
        for k in tm[0].hostinit.cfg}
    jst = jbd._init_state_jit(own.astype(np.uint32), host_j, B=B, L=L,
                              nd=nd, ndt=ndt, maxbts=800)
    tst = tbd.init_state(B, L, nd, ndt, own, host_t, 800, "cpu")
    assert_states_equal(jst, tst, "init")
    pair = build_fmpair(data["ti"], data["tb"], "cpu", dense_sa=not compact)
    rounds = 0
    while True:
        jst, _ = jbd.run_chunk(jcat, cfg_j, jst, chunk=CHUNK, **static)
        tst, _it = tbd.run_machine_plain(pair, cfg_t, tst, chunk=CHUNK,
                                         **static)
        rounds += 1
        assert_states_equal(jst, tst, f"after chunk {rounds}")
        if not bool((tst["mode"] != tbd.M_DONE).any()):
            break
    assert rounds > 1                      # the first chunk cut the run
    return tst, rounds


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_record_machine_matches_jax(data, compact):
    st, _ = record_case(data, dict(mode="v", v=2, seed_mms=2, seed_len=28,
                                   qual_cutoff=70), 12, compact)
    nh = st["nhits"]
    hits = st["hits"].view(len(nh), tbd.H_MAX, tbd.HIT_W)
    assert int(nh.sum()) > 0
    # a lane frozen by the cap marks its last record (done column 2)
    capped = [int(hits[b, nh[b] - 1, 6]) == 2 for b in range(len(nh))
              if nh[b] > 0]
    assert any(capped) and int(nh.max()) == 12
