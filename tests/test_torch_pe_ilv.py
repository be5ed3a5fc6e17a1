"""K13, the V1 interleave, chase and rescue machine (align/pe_ilv_device.py),
on the CPU:

- run_ilv_plain's decision for every pair (decided or escalated, and the
  ReadResult that _ilv_assemble builds) against the port's host replay of
  the same recorded streams (ReplayDriver, ReplayTruncated), round 1
  (capped, after phase 0) and round 2 (uncapped), under --fr, --ff and
  --rf, with -3/-5 trims, -I/-X windows that reject, -v 2 scoring, a low
  symmetric ceiling and a thinned SA sample (walk-left), on the 150 pairs
  of tests/test_torch_pe_streams.py and seeded pairs of both strands with
  Ns, 5-9 base mates, random mates and long fragments;
- run_ilv_plain against the reference's run_ilv (bowtie_tpu/align/
  pe_ilv_device.py) on the same inputs, all 12 output fields, array for
  array (one XLA compile: 32 lanes, chunk 128);
- DevicePairedBestAligner(device="cpu"), K13 included, against the port's
  V1 host engine, pair for pair, on the dense index and on the index
  thinned to offRate 13, where K13 runs out of its step budget and the
  pairs fall back."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bowtie_tpu.align import best_device as jbd
from bowtie_tpu.align import pe_ilv_device as jilv
from bowtie_tpu_torch.align import pe_device as tpe
from bowtie_tpu_torch.align import pe_ilv_device as tilv
from bowtie_tpu_torch.align.best_factories import make_paired_best_aligner
from bowtie_tpu_torch.align.golden import GoldenFM
from bowtie_tpu_torch.align.policy import KPolicy
from bowtie_tpu_torch.io.readers import PairedReadSource
from bowtie_tpu_torch.utils.alphabet import codes_to_seq
from bowtie_tpu_torch.utils.rng import fill_seed_caches
from test_torch_pe_aligner import pe_key
from test_torch_pe_streams import INF, data  # noqa: F401

N_EXTRA = 40
N_MODE = dict(mode="n", seed_mms=2, seed_len=28, qual_cutoff=70)


def _revcomp(q):
    return np.where(q < 4, 3 - q, q)[::-1].astype(np.uint8)


def extra_pairs(seqs, n, layout, path, seed, lens=(18, 36), **trim):
    """n seeded pairs of one mate layout ("fr", "ff" or "rf") from either
    strand of the genome `seqs`: fragments of 80-250 bases (every 8th
    300-400), mates of lens[0]-lens[1] bases with 0-2 mismatches; every
    7th with an N in a mate, every 9th with a 5-9 base mate 2, every 5th
    with a random mate 1.  Written as FASTQ and read back with `trim`
    (trim5, trim3)."""
    rng = np.random.default_rng(seed)
    f1, f2 = [], []
    for k in range(n):
        s = seqs[k % len(seqs)]
        if k % 2:
            s = _revcomp(s)                 # the other strand
        frag = int(rng.integers(300, 401) if k % 8 == 6
                   else rng.integers(80, 251))
        p = int(rng.integers(0, len(s) - frag))
        l1, l2 = (int(x) for x in rng.integers(lens[0], lens[1] + 1, 2))
        if k % 9 == 4:
            l2 = int(rng.integers(5, 10))
        up, dn = s[p:p + l1], s[p + frag - l2:p + frag]
        m1, m2 = {"fr": (up, _revcomp(dn)), "ff": (up, dn),
                  "rf": (_revcomp(up), dn)}[layout]
        m1, m2 = m1.copy(), m2.copy()
        if k % 5 == 1:
            m1 = rng.integers(0, 4, l1).astype(np.uint8)
        for q in (m1, m2):
            for _ in range(k % 3):
                q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        if k % 7 == 3:
            m2[int(rng.integers(len(m2)))] = 4
        for f, q, m in ((f1, m1, 1), (f2, m2, 2)):
            qual = "".join(chr(33 + int(x))
                           for x in rng.integers(5, 41, len(q)))
            f.append(f"@x{k}/{m}\n{codes_to_seq(q)}\n+\n{qual}\n")
    (path / "x1.fq").write_text("".join(f1))
    (path / "x2.fq").write_text("".join(f2))
    return list(PairedReadSource([str(path / "x1.fq")], [str(path / "x2.fq")],
                                 **trim).pairs())


@pytest.fixture(scope="module")
def genome(data):
    return [np.asarray(r, np.uint8) for r in data["trefs"]]


# (id, layout, reader trims, aligner keyword arguments, SA thinning); the
# --fr cases without trims replay the shared recording of fr_streams
CASES = [
    ("fr", "fr", {}, {}, 1),
    ("fr_I150_X220", "fr", {}, dict(min_insert=150, max_insert=220), 1),
    ("fr_sym1", "fr", {}, dict(sym_ceiling=1), 1),
    ("fr_walk_offrate9", "fr", {}, {}, 16),
    ("fr_trim", "fr", dict(trim5=3, trim3=2), {}, 1),
    ("ff", "ff", {}, dict(fw1=True, fw2=True), 1),
    ("rf", "rf", {}, dict(fw1=False, fw2=True), 1),
    ("fr_v2", "fr", {}, dict(mode="v", v=2), 1),
]


def _aligner(data, kw, by=1):
    idx, idx_bw = data["ti"], data["tb"]
    if by > 1:
        rate = idx.off_rate + by.bit_length() - 1
        idx, idx_bw = idx.with_off_rate(rate), idx_bw.with_off_rate(rate)
    akw = {**N_MODE, "sym_ceiling": INF, **kw}
    return tpe.DevicePairedBestAligner(idx, idx_bw, data["trefs"], KPolicy(),
                                       device="cpu", compact=by > 1, **akw)


def _record(al, pairs):
    """The recordings of align_batch: round 1 (rec_cap 1 after phase 0)
    for every pair, round 2 (uncapped) for the pairs whose host replay
    escalates.  -> {"pairs", "seeds", 1: items, None: items}."""
    s1 = fill_seed_caches([p[0] for p in pairs], 0)
    rec = {"pairs": pairs, "seeds": s1}
    idxs = list(range(len(pairs)))
    for cap in (1, None):
        sts, ovd = al._record_all(al.plan(pairs), idxs,
                                  s1[np.asarray(idxs, np.int64)], cap)
        rec[cap] = [(i, sts[i]) for i in idxs if not ovd[i]]
        idxs = [i for i, st in rec[cap]
                if al._replay_state.replay(*pairs[i], st)[1]]
    return rec


@pytest.fixture(scope="module")
def fr_streams(data, genome, tmp_path_factory):
    """The 150 pairs, the two odd ones and 60 seeded --fr pairs of both
    strands, recorded as align_batch records them."""
    pairs = data["tp"] + extra_pairs(genome, N_EXTRA, "fr",
                                     tmp_path_factory.mktemp("fr"), 11)
    return _record(_aligner(data, {}), pairs)


def _decisions(al, rec, cap):
    """run_ilv_plain over a recording's items: -> (lanes, outputs by key
    as lists, iterations, S, the initial state)."""
    S, st, lanes, host = al.ilv_inputs(rec["pairs"], rec[cap], rec["seeds"])
    assert not host and len(lanes) == len(rec[cap])
    st0 = {k: v.clone() for k, v in st.items()}
    out, iters = tilv.run_ilv_plain(al.pair, st, S)
    return (lanes, dict(zip(tilv.OUT_KEYS, tilv.stack_out(out).tolist())),
            iters.tolist(), S, st0)


@pytest.mark.parametrize("layout,trim,kw,by", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_plain_decides_as_host_replay(data, genome, fr_streams, tmp_path,
                                      layout, trim, kw, by):
    """Every pair run_ilv_plain finishes: escalated exactly where the host
    replay raises ReplayTruncated, else the host replay's ReadResult;
    round 1 and round 2."""
    al = _aligner(data, kw, by)
    assert al.use_ilv and al.rec_cap == 1
    if layout == "fr" and not trim and "mode" not in kw:
        rec = fr_streams
    else:
        rec = _record(al, extra_pairs(genome, 30, layout, tmp_path, 11,
                                      **trim))
    pairs = rec["pairs"]
    seen = {"found": 0, "escalated": 0, "budget": 0, "phase1": 0}
    for cap in (1, None):
        lanes, o, iters, S, _ = _decisions(al, rec, cap)
        for k, (i, streams) in enumerate(lanes):
            if o["mode"][k] != tilv.I_DONE:     # K13's step budget
                assert o["escalate"][k] and iters[k] == S.max_steps
                seen["budget"] += 1
                continue
            want, esc = al._replay_state.replay(*pairs[i], streams)
            assert bool(o["escalate"][k]) == esc, (cap, i)
            if esc:
                seen["escalated"] += 1
                continue
            res = ({key: v[k] for key, v in o.items()}
                   if o["res_found"][k] else None)
            got = al._ilv_assemble(pairs[i], streams, res)
            assert pe_key(got) == pe_key(want), (cap, i)
            seen["found"] += int(bool(got.hits))
            seen["phase1"] += int(o["res_found"][k] and o["res_phase"][k])
    assert seen["found"] > 10 and seen["escalated"] > 0
    assert seen["phase1"] > 0                 # rc-orientation pairs
    if by == 1:
        assert seen["budget"] == 0


def _reference_out(data, S, st):
    """The reference's run_ilv on the port's inputs, 32 lanes a call
    (padding lanes start done), one chunk size: -> [12, B] int64."""
    cat = jbd.build_fmcat(data["ji"], data["jb"], occ_every=128,
                          dense_sa=True)
    JS = jilv.IlvStatic(**{**dataclasses.asdict(S),
                           "sym_ceiling": min(S.sym_ceiling, 0x7FFFFFFE)})
    g = dict(efw_tab=st["efw_tab"].numpy(),
             reflen=st["reflen"].numpy().astype(np.int32),
             _refcat=st["refcat"].numpy(),
             _refbase=st["refbase"].numpy().astype(np.int32))
    B, BJ = st["mode"].shape[0], 32
    outs = []
    for lo in range(0, B, BJ):
        n = min(BJ, B - lo)

        def pad(k, dt=np.int32):
            a = st[k][lo:lo + n].numpy().astype(dt)
            return jnp.asarray(np.concatenate(
                [a, np.zeros((BJ - n,) + a.shape[1:], dt)]))
        consts = {k: pad(k, np.uint8 if k == "q_c" else np.int32)
                  for k in tilv.LANE_KEYS[3:]}
        consts.update({k: jnp.asarray(v) for k, v in g.items()})
        st0 = jilv.init_state(BJ, pad("hits"), pad("nrec"), pad("capped"),
                              pad("rng", np.uint32), consts,
                              np.arange(BJ) >= n)
        out, _ = jilv.run_ilv(cat, st0, S=JS, chunk=128)
        outs.append(np.stack([np.asarray(out[k])[:n].astype(np.int64)
                              for k in jilv.OUT_KEYS]))
    return np.concatenate(outs, 1)


def test_plain_matches_reference_run_ilv(data, fr_streams):
    """run_ilv_plain equals the reference's run_ilv on every lane and all
    12 fields, on round 1's and round 2's streams of fr_streams (one
    IlvStatic: --fr, -n 2, Lq 40), when it starts as the reference does,
    with the sides of empty streams done; from its own start it may differ
    on lanes with an empty stream only (ROADMAP queue 3)."""
    al = _aligner(data, {})
    assert tilv.OUT_KEYS == jilv.OUT_KEYS and tilv.REC_W == jilv.REC_W
    for cap in (1, None):
        lanes, o, _, S, st0 = _decisions(al, fr_streams, cap)
        got = np.array([o[k] for k in tilv.OUT_KEYS])
        assert S.Lq == 40
        st0["sdone"] = (st0["nrec"] == 0).long()
        want = _reference_out(data, S, {k: v.clone() for k, v in st0.items()})
        out, _ = tilv.run_ilv_plain(al.pair, st0, S)
        assert np.array_equal(tilv.stack_out(out), want), cap
        lanes_d = np.flatnonzero((got != want).any(0))
        assert (st0["nrec"][lanes_d] == 0).any(1).all()
        assert (want[10].sum() > 0) == (cap == 1)
        if cap == 1:
            assert want[0].sum() > 40 and want[8][want[0] == 1].sum() > 0


def test_plain_work_counts_what_the_scan_reads(data, fr_streams,
                                               monkeypatch):
    """The scan counts of run_ilv_plain's `work` (the bytes of K13's
    bound) equal a scalar walk of the kernel's zig-zag scan over the same
    scans: candidates, bases compared, and of the queries read, their
    number, the bases up to the last one compared and the distinct
    penalties a compared mismatch read."""
    al = _aligner(data, {})
    S, st, _, _ = al.ilv_inputs(fr_streams["pairs"], fr_streams[1],
                                fr_streams["seeds"])
    assert S.v < 0
    scans, real = [], tilv._step_scan

    def spy(st, S, work):
        lanes = torch.nonzero(st["mode"] == tilv.I_SCAN).squeeze(1)
        scans.extend(zip(lanes.tolist(), *(st[k][lanes].tolist() for k in (
            "sc_combo", "sc_tidx", "sc_begin", "sc_end"))))
        return real(st, S, work)
    monkeypatch.setattr(tilv, "_step_scan", spy)
    t = {k: v.clone() for k, v in st.items()}
    work = {}
    tilv.run_ilv_plain(al.pair, st, S, work)
    ref, want = t["refcat"].tolist(), dict(candidates=0, bases=0)
    pref, pens = {}, set()
    for b, combo, tidx, begin, end in scans:
        qlen = int(t["qlen_c"][b, combo])
        sol = int(t["sol_c"][b, combo]) > 0
        q = t["q_c"][b, combo].tolist()
        pen = t["pen_c"][b, combo].tolist()
        base, reflen = int(t["refbase"][tidx]), int(t["reflen"][tidx])
        qb, qe = (begin, end - qlen) if sol else (begin + qlen, end)
        lim, slen = qe - qb, min(S.seed_len, qlen)
        halfway = qb + (lim >> 1)
        for i in range(1, lim + 2):
            ri = halfway - (i >> 1) if i & 1 else halfway + (i >> 1)
            left = ri if sol else ri - qlen
            if left < 0 or left + qlen > reflen:
                continue
            want["candidates"] += 1
            smm = ham = 0
            for j in range(qlen + 1):
                if j == qlen:
                    break
                c = ref[base + left + j]
                if c > 3:
                    break
                pref[(b, combo)] = max(pref.get((b, combo), 0), j + 1)
                if c == q[j]:
                    continue
                pens.add((b, combo, j))
                smm += (j < slen) if sol else (j >= qlen - slen)
                ham += pen[j]
                if smm > S.seed_mms or ham > S.qual_max:
                    break
            want["bases"] += min(j + 1, qlen)
            if j == qlen:
                break
    assert len(scans) > 50 and work["scans"] == len(scans)
    assert {k: work[k] for k in want} == want
    assert work["queries"] == len(pref)
    assert work["query_bases"] == sum(pref.values())
    assert 0 < work["pen_entries"] == len(pens) < work["query_bases"]


def test_empty_stream_divergence_pinned(data, genome, tmp_path):
    """ROADMAP queue 3: the reference's ReplayDriver and run_ilv start a
    side whose stream is empty as done, so they skip the other side's
    first chase and its LCG draw.  On --fr pair x49 of extra_pairs(seed
    17) (-n 2 -k 1, mate 1 with no forward range, mate 2 of 7 bases) the
    host engine chases mate 2's range first and reports the pair at
    chromosome 1:823/922; the reference's run_ilv reports it at 0:4640/
    4822.  The port's K13 gives the host engine's answer."""
    pairs = extra_pairs(genome, 50, "fr", tmp_path, 17)[49:50]
    assert pairs[0][1].seq == b"TTATGAG"
    al = _aligner(data, {})
    rec = _record(al, pairs)
    lanes, o, _, S, st0 = _decisions(al, rec, 1)
    host = make_paired_best_aligner(
        GoldenFM(data["ti"]), GoldenFM(data["tb"]), data["trefs"],
        KPolicy(), sym_ceiling=INF, **N_MODE)
    want = host.align_pair(*pairs[0])
    assert [(h.tidx, h.toff) for h in want.hits] == [(1, 823), (1, 922)]
    got = al._ilv_assemble(pairs[0], lanes[0][1],
                           {k: v[0] for k, v in o.items()})
    assert pe_key(got) == pe_key(want)
    st0["sdone"] = (st0["nrec"] == 0).long()
    ref = dict(zip(jilv.OUT_KEYS, _reference_out(data, S, st0)[:, 0]))
    assert (ref["res_tidx"], ref["res_toff"], ref["res_left"]) == (0, 4640,
                                                                    4822)


@pytest.mark.parametrize("by", [1, 256], ids=["dense", "offrate13"])
def test_aligner_matches_host_engine(data, genome, tmp_path, by):
    """The CPU aligner with K13 gives the V1 host engine's results; on the
    offRate-13 index K13's walks outrun its budget, so pairs escalate,
    re-record uncapped and fall back to the host drivers."""
    pairs = extra_pairs(genome, 50 if by == 1 else 10, "fr", tmp_path,
                        17)
    host = make_paired_best_aligner(
        GoldenFM(data["ti"]), GoldenFM(data["tb"]), data["trefs"],
        KPolicy(), sym_ceiling=INF, **N_MODE)
    want = [pe_key(r) for r in host.align_batch(pairs)]
    al = _aligner(data, {}, by)
    got = [pe_key(r) for r in al.align_batch(pairs)]
    assert got == want
    r1, r2 = al.ilv_by_round["round 1"], al.ilv_by_round["round 2"]
    assert r1["escalated"] > 0 and r1["host"] == 0
    assert r1["decided"] + r1["escalated"] + al.fallbacks >= len(pairs)
    assert al.escalations == r1["escalated"]
    if by == 1:
        assert r1["decided"] > len(pairs) // 2
        assert al.ilv_decided == r1["decided"] + r2["decided"]
    else:
        assert r2["escalated"] > 0
        assert al.fallbacks >= r2["escalated"]


def test_long_mates_stay_on_host_replay(data, genome, tmp_path):
    """K13 leaves pairs with a mate over 64 bases to the host replay, and
    the aligner's results stay the host engine's; -k 2 and a -X past
    2,048 take no K13 at all."""
    pairs = extra_pairs(genome, 16, "fr", tmp_path, 19, lens=(50, 80))
    al = _aligner(data, {})
    rec = _record(al, pairs)
    items = rec[1]
    S, st, lanes, host = al.ilv_inputs(pairs, items, rec["seeds"])
    assert [i for i, _ in host] == [
        i for i, _ in items if max(len(pairs[i][0].seq),
                                   len(pairs[i][1].seq)) > 64]
    assert host and lanes and S.Lq == 64
    hal = make_paired_best_aligner(
        GoldenFM(data["ti"]), GoldenFM(data["tb"]), data["trefs"],
        KPolicy(), sym_ceiling=INF, **N_MODE)
    want = [pe_key(r) for r in hal.align_batch(pairs)]
    assert [pe_key(r) for r in al.align_batch(pairs)] == want
    assert al.ilv_by_round["round 1"]["host"] == len(host)
    for pol, kw in ((KPolicy(khits=2), {}), (KPolicy(), dict(
            max_insert=4000))):
        other = tpe.DevicePairedBestAligner(
            data["ti"], data["tb"], data["trefs"], pol, device="cpu",
            **N_MODE, **kw)
        assert not other.use_ilv
