"""Host layer of the PyTorch port against the JAX package: the index
reader, the per-read RNG, the index builder, the native FASTQ parser,
--stats' metrics, the package boundary and the device policy of the entry
points."""
import ast
import os
import re

import numpy as np
import pytest
import torch

from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu.utils import rng as j_rng
from bowtie_tpu.io.readers import ReadRecord as JRead
from bowtie_tpu_torch.index import ebwt_io as t_io
from bowtie_tpu_torch.utils import rng as t_rng
from bowtie_tpu_torch.io.readers import ReadRecord as TRead

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden", "small_index", "small_oracle")
GOLD_L = os.path.join(HERE, "golden", "small_index_l", "small_oracle")
FASTA = os.path.join(HERE, "golden", "small_genome.fa")

INDEXES = [GOLD, GOLD + ".rev", GOLD_L, GOLD_L + ".rev"]
FIELDS = ["length", "line_rate", "lines_per_side", "off_rate", "ftab_chars",
          "entire_reverse", "npat", "plen", "nfrag", "rstarts", "refnames",
          "flags", "zoff", "fchr", "ftab", "eftab", "offs", "bwt",
          "off_size"]


@pytest.mark.parametrize("base", INDEXES, ids=os.path.relpath)
def test_read_ebwt_arrays_equal(base):
    j, t = j_io.read_ebwt(base), t_io.read_ebwt(base)
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    # the escaped ftab entries of a .ebwtl index resolve as those of the
    # .ebwt index of the same genome (the reference package misreads the
    # 64-bit escapes: ROADMAP, queue 3)
    j32 = j_io.read_ebwt(base.replace("small_index_l", "small_index"))
    for a, b in zip(j32.ftab_resolved(), t.ftab_resolved()):
        np.testing.assert_array_equal(a, b)


def test_bitpair_reference_equal():
    j = j_io.unpack_reference(*j_io.read_bitpair_reference(GOLD))
    t = t_io.unpack_reference(*t_io.read_bitpair_reference(GOLD))
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def _random_reads(cls, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ln = int(rng.integers(0, 60))
        seq = bytes(rng.choice(list(b"ACGTN"), size=ln).tolist())
        qual = bytes(rng.integers(33, 127, size=ln).tolist())
        out.append(cls(name=b"read%d/%d" % (i, rng.integers(1000)),
                       seq=seq, qual=qual))
    return out


def test_next_u32_equal():
    state = np.random.default_rng(5).integers(0, 2**32, size=4096,
                                              dtype=np.uint64)
    state = state.astype(np.uint32)
    for _ in range(4):
        js, jv = j_rng.next_u32(state)
        ts, tv = t_rng.next_u32(state)
        np.testing.assert_array_equal(js, ts)
        np.testing.assert_array_equal(jv, tv)
        state = js
    jb, tb = j_rng.BtRandom(77), t_rng.BtRandom(77)
    assert [jb.next_u32() for _ in range(50)] == \
        [tb.next_u32() for _ in range(50)]


@pytest.mark.parametrize("global_seed", [0, 1, 12345])
def test_gen_rand_seed_equal(global_seed):
    jr, tr = _random_reads(JRead, 300, 3), _random_reads(TRead, 300, 3)
    for a, b in zip(jr, tr):
        assert j_rng.gen_rand_seed(a.codes_fw, a.qual, a.name,
                                   global_seed) == \
            t_rng.gen_rand_seed(b.codes_fw, b.qual, b.name, global_seed)
    np.testing.assert_array_equal(j_rng.fill_seed_caches(jr, global_seed),
                                  t_rng.fill_seed_caches(tr, global_seed))
    assert [int(r.seed(global_seed)) for r in jr] == \
        [int(r.seed(global_seed)) for r in tr]


EXTS = [".1.ebwt", ".2.ebwt", ".3.ebwt", ".4.ebwt",
        ".rev.1.ebwt", ".rev.2.ebwt"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    from bowtie_tpu_torch.build.builder import build_from_fasta
    base = str(tmp_path_factory.mktemp("torch_idx") / "small")
    build_from_fasta([FASTA], base, off_rate=5, ftab_chars=7)
    return base


@pytest.mark.parametrize("ext", EXTS)
def test_builder_byte_identical(built, ext):
    with open(built + ext, "rb") as f, open(GOLD + ext, "rb") as g:
        assert f.read() == g.read()


def _port_files():
    pkg = os.path.join(REPO, "bowtie_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for tool in ("", "-build", "-inspect"):
        yield os.path.join(REPO, "bin", "bowtie-tpu-torch" + tool)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = list(_port_files())
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"bowtie_tpu_torch/align/pe_device.py",
            "bowtie_tpu_torch/align/best_paired.py",
            "bowtie_tpu_torch/build/sa.py",
            "bowtie_tpu_torch/build/blockwise.py",
            "bowtie_tpu_torch/build/inspect.py",
            "bowtie_tpu_torch/cli/build.py",
            "bowtie_tpu_torch/cli/inspect.py",
            "bin/bowtie-tpu-torch-build",
            "bin/bowtie-tpu-torch-inspect",
            "bowtie_tpu_torch/parallel/__init__.py",
            "bowtie_tpu_torch/parallel/mesh.py",
            "bowtie_tpu_torch/parallel/dfs_mesh.py",
            "bowtie_tpu_torch/parallel/launch.py"} <= names
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "bowtie_tpu"}, path


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from bowtie_tpu_torch.cli import align as cli
    from bowtie_tpu_torch.index.arrays import from_ebwt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = t_io.read_ebwt(GOLD)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_ebwt(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-v", "0", GOLD, "-c", "ACGTACGTAC"])
    assert from_ebwt(idx, device="cpu").device.type == "cpu"
    from bowtie_tpu_torch.parallel import dfs_mesh, launch, mesh
    for make in (mesh.make_mesh, dfs_mesh.make_dp_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--coordinator", "localhost:1", "--num-hosts", "1",
                     "--host-id", "0", "--", "-v", "0", GOLD, "x.fq",
                     "x.out"])


def test_wrappers_refuse_mixed_devices():
    from bowtie_tpu_torch.align.exact import exact_ranges, resolve_rows
    from bowtie_tpu_torch.index.arrays import from_ebwt
    fm = from_ebwt(t_io.read_ebwt(GOLD), device="cpu")
    reads = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        exact_ranges(fm, reads, lens)
    with pytest.raises(ValueError, match="devices"):
        resolve_rows(fm, torch.empty(2, dtype=torch.int64, device="meta"))


def test_launcher_reports_unported_mode():
    """Paired input is ported: the launcher takes it, and without a card
    it stops naming CUDA, never falling back to the CPU."""
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "bowtie-tpu-torch"),
         "-v", "3", "--interleaved", "x.fq", "-x", GOLD],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "not yet ported" not in proc.stderr
    assert "CUDA" in proc.stderr


# (test id, flags, the input they read): the flag sets that were refused
# while paired input was not ported, each now held to the JAX CLI on paired
# fixtures drawn from the small index's genome: -1/-2 files (PE), a --12
# file (TAB) and an --interleaved file (IL)
PE = ["-1", "M1", "-2", "M2"]
UNPORTED = [
    ("-n", ["-n", "2", "--best"] + PE),
    ("-v 1", ["-v", "1", "--best", "--12", "TAB"]),
    ("-v 2", ["-v", "2", "-M", "1", "--interleaved", "IL"]),
    ("-v 3", ["-v", "3"] + PE),
    ("--best", ["-v", "0", "--best"] + PE),
    ("-M", ["-v", "0", "-M", "1"] + PE),
    ("paired-end input", ["-v", "0"] + PE),
    ("--sanity", ["-n", "2", "--sanity", "-M", "1"] + PE),
    ("--stats", ["-v", "3", "--stats", "--12", "TAB"]),
    ("-v 2 --strata", ["-v", "2", "--best", "--strata", "-a"] + PE),
]


@pytest.fixture(scope="module")
def pe_inputs(tmp_path_factory):
    """40 seeded pairs from the small index's genome (fragments of 80-220
    bases, mates of 20-36 bases with 0-2 mismatches, every 7th pair with a
    random mate) as -1/-2 FASTQ files, a --12 file with three unpaired
    records among them, and an interleaved FASTQ file."""
    from bowtie_tpu_torch.utils.alphabet import codes_to_seq
    d = tmp_path_factory.mktemp("torch_host_pe")
    recs, packed = t_io.read_bitpair_reference(GOLD)
    refs = t_io.unpack_reference(recs, packed,
                                 plen=t_io.read_ebwt(GOLD).plen)
    rng = np.random.default_rng(21)
    m1s, m2s, tab, il = [], [], [], []
    for k in range(40):
        ref = refs[k % len(refs)]
        frag = int(rng.integers(80, min(221, len(ref))))
        p = int(rng.integers(0, len(ref) - frag + 1))
        ln1, ln2 = (int(x) for x in rng.integers(20, 37, 2))
        a = np.minimum(ref[p:p + ln1], 3).astype(np.uint8)
        b = (3 - np.minimum(ref[p + frag - ln2:p + frag], 3)[::-1]
             ).astype(np.uint8)
        if k % 7 == 3:
            b = rng.integers(0, 4, ln2).astype(np.uint8)
        for q in (a, b):
            for _ in range(k % 3):
                q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        s1, s2 = codes_to_seq(a), codes_to_seq(b)
        q1 = "".join(chr(33 + int(x)) for x in rng.integers(5, 41, ln1))
        q2 = "".join(chr(33 + int(x)) for x in rng.integers(5, 41, ln2))
        m1s.append(f"@q{k}/1\n{s1}\n+\n{q1}\n")
        m2s.append(f"@q{k}/2\n{s2}\n+\n{q2}\n")
        il += [m1s[-1], m2s[-1]]
        tab.append(f"q{k}\t{s1}\t{q1}\t{s2}\t{q2}\n")
        if k % 13 == 5:
            tab.append(f"solo{k}\t{s1}\t{q1}\n")
    files = {}
    for key, lines in (("M1", m1s), ("M2", m2s), ("TAB", tab), ("IL", il)):
        (d / key).write_text("".join(lines))
        files[key] = str(d / key)
    return files


@pytest.mark.parametrize("case,args", UNPORTED,
                         ids=[c for c, _ in UNPORTED])
def test_unported_modes_exit_1(case, args, pe_inputs, tmp_path, monkeypatch):
    """Each flag set that was refused while paired input was not ported
    now runs, and its hits and summary equal the JAX CLI's (its host
    engines, which are what it picks on a CPU backend) byte for byte."""
    import contextlib
    import io
    from bowtie_tpu.cli import align as jcli
    from bowtie_tpu_torch.cli import align as tcli
    argv = [pe_inputs.get(a, a) for a in args]
    outs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, {"device": "cpu"})):
        if name == "jax":
            monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
        else:
            monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE", raising=False)
        out = str(tmp_path / name)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(argv + [GOLD, out], **kw)
        assert rc in (0, None), (name, err.getvalue())
        summary = [ln for ln in err.getvalue().splitlines()
                   if ln.startswith(("# ", "Reported ", "No alignments"))]
        outs[name] = (open(out, "rb").read(), summary)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0]                   # pairs were reported


def _fastq_variants(tmp_path):
    """FASTQ files the native parser reads: plain, CRLF, '+name' lines and
    reads longer than the reference's 1,024-base cap; and one whose
    quality line is short, where the native parser stops early."""
    rng = np.random.default_rng(4)
    recs = []
    for i in range(300):
        ln = int(rng.integers(1, 60)) if i % 50 else 1500
        seq = "".join(rng.choice(list("ACGTN"), ln))
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
        recs.append((f"r{i} desc {i}", seq, qual))
    plain = "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in recs)
    files = {
        "plain": plain,
        "crlf": plain.replace("\n", "\r\n"),
        "plus_name": "".join(f"@{n}\n{s}\n+{n}\n{q}\n" for n, s, q in recs),
        "blank_lines": "\n".join(f"@{n}\n{s}\n+\n{q}\n"
                                 for n, s, q in recs),
        "short_qual": plain + "@bad\nACGT\n+\nII\n",
    }
    for k, text in files.items():
        (tmp_path / f"{k}.fq").write_text(text)
    return {k: str(tmp_path / f"{k}.fq") for k in files}


def test_native_fastq_matches_python(tmp_path):
    from bowtie_tpu_torch.io import readers
    from bowtie_tpu_torch.native.fastq_native import parse_fastq_bytes
    for name, path in _fastq_variants(tmp_path).items():
        native = list(readers.parse_fastq(path))
        python = list(readers.parse_fastq(path, use_native=False))
        assert native == python, name
        assert len(native) >= 300
        with open(path, "rb") as f:
            res = parse_fastq_bytes(f.read())
        assert (res is None) == (name == "short_qual"), name
        if res is not None:
            assert list(zip(*res)) == native


def test_native_reader_matches_jax(tmp_path):
    """ReadSource with the native parser (the port's default) gives the
    reference's records, quality conversion included."""
    from bowtie_tpu.io.readers import ReadSource as JSource
    from bowtie_tpu_torch.io.readers import ReadSource as TSource
    for name, path in _fastq_variants(tmp_path).items():
        for kw in ({}, {"phred64": True}, {"trim5": 2, "upto": 120}):
            j = [(r.name, r.seq, r.qual) for r in JSource([path], **kw)
                 .records()]
            t = [(r.name, r.seq, r.qual) for r in TSource([path], **kw)
                 .records()]
            assert j == t, (name, kw)


def test_fastio_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; nothing falls back to the pure-Python
    parser behind it."""
    import subprocess
    from bowtie_tpu_torch.native import build
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_cached", {})
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.
                        CompletedProcess(a, 1, "", "g++: not found"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.load_fastio()


def test_aligner_metrics_match_jax(capsys):
    from bowtie_tpu.align.policy import ReadResult as JRes
    from bowtie_tpu.align.types import Hit as JHit
    from bowtie_tpu.utils.metrics import AlignerMetrics as JMetrics
    from bowtie_tpu_torch.align.policy import ReadResult as TRes
    from bowtie_tpu_torch.align.types import Hit as THit
    from bowtie_tpu_torch.utils.metrics import AlignerMetrics as TMetrics
    outs = []
    for Metrics, Read, Hit, Res in ((JMetrics, JRead, JHit, JRes),
                                    (TMetrics, TRead, THit, TRes)):
        m = Metrics()
        for i, r in enumerate(_random_reads(Read, 200, 8)):
            m.next_read(r.codes_fw)
            hits = [Hit(read=r, fw=True, tidx=0, toff=j, oms=0,
                        stratum=(i + j) % 3) for j in range(i % 4)]
            m.record_result(Res(hits, maxed=i % 7 == 3))
        m.t0 = 0.0
        m.print(fallbacks=i % 5 if Metrics is TMetrics else 4)
        m.print()
        outs.append(capsys.readouterr().err)
    for o in outs:
        assert "stratum 2:" in o and "fallbacks: 4" in o
    mask = [re.sub(r"wall time: .*", "", o) for o in outs]
    assert mask[0] == mask[1]
