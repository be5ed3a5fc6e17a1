"""K13 (csrc/ilv.cu ilv_kernel, a warp per pair) on the CPU:

- its launch shape (align/pe_ilv_device.py ilv_shape) for a range of
  pair counts and query widths, B = 0 included, what a window's scan
  stages (ilv_window) up to the widest window (-X 2048), and the shapes
  they refuse;
- the wrapper's refusals (check_inputs) and its CPU path, which is
  run_ilv_plain unchanged and launches nothing;
- the kernel source itself, built with g++ against
  tests/cuda_stub/cuda_runtime.h (a block's threads as fibers, a
  barrier for __syncthreads and __syncwarp, __ballot_sync and
  __shfl_sync through a per-warp exchange array; launches rewritten to
  emu_launch), its shared memory poisoned before each block: every output
  and each pair's iterations equal to run_ilv_plain's on up to 48 pairs of
  a seeded two-reference genome with a tandem repeat (several valid
  rescue candidates in one pass), segment copies and a run of Ns, dense
  and walk-left, seeded and -v 2 scoring, at -X 250 (each side of a
  window in one piece) and -X 1000 (staged in pieces), and on 1, 5 and
  33 pairs (a block's warps partly used).  Skipped only without g++.
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
from bowtie_tpu_torch.align import pe_ilv_device as ilv
from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
from bowtie_tpu_torch.align.policy import KPolicy
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)
from bowtie_tpu_torch.io.readers import PairedReadSource
from bowtie_tpu_torch.utils.rng import fill_seed_caches

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "bowtie_tpu_torch", "csrc")
STUB = os.path.join(HERE, "cuda_stub")
N_PAIRS = 48
HARNESS = """#include "ilv_emu.cu"
alignas(16) unsigned char bt_ilv_smem[1 << 16];
static const int poison_ = (emu_block_start = [] {
    std::memset(bt_ilv_smem, 0xA5, sizeof bt_ilv_smem); }, 0);
"""


# ---------------------------------------------------------------- shape

@pytest.mark.parametrize("B", [0, 1, 3, 4, 5, 31, 33, 133, 8192])
def test_ilv_shape_blocks(B):
    """Pairs a block, blocks and shared bytes for every pair count: a
    block of ILV_WARPS warps holds ILV_WARPS pairs, each with its warp's
    buffers behind the arguments' copy."""
    s = ilv.ilv_shape(B, 64)
    per = ilv.ILV_WARPS
    assert s["threads"] == ilv.ILV_WARPS * 32
    assert s["pairs_a_block"] == per
    assert s["blocks"] == -(-B // per)
    assert (s["blocks"] - 1) * per < B <= s["blocks"] * per or B == 0
    assert s["dynamic_shared"] == (
        -(-ctypes.sizeof(ilv.IlvArgs) // 16) * 16 + per * ilv.ILV_WARP_BYTES)
    assert s["dynamic_shared"] <= 48 * 1024     # no opt-in needed


@pytest.mark.parametrize("maxins,Lq,pieces", [
    (0, 40, False), (250, 40, False), (250, 64, False), (300, 64, False),
    (450, 64, True), (1000, 64, True), (2048, 40, True), (2048, 64, True)])
def test_ilv_shape_windows(maxins, Lq, pieces):
    """A window's bytes a side and whether they are staged in pieces,
    for IlvStatic.SPAN as the aligner sizes it, up to the widest insert
    K13 takes; no window is refused."""
    span = ((maxins + Lq + 2 + 63) // 64) * 64
    w = ilv.ilv_window(span, Lq)
    assert w["side_bytes"] == (span - Lq + 1) // 2 + Lq
    assert w["in_pieces"] is pieces
    assert ilv.ilv_shape(8192, Lq)["blocks"] > 0


@pytest.mark.parametrize("kw", [dict(Lq=0), dict(Lq=65), dict(B=-1),
                                dict(B=1 << 31)],
                         ids=["lq0", "lq65", "b_negative", "b_2_31"])
def test_ilv_shape_refuses(kw):
    args = dict(B=64, Lq=40)
    args.update(kw)
    with pytest.raises(ValueError):
        ilv.ilv_shape(**args)


def test_ilv_window_refuses():
    with pytest.raises(ValueError):
        ilv.ilv_window(39, 40)


# ---------------------------------------------------------------- inputs

COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def _genome(rng):
    """Two references: 14 kb with an 11-base unit repeated 50 times at
    6,000 and a 400-base segment at 2,000 and 9,000; 9 kb with the segment
    at 3,000 and a run of 20 Ns at 7,000."""
    seg = rng.integers(0, 4, 400).astype(np.uint8)
    a = rng.integers(0, 4, 14_000).astype(np.uint8)
    a[6000:6550] = np.tile(rng.integers(0, 4, 11).astype(np.uint8), 50)
    a[2000:2400] = seg
    a[9000:9400] = seg
    b = rng.integers(0, 4, 9_000).astype(np.uint8)
    b[3000:3400] = seg
    b[7000:7020] = 4
    return [a, b]


def _write_pairs(refs, n, seed, frag, path):
    """n seeded --fr pairs: fragments of frag[0]-frag[1] bases (every
    fifth starting in the tandem repeat, every eighth with mate 2 ending
    1-3 bases into the run of Ns, read there as T), mates of 30-50 bases
    with 0-2 mismatches, every sixth pair with a random mate, every
    seventh mate 2 with an N; Phred 5-40."""
    rng = np.random.default_rng(seed)
    f1, f2 = [], []
    for k in range(n):
        r = refs[k % 2]
        f = int(rng.integers(frag[0], frag[1] + 1))
        l1, l2 = (int(x) for x in rng.integers(30, 51, 2))
        if k % 5 == 0 and k % 2 == 0:
            p = int(rng.integers(5900, 6300))
        elif k % 8 == 7:
            # mate 2 ends 1-3 bases into the run of Ns
            p = 7000 + int(rng.integers(1, 4)) - f
        else:
            p = int(rng.integers(0, len(r) - f))
        m1 = np.minimum(r[p:p + l1], 3).copy()
        m2 = COMP[np.minimum(r[p + f - l2:p + f], 3)[::-1]].copy()
        if k % 6 == 5:
            m2 = rng.integers(0, 4, l2).astype(np.uint8)
        for q in (m1, m2):
            for _ in range(k % 3):
                q[int(rng.integers(len(q)))] = rng.integers(0, 4)
        if k % 7 == 3:
            m2[int(rng.integers(len(m2)))] = 4
        for lst, q, m in ((f1, m1, 1), (f2, m2, 2)):
            qual = "".join(chr(33 + int(x))
                           for x in rng.integers(5, 41, len(q)))
            lst.append(f"@p{k}/{m}\n{''.join('ACGTN'[c] for c in q)}\n+\n"
                       f"{qual}\n")
    p1, p2 = path / "m1.fq", path / "m2.fq"
    p1.write_text("".join(f1))
    p2.write_text("".join(f2))
    return list(PairedReadSource([str(p1)], [str(p2)]).pairs())


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("ilv_index")
    base = str(d / "g")
    build_index(_genome(np.random.default_rng(5)), ["a", "b"], base,
                off_rate=4, ftab_chars=6)
    idx, idx_bw = read_ebwt(base), read_ebwt(base + ".rev")
    refs = unpack_reference(*read_bitpair_reference(base), plen=idx.plen)
    return idx, idx_bw, refs, d


# case -> (dense, -X, fragments, aligner keyword arguments)
CASES = {"dense": (True, 250, (60, 240), {}),
         "wide": (True, 1000, (60, 900), {}),
         "v2": (True, 250, (60, 240), dict(mode="v", v=2)),
         "walk": (False, 250, (60, 240), {})}
_INPUTS = {}


def _inputs(index, case):
    """K13's inputs for a case as the aligner builds them for round 1
    (rec_cap 1 after phase 0), on the CPU; cached per case."""
    if case not in _INPUTS:
        idx, idx_bw, refs, d = index
        dense, maxins, frag, kw = CASES[case]
        if not dense:
            idx, idx_bw = (idx.with_off_rate(idx.off_rate + 9),
                           idx_bw.with_off_rate(idx_bw.off_rate + 9))
        al = DevicePairedBestAligner(idx, idx_bw, refs, KPolicy(),
                                     compact=not dense, device="cpu",
                                     max_insert=maxins, **kw)
        (d / case).mkdir(exist_ok=True)
        pairs = _write_pairs(refs, N_PAIRS, 11 + len(case), frag, d / case)
        idxs = list(range(len(pairs)))
        s1 = fill_seed_caches([p[0] for p in pairs], 0)
        sts, ovd = al._record_all(al.plan(pairs), idxs, s1, 1)
        items = [(i, sts[i]) for i in idxs if not ovd[i]]
        S, st, lanes, host = al.ilv_inputs(pairs, items, s1)
        assert lanes and not host
        _INPUTS[case] = (al.pair, S, st)
    return _INPUTS[case]


def first_pairs(st, n):
    """init_state's lane state of the first n pairs of st."""
    s = {k: st[k][:n].contiguous() for k in ilv.LANE_KEYS + ("rng",)}
    consts = {k: s[k] for k in ilv.LANE_KEYS[3:]}
    consts.update({k: st[k] for k in ilv.GLOBAL_KEYS})
    return ilv.init_state(n, s["hits"], s["nrec"], s["capped"], s["rng"],
                          consts)


def _plain(pair, S, st):
    """run_ilv_plain on a copy of st: (outputs, iterations, final state)."""
    fin = {k: v.clone() for k, v in st.items()}
    out, it = ilv.run_ilv_plain(pair, fin, S)
    return out, it, fin


# ---------------------------------------------------------------- wrapper

def test_run_ilv_on_cpu_is_the_plain_version(index):
    """CPU tensors take run_ilv_plain: the same outputs and iterations,
    and no launch."""
    pair, S, st = _inputs(index, "dense")
    kernels.reset_launches()
    out, it = ilv.run_ilv(pair, {k: v.clone() for k, v in st.items()}, S)
    pout, pit, _ = _plain(pair, S, st)
    assert kernels.LAUNCHES["pe_ilv"] == 0
    for k in ilv.OUT_KEYS:
        assert torch.equal(out[k], pout[k]), k
    assert torch.equal(it, pit)
    assert int(pout["res_found"].sum()) > 0


@pytest.mark.parametrize("bad", ["hits_dtype", "q_width", "efw_len",
                                 "dense", "seeds_dtype", "lanes"])
def test_check_inputs_refuses(index, bad):
    """The wrapper raises on inputs the kernel cannot read as they are
    (before any launch)."""
    pair, S, st = _inputs(index, "dense")
    st = dict(st)
    if bad == "hits_dtype":
        st["hits"] = st["hits"].long()
    elif bad == "q_width":
        st["q_c"] = torch.zeros((st["q_c"].shape[0], 4, S.Lq + 8),
                                dtype=torch.uint8)
    elif bad == "efw_len":
        st["efw_tab"] = st["efw_tab"][:-1].contiguous()
    elif bad == "dense":
        S = dataclasses.replace(S, dense=not S.dense)
    elif bad == "seeds_dtype":
        st["rng"] = st["rng"].int()
    else:
        st["minins"] = st["minins"][1:].contiguous()
    ilv.check_inputs(pair, _inputs(index, "dense")[2], _inputs(
        index, "dense")[1])
    with pytest.raises((ValueError, TypeError)):
        ilv.check_inputs(pair, st, S)


# ---------------------------------------------------------------- the kernel

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/ilv.cu built with g++ against the stub header, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/ilv.cu against the CUDA stub")
    d = tmp_path_factory.mktemp("ilv_emu")
    with open(os.path.join(CSRC, "ilv.cu")) as f:
        src = f.read()
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\1, \2, \3);", src, flags=re.S)
    assert n == 1
    (d / "ilv_emu.cu").write_text(src)
    shutil.copy(os.path.join(CSRC, "fm.cuh"), d / "fm.cuh")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libilv_emu.so"
    # -Wno-maybe-uninitialized: g++ cannot follow that a lane's field is
    # read only in a mode whose entry wrote it (the chase's and the scan's
    # fields, the delayed and pending ranges)
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-Wno-unused-function", "-Wno-maybe-uninitialized",
                    "-I", STUB, "-I", str(d),
                    "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bt_pe_ilv.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _aligned(t, align=32):
    """A copy of t at an `align`-byte boundary (fm_view's)."""
    buf = torch.empty(t.numel() + align, dtype=t.dtype)
    off = (-buf.data_ptr() % align) // t.element_size()
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _emulate(lib, pair, S, st):
    """K13 through the emulated C entry: (outputs [13, B] int64, the
    FM pair whose arrays the kernel read, kept alive with them)."""
    fms = {k: dataclasses.replace(getattr(pair, k),
                                  bwt=_aligned(getattr(pair, k).bwt),
                                  occ=_aligned(getattr(pair, k).occ),
                                  kernel_view=None) for k in ("fw", "bw")}
    pair = dataclasses.replace(pair, **fms)
    ilv.check_inputs(pair, st, S)
    B = st["hits"].shape[0]
    ilv.ilv_shape(B, S.Lq)
    out = torch.full((len(ilv.OUT_KEYS) + 1, B), -7, dtype=torch.int64)
    a = ilv.ilv_args(pair, st, S, out)
    assert lib.bt_pe_ilv(ctypes.byref(a), None) == 0
    return out, pair


def test_emulated_shape_agrees(emulated):
    """The C source's launch constants are ilv_shape's."""
    assert emulated.bt_ilv_warps() == ilv.ILV_WARPS
    assert emulated.bt_ilv_piece() == ilv.ILV_PIECE
    assert emulated.bt_ilv_max_lq() == ilv.ILV_MAX_LQ
    assert emulated.bt_ilv_warp_bytes() == ilv.ILV_WARP_BYTES
    assert emulated.bt_ilv_args_bytes() == -(
        -ctypes.sizeof(ilv.IlvArgs) // 16) * 16


def _hold(out, pout, pit):
    for i, k in enumerate(ilv.OUT_KEYS):
        assert torch.equal(out[i], pout[k]), k
    assert torch.equal(out[-1], pit)


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_matches_plain(emulated, index, case):
    """csrc/ilv.cu run on the CPU equals run_ilv_plain on every output
    and each pair's iterations."""
    pair, S, st = _inputs(index, case)
    pout, pit, fin = _plain(pair, S, st)
    out, _keep = _emulate(emulated, pair, S, st)
    _hold(out, pout, pit)
    found = pout["res_found"] > 0
    assert int(found.sum()) > 0
    if case == "walk":
        assert not S.dense and int((pout["mode"] != ilv.I_DONE).sum()) > 0
    if case == "wide":
        # some pair's mate lies beyond the first piece of its side: the
        # scan restaged it
        qlen = fin["qlen_c"].gather(1, fin["sc_combo"][:, None])[:, 0]
        sol = fin["sol_c"].gather(1, fin["sc_combo"][:, None])[:, 0] > 0
        qb = torch.where(sol, fin["sc_begin"], fin["sc_begin"] + qlen)
        qe = torch.where(sol, fin["sc_end"] - qlen, fin["sc_end"])
        half = qb + ((qe - qb) >> 1)
        ri = torch.where(sol, pout["res_left"], pout["res_left"] + qlen)
        assert S.SPAN > 2 * ilv.ILV_PIECE
        assert int((ri - half).abs()[found].max()) > ilv.ILV_PIECE


@pytest.mark.parametrize("n", [1, 5, 33])
def test_emulated_partial_blocks(emulated, index, n):
    """The first n pairs alone, so that the last block's warps are
    partly used (one pair; two blocks, one pair in the second; nine
    blocks): equal to run_ilv_plain."""
    pair, S, st = _inputs(index, "dense")
    st = first_pairs(st, n)
    pout, pit, _ = _plain(pair, S, st)
    out, _keep = _emulate(emulated, pair, S, st)
    assert out.shape[1] == n
    _hold(out, pout, pit)
