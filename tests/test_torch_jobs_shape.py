"""K6 and K9 (csrc/jobs.cu derive_rows_kernel, a warp per (lane, job) row,
and derive_b_jobs_kernel, a warp per lane) on the CPU:

- their launch shapes (dfs_device.derive_rows_shape,
  n_device.derive_b_jobs_shape) and the J that K9 refuses;
- the wrappers' CPU paths, which are the plain versions and launch
  nothing;
- the kernel source itself, built with g++ against
  tests/cuda_stub/cuda_runtime.h (a block's threads as fibers,
  __ballot_sync and __shfl_sync through a per-warp exchange array;
  launches rewritten to emu_launch), its shared memory poisoned before
  each block and its outputs before each call: every byte of both outputs
  equal to derive_rows_plain's and derive_b_jobs_plain's on seeded tables.
  K6 at L 40, 64 and 128, reads shorter than L and as long, N runs across
  a 32-position chunk boundary, more than three Ns, all three seed
  mutations (one of them onto an N, some to N), ftabChars at and past the
  query length, fw/ebwt_fw in all four combinations, invalid rows.  K9
  with 0, 1, 31, 32 and more partials, n 0-3, --norc and --nofw, a J
  smaller than the partials + 2 (rows dropped) and a J whose lane tables
  are not 16-byte multiples, an output not 16-byte aligned, overflowed,
  unfinished, hit and gated lanes, on 1, 5 and 33 lanes (a block partly
  used).  Skipped only without g++.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bowtie_tpu_torch import kernels
from bowtie_tpu_torch.align import dfs_device as dfs
from bowtie_tpu_torch.align import n_device as nd
from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "bowtie_tpu_torch", "csrc")
STUB = os.path.join(HERE, "cuda_stub")
SMEM_WORDS = nd.MAX_SHARED // 4
HARNESS = f"""#include "jobs_emu.cu"
alignas(16) int32_t bt_jobs_smem[{SMEM_WORDS}];
static const int poison_ = (emu_block_start = [] {{
    std::memset(bt_jobs_smem, 0xA5, sizeof bt_jobs_smem); }}, 0);
"""
F = dfs._FIDX
POISON = 0x5B


# ---------------------------------------------------------------- shape

@pytest.mark.parametrize("B,J", [(0, 36), (1, 1), (5, 36), (33, 36),
                                 (8192, 36), (8192, 12)])
def test_derive_rows_shape(B, J):
    """A warp a row, ROWS_A_WARP rows a warp, ROW_WARPS warps a block,
    enough blocks for B * J rows."""
    s = dfs.derive_rows_shape(B, J)
    per = dfs.ROW_WARPS * dfs.ROWS_A_WARP
    assert s["threads"] == 32 * dfs.ROW_WARPS
    assert s["rows_a_warp"] == dfs.ROWS_A_WARP
    assert s["rows_a_block"] == per
    assert (s["blocks"] - 1) * per < B * J <= s["blocks"] * per or B * J == 0


@pytest.mark.parametrize("B,J", [(0, 36), (1, 36), (5, 5), (33, 36),
                                 (8192, 36), (8192, 105)])
def test_derive_b_jobs_shape(B, J):
    """A warp a lane, LANE_WARPS lanes a block, each lane's table padded
    to whole 16 bytes with room to shift it by 3 words; J_B fits with no
    opt-in."""
    s = nd.derive_b_jobs_shape(B, J)
    assert s["threads"] == 32 * nd.LANE_WARPS
    assert s["lanes_a_block"] == nd.LANE_WARPS
    assert s["blocks"] == -(-B // nd.LANE_WARPS)
    stride = s["dynamic_shared"] // (4 * nd.LANE_WARPS)
    assert stride % 4 == 0 and J * dfs.NJF + 3 <= stride < J * dfs.NJF + 7
    assert s["dynamic_shared"] <= nd.MAX_SHARED
    if J == nd.J_B:
        assert s["dynamic_shared"] == 16768


@pytest.mark.parametrize("B,J", [(8, 0), (8, 106), (8, 400), (-1, 36),
                                 (1 << 31, 36)])
def test_derive_b_jobs_shape_refuses(B, J):
    with pytest.raises(ValueError):
        nd.derive_b_jobs_shape(B, J)


# ---------------------------------------------------------------- inputs

def rows_inputs(seed, B, J, L):
    """A seeded K6 table [B, J, NJF] and base arrays [B, L]: read lengths
    from 1 to L (every fourth L), codes with 4 % Ns and, on every third
    lane, a run of Ns around position 32 (and 64); Phred values -8..60;
    query lengths up to the read's and past it; random fw/ebwt_fw, setOffs
    offsets, Maq rounding, validity; 0-3 seed mutations at distinct
    positions of the query, their codes 0-4, every fifth row's first
    mutation onto an N of its by-depth row."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(1, L + 1, B).astype(np.int32)
    plen[::4] = L
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.04] = 4
    for b in range(0, B, 3):
        for c in range(32, L, 32):
            lo = c - int(rng.integers(1, 5))
            codes[b, lo:c + int(rng.integers(1, 5))] = 4
    qual = rng.integers(-8, 61, (B, L)).astype(np.int8)
    scal = rng.integers(-50, 1000, (B, J, dfs.NJF)).astype(np.int32)
    qs = np.minimum(plen[:, None] - rng.integers(0, 3, (B, J)), L)
    qs[rng.random((B, J)) < 0.1] = L
    qs = np.maximum(qs, 1)
    scal[..., F["qlen"]] = qs
    scal[..., F["valid"]] = rng.random((B, J)) < 0.9
    scal[..., F["fw"]] = rng.integers(0, 2, (B, J))
    scal[..., F["ebwt_fw"]] = rng.integers(0, 2, (B, J))
    for k in ("unrev", "rev1", "rev2", "rev3"):
        scal[..., F[k]] = rng.integers(0, qs + 1)
    scal[..., F["rev3"]][rng.random((B, J)) < 0.5] = L
    scal[..., F["maq_round"]] = rng.integers(0, 2, (B, J))
    scal[..., F["npremut"]] = rng.integers(0, 4, (B, J))
    for b in range(B):
        for j in range(J):
            pos = rng.permutation(int(qs[b, j]))[:3]
            for k in range(3):
                scal[b, j, F[f"premut_pos{k}"]] = (
                    pos[k] if k < len(pos) else 0)
            scal[b, j, [F[f"premut_refc{k}"] for k in range(3)]] = (
                rng.integers(0, 5, 3))
    t = [torch.from_numpy(x) for x in (scal, codes, qual, plen)]
    # every fifth row: the first mutation onto a by-depth N, if it has one
    _, qqp = dfs.derive_rows_plain(*t, 10)
    qd = qqp[..., :L].numpy()
    for b in range(B):
        for j in range(0, J, 5):
            d = np.nonzero(qd[b, j, :qs[b, j]] == 4)[0]
            if len(d):
                scal[b, j, F["npremut"]] = max(1, scal[b, j, F["npremut"]])
                scal[b, j, F["premut_pos0"]] = qs[b, j] - 1 - d[0]
                scal[b, j, F["premut_refc0"]] = rng.integers(0, 4)
    return [torch.from_numpy(x) for x in (scal, codes, qual, plen)]


def b_inputs(seed, B, L, jrc=3):
    """Seeded launch-A outputs for K9: npart 0-40 (lanes 0-4 at 0, 1, 31,
    32 and 40 when there are that many, each taking jobs), part_job jrc
    or another job, part_n 0-3, positions -2..L+5, codes 0-3; result,
    overflow, mode and gated each off the taking path on some lanes."""
    rng = np.random.default_rng(seed)
    P = dfs.P_MAX
    npart = rng.integers(0, 41, B).astype(np.int32)
    npart[:5] = [0, 1, 31, 32, 40][:min(B, 5)]
    out_a = {
        "result": np.where(rng.random(B) < 0.15, 1, 0).astype(np.int32),
        "overflow": rng.random(B) < 0.1,
        "mode": np.where(rng.random(B) < 0.1, dfs.M_ADV,
                         dfs.M_DONE).astype(np.int32),
        "npart": npart,
        "part_job": np.where(rng.random((B, P)) < 0.5, jrc,
                             rng.integers(0, 9, (B, P))).astype(np.int32),
        "part_n": rng.integers(0, 4, (B, P)).astype(np.int32),
        "part_pos": rng.integers(-2, L + 6, (B, 3 * P)).astype(np.int32),
        "part_refc": rng.integers(0, 4, (B, 3 * P)).astype(np.int32)}
    out_a["result"][:5] = 0
    out_a["overflow"][:5] = False
    out_a["mode"][:5] = dfs.M_DONE
    gated = rng.random(B) < 0.1
    gated[:5] = False
    qual = rng.integers(-8, 61, (B, L)).astype(np.int8)
    plen = rng.integers(4, L + 1, B).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in out_a.items()}
    return (t, torch.from_numpy(gated), torch.from_numpy(qual),
            torch.from_numpy(plen),
            torch.from_numpy(QUAL_ROUNDS.astype(np.int32)))


# ---------------------------------------------------------------- wrapper

def test_wrappers_on_cpu_are_the_plain_versions():
    """CPU tensors take the plain versions: the same tables, no launch."""
    kernels.reset_launches()
    t = rows_inputs(1, 3, 4, 40)
    got, want = dfs.derive_rows(*t, 10), dfs.derive_rows_plain(*t, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = b_inputs(2, 6, 40)
    kw = dict(J=nd.J_B, jrc=3, n=2, s=28, qt=70, maxbts=125, maq=True,
              norc=False, nofw=False)
    assert torch.equal(nd.derive_b_jobs(*a, **kw),
                       nd.derive_b_jobs_plain(*a, **kw))
    assert kernels.LAUNCHES["derive_rows"] == 0
    assert kernels.LAUNCHES["derive_b_jobs"] == 0


# ---------------------------------------------------------------- the kernels

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/jobs.cu built with g++ against the stub header, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/jobs.cu against the CUDA stub")
    d = tmp_path_factory.mktemp("jobs_emu")
    with open(os.path.join(CSRC, "jobs.cu")) as f:
        src = f.read()
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\1, \2, \3);", src, flags=re.S)
    assert n == 2
    (d / "jobs_emu.cu").write_text(src)
    shutil.copy(os.path.join(CSRC, "dfs_layout.cuh"), d / "dfs_layout.cuh")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libjobs_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-Wno-unused-function", "-I", STUB, "-I", str(d),
                    "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bt_derive_rows.argtypes = [P] * 4 + [I] * 4 + [P] * 3
    lib.bt_derive_b_jobs.argtypes = [P] * 12 + [I] * 11 + [P, P]
    for name in ("bt_jobs_b_shared", "bt_jobs_local_bytes"):
        getattr(lib, name).argtypes = [I]
    return lib


def test_emulated_shape_agrees(emulated):
    """The C source's launch constants are the wrappers'."""
    assert emulated.bt_jobs_row_warps() == dfs.ROW_WARPS
    assert emulated.bt_jobs_rows_per_warp() == dfs.ROWS_A_WARP
    assert emulated.bt_jobs_lane_warps() == nd.LANE_WARPS
    assert emulated.bt_jobs_max_shared() == nd.MAX_SHARED
    for J in (1, 5, nd.J_B, 105):
        assert emulated.bt_jobs_b_shared(J) == nd.derive_b_jobs_shape(
            1, J)["dynamic_shared"]


def emu_rows(lib, scal, codes, qual, plen, fc):
    B, J, _ = scal.shape
    L = codes.shape[1]
    out = torch.full_like(scal, -POISON)
    qqp = torch.full((B, J, 3 * L), POISON, dtype=torch.int8)
    assert lib.bt_derive_rows(scal.data_ptr(), codes.data_ptr(),
                              qual.data_ptr(), plen.data_ptr(), B, J, L, fc,
                              out.data_ptr(), qqp.data_ptr(), None) == 0
    return out, qqp


@pytest.mark.parametrize("L,B,J,fc", [
    (40, 12, 24, 10), (40, 5, 7, 41), (64, 9, 16, 10), (64, 4, 9, 64),
    (128, 6, 12, 10), (128, 4, 8, 200), (256, 3, 11, 10), (42, 5, 9, 10),
    (512, 2, 7, 10)])
def test_emulated_derive_rows_matches_plain(emulated, L, B, J, fc):
    """K6 run on the CPU equals derive_rows_plain byte for byte (L 40 to
    512, 42 not a multiple of 4; row counts that leave a warp's and a
    block's last rows unused); the table covers what the N tally decides
    on."""
    scal, codes, qual, plen = rows_inputs(L * 7 + B, B, J, L)
    want = dfs.derive_rows_plain(scal, codes, qual, plen, fc)
    got = emu_rows(emulated, scal, codes, qual, plen, fc)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    # what the case exercises, read from the plain version's output
    s = scal.reshape(-1, dfs.NJF)
    qd = want[1].reshape(B * J, 3 * L)[:, :L].long()
    di = torch.arange(L)[None, :]
    isn = (qd == 4) & (di < s[:, F["qlen"]][:, None]) & (
        di < s[:, F["rev3"]][:, None])
    gate = want[0].reshape(-1, dfs.NJF)[:, F["ns_gate"]]
    assert int(gate.sum()) > 0
    assert int((gate == 0).sum()) > 0 or L > 256   # ~20 Ns a read there
    assert int((isn.sum(1) > 3).sum()) > 0
    if B * J > 40:
        assert int((isn[:, 31] & isn[:, 32]).sum()) > 0
    assert int((s[:, F["qlen"]] < plen.repeat_interleave(J)).sum()) > 0
    assert int((s[:, F["npremut"]] == 3).sum()) > 0
    combos = {(int(a), int(b)) for a, b in zip(s[:, F["fw"]],
                                               s[:, F["ebwt_fw"]])}
    assert combos == {(0, 0), (0, 1), (1, 0), (1, 1)}


def emu_b(lib, args, kw, B, J, L, offset=0):
    out_a, gated, qual, plen, qr = args
    buf = torch.full((B * J * dfs.NJF + offset,), -POISON, dtype=torch.int32)
    out = buf[offset:].view(B, J, dfs.NJF)
    assert lib.bt_derive_b_jobs(
        *(out_a[k].data_ptr() for k in nd._A_KEYS), gated.data_ptr(),
        qual.data_ptr(), plen.data_ptr(), qr.data_ptr(), B, L, J,
        kw["jrc"], kw["n"], kw["s"], kw["qt"], kw["maxbts"], int(kw["maq"]),
        int(kw["norc"]), int(kw["nofw"]), out.data_ptr(), None) == 0
    return out


B_CASES = {  # name: (B, J, n, seed length, maq, norc, nofw, word offset)
    "n2": (33, nd.J_B, 2, 28, True, False, False, 0),
    "n1": (33, nd.J_B, 1, 28, True, False, False, 0),
    "n3_nomaq": (33, nd.J_B, 3, 20, False, False, False, 0),
    "n0": (5, nd.J_B, 0, 28, True, False, False, 0),
    "norc": (33, nd.J_B, 2, 28, True, True, False, 0),
    "nofw": (33, nd.J_B, 3, 28, True, False, True, 0),
    "dropped_j5": (33, 5, 2, 28, True, False, False, 0),
    "dropped_j12_norc": (33, 12, 3, 28, True, True, False, 0),
    "unaligned_out": (5, nd.J_B, 2, 28, True, False, False, 1),
    "one_lane": (1, nd.J_B, 2, 28, True, False, False, 0),
    "five_lanes_j7": (5, 7, 2, 28, True, False, False, 3),
}


@pytest.mark.parametrize("case", list(B_CASES))
def test_emulated_derive_b_jobs_matches_plain(emulated, case):
    """K9 run on the CPU equals derive_b_jobs_plain on every word."""
    B, J, n, s, maq, norc, nofw, offset = B_CASES[case]
    L = 40
    args = b_inputs(B * 13 + J + n, B, L)
    kw = dict(J=J, jrc=3, n=n, s=s, qt=70, maxbts=125, maq=maq, norc=norc,
              nofw=nofw)
    want = nd.derive_b_jobs_plain(*args, **kw)
    got = emu_b(emulated, args, kw, B, J, L, offset)
    assert torch.equal(got, want)
    valid = want[..., F["valid"]]
    if n > 1:
        assert int(valid.sum()) > 0
    if B > 5:
        assert int((valid.sum(1) == 0).sum()) > 0   # lanes taking no jobs
        assert int((want[..., F["npremut"]] == 3).sum()) > 0 or n == 0


@pytest.mark.parametrize("L", [64, 128])
def test_emulated_derive_b_jobs_wide_rows(emulated, L):
    """K9 at L 64 and 128 (positions past L+3 clamp, qualities past L
    read 0), with -n 3 and a 20-base seed."""
    args = b_inputs(L, 9, L)
    kw = dict(J=nd.J_B, jrc=3, n=3, s=20, qt=70, maxbts=125, maq=True,
              norc=False, nofw=False)
    want = nd.derive_b_jobs_plain(*args, **kw)
    assert torch.equal(emu_b(emulated, args, kw, 9, nd.J_B, L), want)


def test_emulated_launch_b_rows(emulated):
    """K6 on K9's launch-B table (both emulated) equals the plain chain."""
    L, B = 40, 9
    args = b_inputs(7, B, L)
    out_a, gated, qual, plen, qr = args
    kw = dict(J=nd.J_B, jrc=3, n=2, s=28, qt=70, maxbts=125, maq=True,
              norc=False, nofw=False)
    scal_b = emu_b(emulated, args, kw, B, nd.J_B, L)
    codes = torch.from_numpy(np.random.default_rng(8).integers(
        0, 5, (B, L)).astype(np.int8))
    got = emu_rows(emulated, scal_b, codes, qual, plen, 10)
    want = dfs.derive_rows_plain(nd.derive_b_jobs_plain(*args, **kw), codes,
                                 qual, plen, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
