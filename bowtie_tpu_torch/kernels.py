"""Build, load and launch the hand-written CUDA kernels of csrc/.

The sources compile at first use, with nvcc for sm_90a (one nvcc per
source, all started together, then one link), into
``csrc/build/libbtkernels.so`` (listed in .gitignore), and load through
ctypes; each C entry point launches one kernel on the stream it is given
and returns ``cudaGetLastError()`` (``bt_sa_round`` launches the several
kernels of one K16 round and returns the first error).  The wrappers in
``align/`` and ``build/sa.py`` check their tensors, allocate outputs,
call ``launch`` and count launches in ``LAUNCHES``.  Nothing here runs at
import time: a CPU-only install can import every module.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_LIB = os.path.join(_BUILD_DIR, "libbtkernels.so")
SOURCES = ("exact.cu", "dfs.cu", "jobs.cu", "best.cu", "sa.cu", "ilv.cu")
HEADERS = ("fm.cuh", "lookback.cuh", "dfs_layout.cuh")

# kernel launches since the last reset_launches(), by wrapper
LAUNCHES = {"exact_ranges": 0, "exact_ranges_cat": 0,
            "resolve_rows_walk": 0, "resolve_rows_sa": 0, "one_row": 0,
            "bwt_rows_offsets": 0, "align_step": 0, "walk_table": 0,
            "derive_rows": 0,
            "dfs_machine": 0, "dfs_pack": 0, "derive_b_jobs": 0,
            "best_machine": 0, "best_record": 0, "best_pev2": 0,
            "best_pack": 0,
            "sa_round": 0, "pe_ilv": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into csrc/build/libbtkernels.so unless it is
    newer than every source; returns its path.  Each source compiles in
    its own nvcc process, all at once, and one more links them.  ptxas's
    register and spill report is kept in csrc/build/ptxas.txt."""
    srcs = [os.path.join(_CSRC, s) for s in SOURCES + HEADERS]
    if (not force and os.path.exists(_LIB) and os.path.getmtime(_LIB)
            >= max(os.path.getmtime(s) for s in srcs)):
        return _LIB
    os.makedirs(_BUILD_DIR, exist_ok=True)
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(_BUILD_DIR, f"{src}.{tag}.o")
        cmd = [_nvcc(), *arch, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", obj,
               os.path.join(_CSRC, src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        report.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    with open(os.path.join(_BUILD_DIR, "ptxas.txt"), "w") as f:
        f.write("".join(report))
    tmp = f"{_LIB}.{tag}"
    if not failed:
        cmd = [_nvcc(), *arch, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, _LIB)
    return _LIB


class FMView(ctypes.Structure):
    """Mirror of `struct BtFM` in csrc/fm.cuh (passed by pointer)."""
    _fields_ = [("bwt", ctypes.c_void_p), ("occ", ctypes.c_void_p),
                ("ftab_hi", ctypes.c_void_p), ("ftab_lo", ctypes.c_void_p),
                ("offs", ctypes.c_void_p), ("sa", ctypes.c_void_p),
                ("fchr", ctypes.c_uint32 * 5), ("zoff", ctypes.c_uint32),
                ("bwt_len", ctypes.c_uint32),
                ("ftab_chars", ctypes.c_int32), ("off_rate", ctypes.c_int32)]


_P = ctypes.c_void_p
_I32 = ctypes.c_int32


class DfsArgs(ctypes.Structure):
    """Mirror of `struct DfsArgs` in csrc/dfs.cu (passed by pointer)."""
    _fields_ = [("fw", FMView), ("bw", FMView), ("rstarts", _P),
                ("nfrag", _I32), ("length", ctypes.c_uint32),
                ("dense", _I32), ("scal", _P), ("qqp", _P), ("seeds", _P),
                ("count0", _P), ("B", _I32), ("J", _I32), ("L", _I32),
                ("n_k", _I32), ("m_max", _I32),
                ("max_transitions", ctypes.c_int64), ("pairs", _P),
                ("elims", _P)] + [(k, _P) for k in (
                    "result", "overflow", "count", "nhits", "hits", "npart",
                    "part_n", "part_job", "part_pos", "part_refc", "rng",
                    "mode", "steps")]


_FM = ctypes.POINTER(FMView)
_SIGNATURES = {
    # (fm, reads, lens, n, L, top, bot, stream)
    "bt_exact_ranges": [_FM, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    # (fw, bw, reads, lens, efw, n, L, top, bot, stream)
    "bt_exact_ranges_cat": [_FM, _FM, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            _P, _P, _P],
    # (fm, walk, rows, n, counter, off, ok, iters, stream)
    "bt_resolve_walk": [_FM, _P, _P, ctypes.c_int, _P, _P, _P, _P, _P],
    # (n, out[4]) -> K3 walk's launch shape
    "bt_walk_shape": [ctypes.c_int, _P],
    # (fm, rows, n, off, ok, stream)
    "bt_resolve_sa": [_FM, _P, ctypes.c_int, _P, _P, _P],
    # (bwt, occ, n, out, stream)
    "bt_walk_table": [_P, _P, ctypes.c_int, _P, _P],
    # (fm, walk, reads, lens, seeds, n, L, dense, out, stream)
    "bt_one_row": [_FM, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P, _P],
    # (fm, walk, reads, lens, n, L, dense, top, bot, off, ok, stream)
    "bt_align_step": [_FM, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P, _P, _P, _P, _P],
    # (args, onchip, stream)
    "bt_dfs_machine": [ctypes.POINTER(DfsArgs), ctypes.c_int, _P],
    # () -> K7's threads a block; () -> the widest on-chip L
    "bt_dfs_machine_threads": [],
    "bt_dfs_onchip_l": [],
    # (L, onchip) -> K7's shared bytes a lane
    "bt_dfs_lane_bytes": [ctypes.c_int, ctypes.c_int],
    # (scal, codes, qual, plen, B, J, L, fc, out, qqp, stream)
    "bt_derive_rows": [_P, _P, _P, _P] + [ctypes.c_int] * 4 + [_P, _P, _P],
    # (hits, nhits, overflow, npart, part_n, part_job, part_pos,
    #  part_refc, B, nh_eff, hout, pout, scratch, stream)
    "bt_dfs_pack": [_P] * 8 + [ctypes.c_int] + [_P] * 5,
    # (B) -> the int64 scratch words bt_dfs_pack needs
    "bt_dfs_pack_scratch_words": [ctypes.c_int],
    # (result, overflow, mode, npart, part_job, part_n, part_pos,
    #  part_refc, gated, qual, plen, qual_rounds, B, L, J, jrc, n, s, qt,
    #  maxbts, maq, norc, nofw, out, stream)
    "bt_derive_b_jobs": [_P] * 12 + [ctypes.c_int] * 11 + [_P, _P],
    # () -> K6's warps a block and rows a warp, K9's warps a block and
    # most shared bytes; (J) -> K9's shared bytes a block
    "bt_jobs_row_warps": [],
    "bt_jobs_rows_per_warp": [],
    "bt_jobs_lane_warps": [],
    "bt_jobs_max_shared": [],
    "bt_jobs_b_shared": [ctypes.c_int],
    # (0: K6, 1: K9) -> the kernel's local bytes per thread
    "bt_jobs_local_bytes": [ctypes.c_int],
    # (args, threads, stream); BestArgs is align/best_device.py's
    "bt_best_machine": [_P, ctypes.c_int, _P],
    # () -> K10's most lanes a block, widest on-chip L, arguments' bytes
    "bt_best_max_lanes": [],
    "bt_best_onchip_l": [],
    "bt_best_args_bytes": [],
    # (L, nd, onchip) -> K10's shared words a lane; (nd, ndt, paired) ->
    # its scratch words a lane
    "bt_best_lane_words": [ctypes.c_int] * 3,
    "bt_best_scratch_words": [ctypes.c_int] * 3,
    # (result, overflow, count, best_stratum, nhits, hits, hoff, B, out,
    #  stream)
    "bt_best_pack": [_P] * 7 + [ctypes.c_int, _P, _P],
    # (nd, ndt, paired) -> the width of the machine's per-lane init row
    "bt_best_init_width": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    # (paired) -> the machine instantiation's local bytes per thread
    "bt_best_local_bytes": [ctypes.c_int],
    # (r, n1, k, big, nr, order, maxg, scratch, stream)
    "bt_sa_round": [_P] + [ctypes.c_int] * 3 + [_P] * 4 + [_P],
    # (args, stream); IlvArgs is align/pe_ilv_device.py's
    "bt_pe_ilv": [_P, _P],
    # () -> K13's warps a block, reference piece bytes, widest query row,
    # a warp's and the arguments' shared bytes, its local bytes
    "bt_ilv_warps": [],
    "bt_ilv_piece": [],
    "bt_ilv_max_lq": [],
    "bt_ilv_warp_bytes": [],
    "bt_ilv_args_bytes": [],
    "bt_ilv_local_bytes": [],
}


def lib():
    """The kernel library, built and loaded on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.bt_sa_scratch_bytes.argtypes = [ctypes.c_int]
            so.bt_sa_scratch_bytes.restype = ctypes.c_int64
            so.bt_error_string.argtypes = [ctypes.c_int]
            so.bt_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def fm_view(fm) -> FMView:
    """The kernels' view of a CUDA-resident FMIndexArrays (cached on it;
    the view borrows the arrays' device pointers)."""
    if fm.kernel_view is None:
        for name in ("bwt", "occ", "ftab_hi", "ftab_lo", "offs"):
            check(getattr(fm, name), f"fm.{name}", torch.int32, None,
                  fm.device)
        if fm.bwt.data_ptr() % 32 or fm.occ.data_ptr() % 16:
            raise ValueError("fm.bwt/fm.occ are not 32/16-byte aligned")
        v = FMView()
        v.bwt, v.occ = fm.bwt.data_ptr(), fm.occ.data_ptr()
        v.ftab_hi, v.ftab_lo = fm.ftab_hi.data_ptr(), fm.ftab_lo.data_ptr()
        v.offs = fm.offs.data_ptr()
        v.sa = fm.sa.data_ptr() if fm.sa is not None else None
        v.fchr[:] = [int(x) for x in fm.fchr.tolist()]
        v.zoff, v.bwt_len = fm.zoff, fm.bwt_len
        v.ftab_chars, v.off_rate = fm.ftab_chars, fm.off_rate
        fm.kernel_view = v
    return fm.kernel_view


def on_cpu(fm, *tensors: torch.Tensor) -> bool:
    """True when the index and every tensor lie on the CPU (the plain
    version's case), False when all lie on one CUDA device (the
    kernel's); anything else raises."""
    return all_on_cpu(*tensors, device=fm.device)


def all_on_cpu(*tensors: torch.Tensor, device=None) -> bool:
    """on_cpu for tensors (and `device`, if given) without an index."""
    devs = {t.device for t in tensors} | ({device} if device else set())
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          ndim: int | None, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(name: str, entry: str, *args, device: torch.device) -> None:
    """Call C entry `entry` with `args` plus the current stream of
    `device`, the CUDA device the arguments live on, with that device
    current; raise on a launch error, and count the launch under `name`.
    (The current device's stream would be another device's for the
    shards of a mesh, parallel/mesh.py.)"""
    so = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(so, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}: "
                           f"{so.bt_error_string(rc).decode()}")
    LAUNCHES[name] += 1
