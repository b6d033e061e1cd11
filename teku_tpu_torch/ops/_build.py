"""Build and bind the hand-written CUDA kernels (ops/kernels/*.cu).

Each kernel source is compiled by ``nvcc -O3 -arch=sm_90a -shared
-Xcompiler -fPIC`` into its own shared library with a plain C ABI,
loaded with ctypes, once for each Montgomery engine (``ENGINES``):
``cios`` (the CUDA-core CIOS product) and ``mma`` (the tensor-core
digit product of kernels/mma_digits.cuh, ``-DMONT_ENGINE_MMA=1``).  The
libraries are keyed by (source, host, engine).  On the card every
source of both engines builds in one parallel batch (one nvcc process
each, all started together) on first use; the host C++ build compiles
the one engine a caller loads.  Libraries go to ``ops/_build/<key>/``,
where the key hashes the sources, the generated constants header and
the flags -- an edit rebuilds, an unchanged tree reuses the libraries.

``fp381_consts.h`` (Fq, R = 2^384) and ``fr255_consts.h`` (the scalar
field Fr, R = 2^256) are generated here from the port's own constants,
so the kernels and the plain PyTorch versions share one source of truth
for every constant.

A missing ``nvcc`` is an error: there is no fallback.  Every C entry
point returns ``cudaGetLastError()``; ``check`` raises when it is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..crypto.bls import curve as C
from ..crypto.bls import fields as F
from ..crypto.bls.constants import (B_G1, B_G2, ISO3_X_DEN, ISO3_X_NUM,
                                    ISO3_Y_DEN, ISO3_Y_NUM, P, R, SSWU_A2,
                                    SSWU_B2, SSWU_Z2, X_ABS)

KERNEL_DIR = os.path.join(os.path.dirname(__file__), "kernels")
BUILD_ROOT = os.path.join(os.path.dirname(__file__), "_build")
SOURCES = ("fp381", "decompress", "h2c", "scalars_group", "msm", "pairing",
           "kzg", "shard")
NVCC_FLAGS = ["-O3", "-arch=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
# the host build: the same sources as C++ (no __CUDACC__), each kernel a
# plain loop over its per-thread body -- checks the kernels' arithmetic on
# a machine without a card
HOST_FLAGS = ["-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w"]

ENGINES = ("cios", "mma")
# the compile-time switch of the mma engine (fp381.cuh)
ENGINE_FLAGS = {"cios": [], "mma": ["-DMONT_ENGINE_MMA=1"]}

R_MONT = (1 << 384) % P


def _words(x: int, n: int = 12) -> str:
    return ", ".join(f"0x{(x >> (32 * j)) & 0xFFFFFFFF:08x}u"
                     for j in range(n))


def _fp(x: int, mont: bool = True) -> str:
    v = (x % P) * R_MONT % P if mont else x
    return "{{" + _words(v) + "}}"


def _fq2(c) -> str:
    return "{" + _fp(c[0]) + ", " + _fp(c[1]) + "}"


def constants_header() -> str:
    """The generated constants header (C text)."""
    from .h2c import _Z3_POW_E
    from .points import _PSI_X, _PSI_Y, BETA
    from .towers import SQRT_EXP, _SQRT_C2, _SQRT_C3, _SQRT_M1
    neg_g1 = C.to_affine(C.FQ_OPS, C.point_neg(C.FQ_OPS, C.G1_GENERATOR))
    lines = ["// generated by teku_tpu_torch/ops/_build.py -- do not edit",
             "#pragma once"]

    def fpc(name, x, mont=True):
        lines.append(f"DCONST fp {name} = {_fp(x, mont)};")

    def fq2c(name, c):
        lines.append(f"DCONST fq2 {name} = {_fq2(c)};")

    def fq2arr(name, cs):
        body = ", ".join(_fq2(c) for c in cs)
        lines.append(f"DCONST fq2 {name}[{len(cs)}] = {{{body}}};")

    def expc(name, e):
        n = (e.bit_length() + 31) // 32
        lines.append(f"DCONST uint32_t {name}[{n}] = {{{_words(e, n)}}};")
        lines.append(f"#define {name}_BITS {e.bit_length()}")

    lines.append(f"#define N0 0x{(-pow(P, -1, 1 << 32)) % (1 << 32):08x}u")
    fpc("K_P", P, mont=False)
    fpc("K_HALF", (P - 1) // 2, mont=False)
    fpc("K_ONE", 1)
    lines.append(f"DCONST fp K_R2 = {{{{{_words(R_MONT * R_MONT % P)}}}}};")
    lines.append(f"DCONST fp K_R3 = {{{{{_words(R_MONT ** 3 % P)}}}}};")
    fpc("K_B1", B_G1)
    fq2c("K_B2", B_G2)
    fpc("K_BETA", BETA)
    fq2c("K_PSI_X", _PSI_X)
    fq2c("K_PSI_Y", _PSI_Y)
    fq2c("K_FROB6_C1", F.FROB6_C1)
    fq2c("K_FROB6_C2", F.FROB6_C2)
    fq2c("K_FROB12_C1", F.FROB12_C1)
    fq2arr("K_SQRT_ROOTS", [_SQRT_M1, _SQRT_C2, _SQRT_C3])
    fq2c("K_SSWU_A", SSWU_A2)
    fq2c("K_SSWU_B", SSWU_B2)
    fq2c("K_SSWU_Z", SSWU_Z2)
    fq2c("K_Z3E", _Z3_POW_E)
    fq2arr("K_ISO_XN", ISO3_X_NUM)
    fq2arr("K_ISO_XD", ISO3_X_DEN)
    fq2arr("K_ISO_YN", ISO3_Y_NUM)
    fq2arr("K_ISO_YD", ISO3_Y_DEN)
    fpc("K_NEG_G1_X", neg_g1[0])
    fpc("K_NEG_G1_Y", neg_g1[1])
    expc("E_PM2", P - 2)
    expc("E_SQRT1", (P + 1) // 4)
    # the Fq2 square-root exponent's halves in base P (wcoop.cuh:
    # a^e = conj(a^HI) a^LO)
    expc("E_SQRT2_LO", SQRT_EXP % P)
    expc("E_SQRT2_HI", SQRT_EXP // P)
    expc("E_XABS", X_ABS)
    expc("E_XSQ", X_ABS * X_ABS)
    return "\n".join(lines) + "\n"


FR_R_MONT = (1 << 256) % R


def fr_constants_header() -> str:
    """The generated Fr constants header (C text)."""
    def frc(name, x):
        return f"DCONST fr {name} = {{{{{_words(x, 8)}}}}};"
    e = R - 2
    return "\n".join([
        "// generated by teku_tpu_torch/ops/_build.py -- do not edit",
        "#pragma once",
        f"#define FR_N0 0x{(-pow(R, -1, 1 << 32)) % (1 << 32):08x}u",
        frc("FR_M", R),
        frc("FR_ONE", FR_R_MONT),
        frc("FR_R2", FR_R_MONT * FR_R_MONT % R),
        frc("FR_INV_2", (R + 1) // 2 * FR_R_MONT % R),
        f"DCONST uint32_t FR_E_MM2[8] = {{{_words(e, 8)}}};",
        f"#define FR_E_MM2_BITS {e.bit_length()}"]) + "\n"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _source_text(name: str) -> bytes:
    with open(os.path.join(KERNEL_DIR, name), "rb") as fh:
        return fh.read()


def build_key(headers, flags) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(KERNEL_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update(_source_text(name))
    for name, text in sorted(headers.items()):
        h.update(name.encode())
        h.update(text.encode())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


_LOCK = threading.Lock()
_LIBS: dict = {}
_INIT: set = set()          # (source, engine, CUDA device index or "host")
BUILD_INFO: dict = {}       # seconds, ptxas report per source, directory


def host_compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler for the host build of the kernels")
    return cxx


def build_all(host: bool = False, engines=ENGINES) -> dict:
    """Compile every kernel source of each engine (all in parallel)
    unless already built; returns {(source, engine): library path}.
    host=True builds the sources as C++ for the CPU instead (tests of
    the kernels' arithmetic)."""
    headers = {"fp381_consts.h": constants_header(),
               "fr255_consts.h": fr_constants_header()}
    flags = HOST_FLAGS if host else NVCC_FLAGS
    out_dir = os.path.join(BUILD_ROOT, ("host-" if host else "")
                           + build_key(headers, flags))
    paths = {(s, e): os.path.join(out_dir, f"lib{s}-{e}.so")
             for e in engines for s in SOURCES}
    todo = [k for k, p in paths.items() if not os.path.exists(p)]
    if not todo:
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO["dir"] = out_dir
        return paths
    compiler = host_compiler() if host else nvcc_path()
    os.makedirs(out_dir, exist_ok=True)
    for name, text in headers.items():
        # whole files only: another process may be compiling against them
        tmp = os.path.join(out_dir, f"{name}.{os.getpid()}.tmp")
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, os.path.join(out_dir, name))
    t0 = time.perf_counter()
    procs = {}
    for s, e in todo:
        tmp = paths[(s, e)] + f".{os.getpid()}.tmp"
        cmd = [compiler, *flags, *ENGINE_FLAGS[e], "-I", out_dir,
               "-I", KERNEL_DIR, "-o", tmp,
               os.path.join(KERNEL_DIR, f"{s}.cu")]
        procs[(s, e)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT), tmp)
    reports, failed = {}, []
    for (s, e), (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        reports[(s, e)] = log
        with open(os.path.join(out_dir, f"{s}-{e}.log"), "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failed.append((s, e))
        else:
            os.replace(tmp, paths[(s, e)])
    if failed:
        msg = "\n".join(f"--- {s} ({e}) ---\n{reports[(s, e)][-4000:]}"
                        for s, e in failed)
        raise RuntimeError(f"kernel build failed for {failed}:\n{msg}")
    if not host:
        BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=reports,
                          dir=out_dir, processes=len(procs))
    return paths


_VOIDP = ctypes.c_void_p
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# the C entry points (every one returns a cudaError_t as int; the last
# argument is the CUDA stream, NULL in the host build)
SIGNATURES = {
    "fp381_init": ([], ctypes.c_int),
    "fp381_mul_count": ([], ctypes.c_ulonglong),      # host build only
    "fp381_ops": ([_I, _P, _P, _P, _L, _P], ctypes.c_int),
    "g1_validate": ([_P] * 5 + [_L, _P], ctypes.c_int),
    "prepare": ([_P, _P, _P, _I] + [_P] * 10 + [_L, _P], ctypes.c_int),
    "h2c": ([_P, _P, _P, _L, _P], ctypes.c_int),
    "scalars_group": ([_P] * 6 + [_I] + [_P] * 4 + [_L, _L, _P],
                      ctypes.c_int),
    "scalars_msm": ([_P] * 6 + [_I] + [_P] * 4 + [_L, _L, _L, _P],
                    ctypes.c_int),
    "scalars": ([_P] * 5 + [_L, _P], ctypes.c_int),
    "miller": ([_P] * 4 + [_L, _P], ctypes.c_int),
    "finish": ([_P, _L, _P, _L, _P, _P], ctypes.c_int),
    "pairing_ops": ([_I, _P, _P, _P, _L, _I, _P], ctypes.c_int),
    "fr_mul_count": ([], ctypes.c_ulonglong),         # host build only
    "kzg_eval": ([_P] * 6 + [_L, _L, _P], ctypes.c_int),
    "kzg_msm": ([_P] * 7 + [_L, _P], ctypes.c_int),
    "kzg_fold": ([_P] * 11 + [_L, _P], ctypes.c_int),
    "gather_hm": ([_P, _L, _P, _P, _P, _L, _P], ctypes.c_int),
    "lane_affine": ([_P, _P, _L, _P], ctypes.c_int),
    "shard_partials": ([_P, _L, _P, _L, _P], ctypes.c_int),
    "aggregate_points": ([_P, _P, _I, _P, _L, _P], ctypes.c_int),
    "mma_layout_check": ([_I, _P, _P], ctypes.c_int),   # host mma build
}


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def library(source: str, host: bool = False,
            engine: str = "cios") -> ctypes.CDLL:
    """The loaded library of one kernel source and engine (builds on
    first use: on the card every source of both engines, on the host the
    requested engine's sources; the CUDA libraries init the device
    current when they load)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (use one of "
                         f"{'/'.join(ENGINES)})")
    lib = _LIBS.get((source, host, engine))
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get((source, host, engine))
        if lib is None:
            built = build_all(host, (engine,) if host else ENGINES)
            for (s, e), path in built.items():
                _LIBS.setdefault((s, host, e), _load(path))
            _init_locked("host" if host else _current_device())
            lib = _LIBS[(source, host, engine)]
    return lib


def _current_device() -> int:
    import torch
    return torch.cuda.current_device()


def _init_locked(index) -> None:
    """fp381_init (the per-thread stack limit) of every loaded library on
    CUDA device `index` ("host": the host build), once each; _LOCK held."""
    host = index == "host"
    for (s, h, e), lib in list(_LIBS.items()):
        if h == host and (s, e, index) not in _INIT:
            what = f"{s} ({e}) init" + ("" if host else f" on cuda:{index}")
            check(lib.fp381_init(), what)
            _INIT.add((s, e, index))


def init_device(index: int) -> None:
    """Init every CUDA library on card `index` (a mesh over several cards
    does this once for each card before its first launch there)."""
    import torch
    library(SOURCES[0])
    with _LOCK, torch.cuda.device(index):
        _init_locked(index)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


_RAW_STREAM: list = []     # torch's current-stream handle getter, once looked up


def stream_ptr(t):
    """The current CUDA stream's handle (an int) for tensor t's device
    (None on the CPU)."""
    if not t.is_cuda:
        return None
    if not _RAW_STREAM:
        import torch
        _RAW_STREAM.append(getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda i: torch.cuda.current_stream(i).cuda_stream))
    return _RAW_STREAM[0](t.get_device())


def ptr(t):
    return _VOIDP(t.data_ptr())
