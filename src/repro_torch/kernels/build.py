"""Build and load the hand-written Hopper kernels.

Each `csrc/<source>.cu` compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a -shared` into its own shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers: a build takes
seconds); the paged decode's source compiles into one library a pool type
(`LIBRARIES`: its 72 instantiations were the build's longest pole in one
nvcc). Libraries land in `build/repro_torch_kernels/` at the repository
root, named by a hash of their source and
flags, so an edited source is rebuilt and an unchanged one is reused.

`build_all()` starts one `nvcc` per source, all at once, and returns each
kernel's `-Xptxas -v` report (registers, shared memory, spills). Nothing
here runs at import time: the CPU tests import every module. A first use
builds under a file lock in the build directory, so ranks that start
together build a library once (the others wait, then load it).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# library name → (source, its own nvcc flags)
LIBRARIES = {
    "sa_matmul": ("sa_matmul", ()),
    **{f"sa_decode_attention_{pool}": ("sa_decode_attention",
                                       (f"-DREPRO_POOL_DT={code}",))
       for code, pool in enumerate(("f32", "bf16", "f16"))},
    "sa_attention": ("sa_attention", ()),
    "quantize": ("quantize", ()),
    "fp_emu": ("fp_emu", ()),
}
SOURCES = tuple(LIBRARIES)   # every library, as `build_all` builds them
# no --use_fast_math: quantize.cu needs the IEEE reciprocal (-prec-div=true)
# and products kept below the normal range (-ftz=false)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# where nvcc has it, the SA GEMM library's 22 kernels are optimized in
# parallel on every core: on the card's machine its build falls from ~100
# to ~40 s with the same registers, spills and times. Not for the decode
# library: built so, its fp32 decode at 2048-token slots ran 40 % slower.
SPLIT_COMPILE = "--split-compile=0"
SPLIT_COMPILE_SOURCES = ("sa_matmul",)

_LIBS: dict[str, ctypes.CDLL] = {}
REPORTS: dict[str, str] = {}
SECONDS: dict[str, float] = {}


def build_dir() -> pathlib.Path:
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_SPLIT: list = []


def flags(name: str) -> tuple:
    """nvcc's flags for library `name`: FLAGS, the library's own, and
    SPLIT_COMPILE for the sources that take it where this nvcc has it."""
    if not _SPLIT:
        usage = subprocess.run([nvcc(), "--help"], capture_output=True,
                               text=True).stdout
        _SPLIT.append(SPLIT_COMPILE.split("=")[0] in usage)
    source, own = LIBRARIES[name]
    split = _SPLIT[0] and source in SPLIT_COMPILE_SOURCES
    return FLAGS + own + ((SPLIT_COMPILE,) if split else ())


def _source(name: str) -> pathlib.Path:
    return CSRC / f"{LIBRARIES[name][0]}.cu"


def _target(name: str) -> pathlib.Path:
    src = _source(name).read_bytes()
    h = hashlib.sha1(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{h}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not built yet, in parallel; return the ptxas
    reports of what was compiled (and each compile's seconds in
    `SECONDS`). Raises on any compiler error."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(target.with_suffix(f".{os.getpid()}.log"), "w+")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, log)
    failed = []
    while procs:
        for name, (proc, tmp, target, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            SECONDS[name] = time.monotonic() - t0
            log.seek(0)
            REPORTS[name] = log.read()
            log.close()
            os.remove(log.name)
            if proc.returncode != 0:
                failed.append(f"--- {name} ---\n{REPORTS[name]}")
                continue
            os.replace(tmp, target)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: REPORTS.get(n, "") for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_dir().mkdir(parents=True, exist_ok=True)
            with open(build_dir() / f"{name}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not target.exists():
                    build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib


_FUNCS: dict[tuple, object] = {}


def function(lib: str, name: str, argtypes):
    """The C entry point `name` of library `lib`, with its argument types
    set once (ctypes otherwise passes every int as 32 bits and cuts
    pointers). Every entry point returns `cudaGetLastError()` as an int."""
    fn = _FUNCS.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCS[lib, name] = fn
    return fn


def check(err: int, what: str):
    """Raise on a nonzero `cudaGetLastError()` returned by a C launcher."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")
