"""Build and load the CUDA kernels of ``tpufluid_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``), and the host-only ``csrc/*.cpp`` (the chamfer field of
``native.distfield``), one process per source, all started together, and
links the objects into one shared library with a plain C interface,
which is then loaded with ``ctypes``. The library lands in ``tpufluid_torch/_build/<hash>/``, keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. A failed build raises with the compiler's
output; nothing falls back.

The kernel wrappers of ``ops`` launch through the helpers at the end:
``on_cuda`` picks the kernel or the plain version, ``ptr`` and ``stream``
make the arguments, and ``launched`` counts each launch in ``LAUNCHES``
or raises with the CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libtpufluid_kernels.so"
# -fmad=false: every f32 op rounds on its own, as in the plain versions.
# -Xptxas -v: registers / spills of each kernel, kept in build.log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of each C entry point (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "tf_rebin": [_P] * 7 + [_P] * 4 + [_P] * 3 + [_I] * 3 + [_F] * 3
    + [_I] * 2 + [_P],
    "tf_rebin_tile": [_I],
    "tf_rebin_valid": [_P] * 6 + [_P] * 6 + [_I] * 3 + [_F] * 3 + [_I] * 2
    + [_F] + [_P],
    "tf_rebin_valid_tile": [_I],
    "tf_density": [_P] * 7 + [_P] * 2 + [_I] * 3 + [_F] * 4 + [_P],
    "tf_density_tile": [_I],
    "tf_forces": [_P] * 10 + [_P] * 2 + [_P] * 4 + [_I] * 3 + [_I, _P]
    + [_P],
    "tf_forces_tile": [_I],
    "tf_physics": [_P] * 8 + [_P] * 2 + [_P] * 4 + [_I] * 3 + [_I]
    + [_F] * 2 + [_P] + [_P],
    "tf_physics_tile": [_I],
    "tf_physics_max_k": [],
    "tf_metaball_coarse": [_P] * 6 + [_I] * 5 + [_F] * 4 + [_P],
    "tf_sph_density": [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P],
    "tf_sph_density_tile": [_I],
    "tf_sph_density_max_k": [],
    "tf_sph_forces": [_P] * 8 + [_P] * 4 + [_I] * 3 + [_I] * 2 + [_F] * 11
    + [_P],
    "tf_sph_forces_tile": [_I],
    "tf_sph_forces_max_k": [],
    "tf_dense_density": [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P],
    "tf_dense_forces": [_P] * 8 + [_P] * 4 + [_I] * 3 + [_I] * 2 + [_F] * 9
    + [_P],
    "tf_dense_build": [_P] * 4 + [_L] * 4 + [_P, _I] + [_I] * 5 + [_P] * 2
    + [_P],
    "tf_dense_readback": [_P, _I, _L] + [_P] * 5 + [_P] + [_P],
    "tf_chamfer_push_field": [_P, _I, _I, _P],
    "tf_far_reinsert": [_P] * 7 + [_P] * 3 + [_P] * 4 + [_P] * 3 + [_I] * 6
    + [_F] * 3 + [_I] * 2 + [_P],
    "tf_far_smem_entries": [],
    "tf_far_band_collect": [_P] * 8 + [_P] * 2 + [_I] * 5 + [_F] * 3
    + [_I] * 2 + [_P],
    "tf_far_band_insert": [_P, _I] + [_P] * 5 + [_P] * 6 + [_I] * 5
    + [_F] * 3 + [_I] * 2 + [_P],
}

_lib = None
build_seconds = None  # wall time of the build that this process ran


def _compiled():
    """The sources compiled one to an object: kernels, then host code."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def _sources():
    return _compiled() + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; (cmd, returncode, output) each."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    outs = [p.communicate()[0] for _, p in procs]
    return [(c, p.returncode, out) for (c, p), out in zip(procs, outs)]


def _build(out_dir: Path) -> Path:
    global build_seconds
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    srcs = _compiled()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(srcs, objs)])
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, "-shared", "-o", str(tmp),
                              *(str(o) for o in objs)]])
    build_seconds = time.perf_counter() - t0
    log = "".join(" ".join(c) + "\n" + out for c, _, out in results)
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, rc) for c, rc, _ in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0][1]}):\n{log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        lib_path = _build(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tf_error_string.argtypes = [ctypes.c_int]
    lib.tf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def build_log() -> str:
    """The compiler output (incl. ptxas register counts) of the loaded build."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def error_string(err: int) -> str:
    return f"{err} ({load().tf_error_string(err).decode()})"


# kernel launches by name (CUDA tensors only). The qualified names count
# the launches of a kernel that took a variant: forces_integrate with an
# obstacle field (has_ff), x wrap, surface tension, adaptive subsampling
# or a batched world stack (wid); rebin with row_shift, density with wid.
LAUNCHES = dict.fromkeys((
    # ops.fused
    "rebin", "rebin_row_shift", "density", "density_wid",
    "forces_integrate", "forces_integrate_has_ff", "forces_integrate_wrap",
    "forces_integrate_surface_tension", "forces_integrate_adaptive",
    "forces_integrate_wid", "physics",
    # ops.rebin, ops.render_coarse, ops.sph
    "rebin_valid", "metaball_coarse", "sph_density", "sph_forces",
    # ops.resident: the far-mover pass, one a step of the kernel step on a
    # CUDA device, gate open or not
    "far_reinsert",
    # ops.far_sharded: one of each a band a step of the row-band sharded
    # step on a CUDA device, gate open or not
    "far_collect", "far_insert",
    # ops.dense
    "dense_density", "dense_forces", "dense_build", "dense_readback"), 0)


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise NotImplementedError(f"no kernel for device {dev}")
    return True


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launched(name: str, err: int) -> None:
    """Raise on a nonzero CUDA error of a launch of ``name``, else count
    it in ``LAUNCHES``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{error_string(err)}")
    LAUNCHES[name] += 1
