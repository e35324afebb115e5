"""The MSDA forward as a C++ operator library, for processes without
Python.

`csrc/msda_op.cpp` registers `semi_detr::ms_deform_attn` with the schema
of the Python operator (`ops/ms_deform_attn_cuda.py`) and a CUDA kernel
that calls the forward kernel's launchers in the nvcc-built library
(`ms_deform_attn_cuda.build`), which it links. g++ builds it at first use
against the installed torch (`torch.utils.cpp_extension`'s include and
library paths, torch's C++ ABI) into `_build/<hash of the sources, flags
and torch version>/libsdt_msda_op.so`; `cpp_extension.load` is not used
(it needs ninja). The serving runner (`tools/serve_runner.py`) loads it.

Never load it into a process that imported `ms_deform_attn_cuda`: the
two schema definitions collide. Nothing falls back: a failed build
raises with the compiler's log.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import List, Sequence, Tuple

import torch

from . import ms_deform_attn_cuda as msda

SOURCE = "msda_op.cpp"
LIBRARY = "libsdt_msda_op.so"


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def cxx_std() -> str:
    """The C++ standard torch's own extension builder compiles with."""
    from torch.utils import cpp_extension
    with open(cpp_extension.__file__) as f:
        return "-std=c++20" if "-std=c++20" in f.read() else "-std=c++17"


def torch_flags(cuda: bool) -> List[str]:
    """g++ flags that compile and link against the installed libtorch:
    its headers, its C++ ABI, its libraries (with an rpath), and with
    `cuda` the CUDA toolkit's headers and libtorch_cuda, linked even where
    no symbol of it is used (it registers the CUDA backend)."""
    from torch.utils import cpp_extension
    lib_dir = cpp_extension.library_paths()[0]
    flags = [cxx_std(), "-O2", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    flags += [f"-I{p}" for p in cpp_extension.include_paths()]
    if cuda:
        flags.append(f"-I{os.path.join(cuda_home(), 'include')}")
    flags += [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}"]
    if cuda:
        flags += ["-Wl,--no-as-needed", "-ltorch_cuda", "-lc10_cuda",
                  "-Wl,--as-needed"]
    return flags + ["-ltorch", "-ltorch_cpu", "-lc10", "-pthread"]


def build_dir(sources: Sequence[str], flags: Sequence[str]) -> str:
    """`_build/<hash>/` of these sources (paths), flags and torch."""
    h = hashlib.sha256(" ".join(flags).encode() + torch.__version__.encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(os.path.dirname(msda.CSRC), "_build",
                        h.hexdigest()[:16])


def gxx(sources: Sequence[str], out: str, flags: Sequence[str],
        shared: bool) -> str:
    """g++ sources -> out (written under a temporary name and renamed into
    place); returns g++'s log, raises with it on failure."""
    if not shutil.which("g++"):
        raise RuntimeError("g++ not found: the C++ serving pieces are "
                           "compiled with g++ at first use")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out))
    os.close(fd)
    cmd = ["g++", *(["-shared"] if shared else []), *sources, "-o", tmp,
           *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {[os.path.basename(s) for s in sources]}:"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def library_path() -> str:
    kernels = msda.library_paths()[0]
    deps = [os.path.join(msda.CSRC, n) for n in
            (SOURCE, *msda.SOURCES[:1], *msda.HEADERS)]
    return os.path.join(build_dir(deps, torch_flags(True) + [kernels]),
                        LIBRARY)


def build() -> Tuple[str, str]:
    """The operator library, built if missing (after the kernels'
    libraries, which it links). Returns (path, g++'s log; empty when it
    existed)."""
    kernels = msda.build()[0][0]
    out = library_path()
    if os.path.exists(out):
        return out, ""
    log = gxx([os.path.join(msda.CSRC, SOURCE), kernels], out,
              torch_flags(True) + [f"-Wl,-rpath,{os.path.dirname(kernels)}"],
              shared=True)
    return out, log


def schema_in_source() -> str:
    """The schema string `csrc/msda_op.cpp` defines (its string literals
    joined), for the test that holds it to the Python operator's."""
    with open(os.path.join(msda.CSRC, SOURCE)) as f:
        src = f.read()
    body = re.search(r"TORCH_LIBRARY\(semi_detr, m\) \{(.*?)\n\}", src,
                     re.S).group(1)
    return "".join(re.findall(r'"([^"]*)"', body))
