"""The C ABI on the PyTorch port: the library and the worker launcher.

    python -m hprlp_tpu_torch.capi [--device N|cpu]

builds `_build/libhprlp_tpu.so` and a launcher, and prints the library's
path and the two variables a C, Julia or MATLAB caller exports:

    HPRLP_TPU_PYTHON=<launcher>  HPRLP_TPU_ROOT=<repo root>

The library is the JAX package's own C ABI, native/src/hprlp_c_api.cpp,
compiled with native/Makefile's flags (its CAPI target) into this
package's `_build/`; native/ is never written.  That library, and the
Julia and MATLAB wrappers, start "$HPRLP_TPU_PYTHON -m hprlp_tpu.server
[args]" and speak its protocol over pipes or files.  The launcher is an
executable script with this interpreter baked in: invoked that way it
execs "python -m hprlp_tpu_torch.server [--device D] [args]", so every
such caller drives the port unchanged; any other invocation exits 2.
The library reads HPRLP_TPU_PYTHON when it starts its worker: a caller
that switches launchers calls hprlp_shutdown() first.
"""

from __future__ import annotations

import os
import shlex
import sys
import tempfile

from . import native

ROOT = os.path.dirname(native._PKG_DIR)
SOURCE = os.path.join(native._NATIVE_DIR, "src", "hprlp_c_api.cpp")
HEADER = os.path.join(native._NATIVE_DIR, "include", "hprlp_tpu.h")
LIB_PATH = os.path.join(native.BUILD_DIR, "libhprlp_tpu.so")


def build(timeout: float = native.BUILD_TIMEOUT_S) -> str:
    """Compile the C ABI library if it is missing or stale, with the repo
    root baked in as the worker's default HPRLP_TPU_ROOT
    (native/Makefile:31-32).  Returns its path."""
    return native.build_library(
        LIB_PATH, (SOURCE,), (HEADER,),
        flags=(f'-DHPRLP_TPU_DEFAULT_ROOT="{ROOT}"',), timeout=timeout)


def _device_flag(device) -> list[str]:
    """The server's --device arguments for `device`: None (the server's
    default, the card), "cpu" or a CUDA index."""
    if device is None:
        return []
    if device != "cpu" and not (isinstance(device, int) and device >= 0):
        raise ValueError(f"expected None, 'cpu' or a CUDA index, got "
                         f"{device!r}")
    return ["--device", str(device)]


LAUNCHER = """#!/bin/sh
# Worker launcher of hprlp_tpu_torch (written by capi.write_launcher).
# Callers of the C ABI, Julia and MATLAB run "$HPRLP_TPU_PYTHON -m
# hprlp_tpu.server [args]"; this runs the PyTorch port's server instead.
if [ "$#" -ge 2 ] && [ "$1" = "-m" ] && [ "$2" = "hprlp_tpu.server" ]; then
    shift 2
    PYTHONPATH={root}${{PYTHONPATH:+:$PYTHONPATH}}
    export PYTHONPATH
    exec {python} -m hprlp_tpu_torch.server {device}"$@"
fi
echo "hprlp_tpu_torch launcher: expected '-m hprlp_tpu.server [args]'," \\
     "got: $*" >&2
exit 2
"""


def write_launcher(path: str | None = None, device=None) -> str:
    """Write the worker launcher (an executable shell script) to `path`,
    by default `_build/hprlp_tpu_python` (`_build/hprlp_tpu_python_cpu`
    for device "cpu"), atomically.  device: None for the server's default
    (cuda:{params.device_number} of each request), "cpu" or a CUDA index.
    Returns the path."""
    flag = _device_flag(device)
    if path is None:
        suffix = "" if device is None else "_" + flag[1]
        path = os.path.join(native.BUILD_DIR, "hprlp_tpu_python" + suffix)
    text = LAUNCHER.format(
        root=shlex.quote(ROOT), python=shlex.quote(sys.executable),
        device="".join(shlex.quote(a) + " " for a in flag))
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.chmod(tmp, 0o755)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def environ(device=None) -> dict:
    """The two variables that point the C ABI, Julia and MATLAB at the
    port: HPRLP_TPU_PYTHON (a launcher for `device`, written now) and
    HPRLP_TPU_ROOT."""
    return {"HPRLP_TPU_PYTHON": write_launcher(device=device),
            "HPRLP_TPU_ROOT": ROOT}


def main(argv=None) -> int:
    import argparse

    from .cli import _device

    ap = argparse.ArgumentParser(
        prog="python -m hprlp_tpu_torch.capi",
        description="Build the C ABI library and the worker launcher of "
                    "the PyTorch port, and print what a caller exports.")
    ap.add_argument("--device", type=_device, default=None,
                    help="CUDA device index, or 'cpu', for the launcher "
                         "(default: the server's, the card)")
    args = ap.parse_args(argv)
    lib = build()
    print(f"library {lib}")
    for key, value in environ(args.device).items():
        print(f"export {key}={shlex.quote(value)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
