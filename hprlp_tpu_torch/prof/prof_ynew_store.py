"""The batched y-half's y_new store with and without an L2 evict-first
policy, end to end: batched_large's loop (prof_loop.BatchedLoop, B = 64)
profiled with csrc/spmm.cu's ring kernel storing y_new evict-first and
storing it plainly, in turns (evict-first, plain, plain, evict-first).

    python -m hprlp_tpu_torch.prof.prof_ynew_store [--dtype f32|f64]

The x-half that follows the y-half in every middle iteration gathers y_new
from L2, so the store's policy may cost the next kernel what it saves the
y-half.  The plain form is built from a copy of csrc/spmm.cu under
_build/ that differs only in the ring kernel's y_new store.  Prints, per
run, unprofiled it/s, device us/it, busy share and each SpMM kernel's
us/it (the y-half's ring kernel and the product kernel's x-half), then
each form's mean device us/it, and the ring kernel's registers and spills
(nvcc -Xptxas -v, for a library this call builds); with the card's name
and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import os
import re
import shutil
import sys

import torch

from ..ops import spmm
from ..ops.spmv import BUILD_DIR, build
from . import prof_loop
from .problems import batched_lp
from .timing import card

EVICT = "store_hint<T, V>(a.out, off, out, evict_first_policy());"
PLAIN = "store_row<T, V>(a.out, off, out);"
FORMS = ("evict_first", "plain")


def build_forms() -> dict:
    """{form: (source path, nvcc -Xptxas -v output)}: csrc/spmm.cu as it
    is (evict-first) and a copy under _build/ with the ring kernel's y_new
    store plain, csrc/'s headers beside it; built at once."""
    text = open(spmm.SOURCE).read()
    if text.count(EVICT) != 1:
        raise RuntimeError("the ring kernel's y_new store was not found")
    d = os.path.join(BUILD_DIR, "ynew_store")
    os.makedirs(d, exist_ok=True)
    for h in glob.glob(os.path.join(os.path.dirname(spmm.SOURCE), "*.cuh")):
        shutil.copy(h, d)
    plain = os.path.join(d, "spmm.cu")
    with open(plain, "w") as f:
        f.write(text.replace(EVICT, PLAIN))
    paths = {"evict_first": spmm.SOURCE, "plain": plain}

    def one(form):
        log: list = []
        build(paths[form], ptxas_log=log)
        return form, (paths[form], "".join(log))

    with concurrent.futures.ThreadPoolExecutor(len(FORMS)) as ex:
        return dict(ex.map(one, FORMS))


def ring_ptxas(log: str) -> dict:
    """{ring kernel's mangled name: its register and spill lines} from
    nvcc -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        elif name and "spmm_y_ring_kernel" in name and (
                "spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def use(path: str) -> None:
    """Make ops/spmm.py load the library built from `path`."""
    spmm.SOURCE = path
    spmm._library.cache_clear()
    spmm._ring_ready.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prof_ynew_store: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    built = build_forms()
    for form, (_, log) in built.items():
        for kernel, lines in ring_ptxas(log).items():
            print(f"ptxas {form} {kernel}: {'; '.join(lines)}", flush=True)
    arrays = batched_lp(65536, 131072, 64, seed=3)
    original = spmm.SOURCE
    device_us = {form: [] for form in FORMS}
    try:
        for form in ("evict_first", "plain", "plain", "evict_first"):
            use(built[form][0])
            loop = prof_loop.BatchedLoop(arrays, dtype)
            r = prof_loop.profile(loop, prof_loop.SPMM_KERNELS)
            device_us[form].append(r["device_us"])
            print(f"{form} {args.dtype}: {r['its']:.1f} it/s unprofiled, "
                  f"device {r['device_us']:.2f} us/it, busy share "
                  f"{r['busy']:.3f}, SpMM {r['product_us']:.2f} us/it "
                  f"[{name}]", flush=True)
            for us, count, key in r["top"]:
                if any(k in key for k in prof_loop.SPMM_KERNELS):
                    print(f"{form} {args.dtype}:   {us:8.3f} us/it "
                          f"{count:6d}x  {key}", flush=True)
            del loop
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    finally:
        use(original)
    for form, v in device_us.items():
        print(f"{form} {args.dtype}: mean device "
              f"{sum(v) / len(v):.2f} us/it over {len(v)} runs {v} "
              f"[{name}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
