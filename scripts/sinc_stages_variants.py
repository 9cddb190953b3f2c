#!/usr/bin/env python3
"""Where SincNet's stage kernels spend their time: variants of
``diart_tpu_torch/csrc/sinc_stages.cu`` made by text edits (the package's
source untouched), each built beside the package's library and timed at
B = 256 and 5 s windows with CUDA events, in turns, with each kernel's
device time from the profiler.

``base`` is the source as it is; each other variant removes one part of the
work, so that the time it saves is that part's: ``no_mma`` (the tensor-core
products left out, their A operands still loaded and split),
``one_product`` (the f32 route's hi.hi product alone: the split's two small
products left out), ``no_transform`` (the input tile's norm and leaky ReLU
not applied), ``no_weights`` (no W^T slice copied into the ring). The outputs of the ablations are wrong by design; only
``base`` is checked, against the package's library, bitwise. ``NAME=PATH``
builds the source at PATH under NAME beside them (another design of the
same entry points, held to the package's library within the card's f32
tolerance).

Run on a machine with the card, from the repository root:
``python3 scripts/sinc_stages_variants.py [NAME | NAME=PATH ...]`` (builds
into ``build/variants/``).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from diart_tpu_torch.ops import _build  # noqa: E402
from diart_tpu_torch.ops import sinc_stages as ss  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")


def edit(src: str, anchor: str, text: str) -> str:
    if src.count(anchor) < 1:
        raise SystemExit(f"the variant's anchor is not in the kernel source: {anchor!r}")
    return src.replace(anchor, text)


def variants() -> dict:
    src = open(os.path.join(_build.CSRC, "sinc_stages.cu")).read()
    nop = ("namespace {\n"
           "__device__ __forceinline__ void nop_mma(float (&d)[8][4], const unsigned (&a)[4], uint64_t db) {\n"
           '  asm volatile("" : "+f"(d[0][0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));\n'
           "}\n}  // namespace\n")
    small = ("        wgmma_m64n64k8_tf32(lo, al[h], wgmma_desc(hi + at, 16, 1024));\n"
             "        wgmma_m64n64k8_tf32(lo, ah[h], wgmma_desc(low + at, 16, 1024));\n")
    transform = "      float v = r < avail ? norm_leaky(xc[r], mean, rstd, scale, shift) : 0.f;"
    ahead = "    if (kb + kStages - 2 < NS) load_slice<CIN, BF16>(s, wt, kb + kStages - 2);"
    return {
        "base": src,
        "no_mma": edit(edit(src, '#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + nop),
                       "      wgmma_m64n64k8_tf32(acc,", "      nop_mma(acc,").replace(
                           "wgmma_m64n64k8_tf32(lo,", "nop_mma(lo,"),
        "one_product": edit(src, small, ""),
        "no_transform": edit(src, transform, "      float v = r < avail ? xc[r] + mean * rstd * scale * shift : 0.f;"),
        "no_weights": edit(edit(src, ahead, "    if (kb < 0) load_slice<CIN, BF16>(s, wt, kb);"),
                           "    load_slice<CIN, BF16>(s, wt, kb);\n    cp_async_commit();",
                           "    cp_async_commit();"),
    }


def build(names):
    os.makedirs(OUT, exist_ok=True)
    sources = {name: text for name, text in variants().items() if name in names}
    for arg in names:
        if "=" in arg:
            name, path = arg.split("=", 1)
            sources[name] = open(path).read()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT, f"sinc_stages_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"libsinc_stages_{name}.so")
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"[{name}] " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(so)
        ss._signature(lib)
        lib.sinc_stages_error_string.restype = ctypes.c_char_p
        lib.sinc_stages_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def main(names):
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    net, pooled = cs.stages_case(256, 80000, gen)
    norms, _, ops = cs.stages_args(net, torch.float32)
    package = _build.library("sinc_stages", ss._signature)

    def run(lib):
        _build._LIBS["sinc_stages"] = lib
        try:
            return ss.sinc_stages(pooled, norms, None, None, None, None, torch.float32, operands=ops)
        finally:
            _build._LIBS["sinc_stages"] = package

    with torch.no_grad():
        want = run(package)
        if "base" in libs:
            assert torch.equal(run(libs["base"]), want), "the base variant differs from the package's library"
        for arg in names:
            if "=" in arg:
                got = run(libs[arg.split("=", 1)[0]])
                err = (got - want).abs().max().item()
                print(f"{arg}: max |difference| from the package's {err:.3e} (tolerance "
                      f"{cs.STAGES_TOL['f32'] * want.abs().max().item():.3e})", flush=True)
        times = {name: [] for name in libs}
        for turn in range(2):  # turns: every variant, then every variant in reverse
            for name in (list(libs) if turn == 0 else list(libs)[::-1]):
                times[name].append(cs.time_ms(lambda: run(libs[name]), 20))
        for name, lib in libs.items():
            device = cs.device_times(lambda: run(lib), name)
            print(f"{name}: ms {' '.join(f'{t:.4f}' for t in times[name])} (mean {np.mean(times[name]):.4f}); device "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms, _ in device), flush=True)
    print(f"gpu: {cs.smi_line()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(variants()))
