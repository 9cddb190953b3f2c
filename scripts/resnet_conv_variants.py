#!/usr/bin/env python3
"""Where ResNet34's trunk convolutions spend their time: variants of
``diart_tpu_torch/csrc/resnet_conv.cu`` made by text edits (the package's
source untouched), each built beside the package's library and timed at the
trunk's geometries at B = 256 with CUDA events, in turns.

``base`` is the source as it is; each other variant removes one part of the
work so that the time it saves is that part's: ``no_store`` (the epilogue
computes but does not store), ``no_epilogue`` (no epilogue at all),
``no_math`` (the epilogue's rounding steps left out), ``no_res`` (the
residual not read), ``no_mma`` (no tensor-core product: the loads and the
epilogue alone). ``warp_producer`` times a design choice instead: one
producer warp in place of the producer warpgroup, and no ``setmaxnreg``
(every thread keeps the 168 registers a block of nine or twelve warps
starts with). The outputs of the ablations are wrong by design; only
``base`` is checked, against the package's library, bitwise.

Run on a machine with the card, from the repository root:
``python3 scripts/resnet_conv_variants.py [NAME ...]`` (builds into
``build/variants/``).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from diart_tpu_torch.ops import _build  # noqa: E402
from diart_tpu_torch.ops import resnet_conv as rc  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
GEOMETRIES = ("stem", "s1.conv1", "s1.conv2", "s2.conv1", "s2.conv2", "s3.conv2", "s4.conv2")


def edit(src: str, anchor: str, text: str) -> str:
    if src.count(anchor) < 1:
        raise SystemExit(f"the variant's anchor is not in the kernel source: {anchor!r}")
    return src.replace(anchor, text)


def variants() -> dict:
    src = open(os.path.join(_build.CSRC, "resnet_conv.cu")).read()
    store = "        if (rows.ok[h] && cj) *reinterpret_cast<uint4*>(out + rows.at[h] + 8 * j) = y.v;"
    return {
        "base": src,
        "no_store": edit(src, store, "        if (rows.ok[h] && cj && p.relu == 7) *reinterpret_cast<uint4*>(out + rows.at[h] + 8 * j) = y.v;"),
        "no_epilogue": edit(edit(src, "    store_box<N>(acc, rows", "    if (p.relu == 7) store_box<N>(acc, rows"),
                            "      store_box<N>(acc[ms], rows", "      if (p.relu == 7) store_box<N>(acc[ms], rows"),
        "no_math": edit(src, "          y.w[k] = bits(epilogue2(pair(v[k]), pair(a.w[k]), pair(sh.w[k]), p.has_res, pair(rv.r[jg][h].w[k]),\n"
                             "                                  p.relu));",
                        "          y.w[k] = v[k] ^ a.w[k] ^ sh.w[k] ^ rv.r[jg][h].w[k];"),
        "no_res": edit(src, "if (p.has_res && rows.ok[h] && j < jn)", "if (p.relu == 7 && rows.ok[h] && j < jn)"),
        "warp_producer": edit(edit(edit(src, "constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 128;", "constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 32;"),
                                   "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 %0;\\n\" ::\"n\"(PRODUCER_REGS));\n", ""),
                              "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(CONSUMER_REGS));\n", ""),
        "warp_producer": edit(edit(edit(src, "constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 128;", "constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 32;"), '    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(PRODUCER_REGS));\n', ""), '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(CONSUMER_REGS));\n', ""),
        "no_mma": edit(edit(edit(src, "            wgmma_bf16_rs(acc[ms], a[ks & 1][ms], wgmma_desc(bt + 32 * ks, 16, 8 * row, row), !first);",
                                 "            ;"),
                            "          wgmma_bf16_rs(acc[ms], a[ks & 1][ms], wgmma_desc(bt + 32 * ks, 16, 8 * row, row), tap > 0 || ks > 0);",
                            "          ;"),
                       "          wgmma_bf16(acc, wgmma_desc(a + 32 * ks, 16, 8 * row, row), wgmma_desc(bt + 32 * ks, 16, 8 * row, row),\n"
                       "                     kk > 0 || ks > 0);", "          ;"),
    }


def build(names):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        if name not in names:
            continue
        cu = os.path.join(OUT, f"resnet_conv_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"libresnet_conv_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        rc._signature(lib)
        lib.resnet_conv_error_string.restype = ctypes.c_char_p
        lib.resnet_conv_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def main():
    names = sys.argv[1:] or list(variants())
    print(f"gpu: {cs.smi_line()}", flush=True)
    _build.library("resnet_conv", rc._signature)  # the package's build
    package = _build._LIBS["resnet_conv"]
    libs = build(set(names) | {"base"})
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {c[0]: c for c in cs.RESNET_CASES}
    for geo in GEOMETRIES:
        case = cases[geo]
        x, weight, a, b, res, stride, pad = cs.resnet_case(case, cs.RESNET_B, gen)
        ops = rc.prepare_conv_operands(weight, a, b)
        run = lambda: rc.resnet_conv(x, weight, a, b, stride, pad, res, case[7], torch.bfloat16, operands=ops)
        want = run()
        _build._LIBS["resnet_conv"] = libs["base"]
        same = torch.equal(run(), want)
        times = {}
        for turn in (names, names[::-1]):
            for name in turn:
                _build._LIBS["resnet_conv"] = libs[name]
                times.setdefault(name, []).append(cs.time_ms(run, 10))
        _build._LIBS["resnet_conv"] = package
        least, by = cs.resnet_least_ms(case, cs.RESNET_B)
        plan = None if case[1] == 1 else rc.conv_plan(case[2], want.shape[1], want.shape[2], case[1], (case[3],) * 2,
                                                      (stride,) * 2, (pad,) * 2)
        print(f"{geo}: plan {plan}; base bitwise the package's {same}; least {least:.4f} ms ({by}); ms (two turns): "
              + ", ".join(f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items()), flush=True)
        del x, weight, res, ops, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
