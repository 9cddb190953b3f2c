#!/usr/bin/env python3
"""The SE-Res2Block's f32 1x1 TDNN on the TF32 tensor cores
(``tdnn_wgmma_tf32`` in ``diart_tpu_torch/csrc/se_res2.cu``) against two
variants of its accumulation, built side by side from text edits of the
package's source:

- ``split``: the package's kernel (hi.hi in one accumulator, the small
  terms lo.hi + hi.lo in another, added to nearest at the end);
- ``single``: every term in one accumulator;
- ``scale_d``: ``split`` with both accumulators started by the first
  ``wgmma``'s scale-d = 0 instead of zero moves (ptxas then does not
  serialize the ``wgmma``s: its note C7515).

For each: ptxas' registers and whether it serialized the ``wgmma``s, z1
(the stage-0 output) at (64, 501, 512) f32 against the plain version (max
and mean error), and the kernel's device time (profiler, 20 calls) in turns
split, single, scale_d, scale_d, single, split. Run on the card from the
repository root: ``python3 scripts/tdnn_tf32_variants.py`` (about a minute
with the builds). It stops with a message when the source no longer holds
the text it edits.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPLIT_ACC = ("  float acc[16][4], lo_acc[16][4];", "for (int i = 0; i < 4; ++i) acc[j][i] = lo_acc[j][i] = 0.0f;")
SMALL_TERMS = ("      wgmma_m64n128k8_tf32(lo_acc, al[ks], wgmma_desc(wh + ks * 32, 16, 1024));\n"
               "      wgmma_m64n128k8_tf32(lo_acc, ah[ks], wgmma_desc(wl + ks * 32, 16, 1024));\n"
               "      wgmma_m64n128k8_tf32(acc, ah[ks], wgmma_desc(wh + ks * 32, 16, 1024));")
SUM = "    for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], lo_acc[j][i]);"


def variants(src, hopper):
    for anchor in (*SPLIT_ACC, SMALL_TERMS, SUM):
        if anchor not in src:
            sys.exit(f"se_res2.cu no longer holds the text this script edits: {anchor!r}")
    single = src.replace(SMALL_TERMS, SMALL_TERMS.replace("lo_acc", "acc")).replace(SUM, "    for (int i = 0; i < 4; ++i) (void)lo_acc[j][i];")
    m = re.search(r"// d \(64 x 128, f32\).*?\n}\n", hopper, re.S)
    if not m:
        sys.exit("hopper.cuh no longer holds wgmma_m64n128k8_tf32")
    wrapper = (m.group(0).replace("wgmma_m64n128k8_tf32(", "wgmma_m64n128k8_tf32_s(")
               .replace("uint64_t db) {", "uint64_t db, int accumulate) {")
               .replace("setp.ne.b32 p, 1, 0;", "setp.ne.b32 p, %69, 0;")
               .replace('"l"(db));', '"l"(db), "r"(accumulate));'))
    scale_d = src.replace("// (a)/(c) 1x1 TDNN", wrapper + "\n// (a)/(c) 1x1 TDNN", 1)
    scale_d = scale_d.replace(SMALL_TERMS, (
        "      const int on = (kb | ks) != 0;\n"
        "      wgmma_m64n128k8_tf32_s(lo_acc, al[ks], wgmma_desc(wh + ks * 32, 16, 1024), on);\n"
        "      wgmma_m64n128k8_tf32(lo_acc, ah[ks], wgmma_desc(wl + ks * 32, 16, 1024));\n"
        "      wgmma_m64n128k8_tf32_s(acc, ah[ks], wgmma_desc(wh + ks * 32, 16, 1024), on);"))
    scale_d = scale_d.replace("#pragma unroll\n    " + SPLIT_ACC[1] + "\n", "", 1).replace(
        "#pragma unroll\n  for (int j = 0; j < 16; ++j)\n\n", "", 1)
    return dict(split=src, single=single, scale_d=scale_d)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diart_tpu_torch.ops import _build, se_res2

    if not torch.cuda.is_available():
        sys.exit("tdnn_tf32_variants: no CUDA device")
    srcs = variants((_build.CSRC / "se_res2.cu").read_text(), (_build.CSRC / "hopper.cuh").read_text())
    out = os.path.join(ROOT, "build", "tdnn_tf32_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(out, f"se_res2_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        at = next(i for i, l in enumerate(lines) if "Compiling entry" in l and "tdnn_wgmma_tf32" in l)
        regs = next(l for l in lines[at:] if "Used" in l).split("Used")[1].split(",")[0].strip()
        serialized = any("C7515" in l and "tdnn_wgmma_tf32" in l for l in lines)
        print(f"{name}: {regs}, wgmmas serialized by ptxas (C7515): {serialized}")
        libs[name] = ctypes.CDLL(so)
        se_res2._signature(libs[name])

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(*s, generator=g)
    mk = lambda *s: n(*s) * (0.5 / s[-2] ** 0.5)
    chans, width, groups = 512, 64, 7
    params = tuple(p.cuda() for p in (
        mk(chans, chans), 0.1 * n(chans), 1 + 0.1 * n(chans), 0.1 * n(chans),
        n(groups, 3, width, width) * (0.5 / (3 * width) ** 0.5),
        0.1 * n(groups, width), 1 + 0.1 * n(groups, width), 0.1 * n(groups, width),
        mk(chans, chans), 0.1 * n(chans), 1 + 0.1 * n(chans), 0.1 * n(chans),
        mk(chans, 128), 0.1 * n(128), mk(128, chans), 0.1 * n(chans)))
    x = n(64, 501, chans).cuda()
    k = se_res2.kernel_operands(params, torch.float32)
    tile = se_res2.cascade_tile(64, 501, torch.float32, _build.num_sms(x.device))

    def z1(lib):
        out_, scratch = torch.empty_like(x), torch.empty_like(x)
        err = lib.se_res2_staged_launch(
            x.data_ptr(), out_.data_ptr(), scratch.data_ptr(), k.w1.data_ptr(), k.v1.data_ptr(), k.wg.data_ptr(),
            k.vg.data_ptr(), k.w1s.data_ptr(), k.wgs.data_ptr(), 64, 501, chans, groups, 3, 2, 0, tile, 0,
            _build.stream_handle(x.device))
        if err:
            sys.exit(f"launch failed: cudaError {err}")
        return out_

    want = se_res2.se_res2_stage_reference(x, params, 2, 0)
    for name, lib in libs.items():
        diff = (z1(lib) - want).abs()
        print(f"{name}: z1 max_abs_err {diff.max().item():.3e}, mean {diff.mean().item():.3e} "
              f"(max |z1| {want.abs().max().item():.3f})")

    def device_ms(lib):
        z1(lib)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                z1(lib)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages() if "tdnn_wgmma_tf32" in e.key) / 1e3 / 20

    turns = ("split", "single", "scale_d", "scale_d", "single", "split")
    times = [device_ms(libs[name]) for name in turns]
    print("tdnn_wgmma_tf32 device ms in turns " + ", ".join(f"{name} {ms:.4f}" for name, ms in zip(turns, times)))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gpu: {gpu}")


if __name__ == "__main__":
    main()
