#!/usr/bin/env python3
"""Where a step of the LSTM sweep backward's split route spends its cycles.

Builds a copy of ``diart_tpu_torch/csrc/lstm_sweep_bwd.cu`` with ``clock64``
stamps around the parts of phase B's step (the cell update and its stores,
the block barrier after it, the wait for the peer block's da, the product
and the parts' store, the block barrier after it, the tree and the
rounding), runs it on the card at (293, B, 128) for B = 64 and 32 in both
stream dtypes, and prints the cycles a step of each part for two threads
of the first block: thread 0 (a cell thread; its warp holds this block's
own parts and does not wait for the peer) and the last thread (a product
thread that waits for the peer). The stamps are this copy's only change;
the package's library times the kernel beside it.

Run on a machine with the card, from the repository root:
``python3 scripts/lstm_bwd_step_probe.py`` (builds into ``build/probe/``).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from diart_tpu_torch.ops import _build, lstm_sweep  # noqa: E402

PARTS = ["cell update + stores", "barrier (da)", "wait for the peer's da", "product + parts store",
         "barrier (parts)", "tree + rounding"]


def probe_source() -> str:
    """The kernel's source with the stamps: g_probe[8 w + k] sums part k's
    cycles of watched thread w (k = 6: the steps counted)."""
    src = open(os.path.join(_build.CSRC, "lstm_sweep_bwd.cu")).read()
    watched = "(blockIdx.x == 0 && blockIdx.y == 0 && (tid == 0 || tid == 4 * H - 1))"

    def insert(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"the probe's anchor is not in the kernel source once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    insert("namespace {\n", "__device__ unsigned long long g_probe[16];\n")
    insert("      float* dab = da_s + (s & 1) * BT * G;\n", "      long long t0 = clock64();\n", after=False)
    insert("      if (s == 0) break;\n", "      long long t1 = clock64();\n", after=False)
    insert("      __syncthreads();  // this block's units of da_s are whole\n", "      long long t2 = clock64();\n")
    insert("        hopper::mbar_wait(hopper::smem_u32(&mbar[s & 1]), ((time - 1 - s) >> 1) & 1);\n",
           "      long long t3 = clock64();\n")
    insert("      __syncthreads();  // the parts' sums are whole\n", "      long long t4 = clock64();\n", after=False)
    insert("      __syncthreads();  // the parts' sums are whole\n", "      long long t5 = clock64();\n")
    insert("        e = rnd<T>(g8[0]);\n      }\n",
           "      long long t6 = clock64();\n"
           f"      if {watched} {{\n"
           "        unsigned long long* g = g_probe + (tid == 0 ? 0 : 8);\n"
           "        g[0] += t1 - t0; g[1] += t2 - t1; g[2] += t3 - t2; g[3] += t4 - t3; g[4] += t5 - t4;\n"
           "        g[5] += t6 - t5; g[6] += 1;\n"
           "      }\n")
    return src + '''
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_bwd_step_probe: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "lstm_sweep_bwd_probe.cu"), os.path.join(out, "liblstm_sweep_bwd_probe.so")
    with open(src, "w") as f:
        f.write(probe_source())
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout, build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_sweep_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    print(f"gpu: {cs.smi_line()}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (64, 32):
            cgen = torch.Generator(device="cuda").manual_seed(3)
            proj, w_hh, out_, dout = cs.sweep_bwd_inputs(cs.T_LSTM, batch, dtype, cgen)
            pre = lstm_sweep._recurrent_products(lstm_sweep._prev_hidden(out_), w_hh.to(dtype).float())
            wp = lstm_sweep.pack_backward_w(w_hh, dtype)
            work = torch.empty_like(pre)
            cells = torch.empty(2, cs.T_LSTM, batch, 2, cs.H, device="cuda")

            def run():
                work.copy_(pre)
                err = lib.lstm_sweep_bwd_launch(proj.data_ptr(), work.data_ptr(), dout.data_ptr(), wp.data_ptr(),
                                                cells.data_ptr(), cs.T_LSTM, batch, cs.H, lstm_sweep._DTYPES[dtype],
                                                _build.num_sms(proj.device), _build.stream_handle(proj.device))
                if err:
                    raise RuntimeError(f"the probe's launch failed: cudaError {err}")

            run()
            lib.probe_zero()
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.probe_read(buf)
            for o, who in ((0, "thread 0 (cell; own parts)"), (8, "last thread (product; peer's parts)")):
                parts = [buf[o + k] / buf[o + 6] for k in range(6)]
                print(f"{str(dtype)[6:]} B={batch} {who}: {sum(parts):.0f} cycles a step: "
                      + ", ".join(f"{n} {v:.0f}" for n, v in zip(PARTS, parts)), flush=True)
            print(f"  the package's kernel alone: {cs.kernel_only_ms(proj, w_hh, out_, dout):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
