#!/usr/bin/env python3
"""Where a step of the LSTM sweep's split route (the f32 stream) spends its cycles.

Builds a copy of ``diart_tpu_torch/csrc/lstm_sweep.cu`` with ``clock64``
stamps around the parts of a step of ``lstm_sweep_split`` (the product over
the block's own half of k, the wait for the peer block's h, the product over
the other half, the tree of the parts' sums, the gate activations, the
gather and the cell update, the new h's stores, the block barrier), runs it
on the card at (293, B, 128) for B = 64 and 32 (and B = 256, several waves
of 4-row tiles), and prints the cycles a step of each part for two threads
of the first block: thread 0 and the last thread. The stamps are this
copy's only change; the package's library times the kernel beside it.

Run on a machine with the card, from the repository root:
``python3 scripts/lstm_sweep_step_probe.py`` (builds into ``build/probe/``).
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

PARTS = ["product, own half", "wait for the peer's h", "product, other half", "tree", "activations",
         "gather + cell update", "h stores", "barrier"]


def probe_source() -> str:
    """The kernel's source with the stamps: g_probe[10 w + k] sums part k's
    cycles of watched thread w (k = 8: the steps counted)."""
    src = open(os.path.join(_build.CSRC, "lstm_sweep.cu")).read()
    watched = "(blockIdx.x == 0 && blockIdx.y == 0 && (tid == 0 || tid == NT - 1))"

    def insert(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"the probe's anchor is not in the kernel source once: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    insert("namespace {\n", "__device__ unsigned long long g_probe[20];\n")
    insert("    const float* hb = &h_s[(t + 1) & 1][0][0];  // h_{t-1}\n", "    long long s0 = clock64();\n",
           after=False)
    wait = "    if (CL > 1 && t > 0) hopper::mbar_wait(hopper::smem_u32(&mbar[(t - 1) & 1]), ((t - 1) >> 1) & 1);\n"
    insert(wait, "    long long s1 = clock64();\n", after=False)
    insert(wait, "    long long s2 = clock64();\n")
    insert("    // the parts' sums as a balanced tree in part order", "    long long s3 = clock64();\n", after=False)
    insert("    float a[R];\n", "    long long s4 = clock64();\n", after=False)
    insert("    float act[4];\n", "    long long s5 = clock64();\n", after=False)
    insert("    float4 h4;\n", "    long long s6 = clock64();\n", after=False)
    barrier = "    __syncthreads();  // this block's h_t is whole\n"
    insert(barrier, "    long long s7 = clock64();\n", after=False)
    insert(barrier,
           "    long long s8 = clock64();\n"
           f"    if {watched} {{\n"
           "      unsigned long long* g = g_probe + (tid == 0 ? 0 : 10);\n"
           "      g[0] += s1 - s0; g[1] += s2 - s1; g[2] += s3 - s2; g[3] += s4 - s3; g[4] += s5 - s4;\n"
           "      g[5] += s6 - s5; g[6] += s7 - s6; g[7] += s8 - s7; g[8] += 1;\n"
           "    }\n")
    return src + '''
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_zero() {
  unsigned long long z[20] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_sweep_step_probe: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "lstm_sweep_probe.cu"), os.path.join(out, "liblstm_sweep_probe.so")
    with open(src, "w") as f:
        f.write(probe_source())
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout, build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_sweep_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    print(f"gpu: {cs.smi_line()}", flush=True)
    for batch in (64, 32, 256):
        gen = torch.Generator(device="cuda").manual_seed(3)
        proj = torch.randn(cs.T_LSTM, 2, batch, 4 * cs.H, generator=gen, device="cuda")
        w_hh = torch.randn(2, 4 * cs.H, cs.H, generator=gen, device="cuda") * (0.3 / (cs.H / 8) ** 0.5)
        packed = lstm_sweep.pack_w_hh(w_hh, torch.float32)
        res = torch.empty(cs.T_LSTM, 2, batch, cs.H, device="cuda")

        def run():
            err = lib.lstm_sweep_launch(proj.data_ptr(), packed.data.data_ptr(), res.data_ptr(), cs.T_LSTM, batch,
                                        cs.H, 0, lstm_sweep._ROUTES["split"], _build.num_sms(proj.device),
                                        _build.stream_handle(proj.device))
            if err:
                raise RuntimeError(f"the probe's launch failed: cudaError {err}")

        run()
        lib.probe_zero()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 20)()
        lib.probe_read(buf)
        for o, who in ((0, "thread 0"), (10, "the last thread")):
            parts = [buf[o + k] / buf[o + 8] for k in range(8)]
            print(f"B={batch} {who}: {sum(parts):.0f} cycles a step: "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(PARTS, parts)), flush=True)
        plan = lstm_sweep.launch_plan(batch, cs.H, torch.float32, proj.device)
        ms = cs.time_ms(lambda: lstm_sweep.lstm_sweep_tm(proj, operands=packed), 20)
        print(f"  the package's kernel alone: {ms:.4f} ms ({ms * 1e-3 * cs.sm_clock_hz() / cs.T_LSTM:.0f} "
              f"cycles a step at the card's highest clock); plan {plan}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
