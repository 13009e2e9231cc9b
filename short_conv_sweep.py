"""Times the short conv's vector instance at other run lengths R and ring
depths U than the ones the port ships (``RUN_ROWS`` / ``RUN_ROWS_GATED``
and ``AHEAD`` in ``src/repro_torch/kernels/short_conv.py``).

Shape: hyena-153m's projection (B=4, L=1024, 2592 channels, K=3, bf16 u
and gate, fp32 w), gated and ungated, on four input sets that together
exceed the L2 cache, with every output written to memory the L2 no longer
holds: ``torch.profiler`` device time of the kernel, as ``chip_smoke.py``'s
phase 4 times the shipped setting.

U is a template argument of the kernel, so each U is a build of
``csrc/short_conv.cu`` with ``-DAHEAD=U`` into ``kernels/_build/sweep/``
(one ``nvcc`` each, all started together).  R is the vector instance's
run-time argument and is passed straight to the C entry point, so the
port's wrapper keeps its one geometry.  Each setting's output is first held
against the plain version (within one bf16 ulp).

Needs a CUDA card:

    python3 short_conv_sweep.py [--rows 4,8,16,32,64] [--aheads 2,4,8]

Prints one line per setting, the card's name and power limit, and as the
last line a JSON object of the device ms by setting and the bounds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

from chip_smoke import (ROOT, card_line, kernel_device_ms, log, short_conv_agrees,
                        short_conv_bound_ms, short_conv_inputs)

B, L, D, K = 4, 1024, 2592, 3


def build(aheads):
    """One library of csrc/short_conv.cu per ring depth, built together."""
    from repro_torch.kernels import build as kb

    out_dir = kb.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kb.nvcc_path()
    procs = {}
    for U in aheads:
        lib = out_dir / f"libshort_conv_ahead{U}.so"
        cmd = [nvcc, *kb.NVCC_FLAGS, f"-DAHEAD={U}", "-o", str(lib),
               str(kb.CSRC / "short_conv.cu")]
        procs[U] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for U, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at AHEAD={U}:\n{text}")
        libs[U] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="4,8,16,32,64", help="run lengths R, comma-separated")
    ap.add_argument("--aheads", default="2,4,8", help="ring depths U, comma-separated")
    args = ap.parse_args()
    rows = [int(x) for x in args.rows.split(",")]
    aheads = [int(x) for x in args.aheads.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("short_conv_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import short_conv as sc

    device = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    libs = build(aheads)
    fns = {}
    for U, lib in libs.items():
        fns[U] = sc.entry_point(lib, "bf16", "f32")
        if lib.short_conv_ahead() != U:
            raise RuntimeError(f"the build for U={U} keeps {lib.short_conv_ahead()} rows ahead")
    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(U, R):
        def call(u, w, gate):
            out = torch.empty_like(u)
            g_ptr, g_strides = (None, (0, 0)) if gate is None else (gate.data_ptr(),
                                                                    gate.stride()[:2])
            err = fns[U](u.data_ptr(), w.data_ptr(), g_ptr, out.data_ptr(), B, L, D, K,
                         0, R, *u.stride()[:2], *g_strides, *w.stride(), stream)
            if err:
                raise RuntimeError(f"launch failed at R={R} U={U}: "
                                   f"{libs[U].short_conv_error_string(err).decode()}")
            return out
        return call

    sets = [short_conv_inputs(B, L, D, K, bf16, 60 + i, device) for i in range(4)]
    times, bounds = {}, {}
    with torch.no_grad():
        for gated in (True, False):
            st = sets if gated else [(u, w, None) for u, w, _ in sets]
            if {sc.short_conv_plan(*a) for a in st} != {"vector"}:
                raise RuntimeError("the timing sets do not take the vector instance")
            key = "gated" if gated else "ungated"
            bounds[key] = short_conv_bound_ms(B, L, D, K, bf16, gated=gated)[0]
            times[key] = {}
            for R in rows:
                for U in aheads:
                    call = launcher(U, R)
                    label = f"R={R} U={U}"
                    short_conv_agrees(call(*st[0]), sc.short_conv_gate_plain(*st[0]),
                                      f"{key} {label}")
                    ms = kernel_device_ms(call, st, "short_conv_vec", cold_outputs=True, tries=3)
                    if ms is None:
                        raise RuntimeError(f"the trace at {label} holds no device time")
                    times[key][label] = ms
                    log(f"  {key} {label}: {ms:.4f} ms device, "
                        f"{100 * bounds[key] / ms:.1f} % of the bound {bounds[key]:.4f} ms")
    shipped = {"gated": sc.RUN_ROWS_GATED, "ungated": sc.RUN_ROWS}
    log(f"shipped: R={shipped['gated']} gated, R={shipped['ungated']} ungated, U={sc.AHEAD}")
    print(card_line())
    print(json.dumps({"device_ms": times, "bound_ms": bounds,
                      "shipped": {"run_rows": shipped, "ahead": sc.AHEAD},
                      "shape": {"B": B, "L": L, "D": D, "K": K, "dtype": "bfloat16"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
