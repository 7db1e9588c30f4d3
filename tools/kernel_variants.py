#!/usr/bin/env python3
"""Time settings of the port's int8 / fp8 streamed_moe path and of its SSD
kernel on one GPU: each setting is a copy of the kernel's source with its
tile constants replaced, built with nvcc (all at once) into
``build/variants/``, held against the plain version and timed.

    python3 tools/kernel_variants.py "A=64,16,64,4,128,32,64,3;B=..." \\
        ["S=32,2;T=32,1"]

The first argument names streamed_moe settings: per phase (up, down) the
columns a block, the columns a warp, the k-rows a stage and the ring depth,
``up_bn,up_wn,up_bk,up_stages,dn_bn,dn_wn,dn_bk,dn_stages``.  The optional
second names SSD settings: ``source_rows,blocks_per_sm``.  For each setting
it prints the error against the plain version at the serving shape (E, C,
d, m) = (32, 64, 1024, 512) and at two ragged ones, the device time per
call (``chip_smoke.device_ms``) and the device time of each kernel from
``torch.profiler``; for SSD at (2, 8, 256, 32, 64, 128) with g = 1 and
g = 32 and at four small shapes.  It never changes the sources in the
repository.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref, ssd  # noqa: E402
from repro_torch.kernels import streamed_moe as sm  # noqa: E402

CSRC = os.path.join(HERE, "src/repro_torch/kernels/csrc")
OUT = os.path.join(HERE, "build/variants")
MOE_LINES = ("constexpr int Q_UP_BN = {}, Q_UP_WN = {}, Q_UP_BK = {}, Q_UP_STAGES = {};",
             "constexpr int Q_DN_BN = {}, Q_DN_WN = {}, Q_DN_BK = {}, Q_DN_STAGES = {};")
SSD_LINES = ("constexpr int ST = {};", "constexpr int Y_BLOCKS = {};")


def _specs(arg):
    return {k: v.split(",") for k, v in (a.split("=") for a in arg.split(";"))} if arg else {}


def _variant(src, lines, values, per_line):
    """``src`` with each line of ``lines`` (as the source has it now) set to
    the next ``per_line`` values."""
    for i, line in enumerate(lines):
        pattern = line.replace("{}", "(\\d+)")
        found = re.search(pattern, src)
        if not found:
            raise SystemExit(f"the source no longer has {line!r}")
        src = src.replace(found.group(0),
                          line.format(*values[i * per_line:(i + 1) * per_line]))
    return src


def _build(jobs):
    procs = {n: subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                                  f"{OUT}/lib{n}.so", path],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, path in jobs.items()}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{log[-3000:]}")
        regs = sorted({ln.split("info    :")[-1].strip() for ln in log.splitlines()
                       if "registers" in ln})
        print(f"built {n}: {regs}", flush=True)


def _load(name, symbol, n_ptr, n_int):
    fn = getattr(ctypes.CDLL(f"{OUT}/lib{name}.so"), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _profile(fn, reps=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: round(e.self_device_time_total / 1e3 / reps, 4)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def moe(name):
    sm._fn = _load("sm_" + name, "streamed_moe_forward", 9, 7)
    for wdt in ("int8", "fp8"):
        for (E, C, d, m, act, x_dtype) in ((32, 64, 1024, 512, "swiglu", torch.bfloat16),
                                           (4, 37, 256, 96, "gelu", torch.float32),
                                           (4, 64, 512, 1024, "swiglu", torch.bfloat16)):
            xe, wg, wu, wd = cs._moe_inputs(E, C, d, m, act, x_dtype)
            ws, scales = cs._stream_operands(wg, wu, wd, wdt)

            def call():
                return sm.streamed_moe_kernel(xe, *ws, activation=act, **scales)
            rel = cs.rel_err(call(), ref.streamed_moe_plain(xe, *ws, act, **scales))
            line = f"streamed_moe {name} {wdt} {(E, C, d, m, act)}: rel vs plain {rel:.3e}"
            if E == 32:
                line += f", device_ms {cs.device_ms(call)[0]:.4f}, {_profile(call)}"
            print(line, flush=True)


def ssd_kernel(name):
    ssd._fn = _load("ssd_" + name, "ssd_intra_chunk_forward", 7, 7)
    for shape in ((2, 8, 256, 32, 1, 64, 128), (2, 8, 256, 32, 32, 64, 128),
                  (1, 3, 32, 3, 1, 32, 16), (1, 2, 100, 3, 3, 64, 16),
                  (1, 2, 300, 2, 1, 128, 32), (1, 1, 17, 2, 2, 16, 8)):
        b, nc, c, h, g, p, n = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        kw = dict(generator=gen, device="cuda")
        xc = torch.randn(b, nc, c, h, p, **kw)
        Bc, Cc = (torch.randn(b, nc, c, g, n, **kw) for _ in range(2))
        Ac = -torch.rand(b, h, nc, c, **kw) * 0.1
        Acum = torch.cumsum(Ac, -1)

        def call():
            return ssd.ssd_intra_chunk_kernel(xc, Bc, Cc, Ac, Acum)
        plain = ref.ssd_intra_chunk_plain(xc, Bc, Cc, Acum)
        rel = max(cs.rel_err(a, w) for a, w in zip(call(), plain))
        line = f"ssd {name} (b,nc,c,h,g,p,n)={shape}: rel vs plain {rel:.3e}"
        if c == 256:
            line += f", device_ms {cs.device_ms(call)[0]:.4f}, {_profile(call)}"
        print(line, flush=True)


def main():
    cs.phase_env()
    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "tensor_core.cuh"), OUT)
    moe_specs = _specs(sys.argv[1] if len(sys.argv) > 1 else "")
    ssd_specs = _specs(sys.argv[2] if len(sys.argv) > 2 else "")
    jobs = {}
    for prefix, specs, src, lines, per_line in (
            ("sm_", moe_specs, "streamed_moe.cu", MOE_LINES, 4),
            ("ssd_", ssd_specs, "ssd.cu", SSD_LINES, 1)):
        text = open(os.path.join(CSRC, src)).read()
        for name, values in specs.items():
            path = f"{OUT}/{prefix}{name}.cu"
            with open(path, "w") as f:
                f.write(_variant(text, lines, values, per_line))
            jobs[prefix + name] = path
    _build(jobs)
    for name in moe_specs:
        moe(name)
    for name in ssd_specs:
        ssd_kernel(name)


if __name__ == "__main__":
    main()
