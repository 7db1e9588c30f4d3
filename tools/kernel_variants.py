#!/usr/bin/env python3
"""Time tile settings of the port's streamed_moe kernel and of its SSD
kernel on one GPU.

    python3 tools/kernel_variants.py "8bit:up2x128k128s3:dn4x256k128s2,..." \\
        ["S=2,8;T=2,4"]

The first argument names streamed_moe settings of
``repro_torch.kernels.streamed_moe.TILE_SETTINGS`` (comma-separated;
``all`` for every one, empty for none).  The kernel takes its setting at
launch (``tiles=``), so these run from the one build of
``csrc/streamed_moe.cu``: for each setting it prints the error against the
plain version at the serving shape (E, C, d, m) = (32, 64, 1024, 512) and
at two ragged ones, with the setting path's weights (bf16; int8 and
fp8; or fp32 and bf16 under fp32 x), the device time per call (``chip_smoke.device_ms``) and the device
time of each kernel from ``torch.profiler``.  The optional second argument
names SSD settings, ``ring_stages,heads_a_block``: each is a copy of
``ssd.cu`` with ``STAGES`` (body 1's TMA ring depth) and ``HB_MAX`` (body
2's most heads a block) replaced, built with nvcc (all at once) into
``build/variants/``, checked against the plain version at six shapes
under the body the wrapper picks, and timed at (2, 8, 256, 32, 64, 128)
with g = 1 and g = 32 (body 1) and at the serving prefill's (1, 1, 8, 32,
1, 64, 128) (body 2).  It never changes the sources in the repository.
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
SSD_LINES = ("constexpr int STAGES = {};", "constexpr int HB_MAX = {};")


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
    path = next(p for p, table in sm.TILE_SETTINGS.items() if name in table)
    wdts = {"bf16": ("bf16",), "8bit": ("int8", "fp8"), "tf32": ("fp32", "bf16")}[path]
    for wdt in wdts:
        for (E, C, d, m, act, x_dtype) in ((32, 64, 1024, 512, "swiglu", torch.bfloat16),
                                           (4, 37, 256, 96, "gelu", torch.float32),
                                           (4, 64, 512, 1024, "swiglu", torch.bfloat16)):
            if path == "bf16":
                x_dtype = torch.bfloat16
            elif path == "tf32":   # fp32 x (with bf16 weights, the path's other case)
                x_dtype = torch.float32
            xe, wg, wu, wd = cs._moe_inputs(E, C, d, m, act, x_dtype)
            ws, scales = cs._stream_operands(wg, wu, wd, wdt)

            def call():
                return sm.streamed_moe_kernel(xe, *ws, activation=act, tiles=name, **scales)
            rel = cs.rel_err(call(), ref.streamed_moe_plain(xe, *ws, act, **scales))
            line = f"streamed_moe {name} {wdt} {(E, C, d, m, act)}: rel vs plain {rel:.3e}"
            if E == 32:
                line += f", device_ms {cs.device_ms(call)[0]:.4f}, {_profile(call)}"
            print(line, flush=True)


def ssd_kernel(name):
    ssd._fn = _load("ssd_" + name, "ssd_intra_chunk_forward", 7, 8)
    for shape in ((2, 8, 256, 32, 1, 64, 128), (2, 8, 256, 32, 32, 64, 128),
                  (1, 1, 8, 32, 1, 64, 128), (1, 3, 32, 3, 1, 32, 16),
                  (1, 2, 100, 3, 3, 64, 16), (1, 2, 300, 2, 1, 128, 32),
                  (1, 1, 17, 2, 2, 16, 8)):
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
        if c in (8, 256):
            line += f", device_ms {cs.device_ms(call)[0]:.4f}, {_profile(call)}"
        print(line, flush=True)


def main():
    cs.phase_env()
    os.makedirs(OUT, exist_ok=True)
    for header in os.listdir(CSRC):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, header), OUT)
    arg = sys.argv[1] if len(sys.argv) > 1 else ""
    known = [n for table in sm.TILE_SETTINGS.values() for n in table]
    moe_names = known if arg == "all" else [n for n in arg.split(",") if n]
    if any(n not in known for n in moe_names):
        raise SystemExit(f"unknown streamed_moe settings "
                         f"{[n for n in moe_names if n not in known]}; known: {known}")
    ssd_specs = _specs(sys.argv[2] if len(sys.argv) > 2 else "")
    text = open(os.path.join(CSRC, "ssd.cu")).read()
    jobs = {}
    for name, values in ssd_specs.items():
        path = f"{OUT}/ssd_{name}.cu"
        with open(path, "w") as f:
            f.write(_variant(text, SSD_LINES, values, 1))
        jobs["ssd_" + name] = path
    if moe_names:
        build.build_all(["streamed_moe"])
    _build(jobs)
    for name in moe_names:
        moe(name)
    for name in ssd_specs:
        ssd_kernel(name)


if __name__ == "__main__":
    main()
