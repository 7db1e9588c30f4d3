#!/usr/bin/env python3
"""Where the 8-bit streamed_moe kernel's time goes, on one GPU.

    python3 tools/moe_8bit_ablations.py [E,C,d,m ...]

Builds copies of ``csrc/streamed_moe.cu`` (into ``build/variants/``, all
at once) with one part of the 8-bit body taken out, and times each beside
the kernel itself at each shape (default: granite's decode step, 32, 64,
1024, 512), int8 weights, bf16 x, swiglu, the default setting: the device
time per call (``chip_smoke.device_ms``) and each phase's device time from
``torch.profiler``.  The copies compute wrong outputs; they only time:

* ``no_epilogue``: both phases return after the mainloop (no activation,
  no h or out stores);
* ``weights_only``: no activation tiles (x, h) are loaded;
* ``acts_only``: no weight tiles are loaded;
* ``no_loads``: K = 0, so the ring is never filled: the launch and the
  epilogue alone;
* ``no_pdl``: phase 2 launched as an ordinary launch (this one computes
  the right output).

Phase 2 is a dependent launch, so its profiled time overlaps phase 1's
tail; the device time per call is the one to compare.  The sources in the
repository are not changed.
"""
import ctypes
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))

import torch  # noqa: E402

import kernel_variants as kv  # noqa: E402
from kernel_variants import cs, sm  # noqa: E402

UP = "  q_mainloop<S, TW, false>(acc, smem, full, d, &xmap, w, n0, c0, e, E);\n"
DOWN = "  q_mainloop<S, TW, true>(acc, smem, full, m, &hmap, w, n0, c0, e, E);\n"
EXPECT = ("hop::mbar_expect_tx(&full[kt], S::STAGE);",
          "hop::mbar_expect_tx(&full[ps], S::STAGE);")
LOAD_A = "  for (int p = 0; p < S::PARTS; ++p)\n    for (int kb"
LOAD_W = "  for (int mat = 0; mat < S::NMAT; ++mat)\n    for (int sb"
PDL = "  launch_dependent(down_kernel_q<D, TW>"


def _expect(src, less):
    for e in EXPECT:
        src = src.replace(e, e.replace("S::STAGE", f"S::STAGE - {less}"))
    return src


ABLATIONS = {
    "no_epilogue": lambda s: s.replace(
        UP + "  if (c >= m) return;",
        UP + "  if (c >= m || acc[0][0] != 12345.0f) return;").replace(
        DOWN + "  if (c >= d) return;",
        DOWN + "  if (c >= d || acc[0][0] != 12345.0f) return;"),
    "weights_only": lambda s: _expect(s, "S::B_BYTES").replace(
        LOAD_A, LOAD_A.replace("p < S::PARTS", "p < 0")),
    "acts_only": lambda s: _expect(s, "S::NMAT * S::W_BYTES").replace(
        LOAD_W, LOAD_W.replace("mat < S::NMAT", "mat < 0")),
    "no_loads": lambda s: s.replace(UP, UP.replace(", d, &xmap", ", 0, &xmap"))
    .replace(DOWN, DOWN.replace(", m, &hmap", ", 0, &hmap")),
    "no_pdl": lambda s: s.replace(PDL, PDL.replace("launch_dependent", "launch_dyn")),
}


def main():
    cs.phase_env()
    os.makedirs(kv.OUT, exist_ok=True)
    for header in os.listdir(kv.CSRC):
        if header.endswith(".cuh"):
            kv.shutil.copy(os.path.join(kv.CSRC, header), kv.OUT)
    src = open(os.path.join(kv.CSRC, "streamed_moe.cu")).read()
    for needle in (UP, DOWN, LOAD_A, LOAD_W, PDL) + EXPECT:
        if needle not in src:
            raise SystemExit(f"the source no longer has {needle!r}")
    jobs = {}
    for name, cut in ABLATIONS.items():
        path = f"{kv.OUT}/moe_{name}.cu"
        with open(path, "w") as f:
            f.write(cut(src))
        jobs["moe_" + name] = path
    kv.build.build_all(["streamed_moe"])
    kv._build(jobs)
    fns = {"kernel": sm._kernel_fn()}
    for name in ABLATIONS:
        fn = ctypes.CDLL(f"{kv.OUT}/libmoe_{name}.so").streamed_moe_forward
        fn.argtypes, fn.restype = fns["kernel"].argtypes, ctypes.c_int
        fns[name] = fn
    shapes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] \
        or [(32, 64, 1024, 512)]
    for (E, C, d, m) in shapes:
        xe, wg, wu, wd = cs._moe_inputs(E, C, d, m, "swiglu", torch.bfloat16)
        ws, scales = cs._stream_operands(wg, wu, wd, "int8")
        bound, by = cs.streamed_moe_bound_ms(E, C, d, m, "int8", 2)
        for name, fn in fns.items():
            sm._fn = fn

            def call():
                return sm.streamed_moe_kernel(xe, *ws, activation="swiglu",
                                              **scales)
            print(f"(E, C, d, m) = {(E, C, d, m)} int8 {name}: device_ms "
                  f"{cs.device_ms(call)[0]:.4f} (bound {bound:.4f}, {by}), "
                  f"{kv._profile(call)}", flush=True)
        sm._fn = fns["kernel"]


if __name__ == "__main__":
    main()
