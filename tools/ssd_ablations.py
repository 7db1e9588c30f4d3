#!/usr/bin/env python3
"""Where the SSD kernel's long-chunk body spends its time, on one GPU.

    python3 tools/ssd_ablations.py [b,nc,c,h,g,p,n ...]

Builds copies of ``csrc/ssd.cu`` (into ``build/variants/``, all at once)
with one part of body 1 taken out, and times each beside the kernel itself
at each shape (default: mamba2-370m's (2, 8, 256, 32, 64, 128) with B and
C per group, g = 1, and per head, g = 32): the device time per call
(``chip_smoke.device_ms``) and each launch's device time from
``torch.profiler``.  The copies compute wrong outputs; they only time:

* ``no_mma``: no wgmma is issued (both passes): the loads, the x^T
  staging, the A fragments and the barriers alone;
* ``one_product``: one TF32 product a k8 step (hi b_hi) instead of the
  split's three;
* ``no_stage``: the output pass stages no x^T planes;
* ``no_frag``: the output pass forms its A fragments from constants (no
  G tile or B tile reads, no exp);
* ``mma_only``: neither staging nor fragments: the loads, the barriers and
  the wgmmas.

The sources in the repository are not changed.
"""
import ctypes
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))

import kernel_variants as kv  # noqa: E402
from kernel_variants import cs, ssd  # noqa: E402

MMA = ("  hop::wgmma_rs_tf32<N>(d, ah, bh, 1);\n  hop::wgmma_rs_tf32<N>(d, ah, bl, 1);\n"
       "  hop::wgmma_rs_tf32<N>(d, al, bh, 1);\n")
STAGE = "for (int it = tid; it < 16 * PT; it += S::NT) {"
G_READ = "const float4 gf = gs[kk * 128];"
B_READ = ("          split(bt[swz(j0, cc)] * d0, fh[0], fl[0]);\n"
          "          split(bt[swz(j0, cc + 8)] * d0, fh[1], fl[1]);\n"
          "          split(bt[swz(j1, cc)] * d1, fh[2], fl[2]);\n"
          "          split(bt[swz(j1, cc + 8)] * d1, fh[3], fl[3]);\n")


def _no_frag(s):
    s = s.replace(G_READ, "const float4 gf = make_float4(1.f, 1.f, 1.f, (float)(size_t)gs);")
    s = s.replace("__expf(", "(1.0f + 0.0f * ")
    return s.replace(B_READ, "".join(
        f"          split(d{i // 2}{' + (float)(size_t)bt' if i == 3 else ''}, "
        f"fh[{i}], fl[{i}]);\n" for i in range(4)))


def _no_stage(s):
    return s.replace(STAGE, STAGE.replace("it < 16 * PT", "it < 0"))


ABLATIONS = {
    "no_mma": lambda s: s.replace(MMA, ""),
    "one_product": lambda s: s.replace(MMA, MMA.splitlines(True)[0]),
    "no_stage": _no_stage,
    "no_frag": _no_frag,
    "mma_only": lambda s: _no_frag(_no_stage(s)),
}


def main():
    cs.phase_env()
    os.makedirs(kv.OUT, exist_ok=True)
    for header in os.listdir(kv.CSRC):
        if header.endswith(".cuh"):
            kv.shutil.copy(os.path.join(kv.CSRC, header), kv.OUT)
    src = open(os.path.join(kv.CSRC, "ssd.cu")).read()
    for needle in (MMA, STAGE, G_READ, B_READ, "__expf("):
        if needle not in src:
            raise SystemExit(f"the source no longer has {needle!r}")
    jobs = {}
    for name, cut in ABLATIONS.items():
        path = f"{kv.OUT}/ssd_{name}.cu"
        with open(path, "w") as f:
            f.write(cut(src))
        jobs["ssd_" + name] = path
    kv.build.build_all(["ssd"])
    kv._build(jobs)
    fns = {"kernel": ssd._kernel_fn()}
    for name in ABLATIONS:
        fns[name] = kv._load("ssd_" + name, "ssd_intra_chunk_forward", 7, 8)
    shapes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] \
        or [(2, 8, 256, 32, g, 64, 128) for g in (1, 32)]
    for shape in shapes:
        t = cs._ssd_inputs(shape)
        bound, by = cs.ssd_bound_ms(*shape)
        split, _ = cs.ssd_bound_ms(*shape, split=True)
        for name, fn in fns.items():
            ssd._fn = fn

            def call():
                return ssd.ssd_intra_chunk_kernel(*t, body=1)
            print(f"(b, nc, c, h, g, p, n) = {shape} {name}: device_ms "
                  f"{cs.device_ms(call)[0]:.4f} (bound {bound:.4f}, {by}; split "
                  f"TF32 {split:.4f}), {kv._profile(call)}", flush=True)
        ssd._fn = fns["kernel"]


if __name__ == "__main__":
    main()
