#!/usr/bin/env python3
"""Where the split-TF32 bodies of streamed_moe and flash attention spend
their time, on one GPU.

    python3 tools/tf32_ablations.py [--parent DIR]

Builds copies of ``csrc/streamed_moe.cu`` and ``csrc/flash_attention.cu``
(into ``build/variants/``, all at once) with one part of the fp32 body
taken out, and times each beside the kernel itself: streamed_moe with fp32
weights and x at granite's decode step (32, 64, 1024, 512) and the scoring
forward's C = 1280, and with bf16 weights and fp32 x at the decode step
(swiglu, the default setting); flash in fp32 at the scoring shape (2,
2048, 16, 64) and InternVL2's (2, 2304, 16, 128).  It prints the device
time per call (``chip_smoke.device_ms``) and each launch's device time from
``torch.profiler``.  The copies compute wrong outputs (but ``no_pdl``);
they only time:

* ``no_mma``: no wgmma is issued: the loads, the fragments, the waits and
  the epilogues alone;
* ``one_term``: one TF32 product a k8 step (hi b_hi) instead of the
  split's two or three;
* ``no_planes``: streamed_moe without x's plane kernel, flash without the
  K / V^T plane kernel;
* ``no_pdl`` (streamed_moe): its phases as ordinary launches, so the
  profiler's times of the three kernels do not overlap.

``--parent DIR``: first and last, the same fp32 calls (and SDPA's) on the
tree in DIR (a ``git archive`` of another commit, its kernels built into
``build/parent_build/``), so two versions are compared in one run.  The sources
in the repository are not changed.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_CASES = ((32, 64, 1024, 512, "fp32"), (32, 1280, 1024, 512, "fp32"),
             (32, 64, 1024, 512, "bf16"))
FLASH_CASES = ((2, 2048, 16, 64), (2, 2304, 16, 128))

MOE_MMA = (
    "        hop::wgmma_rs_tf32<S::N>(part[mat], h[mat], b0, fresh);\n",
    "        if constexpr (S::PARTS == 2) hop::wgmma_rs_tf32<S::N>(part[mat], h[mat], b1, 1);\n",
    "        if constexpr (S::WSPLIT) hop::wgmma_rs_tf32<S::N>(part[mat], l[mat], b0, 1);\n")
MOE_PLANES = ("    tf32_planes_kernel<TX><<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(\n"
              "        static_cast<const TX*>(xe), xp, n);\n")
S_STEP = ("      hop::split_step<BK>(sc, fh, fl, hop::desc_sw128(st + off, 16, 1024),\n"
          "                          hop::desc_sw128(st + L::KPLANE + off, 16, 1024));\n")
S_ONE = ("      hop::fence_regs(fh);\n      hop::fence_regs(sc);\n      hop::wg_fence();\n"
         "      hop::wgmma_rs_tf32<BK>(sc, fh, hop::desc_sw128(st + off, 16, 1024), 1);\n"
         "      hop::wg_commit();\n")
PV = ("        hop::wgmma_rs_tf32<64>(pv, ph[j], vh, 1);\n",
      "        hop::wgmma_rs_tf32<64>(pv, ph[j], vl, 1);\n",
      "        hop::wgmma_rs_tf32<64>(pv, pl[j], vh, 1);\n")
KV_PLANES = ("  flash_kv_planes<HD><<<dim3((skp + 63) / 64, B * H), 256, 0, s>>>(k, v, klo, vtp, B, H, "
             "Sk, skp);\n")


def _no_pdl(src):
    a = src.index("int launch_t_tile(")
    b = src.index("int launch_t_typed(")
    return src[:a] + src[a:b].replace("launch_dependent(", "launch_dyn(") + src[b:]


MOE = {
    "no_mma": lambda s: s.replace("".join(MOE_MMA), ""),
    "one_term": lambda s: s.replace("".join(MOE_MMA), MOE_MMA[0]),
    "no_planes": lambda s: s.replace(MOE_PLANES, ""),
    "no_pdl": _no_pdl,
}
FLASH = {
    "no_mma": lambda s: s.replace(S_STEP, "      hop::wg_commit();\n").replace("".join(PV), ""),
    "one_term": lambda s: s.replace(S_STEP, S_ONE).replace("".join(PV), PV[0]),
    "no_planes": lambda s: s.replace(KV_PLANES, ""),
}


def _flash_load(name):
    from kernel_variants import OUT
    fn = ctypes.CDLL(f"{OUT}/lib{name}.so").flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _moe_operands(cs, E, C, d, m, wdt):
    import torch
    xe, wg, wu, wd = cs._moe_inputs(E, C, d, m, "swiglu", torch.float32)
    ws, scales = cs._stream_operands(wg, wu, wd, wdt)
    return xe, ws, scales


def parent(tree):
    """The fp32 calls on the tree in ``tree`` (run in a process of its own)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_moe as sm
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["streamed_moe", "flash_attention"])
    for E, C, d, m, wdt in MOE_CASES:
        xe, ws, scales = _moe_operands(cs, E, C, d, m, wdt)
        ms = cs.device_ms(lambda: sm.streamed_moe_kernel(xe, *ws, activation="swiglu",
                                                         **scales))[0]
        print(f"parent streamed_moe (E, C, d, m) = {(E, C, d, m)} w={wdt} x=fp32: device_ms "
              f"{ms:.4f}", flush=True)
    for B, S, H, hd in FLASH_CASES:
        q, k, v = cs._flash_inputs(B, S, S, H, hd, torch.float32)
        ms = cs.device_ms(lambda: fa.flash_attention_kernel(q, k, v))[0]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    is_causal=True))[0]
        print(f"parent flash fp32 (B, S, H, hd) = {(B, S, H, hd)}: device_ms {ms:.4f}, "
              f"sdpa {sdpa:.4f}", flush=True)


def main():
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import kernel_variants as kv
    from kernel_variants import cs, sm
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    cs.phase_env()
    os.makedirs(kv.OUT, exist_ok=True)
    for header in os.listdir(kv.CSRC):
        if header.endswith(".cuh"):
            kv.shutil.copy(os.path.join(kv.CSRC, header), kv.OUT)
    jobs = {}
    for src_name, table, needles in (
            ("streamed_moe", MOE, ("".join(MOE_MMA), MOE_PLANES, "int launch_t_tile(")),
            ("flash_attention", FLASH, (S_STEP, "".join(PV), KV_PLANES))):
        src = open(os.path.join(kv.CSRC, f"{src_name}.cu")).read()
        for needle in needles:
            if needle not in src:
                raise SystemExit(f"{src_name}.cu no longer has {needle!r}")
        for name, cut in table.items():
            path = f"{kv.OUT}/{src_name}_{name}.cu"
            with open(path, "w") as f:
                f.write(cut(src))
            jobs[f"{src_name}_{name}"] = path
    kv.build.build_all(["streamed_moe", "flash_attention"])
    kv._build(jobs)
    moe = {"kernel": sm._kernel_fn()}
    for name in MOE:
        moe[name] = kv._load(f"streamed_moe_{name}", "streamed_moe_forward", 9, 8)
    for E, C, d, m, wdt in MOE_CASES:
        xe, ws, scales = _moe_operands(cs, E, C, d, m, wdt)
        bound, by = cs.streamed_moe_bound_ms(E, C, d, m, wdt, 4)
        split, split_by = cs.streamed_moe_bound_ms(E, C, d, m, wdt, 4, split=True)
        for name, fn in moe.items():
            sm._fn = fn

            def call():
                return sm.streamed_moe_kernel(xe, *ws, activation="swiglu", **scales)
            print(f"streamed_moe (E, C, d, m) = {(E, C, d, m)} w={wdt} x=fp32 {name}: "
                  f"device_ms {cs.device_ms(call)[0]:.4f} (bound {bound:.4f}, {by}; split "
                  f"TF32 {split:.4f}, {split_by}), {kv._profile(call)}", flush=True)
        sm._fn = moe["kernel"]
    flash = {"kernel": fa._kernel_fn()}
    for name in FLASH:
        flash[name] = _flash_load(f"flash_attention_{name}")
    for B, S, H, hd in FLASH_CASES:
        q, k, v = cs._flash_inputs(B, S, S, H, hd, torch.float32)
        bound, by = cs.flash_bound_ms(B, S, S, H, hd, "fp32", 4)
        split, _ = cs.flash_bound_ms(B, S, S, H, hd, "fp32", 4, split=True)
        for name, fn in flash.items():
            fa._fn = fn

            def call():
                return fa.flash_attention_kernel(q, k, v)
            print(f"flash fp32 (B, S, H, hd) = {(B, S, H, hd)} {name}: device_ms "
                  f"{cs.device_ms(call)[0]:.4f} (bound {bound:.4f}, {by}; split TF32 "
                  f"{split:.4f}), {kv._profile(call)}", flush=True)
        fa._fn = flash["kernel"]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    is_causal=True))[0]
        print(f"flash fp32 (B, S, H, hd) = {(B, S, H, hd)}: sdpa device_ms {sdpa:.4f}",
              flush=True)


def _run_parent(tree):
    env = dict(os.environ, REPRO_TORCH_BUILD=os.path.join(HERE, "build", "parent_build"))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--as-parent", tree], env=env,
                   check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--as-parent"]:
        parent(os.path.abspath(sys.argv[2]))
    else:
        tree = sys.argv[2] if sys.argv[1:2] == ["--parent"] else None
        if tree:
            _run_parent(tree)
        main()
        if tree:
            _run_parent(tree)
