#!/usr/bin/env python3
"""Whether the flash kernel's hd 64 and hd 128 bodies (bf16 and split-TF32
fp32) keep their bits across the change that added hd 192, on one GPU.

    python3 tools/flash_bits.py

Runs ``flash_attention_kernel`` at ``chip_smoke.py`` phase 3's and phase
3m's flash shapes with hd 64 or 128, in bf16 and fp32, on inputs drawn by
numpy from seed 0 (the same bytes on any card and torch version), and
compares a digest of each output with ``BEFORE``, the digest the kernel
gave before hd 192 was added, on an H100 80GB HBM3.  It prints "the same
bits" for each case, or the digests and the error against the plain
version and the oracle, and exits 1 if any case's bits differ.
"""
import hashlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# (B, Sq, Sk, H, hd, dtype) -> the first 16 hex digits of the sha256 of
# the output's bytes, before hd 192 (H100 80GB HBM3)
BEFORE = {
    (2, 2048, 2048, 16, 64, "bf16"): "72f11fbcd625b00c",
    (2, 2048, 2048, 16, 64, "fp32"): "9d072f6b20eb3d89",
    (1, 17, 17, 3, 64, "fp32"): "59ed4c4abfe2e174",
    (2, 100, 100, 4, 64, "bf16"): "6b978a0d8bd00b4f",
    (1, 100, 200, 2, 64, "fp32"): "c423b85d60f8ea32",
    (2, 64, 128, 4, 128, "bf16"): "83898200eafc5795",
    (1, 130, 301, 2, 64, "bf16"): "25de0aca454a0446",
    (2, 2304, 2304, 16, 128, "bf16"): "997821ed0941c582",
    (1, 200, 331, 2, 128, "bf16"): "1807b515778c1e9d",
    (2, 64, 128, 4, 128, "fp32"): "e611313fccae1be8",
    (1, 130, 301, 2, 64, "fp32"): "d169f30bd2380a79",
    (1, 200, 331, 2, 128, "fp32"): "b1d65ca52de86666",
    (2, 2304, 2304, 16, 128, "fp32"): "af93f045c64d69b2",
}


def _inputs(B, Sq, Sk, H, hd, kind, seed=0):
    """q, k, v drawn by numpy, on the card in the case's dtype."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return [torch.from_numpy(rng.standard_normal((B, s, H, hd),
                                                 dtype=np.float32))
            .cuda().to(dtype) for s in (Sq, Sk, Sk)]


def check(case):
    """-> True when the case's output has its digest of before hd 192."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = _inputs(*case)
    got = fa.flash_attention_kernel(q, k, v)
    digest = hashlib.sha256(got.float().cpu().numpy().tobytes()) \
        .hexdigest()[:16]
    want = BEFORE[case]
    if digest == want:
        print(f"flash {case} (numpy seed 0): the same bits as before hd "
              f"192 ({digest})", flush=True)
        return True
    plain = ref.flash_attention_plain(q, k, v)
    oracle = ref.flash_attention_ref(q, k, v)
    print(f"flash {case} (numpy seed 0): digest {digest}, before {want}; "
          f"rel vs plain {cs.rel_err(got, plain):.3e}, vs oracle "
          f"{cs.rel_err(got, oracle):.3e}", flush=True)
    return False


def main():
    cs.phase_env()
    ok = [check(case) for case in BEFORE]
    sys.exit(0 if all(ok) else 1)


if __name__ == "__main__":
    main()
