#!/usr/bin/env python3
"""Whether moving SSD's split-TF32 helpers (``split``, ``split_step``) out
of ``csrc/ssd.cu`` into ``csrc/hopper.cuh`` kept the kernel's bits, on one
GPU.

    python3 tools/ssd_premove_bits.py

Runs ``ssd_intra_chunk_kernel`` at mamba2-370m's main shape (2, 8, 256, 32,
64, 128), with B and C per group (g = 1) and per head (g = 32), on inputs
drawn by numpy from seed 0 (the same bytes on any card and torch version),
and compares a digest of its outputs (Y_diag, then the states) with
``BEFORE``, the digest of the kernel's outputs before the move on an H100
80GB HBM3.  It prints "the same bits", or the digests and the error
against the plain version and the oracle, and exits 1 if that error is
past SSD's tolerances (``chip_smoke.SSD_PLAIN_TOL`` / ``SSD_ORACLE_TOL``).
"""
import hashlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# the first 16 hex digits of the sha256 of the outputs' bytes, by g
BEFORE = {1: "d8f8e6c214326073", 32: "8676bb98ee8e980e"}


def _inputs(shape, seed=0):
    """SSD's operands drawn by numpy, A_cumsum the fp32 cumulative sum of
    Ac, on the card."""
    import numpy as np
    import torch
    b, nc, c, h, g, p, n = shape
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, c, h, p), dtype=np.float32)
    Bc = rng.standard_normal((b, nc, c, g, n), dtype=np.float32)
    Cc = rng.standard_normal((b, nc, c, g, n), dtype=np.float32)
    Ac = (-rng.random((b, h, nc, c), dtype=np.float32)
          * np.float32(0.1)).astype(np.float32)
    acum = np.cumsum(Ac, -1, dtype=np.float32)
    return [torch.from_numpy(a).cuda() for a in (xc, Bc, Cc, Ac, acum)]


def check(g, want):
    """-> True when g's outputs are the same bits as before the move, or
    within SSD's tolerances of the plain version and the oracle."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd
    shape = (2, 8, 256, 32, g, 64, 128)
    t = _inputs(shape)
    got = ssd.ssd_intra_chunk_kernel(*t)
    digest = hashlib.sha256()
    for a in got:
        digest.update(a.cpu().numpy().tobytes())
    digest = digest.hexdigest()[:16]
    if digest == want:
        print(f"ssd {shape} (numpy seed 0): the same bits as before the "
              f"split helpers moved into hopper.cuh ({digest})", flush=True)
        return True
    xc, Bc, Cc, Ac, acum = t
    plain = ref.ssd_intra_chunk_plain(xc, Bc, Cc, acum)
    oracle = ref.ssd_intra_chunk_ref(xc, Bc, Cc, Ac, acum)
    rel_plain = max(cs.rel_err(a, w) for a, w in zip(got, plain))
    rel_oracle = max(cs.rel_err(a, w) for a, w in zip(got, oracle))
    print(f"ssd {shape} (numpy seed 0): not the bits of before the split "
          f"helpers moved (digest {digest}, was {want}); rel vs plain "
          f"{rel_plain:.3e} (tol {cs.SSD_PLAIN_TOL:g}), vs oracle "
          f"{rel_oracle:.3e} (tol {cs.SSD_ORACLE_TOL:g})", flush=True)
    return rel_plain <= cs.SSD_PLAIN_TOL and rel_oracle <= cs.SSD_ORACLE_TOL


def main():
    cs.phase_env()
    ok = [check(g, want) for g, want in BEFORE.items()]
    sys.exit(0 if all(ok) else 1)


if __name__ == "__main__":
    main()
