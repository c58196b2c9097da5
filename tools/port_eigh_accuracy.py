#!/usr/bin/env python3
"""How accurate ``torch.linalg.eigh`` is in float32 on the CPU (LAPACK)
and on one NVIDIA GPU (cuSOLVER, MAGMA), and in float64 on the GPU
rounded to float32 (``nd.linalg_syevd``'s path for float32), on phase 33's
matrices: 64 SPD ``B B^T + n I`` of n = 256 from ``RandomState(330)``.

    python3 tools/port_eigh_accuracy.py

Against float64 LAPACK on the host, each line prints the eigenvalues'
relative error (norm) and largest absolute error, the reconstruction
``U diag(w) U^T``'s relative error, the eigenvectors' orthogonality, the
smallest ``|dot|`` of an eigenvector with the float64 one (near 1 only
where the eigenvalue stands apart), the time of the call and the
smallest eigenvalue gap.  The card's name and power limit come first.
"""
import subprocess
import time

import numpy as np
import torch


def stats(label, w, v, spd, ref_w, ref_v, secs):
    n = spd.shape[-1]
    w = w.double().cpu().numpy()
    v = v.double().cpu().numpy()
    a = spd.astype(np.float64)
    rec = v @ (w[..., None] * v.transpose(0, 2, 1))
    print(f"{label} ({secs:.3f} s): eigenvalues rel "
          f"{np.linalg.norm(w - ref_w) / np.linalg.norm(ref_w):.3e}, max abs "
          f"{np.abs(w - ref_w).max():.3e}; reconstruction rel "
          f"{np.linalg.norm(rec - a) / np.linalg.norm(a):.3e}; orthogonality "
          f"{np.abs(v.transpose(0, 2, 1) @ v - np.eye(n)).max():.3e}; "
          f"smallest |dot| with float64 "
          f"{np.abs(np.einsum('bij,bij->bj', v, ref_v)).min():.4f}",
          flush=True)


def timed(fn):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    rng = np.random.RandomState(330)
    n = 256
    bm = rng.randn(64, n, n)
    spd = (bm @ bm.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    ref_w, ref_v = np.linalg.eigh(spd.astype(np.float64))
    print(f"eigenvalues {ref_w.min():.2f}-{ref_w.max():.1f}, smallest gap "
          f"{np.diff(ref_w, axis=-1).min():.3e}", flush=True)
    t = torch.tensor(spd)
    (w, v), secs = timed(lambda: torch.linalg.eigh(t))
    stats("CPU float32", w, v, spd, ref_w, ref_v, secs)
    if not torch.cuda.is_available():
        return
    d = t.cuda()
    torch.linalg.eigh(d[:1])                       # cuSOLVER's set-up
    for lib in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        (w, v), secs = timed(lambda: torch.linalg.eigh(d))
        stats(f"card float32 ({lib})", w, v, spd, ref_w, ref_v, secs)
    torch.backends.cuda.preferred_linalg_library("default")
    (w, v), secs = timed(lambda: torch.linalg.eigh(d.double()))
    stats("card float64, rounded to float32", w.float(), v.float(), spd,
          ref_w, ref_v, secs)


if __name__ == "__main__":
    main()
