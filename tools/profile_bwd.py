"""The backward kernels alone on the card:
``python3 tools/profile_bwd.py [--time] [--scans] [--src DIR]``.

Builds ``flash_attention_bwd.cu``, ``rmsnorm_bwd.cu``, ``rglru_scan_bwd.cu``,
``mamba_scan_bwd.cu`` and the Mamba forward ``mamba_scan.cu`` (whose
checkpoints the Mamba backward reads; one nvcc each, started together) and
prints each kernel's registers and spills from the ptxas report, then holds
the kernels to their plain twins: the flash-attention and rmsnorm backward
at ``chip_smoke.py``'s ``BWD_FLASH_SHAPES`` and ``BWD_NORM_SHAPES`` (phase
14's ``phase_backward_kernels``: rtol = atol 3e-5 in float32, 2e-2 in
bfloat16; two launches equal), the two scan backward kernels at
``SCAN_BWD_RGLRU`` and ``SCAN_BWD_MAMBA`` (phase 14b's
``phase_scan_bwd_kernels``: ``torch.equal``, the Mamba backward from the
forward's checkpoints and standalone, no spill).  ``--time``: then the
timed rows (``phase_backward_timing``, ``phase_whisper_bwd_timing``,
``phase_scan_bwd_timing``: CUDA events, L2-warm and cold, beside the plain
twin, autograd of the library's forward where there is one, and the
bound).  ``--scans``: the two scan backward kernels alone.  ``--src DIR``:
the kernel modules of another checkout's ``src`` (built into that
checkout's ``build/``), held and timed by this tree's ``chip_smoke.py``
(where that tree's Mamba kernels keep no checkpoints, its backward runs
standalone only), so that two trees can be timed in turns in one call::

    python3 tools/profile_bwd.py --time --scans --src OLD/src
    python3 tools/profile_bwd.py --time --scans
    python3 tools/profile_bwd.py --time --scans
    python3 tools/profile_bwd.py --time --scans --src OLD/src

Exits non-zero if a kernel disagrees with its twin.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--scans", action="store_true",
                    help="the scan backward kernels alone")
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bwd: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import flash_attention_bwd as FB
    from repro_torch.kernels import mamba_scan as MB
    from repro_torch.kernels import mamba_scan_bwd as MBB
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan_bwd as RB
    from repro_torch.kernels import rmsnorm_bwd as NB

    cs.log(f"[device] {cs.nvidia_smi()}; torch {torch.__version__} CUDA "
           f"{torch.version.cuda}; kernels of {Path(FB.__file__).parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = [RB.LIB, MBB.LIB, MB.LIB]
    if not args.scans:
        libs = [FB.LIB, NB.LIB] + libs
    t0 = time.perf_counter()
    KB.build_all(libs)
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for name, (r, st, ld) in cs.ptxas_table(lib.report()).items():
            cs.log(f"[ptxas] {lib.source.name} {name}: {r} registers, "
                   f"{st} bytes spill stores, {ld} bytes spill loads")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.scans:
        cs.phase_backward_kernels(FB, NB, ref, gen)
    cs.check_scan_bwd_spills(RB, MBB, MB)
    cs.phase_scan_bwd_kernels(RB, MBB, MB, ref, gen)
    if args.time:
        if not args.scans:
            cs.phase_backward_timing(FB, NB, ref, gen)
            cs.phase_whisper_bwd_timing(FB, ref, gen)
        cs.phase_scan_bwd_timing(RB, MBB, MB, ref, gen)
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
