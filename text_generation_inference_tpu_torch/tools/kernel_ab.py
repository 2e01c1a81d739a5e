"""A/B timing of one kernel library against other versions of its source,
in one process on one card:

    python -m text_generation_inference_tpu_torch.tools.kernel_ab \\
        flash_prefill other/flash_prefill_a.cu other/flash_prefill_b.cu

`--only TEXT` (before the sources) runs only the checks whose label holds
TEXT, e.g. `--only S2` for the ring-decode checks of slot_attention.
`--plans` (int4_matmul, int4_mlp) runs K1's decode checks, or M1's, once
for each of 1, 2, 4 and 8 blocks an SM in the split plan
(`int4_matmul.BLOCKS_PER_SM`, which M1's plans and the two-K1 route
beside it read too).

Libraries with checks: flash_prefill (bf16 at D 64 / 128, and the fp32
body at D 64 / 128), paged_attention (the bf16 kernel in both modes, K2 at
7B and TinyLlama widths), slot_attention (S1 at both widths, S2 at three
ring steps), int4_matmul (label `K1`: a 7B layer's four products at M = 16
and at M = 2048) and int4_mlp (label `M1`: a 7B layer's MLP at M = 16 and
64, each with the two-K1 route's time on the same work). A version is any source with the
library's C entry points: a copy with other constants (beside its own
copy of any header it includes), or a file that includes an older source
under other entry names and defines the checkout's entries over them.

Builds `csrc/<library>.cu` as the port builds it, and each other source
with the same nvcc flags, then runs `chip_smoke.py`'s kernel checks of that
library with each build in turn: the checkout's first, then the others, then
again in reverse order (so drift on the card shows as a difference between
a build's two passes). Each check holds the kernel against its plain
version and times it as `chip_smoke.py` does (CUDA events, the L2 flushed
before every launch; a wrong result stops the run). Prints the card's
name and power limit, each source's ptxas lines that report registers or
serialized wgmma instructions, and one JSON line per check. Needs the
card and `chip_smoke.py` at the repository root.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from ..ops.cuda import build

REPO_ROOT = build.PACKAGE_DIR.parent


def _plans(library: str, plans: bool):
    """(label suffix, BLOCKS_PER_SM) of the split plans to run."""
    if not plans:
        return [("", None)]
    if library not in ("int4_matmul", "int4_mlp"):
        raise SystemExit("kernel_ab: --plans is for int4_matmul and int4_mlp")
    return [(f" plan {b}/SM", b) for b in (1, 2, 4, 8)]


def _checks(cs, torch, timer, library: str, only: str = ""):
    """(label, result) of chip_smoke's checks of one library, those whose
    label holds `only`; a check runs only when its label is taken."""
    if library == "flash_prefill":
        checks = [(f"D={d} KV={kh} G={g}",
                   lambda d=d, kh=kh, g=g: cs.check_flash_prefill(
                       torch, timer, d=d, kh=kh, g=g))
                  for d, kh, g in ((64, 4, 8), (128, 8, 4), (128, 32, 1))]
        # the fp32 body at TinyLlama's heads and at D = 128
        checks += [(f"fp32 D={d} KV={kh} G={g}",
                    lambda d=d, kh=kh, g=g: cs.check_flash_prefill(
                        torch, timer, d=d, kh=kh, g=g, dtype=torch.float32))
                   for d, kh, g in ((64, 4, 8), (128, 8, 4))]
    elif library == "paged_attention":
        checks = [(f"bf16 stats={st}",
                   lambda st=st: cs.check_paged(torch, timer, st))
                  for st in (False, True)]
        checks += [("int8 stats D=128 KV=32 G=1",
                    lambda: cs.check_paged_int8(torch, timer)),
                   ("int8 stats D=64 KV=4 G=8",
                    lambda: cs.check_paged_int8(torch, timer, kh=4, g=8,
                                                d=64))]
    elif library == "slot_attention":
        checks = [(f"S1 D={d} KV={kh} G={g}",
                   lambda kh=kh, g=g, d=d: cs.check_slot_decode(
                       torch, timer, s=16, kh=kh, g=g, d=d))
                  for kh, g, d in ((4, 8, 64), (32, 1, 128))]
        checks += [(f"S2 step {step}",
                    lambda step=step: cs.check_ring_decode(torch, timer,
                                                           step))
                   for step in (0, 32, 63)]
    elif library == "int4_matmul":
        # K1 on a 7B layer's four products, both routes: decode rows through
        # the stacked name, prefill rows through the packed name. Each
        # weight lives for the whole run (`keep`: a version may cache what
        # it derives from a weight by its address), and every version is
        # held to the earlier design's tolerance (that kernel rounds each
        # weight to bf16)
        checks = [(f"K1 {route} M={m} {key}",
                   lambda key=key, m=m, entry=entry: cs.check_int4(
                       torch, timer, entry, key, m, light=True, keep=True,
                       loose=True))
                  for route, m, entry in (
                      ("decode", 16, "int4_matmul_s4_stacked"),
                      ("prefill", 2048, "int4_matmul"))
                  for key in cs.K1_SHAPES]
    elif library == "int4_mlp":
        # M1 on a 7B layer's MLP at decode rows, beside the two-K1 route on
        # the same work (`two_k1_ms`); one pair of weights for the run
        checks = [(f"M1 M={m}",
                   lambda m=m: cs.check_int4_mlp(torch, timer, m, "silu_glu",
                                                 keep=True))
                  for m in (16, 64)]
    else:
        raise SystemExit(f"kernel_ab: no checks for library {library!r}")
    for label, check in checks:
        if only in label:
            yield label, check()


def _ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "C75" in line]


def _load(library: str, source: Path, out_dir: Path) -> ctypes.CDLL:
    """Build another version of a library's source and load it with the
    library's argument types."""
    target = out_dir / f"lib{library}-ab-{source.parent.name}-{source.stem}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(target),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in _ptxas_lines(proc.stdout + proc.stderr):
        print(f"ptxas[{source}] {line}", flush=True)
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in build._SIGNATURES[library].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, build._ERROR_STRING[library])
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def main(argv: list[str]) -> int:
    import torch

    if len(argv) < 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke as cs

    only = ""
    if len(argv) > 2 and argv[1] == "--only":
        only, argv = argv[2], argv[:1] + argv[3:]
    plans = len(argv) > 1 and argv[1] == "--plans"
    if plans:
        argv = argv[:1] + argv[2:]
    library, others = argv[0], [Path(p).resolve() for p in argv[1:]]
    cs.DTYPE = torch.bfloat16
    log = build.build_all()[library]
    for line in _ptxas_lines(log):
        print(f"ptxas[csrc/{library}.cu] {line}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    builds = {"checkout": build.library(library)}
    for src in others:
        builds[str(src)] = _load(library, src, build.BUILD_DIR)
    timer = cs.Timer(torch)
    order = list(builds) + list(reversed(builds))
    from ..ops.cuda import int4_matmul as im

    blocks_per_sm = im.BLOCKS_PER_SM
    for name in order:
        build._libs[library] = builds[name]
        for suffix, plan in _plans(library, plans):
            if plan is not None:
                im.BLOCKS_PER_SM = plan
            for label, res in _checks(cs, torch, timer, library, only):
                print(json.dumps({"build": name, "check": label + suffix,
                                  **res}), flush=True)
    im.BLOCKS_PER_SM = blocks_per_sm
    build._libs[library] = builds["checkout"]
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
