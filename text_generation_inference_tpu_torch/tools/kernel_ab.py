"""A/B timing of one kernel library against other versions of its source,
in one process on one card:

    python -m text_generation_inference_tpu_torch.tools.kernel_ab \\
        flash_prefill other/flash_prefill_a.cu other/flash_prefill_b.cu

`--only TEXT` (before the sources) runs only the checks whose label holds
TEXT, or one of TEXT's comma-separated parts, e.g. `--only S2` for the
ring-decode checks of slot_attention. `--plans` (int4_matmul, int4_mlp)
runs K1's decode checks, or M1's, once for each of 1, 2, 4 and 8 blocks an
SM in the split plan (`int4_matmul.BLOCKS_PER_SM`, which M1's plans and the
two-K1 route beside it read too). `--tiles` (flash_prefill) runs its
checks once for each of three row tiles (`flash_prefill.row_tile`): the
rule, the whole kv group (gs = G, rows // G tokens: the earlier tile, part
of whose rows idle where G does not divide the block's rows) and half the
rule's heads (gs // 2, twice its tokens).

Libraries with checks: flash_prefill (bf16 at every served shape of
`FLASH_SHAPES`: D 64 / 128 / 192 / 256, the multi-query groups of
StarCoder, its rank and Falcon-7B, Qwen2's groups of 6 and 7, groups of 64
and 128, a window, ALiBi, fp16; and the fp32 body at D 64 / 128),
paged_attention (the bf16 kernel in both modes, K2 at
7B and TinyLlama widths; the fp32 body in both modes at both widths and K2
with an fp32 q: labels `fp32 stats=...`, `int8 fp32q`), slot_attention
(S1 in bf16 and fp32 at both widths, S2 at three ring steps and in fp32
at step 32), int4_matmul (label `K1`: a 7B layer's four products at M = 16
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
name and power limit, each source's ptxas lines that report registers,
spills or serialized wgmma instructions, and one JSON line per check.
Needs the card and `chip_smoke.py` at the repository root.
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


# flash prefill's bf16 checks: label, check_flash_prefill's arguments
# (T = 2048 and lengths 1500 / 900 unless given)
FLASH_SHAPES = [
    ("D=64 KV=4 G=8", dict(d=64, kh=4, g=8)),
    ("D=128 KV=8 G=4", dict(d=128, kh=8, g=4)),
    ("D=128 KV=32 G=1", dict(d=128, kh=32, g=1)),
    ("starcoder D=128 KV=1 G=48", dict(d=128, kh=1, g=48, lens=(2000, 1500))),
    ("starcoder rank D=128 KV=1 G=24",
     dict(d=128, kh=1, g=24, lens=(2000, 1500))),
    ("falcon-7b D=64 KV=1 G=71", dict(d=64, kh=1, g=71, lens=(2000, 1500))),
    ("gemma-7b D=256 KV=16 G=1", dict(d=256, kh=16, g=1)),
    ("gemma-2b D=256 KV=1 G=8", dict(d=256, kh=1, g=8)),
    ("D=192 KV=2 G=8", dict(d=192, kh=2, g=8)),
    ("qwen2-7b D=128 KV=4 G=7", dict(d=128, kh=4, g=7)),
    ("qwen2-1.5b D=128 KV=2 G=6", dict(d=128, kh=2, g=6)),
    ("group64 D=128 KV=1 G=64", dict(d=128, kh=1, g=64)),
    ("group128 D=128 KV=1 G=128", dict(d=128, kh=1, g=128)),
    ("window512 D=128 KV=8 G=4", dict(d=128, kh=8, g=4, window=512)),
    ("alibi D=128 KV=32 G=1",
     dict(d=128, kh=32, g=1, lens=(2000, 1500), alibi=True)),
    ("fp16 D=128 KV=8 G=4", dict(d=128, kh=8, g=4, dtype="float16")),
]


def _tiles(library: str, tiles: bool):
    """(label suffix, row_tile) of the flash row tiles to run."""
    if not tiles:
        return [("", None)]
    if library != "flash_prefill":
        raise SystemExit("kernel_ab: --tiles is for flash_prefill")
    from ..ops.cuda import flash_prefill as fp

    rule = fp.row_tile

    def group(g, block_m=fp.BLOCK_M):
        return g, block_m // g

    def half(g, block_m=fp.BLOCK_M):
        gs = max(1, rule(g, block_m)[0] // 2)
        return gs, block_m // gs

    return [(" tile rule", rule), (" tile group", group), (" tile half", half)]


def _checks(cs, torch, timer, library: str, only: str = ""):
    """(label, result) of chip_smoke's checks of one library, those whose
    label holds `only` or one of its comma-separated parts; a check runs
    only when its label is taken."""
    if library == "flash_prefill":
        checks = [(label, lambda kw=kw: cs.check_flash_prefill(
                       torch, timer, **{**kw, "dtype": getattr(
                           torch, kw.get("dtype", "bfloat16"))}))
                  for label, kw in FLASH_SHAPES]
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
        # the fp32 body at TinyLlama's and Llama-2-7B's decode widths, and
        # K2 with an fp32 q
        checks += [(f"fp32 stats={st} D={d} KV={kh} G={g}",
                    lambda st=st, kh=kh, g=g, d=d: cs.check_paged(
                        torch, timer, st, torch.float32, kh=kh, g=g, d=d))
                   for kh, g, d in ((4, 8, 64), (32, 1, 128))
                   for st in (False, True)]
        checks += [("int8 fp32q D=64 KV=4 G=8",
                    lambda: cs.check_paged_int8(torch, timer, kh=4, g=8,
                                                d=64, dtype=torch.float32))]
    elif library == "slot_attention":
        checks = [(f"S1 {name} D={d} KV={kh} G={g}",
                   lambda kh=kh, g=g, d=d, dt=dt: cs.check_slot_decode(
                       torch, timer, s=16, kh=kh, g=g, d=d, dtype=dt))
                  for name, dt in (("bf16", torch.bfloat16),
                                   ("fp32", torch.float32))
                  for kh, g, d in ((4, 8, 64), (32, 1, 128))]
        checks += [(f"S2 step {step}",
                    lambda step=step: cs.check_ring_decode(torch, timer,
                                                           step))
                   for step in (0, 32, 63)]
        checks += [("S2 fp32 step 32",
                    lambda: cs.check_ring_decode(torch, timer, 32,
                                                 dtype=torch.float32))]
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
        if any(part in label for part in only.split(",")):
            yield label, check()


def _ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "C75" in line]


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
    tiles = len(argv) > 1 and argv[1] == "--tiles"
    if tiles:
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
    from ..ops.cuda import flash_prefill as fp
    from ..ops.cuda import int4_matmul as im

    blocks_per_sm, row_tile = im.BLOCKS_PER_SM, fp.row_tile
    variants = [(p + t, plan, tile) for p, plan in _plans(library, plans)
                for t, tile in _tiles(library, tiles)]
    for name in order:
        build._libs[library] = builds[name]
        for suffix, plan, tile in variants:
            if plan is not None:
                im.BLOCKS_PER_SM = plan
            if tile is not None:
                fp.row_tile = tile
            for label, res in _checks(cs, torch, timer, library, only):
                print(json.dumps({"build": name, "check": label + suffix,
                                  **res}), flush=True)
    im.BLOCKS_PER_SM, fp.row_tile = blocks_per_sm, row_tile
    build._libs[library] = builds["checkout"]
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
