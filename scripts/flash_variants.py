#!/usr/bin/env python3
"""Where the flash kernels' time goes: time B3/B4 built from edited copies
of ``heat_tpu_torch/csrc/flash_attention.cu``, on one NVIDIA GPU.

    python3 scripts/flash_variants.py [--out FILE]

Each variant is the kernel source with one edit, built with the flags of
``heat_tpu_torch.kernels`` into ``build/flash_variants/<name>/`` (one
``nvcc`` each, all started together) and swapped in under the wrapper:

* ``as_is``      -- the source unchanged;
* ``fast_exp``   -- the softmax's IEEE ``expf`` replaced by ``__expf``
  (wrong in the last bits: how much of the time the accurate exp costs);
* ``no_exp``     -- no exponential at all (wrong results: the cost of the
  rest of the tile loop);
* ``two_stages`` -- a 2-stage K/V ring instead of 3 (how much the deeper
  ring buys).

Timed with ``chip_smoke.device_ms`` at the reference benchmark's shapes:
B3 bf16, bf16 causal and f32 causal at S=4096, H=16, D=64, and B4 at the
zig-zag ring's round fold (bf16, 64 rows x 512 x 512, D=64), in the order
as_is, the edits, as_is again.  Prints one JSON line per variant and the
card's name and power limit; ``--out`` also writes the lines to FILE.
Only ``as_is`` gives right answers; the others are for timing.  It builds
four libraries, so it is not part of the usual card run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: variant -> (pattern, replacement) edits of flash_attention.cu
VARIANTS = {
    "as_is": [],
    "fast_exp": [(r"sc\[i\] = expf\(sc\[i\] - safe_m\[r\]\);",
                  "sc[i] = __expf(sc[i] - safe_m[r]);")],
    "no_exp": [(r"sc\[i\] = expf\(sc\[i\] - safe_m\[r\]\);", "sc[i] = sc[i] - safe_m[r];")],
    "two_stages": [(r"static constexpr int kStages = [^;]*;", "static constexpr int kStages = 2;")],
}


def build(kernels) -> dict:
    """Build every variant; returns name -> library path."""
    csrc = kernels.CSRC
    src = (csrc / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise SystemExit(f"flash_variants: edit {pattern!r} of {name} matched {n} times")
        out = ROOT / "build" / "flash_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_attention.cu").write_text(text)
        for header in csrc.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        cmd = [kernels._nvcc(), *kernels._flags("flash_attention"), "-o", str(out / "lib.so"),
               str(out / "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out / "lib.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"flash_variants: {name} did not build:\n{log[-3000:]}")
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from heat_tpu_torch import kernels

    fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")
    libs = build(kernels)
    dev = torch.device("cuda", 0)
    S, H, D = cs.ATTN_S, cs.ATTN_H, cs.ATTN_D
    b3 = {
        (dt, causal): [tuple(cs.attn_inputs((1, S, H, D), dt, seed=100 + i, dev=dev))
                       for i in range(3)]
        for dt, causal in ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True))
    }
    P, Lh = cs.POSITIONS, S // cs.POSITIONS // 2
    rows = P * H
    b4 = []
    for i in range(3):
        q, k, v = cs.attn_inputs((rows, Lh, D), torch.bfloat16, seed=200 + i, dev=dev)
        m0, l0 = cs.attn_inputs((rows, Lh), torch.float32, seed=300 + i, dev=dev, n=2)
        acc0 = cs.attn_inputs((rows, Lh, D), torch.float32, seed=400 + i, dev=dev, n=1)[0]
        b4.append((q, k, v, m0, l0.abs() + 1.0, acc0))
    bases = (torch.arange(P, device=dev) * Lh, torch.zeros(P, dtype=torch.int64, device=dev))

    card = cs.card_line()
    lines = []
    for name in ["as_is", *[n for n in VARIANTS if n != "as_is"], "as_is"]:
        lib = fa._declare(ctypes.CDLL(str(libs[name])))
        fa._lib = lambda lib=lib: lib
        row = {"variant": name, "card": card}
        for (dt, causal), argsets in b3.items():
            key = f"b3_{str(dt).removeprefix('torch.')}{'_causal' if causal else ''}_us"
            row[key] = 1e3 * cs.device_ms(lambda a, b, c: fa.flash_attention(a, b, c, causal),
                                          argsets)
        row["b4_round_fold_us"] = 1e3 * cs.device_ms(
            lambda *a: fa.flash_attention_partial(*a, *bases), b4)
        row["clocks_sm_power"] = cs.smi("clocks.sm,power.draw")
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    print(card)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
