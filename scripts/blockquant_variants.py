#!/usr/bin/env python3
"""Where the block-quantize kernels' time goes: time ``blockquant_quantize``
and the ring hop ``blockquant_dequantize_add_quantize`` built from edited
copies of ``heat_tpu_torch/csrc/blockquant.cu``, on one NVIDIA GPU.

    python3 scripts/blockquant_variants.py [--out FILE] [--baseline FILE]

Each variant is the kernel source with one edit, built with the flags of
``heat_tpu_torch.kernels`` into ``build/blockquant_variants/<name>/`` (one
``nvcc`` each, all started together) and swapped in under the wrappers:

* ``as_is``      -- the source unchanged: the slab ring (bulk copies of
  4-row slabs into a 16-stage shared-memory ring, one producer thread,
  8 consumer warps taking turns at the slabs, 8 lanes a row, two CTAs
  per SM, launched with programmatic dependent launch);
* ``registers``  -- quantize without shared memory: each warp loads 8
  rows' float4s into registers before it reduces any
  (``scripts/blockquant_registers.cuh``, included into the copy; the hop
  keeps the ring);
* ``ieee_div``   -- every quotient through ``__fdiv_rn`` instead of the
  reciprocal with two exact corrections (the same bits, more instructions);
* ``slab8``      -- 8-row slabs (two warps each) in an 8-stage ring;
* ``slab16``     -- 16-row slabs (four warps each) in a 4-stage ring;
* ``warps16``    -- 16 consumer warps, one CTA per SM;
* ``no_pdl``     -- launched without programmatic dependent launch;

and two probes that give wrong results, for timing only:

* ``no_divide``  -- the quotient replaced by x itself (what the division
  costs);
* ``load_only``  -- the ring without the tail: each warp waits for its
  slab, releases it and writes nothing (launch, copies and barriers).

Every other variant must equal the plain versions bit for bit (random,
special and near-tie blocks, 8192 and 8193 rows) before it is timed with
``chip_smoke.device_ms`` at the main path's 8192 rows (2^20 values,
inputs rotated past the L2), in the order as_is, the edits, as_is again.
Each variant also reads quantize at the KMeans ring's 4 rows (one CTA:
the launch floor), and every reading is taken twice: back to back (32
launches of the kernel in one graph, where programmatic dependent launch
lets each overlap the one before) and behind a ring hop's roll, as the
main path launches the kernel (``*_after_roll_us``: what it adds behind
the roll, ``chip_smoke.after_ms``).  ``--baseline FILE`` also builds
another ``blockquant.cu`` (with the headers beside it; for example the
parent commit's, unpacked with ``git archive``) and times its quantize
the same ways, as ``baseline``.  One line times ``torch.amax`` over the
same 8192 x 128 inputs: one PyTorch kernel that reads the same 4 MB and
writes 32 KB, the floor of a single read of the payload under this
timing.  Prints one JSON line per variant and the card's name and power
limit; ``--out`` also writes the lines to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: variant -> (pattern, replacement) edits of blockquant.cu
VARIANTS = {
    "as_is": [],
    "registers": [
        (r"\n}  // namespace\n", '\n#include "blockquant_registers.cuh"\n\n}  // namespace\n'),
        (r'(extern "C" int blockquant_quantize\([^)]*\) \{\n)[\s\S]*?\n}\n',
         r"\1  return quantize_registers(x, q, scale, rows, stream);\n}\n"),
        (r": stream_grid<false>\(rows, ctas\);", ": registers_grid(rows, ctas, step_rows);"),
    ],
    "ieee_div": [(r"if \(finite && s >= kReciprocalMin\) \{", "if (false) {")],
    "slab8": [(r"constexpr int kSlabRows = 4;", "constexpr int kSlabRows = 8;"),
              (r"constexpr int kStages = 16;", "constexpr int kStages = 8;")],
    "slab16": [(r"constexpr int kSlabRows = 4;", "constexpr int kSlabRows = 16;"),
               (r"constexpr int kStages = 16;", "constexpr int kStages = 4;")],
    "warps16": [(r"constexpr int kConsumerWarps = 8;", "constexpr int kConsumerWarps = 16;"),
                (r"constexpr int kCtasPerSm = 2;", "constexpr int kCtasPerSm = 1;")],
    "no_pdl": [(r'  asm volatile\("griddepcontrol\.wait;\\n" ::: "memory"\);\n'
                r'  asm volatile\("griddepcontrol\.launch_dependents;\\n" ::: "memory"\);\n', ""),
               (r"cfg\.numAttrs = 1;", "cfg.numAttrs = 0;")],
    "no_divide": [(r"float q = __fmul_rn\(v, y\);\n  q = __fmaf_rn[^\n]*\n  q = __fmaf_rn[^\n]*\n",
                   "float q = v;\n")],
    "load_only": [(r"quantize_tail\(v, q \+ row \* \(kBlock / 4\), scale \+ row, sub, rot, live\);",
                   "if (live && v[0].x == 12345.0f) q[row] = make_char4(1, 1, 1, 1);")],
}
#: probes whose results are wrong: timed, not checked
PROBES = ("no_divide", "load_only")


def _compile(kernels, name: str, text: str, headers) -> tuple:
    """Start one ``nvcc`` of ``text`` (with ``headers`` beside it) into
    ``build/blockquant_variants/<name>/lib.so``; returns (process, path)."""
    out = ROOT / "build" / "blockquant_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "blockquant.cu").write_text(text)
    for header in headers:
        (out / header.name).write_text(header.read_text())
    cmd = [kernels._nvcc(), *kernels._flags("blockquant"), "-o", str(out / "lib.so"),
           str(out / "blockquant.cu")]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out / "lib.so")


def build(kernels, baseline=None) -> dict:
    """Build every variant (and ``baseline``, a path to another
    ``blockquant.cu``), all at once; returns name -> library path."""
    csrc = kernels.CSRC
    src = (csrc / "blockquant.cu").read_text()
    headers = [*csrc.glob("*.cuh"), ROOT / "scripts" / "blockquant_registers.cuh"]
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                raise SystemExit(f"blockquant_variants: edit {pattern!r} of {name} matched {n} times")
        procs[name] = _compile(kernels, name, text, headers)
    if baseline is not None:
        procs["baseline"] = _compile(kernels, "baseline", baseline.read_text(),
                                     list(baseline.parent.glob("*.cuh")))
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"blockquant_variants: {name} did not build:\n{log[-3000:]}")
        libs[name] = lib
    return libs


def _load(cq, path, full: bool):
    """Load a built library and route the wrappers to it; a baseline
    (``full`` false) need only export ``blockquant_quantize``."""
    lib = ctypes.CDLL(str(path))
    if full:
        cq._declare(lib)
    else:
        lib.blockquant_quantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
        lib.blockquant_quantize.restype = ctypes.c_int
    cq._lib = lambda: lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--baseline", type=Path,
                    help="another blockquant.cu whose quantize is timed beside the variants")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("blockquant_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from heat_tpu_torch import kernels
    from heat_tpu_torch.comm import compressed as cq

    libs = build(kernels, args.baseline)
    dev = torch.device("cuda", 0)
    rows = cs.PAYLOAD // cs.BLOCK
    n = rows * cs.BLOCK
    xs = [torch.randn(n, device=dev) for _ in range(16)]  # 16 x 4 MiB: past the L2
    adds = [torch.randn(n, device=dev) for _ in range(16)]
    checks = [(torch.from_numpy(cs.payload(r, seed=r)).to(dev),
               torch.from_numpy(cs.payload(r, seed=r + 1)).to(dev)) for r in (rows, rows + 1)]
    small = [(torch.randn(4 * cs.BLOCK, device=dev),) for _ in range(16)]
    # behind a ring hop's roll, as the main path launches them (the hop:
    # the addend's roll, standing in for the ring's gather, then the payload's)
    roll_x = lambda x: cq._hop((x,), cs.POSITIONS)  # noqa: E731
    roll_payload = lambda q, s, a: cs.hop_prep(cq, q, s, a)  # noqa: E731

    card = cs.card_line()
    lines = [json.dumps({"variant": "torch.amax rows", "card": card, "us": 1e3 * cs.device_ms(
        lambda x: torch.amax(x.view(-1, cs.BLOCK), dim=1), [(x,) for x in xs])})]
    print(lines[-1], flush=True)
    order = ["as_is", *[v for v in VARIANTS if v != "as_is"], *(["baseline"] if "baseline" in libs else []),
             "as_is"]
    for name in order:
        full = name != "baseline"
        _load(cq, libs[name], full)
        for x, a in checks if name not in PROBES else ():
            q, s = cq.quantize_blocks(x)
            qp, sp = cq.quantize_blocks_plain(x.reshape(-1, cs.BLOCK))
            pairs = [("quantize q", q, qp), ("quantize scale", s, sp)]
            if full:
                h, hs = cq.dequantize_add_quantize_blocks(q, s, a)
                hp, hsp = cq.dequantize_add_quantize_blocks_plain(q, s, a)
                pairs += [("hop q", h, hp), ("hop scale", hs, hsp)]
            torch.cuda.synchronize()
            for what, got, want in pairs:
                cs.check(cs.bitwise_equal(got, want), f"{name}: {what} != plain at {x.numel() // cs.BLOCK} rows")
        row = {"variant": name, "card": card}
        if full:
            row["grid"] = cq._quantize_grid(rows)
        qargs = [(x,) for x in xs]
        row["quantize_us"] = 1e3 * cs.device_ms(cq.quantize_blocks, qargs)
        row["quantize_after_roll_us"] = 1e3 * cs.after_ms(cq.quantize_blocks, roll_x, qargs)[0]
        row["quantize_4rows_us"] = 1e3 * cs.device_ms(cq.quantize_blocks, small)
        row["quantize_4rows_after_roll_us"] = 1e3 * cs.after_ms(cq.quantize_blocks, roll_x, small)[0]
        if full:
            hargs = [(*cq.quantize_blocks(x), a) for x, a in zip(xs, adds)]
            row["hop_us"] = 1e3 * cs.device_ms(cq.dequantize_add_quantize_blocks, hargs)
            row["hop_after_roll_us"] = 1e3 * cs.after_ms(cq.dequantize_add_quantize_blocks,
                                                         roll_payload, hargs)[0]
        row["clocks_sm_power"] = cs.smi("clocks.sm,power.draw")
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    print(card)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
