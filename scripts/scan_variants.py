#!/usr/bin/env python3
"""The block size of the port's long cumulative ops, on one GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/scan_variants.py [--out FILE]

``heat_tpu_torch.parallel.primitives.local_scan`` scans an axis longer
than two blocks in blocks of ``SCAN_BLOCK`` rows.  On ``chip_smoke.py``
phase 9's 500 000 x 32 float32 blobs (and 131 072 x 64), this times a
``cumsum`` along axis 0 at 1 and 4 positions for each block size in
``BLOCKS``, and for reference torch's own ``cumsum`` along the outer axis
and along the inner axis of a transposed copy: device time of one call
(``chip_smoke.device_ms``: 32 calls in one CUDA graph).  Each blocked
result is held to float64 numpy within ``gamma_k * sum|x|``.

Prints one JSON object per reading and, last, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

BLOCKS = (64, 128, 256, 512, 1024, 2048)
SHAPES = ((500_000, 32), (131_072, 64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    import heat_tpu_torch as htt
    from heat_tpu_torch.parallel import primitives

    dev = torch.device("cuda", 0)
    lines = []

    def emit(row):
        lines.append(json.dumps(row))
        print(lines[-1])

    rng = np.random.default_rng(0)
    for rows, cols in SHAPES:
        data = rng.normal(size=(rows, cols)).astype(np.float32)
        x = torch.from_numpy(data).to(dev)
        k = np.arange(1, rows + 1, dtype=np.float64)[:, None]
        bound = chip_smoke.gamma(k) * np.cumsum(np.abs(data.astype(np.float64)), 0)
        exact = np.cumsum(data.astype(np.float64), 0)
        emit({"shape": [rows, cols], "route": "torch.cumsum outer axis",
              "device_ms": chip_smoke.device_ms(lambda a: torch.cumsum(a, 0), [(x,)], per_graph=4, trials=3)})
        xt = x.T.contiguous()
        emit({"shape": [rows, cols], "route": "torch.cumsum inner axis (a transposed copy)",
              "device_ms": chip_smoke.device_ms(lambda a: torch.cumsum(a, 1), [(xt,)], per_graph=8, trials=5)})
        for block in BLOCKS:
            primitives.SCAN_BLOCK = block
            got = primitives.local_scan(x, "sum", 0).cpu().numpy()
            share = float((np.abs(got - exact) / bound).max())
            chip_smoke.check(share <= 1.0, f"block {block}: outside gamma_k * sum|x|")
            row = {"shape": [rows, cols], "route": "local_scan", "block": block, "err_share_of_bound": share,
                   "device_ms": chip_smoke.device_ms(lambda a: primitives.local_scan(a, "sum", 0), [(x,)])}
            for p in (1, 4):
                comm = htt.TorchCommunication([dev] * p)
                X = htt.array(x, split=0, comm=comm)
                row[f"cumsum_{p}pos_device_ms"] = chip_smoke.device_ms(lambda: htt.cumsum(X, 0), [()])
            emit(row)
    card = chip_smoke.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines + [json.dumps({"card": card})]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
