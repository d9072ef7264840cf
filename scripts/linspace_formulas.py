#!/usr/bin/env python3
"""Why the port's ``linspace`` follows the reference's compiled float64
formula: counts, for three formulas of the float64 grid, the grids of
``tests/test_torch_factories_indexing.py`` (and of the float64, float16
and int32 cases) that are not bitwise the JAX package's.

- ``plain``: ``start * (1 - i/d) + stop * i/d``;
- ``fma``: ``fma(i, stop/d, start * (1 - i * (1/d)))``, the final FMA only;
- ``port``: ``heat_tpu_torch.linspace`` (the FMAs of the vectorized loop too).

Runs both packages on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/linspace_formulas.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import heat_tpu as ht  # noqa: E402
import heat_tpu_torch as htt  # noqa: E402
from heat_tpu_torch.core import factories  # noqa: E402

#: the float32 grids of test_linspace_float32_is_bitwise_the_reference
FLOAT32_GRIDS = [(0.1, 7.3, 11), (-3, 2, 50), (0, 1, 1), (5, -5, 1001), (-5.5, 12.25, 9999),
                 (1e-3, 1e3, 257), (2, 2, 7), (-7, 3, 174), (17.5, -2.25, 173), (-4, 5, 100),
                 (7, -1, 57), (-3, 2, 500_000)]
OTHER_NUMS = (40, 173, 174, 999, 1001, 4097, 500_000)


def grid(kind: str, start: float, stop: float, num: int, endpoint: bool, dtype) -> np.ndarray:
    if kind == "port":
        return htt.linspace(start, stop, num, endpoint=endpoint, dtype=getattr(htt, dtype)).numpy()
    if num == 1:
        g = torch.full((1,), float(start), dtype=torch.float64)
    else:
        d = num - 1 if endpoint else num
        i = torch.arange(d, dtype=torch.float64)
        if kind == "plain":
            g = start * (1 - i / d) + stop * (i / d)
        else:
            r = 1.0 / d
            g = factories._fma(i, stop * r, start * (1.0 - i * r))
        if endpoint:
            g = torch.cat([g, torch.full((1,), float(stop), dtype=torch.float64)])
    return g.to(getattr(torch, dtype)).numpy()


def differs(got: np.ndarray, want: np.ndarray) -> int:
    if got.dtype.kind == "f":
        got, want = got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}")
    return int((got != want).sum())


def main() -> None:
    htt.use_device("cpu")
    cases = [(a, b, n, ep, "float32") for a, b, n in FLOAT32_GRIDS for ep in (True, False)]
    cases += [(-3, 2, n, ep, dt) for n in OTHER_NUMS for ep in (True, False)
              for dt in ("float64", "float16", "int32")]
    for kind in ("plain", "fma", "port"):
        bad = {}
        for start, stop, num, ep, dt in cases:
            want = np.asarray(ht.linspace(start, stop, num, endpoint=ep, dtype=getattr(ht, dt)).numpy())
            n = differs(grid(kind, start, stop, num, ep, dt), want)
            if n:
                bad.setdefault(dt, []).append(f"{num}{'' if ep else ' open'}: {n}/{num}")
        total = {dt: sum(1 for c in cases if c[4] == dt) for dt in ("float32", "float64", "float16", "int32")}
        print(f"{kind}: grids not bitwise the reference's, of {total}:")
        for dt, rows in bad.items():
            print(f"  {dt} {len(rows)}: {', '.join(rows)}")


if __name__ == "__main__":
    main()
