#!/usr/bin/env python3
"""The share of blob labels the JAX package's Spectral recovers, up to a
permutation of the labels, on every 250th row (2 000 rows) of the
reference benchmark's blobs, with the settings ``chip_smoke.py`` phase 8
fits the port at on 20 000 rows: rbf, ``gamma`` 1e-3, 300 Lanczos steps,
8 clusters.  Phase 8 holds the port's labels on the card to at least this
share.  Runs the JAX package on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/spectral_reference_share.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import heat_tpu as ht  # noqa: E402


def main() -> None:
    data, _ = chip_smoke.make_blobs()
    truth = np.repeat(np.arange(chip_smoke.K), chip_smoke.N // chip_smoke.K)
    x, t = data[::250], truth[::250]
    sp = ht.cluster.Spectral(
        n_clusters=chip_smoke.K, gamma=chip_smoke.SPECTRAL_GAMMA, metric="rbf",
        n_lanczos=chip_smoke.SPECTRAL_M,
    ).fit(ht.array(x, split=0))
    share = chip_smoke.label_share(np.asarray(sp.labels_.numpy()), t, chip_smoke.K)
    print(f"reference Spectral on {len(x)} rows of the blobs: label share {share}")


if __name__ == "__main__":
    main()
