"""Host cost of the port's dispatch path, to compare two trees on one card.

Loads ``heat_tpu_torch`` from ``--tree`` (a checkout of the repo) and
times, on the card, calls whose wall time is mostly host work:

* ``op_us`` / ``op_us_min``: one eager ``x + x`` on a (4, 4) float32
  array, 1 position (the median and the least of 7 samples of 2 000
  calls, fenced by a synchronise; the least is the steadier reading on a
  shared host);
* ``allreduce_off_ms`` / ``allreduce_on_ms``: ``comm.allreduce`` of a
  (4, 2^20) float32 array under ``collective_precision("int8_block")`` at
  4 positions, telemetry off and on (chip_smoke.py phase 12's call);
* ``lasso_cd_ms``: a Lasso cd fit of 50 sweeps on the blobs with the
  intercept, 1 position (phase 7's);
* ``ring_attention_ms``: bf16 zig-zag causal ring attention, S = 4096,
  H = 16, D = 64 at 4 positions (phase 6's);
* ``kmeans_predict_ms``: ``KMeans.predict`` on the blobs, k = 8;
* ``allreduce_profile_calls`` / ``allreduce_profile_ms``: Python function
  calls and profiled host time a call of the telemetry-off allreduce,
  over 200 calls under ``cProfile`` (host work alone, no device wait).

Each is the median of 7 synchronised calls after a warm-up.  Host timings
move between runs and hosts, so compare two trees inside one call, in the
order parent, change, change, parent::

    python scripts/host_overhead.py --tree build/parent --label parent
    python scripts/host_overhead.py --tree . --label change

Prints one JSON line (``--out`` appends it to a file too).
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import subprocess
import sys
import time

import numpy as np

N, F, K = 500_000, 32, 8
POSITIONS, PAYLOAD = 4, 1 << 20
REPS = 7


def samples_ms(torch, fn, reps: int = REPS) -> list:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def wall_ms(torch, fn, reps: int = REPS) -> float:
    return float(np.median(samples_ms(torch, fn, reps)))


def blobs():
    """The reference benchmark's blobs (bench.py make_blobs, seed 0)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10, size=(K, F)).astype(np.float32)
    data = np.concatenate([c + rng.normal(size=(N // K, F)).astype(np.float32) for c in centers])
    return data, centers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout whose heat_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import heat_tpu_torch as htt
    from heat_tpu_torch import kernels
    from heat_tpu_torch import telemetry as tel
    from heat_tpu_torch.comm import compressed as cq

    if not torch.cuda.is_available():
        print("host_overhead: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.abspath(htt.__file__).startswith(tree + os.sep):
        print(f"host_overhead: heat_tpu_torch came from {htt.__file__}, not {tree}", file=sys.stderr)
        return 2
    kernels.build_all()
    dev = torch.device("cuda", 0)
    comm1 = htt.TorchCommunication([dev])
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    row = {"label": args.label or tree, "tree": tree}

    small = htt.array(np.ones((4, 4), np.float32), split=0, comm=comm1)

    def ops():
        for _ in range(2000):
            small + small

    op = samples_ms(torch, ops)
    row["op_us"] = float(np.median(op)) / 2000 * 1e3
    row["op_us_min"] = min(op) / 2000 * 1e3

    stacked = torch.from_numpy(np.random.default_rng(1).normal(size=(POSITIONS, PAYLOAD))
                               .astype(np.float32)).to(dev)
    with cq.collective_precision("int8_block"):
        row["allreduce_off_ms"] = wall_ms(torch, lambda: comm4.allreduce(stacked, "sum"))
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(200):
            comm4.allreduce(stacked, "sum")
        prof.disable()
        torch.cuda.synchronize()
        stats = prof.getstats()
        row["allreduce_profile_calls"] = sum(e.callcount for e in stats) / 200
        row["allreduce_profile_ms"] = sum(e.inlinetime for e in stats) / 200 * 1e3
        tel.enable()
        try:
            row["allreduce_on_ms"] = wall_ms(torch, lambda: comm4.allreduce(stacked, "sum"))
        finally:
            tel.disable()

    data, centers = blobs()
    X1 = htt.array(data, split=0, comm=comm1)
    y = (data @ np.arange(1, F + 1, dtype=np.float32) / F
         + np.random.default_rng(1).normal(size=N).astype(np.float32))
    Y1 = htt.array(y, split=0, comm=comm1)
    Lasso = htt.regression.Lasso
    row["lasso_cd_ms"] = wall_ms(torch, lambda: Lasso(lam=0.1, max_iter=50, tol=-1.0).fit(X1, Y1), reps=3)

    rng = np.random.default_rng(501)
    q, k, v = (htt.array(torch.from_numpy(rng.normal(size=(4096, 16, 64)).astype(np.float32))
                         .to(dev).to(torch.bfloat16), split=0, comm=comm4) for _ in range(3))
    row["ring_attention_ms"] = wall_ms(torch, lambda: htt.parallel.ring_attention(q, k, v, causal=True))

    km = htt.cluster.KMeans(n_clusters=K, init=htt.array(centers, comm=comm1), max_iter=2).fit(X1)
    row["kmeans_predict_ms"] = wall_ms(torch, lambda: km.predict(X1))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    row["card"] = card[0] if card else torch.cuda.get_device_name(0)
    line = json.dumps(row)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
