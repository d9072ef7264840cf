"""Ground truth for the capture rules: what the linter flags, the card refuses or freezes.

Each ``pos_*`` function below is a small fused program that the port's
linter must flag, on the lines marked ``# expect: <rules>``; each
``neg_*`` function is one it must leave alone.  The CPU tests lint this
file's own source and hold the findings of SPMD201/202/205/210 to exactly
the marked lines.  On the card (``chip_smoke.py`` phase 19 and
``tests/test_torch_card.py``) the same functions run under ``htt.fuse`` at
one position and show what each finding means there:

* SPMD202 (``REFUSED``): a host read of the card inside the capture; the
  capture is refused and the error reaches the caller.  These run in a
  process of their own (``python tests/test_torch_capture_rules.py
  --refused`` prints one JSON line), as the card's other refused captures
  do;
* SPMD201/205 (``FROZEN``): a host RNG draw or a clock read happens once,
  at capture, and every replay repeats it: two fused calls give equal
  outputs where two eager calls differ;
* SPMD210 (``OBSERVED``): ``telemetry.observe`` records at the warm-up
  and the capture, never at a replay;
* the negatives (``CLEAN``) capture, replay as one ``cudaGraphLaunch`` a
  call, and give their eager call's bits.

On the CPU ``fuse`` builds no graph: it re-runs the function every call,
so every positive runs there and the frozen ones differ from call to
call.  That is the gap the linter closes.

This file imports neither jax nor ``heat_tpu``: ``chip_smoke.py`` imports
it on a machine that has neither.
"""

import json
import os
import random
import re
import sys
import time

import numpy as np
import torch

if __name__ == "__main__":  # run as a script: the checkout's root first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import heat_tpu_torch as htt  # noqa: E402
from heat_tpu_torch import telemetry  # noqa: E402

#: the rules this file holds to ground truth
CAPTURE_RULES = ("SPMD201", "SPMD202", "SPMD205", "SPMD210")
#: the histogram SPMD210's positive records into
OBSERVED_NAME = "capture_rules.observed"
#: fused calls of the SPMD210 positive
OBSERVED_CALLS = 3


# --------------------------------------------------------------------- #
# SPMD202: host reads of the card inside the capture                     #
# --------------------------------------------------------------------- #
@htt.fuse
def pos_item(t):
    return t * t.sum().item()  # expect: SPMD202


@htt.fuse
def pos_tolist(t):
    first = t[:4].tolist()  # expect: SPMD202
    return t * len(first)


@htt.fuse
def pos_cpu(t):
    return (t.cpu() * 2).to(t.device)  # expect: SPMD202


@htt.fuse
def pos_to_host(t):
    host = t.to("cpu")  # expect: SPMD202
    return t + host.numel()


@htt.fuse
def pos_float(t):
    return t * float(t.sum())  # expect: SPMD202


@htt.fuse
def pos_synchronize(t):
    if t.is_cuda:
        torch.cuda.synchronize()  # expect: SPMD202
    return t * 2


# --------------------------------------------------------------------- #
# SPMD201/205: host values frozen at capture                             #
# --------------------------------------------------------------------- #
@htt.fuse
def pos_random(t):
    return t + random.random()  # expect: SPMD201


@htt.fuse
def pos_numpy_random(t):
    return t + np.random.uniform()  # expect: SPMD201


@htt.fuse
def pos_clock(t):
    return t + (time.perf_counter_ns() % 1_000_003)  # expect: SPMD205


@htt.fuse
def pos_wall_clock(t):
    return t + (time.time() % 1.0)  # expect: SPMD201,SPMD205


# --------------------------------------------------------------------- #
# SPMD210: request-scoped observability recorded at capture              #
# --------------------------------------------------------------------- #
@htt.fuse
def pos_observe(t):
    telemetry.observe(OBSERVED_NAME, float(t.shape[0]))  # expect: SPMD210
    return t * 2


# --------------------------------------------------------------------- #
# negatives: host metadata and decisions kept on the card                #
# --------------------------------------------------------------------- #
@htt.fuse
def neg_shape(t):
    return t * int(t.shape[0])


@htt.fuse
def neg_size(t):
    return t / float(t.size(0))


@htt.fuse
def neg_numel(t):
    return t + len(t) - t.numel()


@htt.fuse
def neg_where(t):
    return torch.where(t.sum() > 0, t, -t)


REFUSED = ("pos_item", "pos_tolist", "pos_cpu", "pos_to_host", "pos_float", "pos_synchronize")
FROZEN = ("pos_random", "pos_numpy_random", "pos_clock", "pos_wall_clock")
OBSERVED = ("pos_observe",)
CLEAN = ("neg_shape", "neg_size", "neg_numel", "neg_where")
CASES = REFUSED + FROZEN + OBSERVED + CLEAN

_EXPECT = re.compile(r"#\s*expect:\s*(SPMD\d+(?:\s*,\s*SPMD\d+)*)")


def expected_findings(path: str = __file__) -> set:
    """``(rule, line)`` of every ``# expect:`` marker in ``path``."""
    out = set()
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh.read().splitlines(), 1):
            m = _EXPECT.search(line)
            if m:
                out.update((r.strip(), i) for r in m.group(1).split(","))
    return out


def operand(device) -> torch.Tensor:
    """The input every case runs on: 4096 seeded float64 values."""
    return torch.from_numpy(np.random.default_rng(19).standard_normal(4096)).to(device)


def _case(name: str):
    return globals()[name]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.detach().cpu().view(torch.int64), b.detach().cpu().view(torch.int64))


def run_refused(device) -> dict:
    """Each SPMD202 positive fused on ``device``: whether it raised, the
    error's type and its first line."""
    t = operand(device)
    out = {}
    for name in REFUSED:
        try:
            _case(name)(t)
            if device.type == "cuda":
                torch.cuda.synchronize()
        except Exception as exc:  # what reaches the caller is the finding
            out[name] = {"raised": True, "error": type(exc).__name__,
                         "message": str(exc).splitlines()[0] if str(exc) else ""}
        else:
            out[name] = {"raised": False, "error": None, "message": ""}
    return out


def run_frozen(device) -> dict:
    """Each SPMD201/205 positive: two fused calls, two eager calls."""
    t = operand(device)
    out = {}
    for name in FROZEN:
        fused = _case(name)
        f1, f2 = fused(t), fused(t)
        e1, e2 = fused.__wrapped__(t), fused.__wrapped__(t)
        out[name] = {"fused_equal": _same(f1, f2), "eager_differ": not _same(e1, e2)}
    return out


def run_observed(device) -> dict:
    """The SPMD210 positive's histogram count after the first fused call
    and after ``OBSERVED_CALLS`` of them, with telemetry on."""
    t = operand(device)
    was, det = telemetry.is_enabled(), telemetry.is_deterministic()
    telemetry.enable()

    def count() -> int:
        h = telemetry.histogram(OBSERVED_NAME)
        return h.count if h is not None else 0

    try:
        before = count()
        pos_observe(t)
        first = count() - before
        for _ in range(OBSERVED_CALLS - 1):
            pos_observe(t)
        total = count() - before
    finally:
        if was:
            telemetry.enable(deterministic=det)
        else:
            telemetry.disable()
    return {"after_first": first, "after_all": total, "calls": OBSERVED_CALLS}


def run_clean(device) -> dict:
    """Each negative: whether its fused call is bitwise its eager call."""
    t = operand(device)
    return {name: {"bitwise": _same(_case(name)(t), _case(name).__wrapped__(t))} for name in CLEAN}


# --------------------------------------------------------------------- #
# the CPU tests                                                          #
# --------------------------------------------------------------------- #
def test_lint_flags_exactly_the_marked_lines():
    from heat_tpu_torch.analysis import analyze_file

    findings = analyze_file(os.path.abspath(__file__), rules=list(CAPTURE_RULES))
    want = expected_findings()
    assert len(want) == 12
    assert {(f.rule, f.line) for f in findings} == want


def test_every_case_is_marked_as_its_table_says():
    import ast

    tree = ast.parse(open(__file__, encoding="utf-8").read())
    marked = {line for _, line in expected_findings()}
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith(("pos_", "neg_"))}
    assert sorted(defs) == sorted(CASES)
    for name, node in defs.items():
        lines = set(range(node.lineno, node.end_lineno + 1))
        assert bool(lines & marked) == name.startswith("pos_"), name


def test_the_cpu_trace_lets_every_positive_through():
    cpu = torch.device("cpu")
    refused = run_refused(cpu)
    assert not any(r["raised"] for r in refused.values()), refused
    frozen = run_frozen(cpu)
    # no graph on the CPU: each fused call re-runs the function
    assert all(not r["fused_equal"] and r["eager_differ"] for r in frozen.values()), frozen
    observed = run_observed(cpu)
    assert observed == {"after_first": 1, "after_all": OBSERVED_CALLS, "calls": OBSERVED_CALLS}
    clean = run_clean(cpu)
    assert all(r["bitwise"] for r in clean.values()), clean


if __name__ == "__main__":
    if sys.argv[1:] != ["--refused"]:
        sys.exit("usage: python tests/test_torch_capture_rules.py --refused")
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(json.dumps(run_refused(torch.device("cuda", 0)), sort_keys=True))
