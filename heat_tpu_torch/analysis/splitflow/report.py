"""Static comm-cost report.

Port of ``heat_tpu/analysis/splitflow/report.py``, pricing with the
port's ``comm/_costs.py``.

Prices the layout traffic the dataflow engine derived — explicit
resplits and SPMD501 implicit reshards — with the SAME arithmetic the
runtime uses: :mod:`heat_tpu_torch.comm._costs` is loaded by file path
(``importlib`` spec, no package import, no torch), and ``plan_cost`` /
``ring_wire_model`` in there are exactly what ``comm/redistribute.plan``
and ``comm/compressed.wire_model`` delegate to.  The oracle lane asserts
byte-for-byte equality between this report and the runtime telemetry
ledger, so the numbers here are predictions, not estimates.

Only events with statically-known shape AND dtype are priced; everything
else is counted in ``unmodeled_events`` rather than silently dropped.
Output is deterministic: keys sorted, no timestamps — two runs over the
same tree produce identical JSON.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Optional

from .engine import Program, _fmt_split

__all__ = ["cost_report", "load_costs", "render_table"]

#: events that move bytes and are priced with plan_cost; "reduce" events
#: (sharded reductions/contractions) are recorded but combine *results*
#: via jit-compiled collectives outside the resplit ledger, so they are
#: listed, never priced
_PRICED_OPS = ("resplit", "implicit_resplit")

_COSTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "comm", "_costs.py",
)


def load_costs():
    """The runtime cost model, loaded without importing heat_tpu_torch."""
    spec = importlib.util.spec_from_file_location(
        "heat_tpu_torch_comm_costs_static", _COSTS_PATH
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cost_report(
    program: Program, mesh: int = 8, precision: Optional[str] = "f32"
) -> Dict:
    """Per-function modeled wire bytes at mesh size ``mesh``.

    ``precision`` mirrors the runtime redistribution policy knob: "f32"
    (the default — no compression) or "auto"/"int8_block"/"bf16", fed to
    ``resolve_mode`` per event exactly like ``plan`` does.
    """
    costs = load_costs()
    functions: Dict[str, Dict] = {}
    unmodeled = 0
    for ev in sorted(
        program.events, key=lambda e: (e.ctx.relpath, e.line, e.fact.op)
    ):
        f = ev.fact
        site = ev.site()
        entry = functions.setdefault(site, {
            "path": ev.ctx.relpath,
            "function": ev.qualname,
            "events": [],
            "modeled_wire_bytes": 0,
            "modeled_exact_bytes": 0,
            "modeled_critical_path_ms": {"serial": 0.0, "overlap": 0.0},
        })
        record = {
            "line": ev.line,
            "op": f.op,
            "src": _fmt_split(f.src),
            "dst": _fmt_split(f.dst),
            "shape": list(f.shape) if f.shape is not None else None,
            "dtype": f.dtype,
        }
        priced = (
            f.op in _PRICED_OPS
            and f.shape is not None
            and f.dtype is not None
            and isinstance(f.src, (int, type(None)))
            and isinstance(f.dst, (int, type(None)))
            and f.src != f.dst
        )
        if priced:
            item = costs.itemsize(f.dtype)
            total = 1
            for s in f.shape:
                total *= s
            mode_for = (
                lambda nbytes: costs.resolve_mode(f.dtype, nbytes, precision)
            )
            plan = costs.plan_cost(
                tuple(f.shape), f.dtype, f.src, f.dst, mesh, mode_for=mode_for
            )
            # time model per schedule: serial rings sum wire + compute per
            # hop, overlapped rings pay max(wire, compute) after a warm-up
            # hop (compute is not statically known — 0 here, so this is
            # the pure wire-bound floor under each schedule)
            hops = sum(1 for s in plan["steps"] if s[0] == "rotate")
            cp = {
                "serial": costs.critical_path_ms(
                    plan["wire_bytes"], hops, overlap=False
                ),
                "overlap": costs.critical_path_ms(
                    plan["wire_bytes"], hops, overlap=True
                ),
            }
            record.update({
                "wire_bytes": plan["wire_bytes"],
                "exact_wire_bytes": plan["exact_wire_bytes"],
                "peak_live_bytes": plan["peak_live_bytes"],
                "mode": plan["mode"],
                "critical_path_ms": cp,
                "monolithic_wire_bytes": costs.monolithic_cost(
                    tuple(f.shape), item, f.src, f.dst, mesh
                )["wire_bytes"],
            })
            entry["modeled_wire_bytes"] += plan["wire_bytes"]
            entry["modeled_exact_bytes"] += plan["exact_wire_bytes"]
            entry["modeled_critical_path_ms"]["serial"] += cp["serial"]
            entry["modeled_critical_path_ms"]["overlap"] += cp["overlap"]
        else:
            record["wire_bytes"] = None
            if f.op in _PRICED_OPS:
                unmodeled += 1
        entry["events"].append(record)
    functions = {k: functions[k] for k in sorted(functions)}
    return {
        "mesh": mesh,
        "precision": precision,
        "cost_model": "heat_tpu_torch/comm/_costs.py",
        "functions": functions,
        "totals": {
            "modeled_wire_bytes": sum(
                e["modeled_wire_bytes"] for e in functions.values()
            ),
            "modeled_exact_bytes": sum(
                e["modeled_exact_bytes"] for e in functions.values()
            ),
            "modeled_critical_path_ms": {
                sched: sum(
                    e["modeled_critical_path_ms"][sched]
                    for e in functions.values()
                )
                for sched in ("serial", "overlap")
            },
            "events": sum(len(e["events"]) for e in functions.values()),
            "unmodeled_events": unmodeled,
        },
    }


def render_table(report: Dict) -> str:
    """Human-readable view of :func:`cost_report` output."""
    lines: List[str] = []
    mesh = report["mesh"]
    lines.append(
        f"static comm-cost report  (mesh={mesh}, "
        f"precision={report['precision']}, model={report['cost_model']})"
    )
    header = f"{'modeled wire':>14}  {'events':>6}  function"
    lines.append(header)
    lines.append("-" * len(header))
    for site, entry in report["functions"].items():
        lines.append(
            f"{entry['modeled_wire_bytes']:>14,}  "
            f"{len(entry['events']):>6}  {site}"
        )
        for ev in entry["events"]:
            wire = f"{ev['wire_bytes']:,}" if ev["wire_bytes"] is not None \
                else "(unmodeled)"
            shape = "x".join(str(s) for s in ev["shape"]) \
                if ev["shape"] else "?"
            lines.append(
                f"{'':>14}  {'':>6}    L{ev['line']}: {ev['op']} "
                f"{ev['src']}→{ev['dst']} {shape} {ev['dtype'] or '?'} "
                f"= {wire} B"
            )
    t = report["totals"]
    lines.append("-" * len(header))
    lines.append(
        f"{t['modeled_wire_bytes']:>14,}  {t['events']:>6}  TOTAL "
        f"({t['unmodeled_events']} unmodeled)"
    )
    return "\n".join(lines)
