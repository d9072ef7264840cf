"""The port's file-scope linter: every rule's fixtures, its baseline, cache and CLI, and the gate.

``TWINS`` holds the reference's ``tests/test_spmdlint.py`` fixtures
carried into the port's idiom, one entry per fixture (keyed
``"<reference test>:<variable>"``), line for line: each flagged line
stays where it was, so ``tests/test_torch_spmdlint_parity.py`` can hold
the port's ``(rule, line)`` set on a twin to the reference's on its JAX
original.  The carrying: ``@jax.jit`` and ``shard_map(kernel, ...)``
become ``@htt.fuse`` and ``fuse(kernel)``; an op engine's ``jitted``
factory (traced in the reference, eager in the port) becomes a
``with torch.cuda.graph(...)`` body or a ``fuse``d lambda;
``jax.lax.ppermute(x, axis, perm)`` becomes ``primitives._permute(x,
perm)``; ``jnp`` dtypes and constructors become ``torch``'s; imports of
``heat_tpu`` become ``heat_tpu_torch``.

The tests here run the port alone (no jax, no ``heat_tpu``): each
reference test's assertion on its twin, the port's own idioms
(``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize``, ``.long()``
payloads, capture blocks), the runtime ground truth of the schedule
builders, the baseline, the cache, the CLI, and the gate: the port's tree
at zero findings against its empty committed baseline.
"""

import json
import os
import subprocess
import sys

import pytest

from heat_tpu_torch.analysis import Finding, all_rules, analyze_file, analyze_paths
from heat_tpu_torch.analysis.baseline import DEFAULT_BASELINE, load_baseline, partition, write_baseline
from heat_tpu_torch.analysis.cache import FindingsCache
from heat_tpu_torch.analysis.checkers import (
    MESH_SIZES,
    check_partial_bijection,
    verify_ring_schedule,
    verify_zigzag_builders,
)
from heat_tpu_torch.analysis.core import FileContext, analyze_contexts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's rule ids the port registers, in its order
PORTED = [
    "SPMD001", "SPMD101", "SPMD201", "SPMD202", "SPMD203", "SPMD204", "SPMD205",
    "SPMD206", "SPMD207", "SPMD208", "SPMD210", "SPMD211", "SPMD212", "SPMD213",
    "SPMD214", "SPMD401", "SPMD501", "SPMD502", "SPMD503", "SPMD504", "SPMD505",
]
#: the reference's rules the port leaves out (ROADMAP: not ported on
#: purpose, and A3b for SPMD209)
NOT_PORTED = ["SPMD102", "SPMD209", "SPMD301", "SPMD302"]


def lint(source, rule=None, dynamic=True):
    findings = analyze_file(
        os.path.join(REPO, "tests", "_fixture.py"),
        source=source,
        dynamic=dynamic,
        relpath="tests/_fixture.py",
    )
    if rule is not None:
        findings = [f for f in findings if f.rule == rule]
    return findings


def rules_of(findings):
    return sorted({f.rule for f in findings})


TWINS = {
    # ----------------------------------------------------------------- SPMD101
    "test_spmd101_triggers_on_duplicate_destination:src": """
from heat_tpu_torch.parallel.primitives import _permute

def kernel(x, size):
    perm = [(i, 0) for i in range(size)]
    return _permute(x, perm)
""",
    "test_spmd101_triggers_on_out_of_range:src": """
from heat_tpu_torch.parallel.primitives import _permute

def kernel(x, size):
    return _permute(x, [(i, i + 1) for i in range(size)])
""",
    "test_spmd101_clean_on_rotation_and_partial_perms:src": """
from heat_tpu_torch.parallel.primitives import _permute

def rotate(x, size):
    perm = [(i, (i + 1) % size) for i in range(size)]
    return _permute(x, perm)

def halo(x, size):
    # partial perms (boundary positions idle) are legal
    fwd = [(i, i + 1) for i in range(size - 1)]
    return _permute(x, fwd)
""",
    "test_spmd101_verifies_builder_by_simulation:bad": """
def ring_source(position, round, size):
    return (position + round) % size
""",
    "test_spmd101_verifies_builder_by_simulation:good": """
def ring_source(position, round, size):
    return (position - round) % size
""",
    "test_spmd101_skipped_without_dynamic:src": """
from heat_tpu_torch.parallel.primitives import _permute

def kernel(x, size):
    return _permute(x, [(i, 0) for i in range(size)])
""",
    # ----------------------------------------------------------------- SPMD201
    "test_spmd201_triggers_on_host_effects:src": """
import time
import numpy as np
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    t = time.time()
    print(x)
    noise = np.random.uniform()
    return x * t + noise
""",
    "test_spmd201_triggers_on_global_write_in_shard_map_kernel:src": """
from heat_tpu_torch import fuse

_STATE = 0

def f(x, mesh, specs):
    def kernel(s):
        global _STATE
        _STATE += 1
        return s
    return fuse(kernel)(x)
""",
    "test_spmd201_clean_outside_traced_context:src": """
import time
import heat_tpu_torch as htt

def untraced(x):
    print(x)          # host-side helper: fine
    return time.time()

@htt.fuse
def f(x):
    return x * 2.0    # pure
""",
    "test_spmd201_sees_through_jitted_factories:src": """
from heat_tpu_torch import fuse

def op(x):
    fn = fuse(lambda a: print(a) or a)
    return fn(x)
""",
    # ----------------------------------------------------------------- SPMD202
    "test_spmd202_triggers_on_float_of_device_value_under_fuse:src": """
import torch
from heat_tpu_torch.core.fuse import fuse

@fuse
def program(x):
    beta = torch.linalg.norm(x.larray)
    if float(beta) < 1e-10:
        return x
    return x * 2.0
""",
    "test_spmd202_triggers_on_item_and_asarray:src": """
import heat_tpu_torch as htt
import numpy as np
from heat_tpu_torch.core.fuse import fuse

def program(x):
    return x.larray.sum().item()

_fused = fuse(program)

@htt.fuse
def f(x):
    return np.asarray(x)
""",
    "test_spmd202_clean_on_static_metadata_and_host_code:src": """
import heat_tpu_torch as htt
import numpy as np

@htt.fuse
def f(x):
    n = int(x.size(0))
    scale = float(n * 2 - 1)
    return x * scale

def host_helper(a):
    # outside any traced context: syncs are the caller's business
    v = float(a.larray.sum())
    return np.asarray(a), a.item(), v
""",
    "test_spmd202_ignores_bare_names_without_device_evidence:src": """
import heat_tpu_torch as htt

@htt.fuse
def f(x, steps):
    # python-int bookkeeping: a bare-name coercion with no visible
    # device-value assignment must NOT fire
    count = steps - 1
    return x * float(count)
""",
    "test_spmd202_triggers_on_old_norm_coercion_shape:src": """
import torch
from heat_tpu_torch.core.fuse import fuse

@fuse
def norm(a):
    return float(torch.sqrt(torch.sum(a.larray * a.larray)))
""",
    "test_spmd202_recognizes_ht_fuse_decorator:src": """
import heat_tpu_torch as ht

@ht.fuse
def program(x):
    return x.larray.max().tolist()
""",
    # ----------------------------------------------------------------- SPMD203
    "test_spmd203_triggers_on_astype_int_payload:src": """
import torch
from heat_tpu_torch.comm.compressed import ring_allreduce_q

def kernel(v, name):
    counts = v.to(torch.int32)
    return ring_allreduce_q(counts, size=8, mode="int8_block")
""",
    "test_spmd203_triggers_on_integer_constructor_payload:src": """
import torch
from heat_tpu_torch.comm import compressed

def kernel(name):
    mask = torch.zeros((128,), dtype=torch.bool)
    return compressed.ring_allgather_q(mask, size=4, mode="int8_block")
""",
    "test_spmd203_clean_on_float_payloads:src": """
import torch
from heat_tpu_torch.comm.compressed import ring_allreduce_q, ring_allreduce_q_ef

def kernel(a, e, name):
    sums = torch.matmul(a.T, a)
    r = ring_allreduce_q(sums.reshape(-1), size=8, mode="int8_block")
    g, e2 = ring_allreduce_q_ef(a.to(torch.float32), e, size=8, mode="bf16")
    return r, g, e2
""",
    # ----------------------------------------------------------------- SPMD204
    "test_spmd204_triggers_inside_guard_off_block:src": """
from heat_tpu_torch.comm.compressed import allreduce_q
from heat_tpu_torch.resilience import guard

def combine(x, comm):
    with guard("off"):
        return allreduce_q(x, comm=comm)
""",
    "test_spmd204_triggers_after_set_guard_policy_off:src": """
from heat_tpu_torch.comm import compressed
from heat_tpu_torch.resilience.guards import set_guard_policy

def combine(x, comm):
    set_guard_policy(policy="off")
    return compressed.allgather_q(x, axis=0, comm=comm)
""",
    "test_spmd204_suppression_comment_silences:src": """
from heat_tpu_torch.comm.compressed import allreduce_q
from heat_tpu_torch.resilience import guard

def combine(x, comm):
    with guard("off"):
        return allreduce_q(x, comm=comm)  # spmdlint: disable=SPMD204
""",
    "test_spmd204_clean_when_guards_active_or_absent:src": """
from heat_tpu_torch.comm.compressed import allreduce_q
from heat_tpu_torch.resilience import guard

def plain(x, comm):
    return allreduce_q(x, comm=comm)

def guarded(x, comm):
    with guard("degrade"):
        return allreduce_q(x, comm=comm)

def disjoint(x, comm):
    with guard("off"):
        pass
    return allreduce_q(x, comm=comm)
""",
    # ----------------------------------------------------------------- SPMD205
    "test_spmd205_triggers_on_clock_reads_in_jit:src": """
import time
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    t0 = time.perf_counter_ns()
    y = x * 2
    t1 = time.process_time()
    return y, t1 - t0
""",
    "test_spmd205_triggers_on_span_in_shard_map_kernel:src": """
from heat_tpu_torch import fuse
from heat_tpu_torch import telemetry

def f(x, mesh, specs):
    def kernel(s):
        with telemetry.span("kernel"):
            return s * 2
    return fuse(kernel)(x)
""",
    "test_spmd205_triggers_inside_jitted_factory:src": """
import time
import torch

def op(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t = time.monotonic_ns()
        y = x + t
    graph.replay()
    return y
""",
    "test_spmd205_clean_on_host_side_timing:src": """
import time
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry

@htt.fuse
def f(x):
    return x * 2

def timed(x):
    t0 = time.perf_counter()
    with telemetry.span("host"):
        y = f(x)
    return y, time.perf_counter() - t0
""",
    "test_spmd205_overlaps_spmd201_on_wall_clock:src": """
import time
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    return x * time.time()
""",
    # ----------------------------------------------------------------- SPMD206
    "test_spmd206_triggers_on_resplit_in_for_loop:src": """
def pipeline(x, comm):
    for _ in range(8):
        x = comm.resplit(x, 1)
    return x
""",
    "test_spmd206_triggers_on_alltoall_in_while_loop:src": """
def pump(arr, comm):
    while arr.converged() is False:
        arr = comm.alltoall(arr, send_axis=1, recv_axis=0)
    return arr
""",
    "test_spmd206_triggers_on_dndarray_method_resplit:src": """
def epoch(batches):
    for b in batches:
        b.resplit_(0)
        yield b
""",
    "test_spmd206_clean_under_planned_policy:src": """
from heat_tpu_torch.comm import redistribution, set_redistribution

def with_block(x, comm):
    with redistribution("planned"):
        for _ in range(8):
            x = comm.resplit(x, 1)
    return x

def with_setter(x, comm):
    set_redistribution("auto")
    for _ in range(8):
        x = comm.alltoall(x, send_axis=1, recv_axis=0)
    return x
""",
    "test_spmd206_clean_outside_loops_and_in_traced_bodies:src": """
import heat_tpu_torch as htt

def once(x, comm):
    return comm.resplit(x, 1)

def loop_then_resplit(xs, comm):
    for x in xs:
        pass
    return comm.commit_split(xs[0], 0)

@htt.fuse
def traced(x, comm):
    for _ in range(4):
        x = comm.resplit(x, 1)
    return x
""",
    "test_spmd206_monolithic_policy_does_not_exempt:src": """
from heat_tpu_torch.comm import redistribution

def shuffle(x, comm):
    with redistribution("monolithic"):
        for _ in range(8):
            x = comm.resplit(x, 1)
    return x
""",
    "test_spmd206_suppression_comment_silences:src": """
def shuffle(x, comm):
    for _ in range(8):
        x = comm.resplit(x, 1)  # spmdlint: disable=SPMD206
    return x
""",
    # ----------------------------------------------------------------- SPMD207
    "test_spmd207_triggers_on_silent_except_around_collective:src": """
def shuffle(x, comm):
    try:
        x = comm.resplit(x, 1)
    except Exception:
        pass
    return x
""",
    "test_spmd207_triggers_on_swallowed_oserror_open:src": """
def probe(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None
""",
    "test_spmd207_triggers_on_bare_except_and_broad_tuple_member:src": """
def reduce(comm, arr):
    try:
        return comm.allreduce(arr)
    except:
        return arr

def load(path):
    try:
        return load_hdf5(path, "data")
    except (ValueError, OSError):
        return None
""",
    "test_spmd207_clean_on_visible_handlers:src": """
import logging
from heat_tpu_torch.resilience import incidents

def reraise(path):
    try:
        f = open(path)
    except OSError:
        cleanup()
        raise

def deferred(comm, x):
    err = None
    try:
        x = comm.resplit(x, 1)
    except Exception as e:
        err = e
    return x, err

def recorded(comm, x):
    try:
        return comm.allgather(x)
    except OSError:
        incidents.record(kind="io", site="gather", policy="manual", action="noted")
        return x

def logged(path):
    try:
        return open(path)
    except OSError:
        logging.warning("open failed")
        return None
""",
    "test_spmd207_clean_on_narrow_or_unguarded_try:src": """
import os

def narrow(d):
    try:
        return d.load("key")
    except KeyError:
        return None

def unguarded(path):
    try:
        os.remove(path)
    except OSError:
        pass
""",
    "test_spmd207_suppression_comment_silences:src": """
def shuffle(x, comm):
    try:
        x = comm.resplit(x, 1)
    except Exception:  # spmdlint: disable=SPMD207
        pass
    return x
""",
    # ----------------------------------------------------------------- SPMD208
    "test_spmd208_triggers_on_dynamic_slice_into_fused_in_loop:src": """
from heat_tpu_torch import fuse

def program(x):
    return x

compiled = fuse(program)

def serve_loop(queue, sizes):
    off = 0
    out = []
    for n in sizes:
        out.append(compiled(queue[off : off + n]))
        off += n
    return out
""",
    "test_spmd208_triggers_via_named_slice_and_jitted_product:src": """
from heat_tpu_torch.core._compile import jitted
from heat_tpu_torch import fuse
def serve_loop(queue, sizes, key, make):
    prog = fuse(jitted(key, make))
    for n in sizes:
        chunk = queue[:n]
        prog(chunk)
""",
    "test_spmd208_clean_when_bounds_are_bucketed:src": """
from heat_tpu_torch import fuse
from heat_tpu_torch.serve import bucket_rows

def program(x):
    return x

compiled = fuse(program)

def serve_loop(queue, sizes):
    out = []
    for n in sizes:
        out.append(compiled(queue[: bucket_rows(n)]))
    return out

def serve_loop_named(queue, sizes):
    out = []
    for n in sizes:
        b = bucket_rows(n)
        out.append(compiled(queue[:b]))
    return out
""",
    "test_spmd208_clean_outside_loops_constant_bounds_and_traced_bodies:src": """
import heat_tpu_torch as htt
from heat_tpu_torch import fuse

def program(x):
    return x

compiled = fuse(program)

def once(queue, n):
    return compiled(queue[:n])

def static_bounds(queue):
    out = []
    for _ in range(4):
        out.append(compiled(queue[:32]))
    return out

@htt.fuse
def traced(queue, sizes):
    acc = 0
    for n in sizes:
        acc = acc + compiled(queue[:n])
    return acc
""",
    "test_spmd208_plain_function_calls_do_not_fire:src": """
def helper(x):
    return x

def serve_loop(queue, sizes):
    out = []
    for n in sizes:
        out.append(helper(queue[:n]))
    return out
""",
    "test_spmd208_suppression_comment_silences:src": """
from heat_tpu_torch import fuse

def program(x):
    return x

compiled = fuse(program)

def serve_loop(queue, sizes):
    out = []
    for n in sizes:
        out.append(compiled(queue[:n]))  # spmdlint: disable=SPMD208
    return out
""",
    # ----------------------------------------------------------------- SPMD210
    "test_spmd210_triggers_on_trace_ctx_in_jit:src": """
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry

@htt.fuse
def f(x):
    with telemetry.trace_ctx("req-1"):
        return x * 2
""",
    "test_spmd210_triggers_on_observe_and_flight_note_in_traced:src": """
from heat_tpu_torch import fuse
from heat_tpu_torch import obs
from heat_tpu_torch.telemetry import flight

def f(x, mesh, specs):
    def kernel(s):
        obs.observe("kernel.value", s.shape[0])
        flight.note("kernel", site="k")
        return s * 2
    return fuse(kernel)(x)
""",
    "test_spmd210_triggers_inside_jitted_factory:src": """
import torch
from heat_tpu_torch.telemetry import _core as _tel

def op(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _tel.observe("op.val", 1.0)
        y = x * 1
    graph.replay()
    return y
""",
    "test_spmd210_clean_on_host_side_observability:src": """
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.telemetry import flight

@htt.fuse
def f(x):
    return x * 2

def serve_one(x, rid, lat_ms):
    with telemetry.trace_ctx(rid):
        y = f(x)
    telemetry.observe("serve.latency_ms", lat_ms)
    flight.note("served", site="serve", rid=rid)
    return y
""",
    "test_spmd210_suppression_comment_silences:src": """
import heat_tpu_torch as htt
from heat_tpu_torch import telemetry

@htt.fuse
def f(x):
    telemetry.observe("trace.cost", 1.0)  # spmdlint: disable=SPMD210
    return x * 2
""",
    # ----------------------------------------------------------------- SPMD211
    "test_spmd211_triggers_on_forever_retry_of_compiled_call:src": """
import heat_tpu_torch as htt

@htt.fuse
def step(x):
    return x * 2

def run(x):
    while True:
        try:
            return step(x)
        except Exception:
            pass
""",
    "test_spmd211_triggers_on_forever_retry_of_guarded_io:src": """
def read(path):
    while True:
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            continue
""",
    "test_spmd211_clean_on_retry_engine_and_bounded_loops:src": """
import time
from heat_tpu_torch.resilience import retry as _retry

def read(path, policy):
    for attempt in _retry.retry(policy, site="registry_open"):
        with attempt:
            with open(path, "rb") as fh:
                return fh.read()

def read_counted(path):
    for attempt in range(5):
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            continue

def read_deadline(path, deadline):
    while True:
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            if time.monotonic() > deadline:
                raise

def poll(path):
    # no compiled/guarded call inside the try: not this rule's business
    while True:
        try:
            return path.stat()
        except FileNotFoundError:
            pass
""",
    "test_spmd211_handler_that_escapes_is_clean:src": """
def read(path):
    while True:
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:
            break
""",
    "test_spmd211_suppression_comment_silences:src": """
def read(path):
    while True:
        try:
            with open(path, "rb") as fh:
                return fh.read()
        except OSError:  # spmdlint: disable=SPMD211
            pass
""",
    # ----------------------------------------------------------------- SPMD212
    "test_spmd212_triggers_on_h5py_read_in_compiled_loop:src": """
import h5py
import numpy as np
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(path, chunks, carry):
    f = h5py.File(path, "r")
    for lo, hi in chunks:
        chunk = np.asarray(f["data"][lo:hi])
        carry = step(carry, chunk)
    return carry
""",
    "test_spmd212_triggers_on_per_iteration_reopen:src": """
import h5py
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(path, chunks, carry):
    for lo, hi in chunks:
        with h5py.File(path, "r") as f:
            chunk = f["data"][lo:hi]
        carry = step(carry, chunk)
    return carry
""",
    "test_spmd212_triggers_on_netcdf_variable_read:src": """
import netCDF4 as nc
import numpy as np
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(path, chunks, carry):
    f = nc.Dataset(path, "r")
    for lo, hi in chunks:
        chunk = np.asarray(f.variables["v"][lo:hi])
        carry = step(carry, chunk)
    return carry
""",
    "test_spmd212_clean_on_hoisted_read_and_streamed_loop:src": """
import h5py
import numpy as np
import heat_tpu_torch as htt
from heat_tpu_torch.io import stream

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run_hoisted(path, carry, n):
    with h5py.File(path, "r") as f:
        data = np.asarray(f["data"][:])
    for i in range(n):
        carry = step(carry, data)
    return carry

def run_streamed(src_, mb, stop, carry):
    for arrs, nv in stream.stream_chunks(src_, mb, 0, stop):
        carry = step(carry, arrs[0])
    return carry

def read_only(path, chunks):
    out = []
    f = h5py.File(path, "r")
    for lo, hi in chunks:
        out.append(np.asarray(f["data"][lo:hi]))
    return out
""",
    "test_spmd212_suppression_comment_silences:src": """
import h5py
import numpy as np
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(path, chunks, carry):
    f = h5py.File(path, "r")
    for lo, hi in chunks:
        chunk = np.asarray(f["data"][lo:hi])  # spmdlint: disable=SPMD212
        carry = step(carry, chunk)
    return carry
""",
    # ----------------------------------------------------------------- SPMD213
    "test_spmd213_triggers_on_socket_recv_in_compiled_loop:src": """
import socket
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(port, chunks, carry):
    sock = socket.create_connection(("127.0.0.1", port))
    for chunk in chunks:
        carry = step(carry, chunk)
        ack = sock.recv(4)
    return carry
""",
    "test_spmd213_triggers_on_os_read_and_subprocess_wait:src": """
import os
import subprocess
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run_pipe(fd, chunks, carry):
    for chunk in chunks:
        carry = step(carry, chunk)
        header = os.read(fd, 8)
    return carry

def run_children(cmds, chunks, carry):
    for cmd, chunk in zip(cmds, chunks):
        proc = subprocess.Popen(cmd)
        carry = step(carry, chunk)
        proc.wait()
    return carry
""",
    "test_spmd213_clean_on_ipc_without_dispatch_and_worker_shape:src": """
import socket
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def rpc_worker(port, outbox):
    sock = socket.create_connection(("127.0.0.1", port))
    while True:
        frame = sock.recv(4096)
        if not frame:
            return
        outbox.append(frame)

def dispatch_loop(inbox, carry):
    for chunk in inbox:
        carry = step(carry, chunk)
    return carry
""",
    "test_spmd213_traced_context_exempt:src": """
import socket
import heat_tpu_torch as htt

def build(port, chunks, carry):
    sock = socket.create_connection(("127.0.0.1", port))

    @htt.fuse
    def step(c, chunk):
        return c + chunk.sum()

    for chunk in chunks:
        carry = step(carry, chunk)
    return carry
""",
    "test_spmd213_suppression_comment_silences:src": """
import socket
import heat_tpu_torch as htt

@htt.fuse
def step(carry, chunk):
    return carry + chunk.sum()

def run(port, chunks, carry):
    sock = socket.create_connection(("127.0.0.1", port))
    for chunk in chunks:
        carry = step(carry, chunk)
        ack = sock.recv(4)  # spmdlint: disable=SPMD213
    return carry
""",
    # ----------------------------------------------------------------- SPMD214
    "test_spmd214_triggers_on_zero_timeout_waits:src": """
import socket
import threading

def cv_worker(cond, inbox, out):
    while True:
        with cond:
            cond.wait()
        out.append(inbox.pop())

def queue_worker(q, out):
    while True:
        item = q.get()
        if item is None:
            return
        out.append(item)

def sock_worker(port, out):
    sock = socket.create_connection(("127.0.0.1", port))
    while True:
        frame = sock.recv(4096)
        if not frame:
            return
        out.append(frame)
""",
    "test_spmd214_clean_on_bounded_waits:src": """
import socket
import time

def cv_worker(cond, ready, out, timeout):
    deadline = time.monotonic() + timeout
    while True:
        with cond:
            if ready():
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not cond.wait(timeout=remaining):
                return

def queue_worker(q, out):
    while True:
        item = q.get(timeout=0.25)
        if item is None:
            return
        out.append(item)

def sock_worker(port, out):
    sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    while True:
        frame = sock.recv(4096)
        if not frame:
            return
        out.append(frame)

def settimeout_worker(port, out):
    sock = socket.create_connection(("127.0.0.1", port))
    sock.settimeout(2.0)
    while True:
        frame = sock.recv(4096)
        if not frame:
            return
        out.append(frame)
""",
    "test_spmd214_dict_get_and_bounded_loops_exempt:src": """
def frame_loop(recv_frame, out):
    while True:
        msg = recv_frame()
        if msg is None:
            return
        out.append(msg.get("kind"))

def counted_worker(cond, max_attempts):
    attempts = 0
    while True:
        attempts += 1
        if attempts > max_attempts:
            return
        with cond:
            cond.wait()
""",
    "test_spmd214_suppression_comment_silences:src": """
def pump(q, out):
    while True:
        item = q.get()  # spmdlint: disable=SPMD214
        if item is None:
            return
        out.append(item)
""",
    # ----------------------------------------------------------------- SPMD401
    "test_spmd401_triggers_on_callable_in_key:src": """
from heat_tpu_torch.core._compile import jitted

def apply(fn, x):
    return jitted(("apply", fn), lambda: lambda a: fn(a))(x)
""",
    "test_spmd401_triggers_on_lambda_array_and_shapeless_keys:src": """
import torch
from heat_tpu_torch.core._compile import jitted

def bad(x):
    a = jitted(("k1", lambda: 1), lambda: lambda v: v)(x)
    b = jitted(("k2", torch.zeros(3)), lambda: lambda v: v)(x)
    c = jitted(make_key(), lambda: lambda v: v)(x)
    d = jitted((1, 2), lambda: lambda v: v)(x)
    return a, b, c, d
""",
    "test_spmd401_clean_on_static_data_keys:src": """
from heat_tpu_torch.core._compile import jitted

def good(x, axis, comm, widths):
    key = ("op.good", axis, str(x.dtype), x.ndim, comm, tuple(widths))
    return jitted(key, lambda: lambda v: v)(x)
""",
    # ---------------------------------------------------- suppressions, skip-file
    "test_inline_suppression_and_skip_file:hot": """
import time
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    return x * time.time()  # spmdlint: disable=SPMD201
""",
    "test_inline_suppression_and_skip_file:skipped": """# spmdlint: skip-file
import time
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    return x * time.time()
""",
    "test_suppression_is_rule_specific:src": """
import time
import heat_tpu_torch as htt

@htt.fuse
def f(x):
    return x * time.time()  # spmdlint: disable=SPMD401
""",
}


def twin(key):
    return TWINS[key]


# --------------------------------------------------------------------- #
# SPMD101: _permute bijections                                           #
# --------------------------------------------------------------------- #
def test_spmd101_triggers_on_duplicate_destination():
    findings = lint(twin("test_spmd101_triggers_on_duplicate_destination:src"), "SPMD101")
    assert findings, "duplicate-destination perm must fire SPMD101"
    assert "duplicate destination" in findings[0].message


def test_spmd101_triggers_on_out_of_range():
    findings = lint(twin("test_spmd101_triggers_on_out_of_range:src"), "SPMD101")
    assert findings and "out of range" in findings[0].message


def test_spmd101_clean_on_rotation_and_partial_perms():
    assert lint(twin("test_spmd101_clean_on_rotation_and_partial_perms:src"), "SPMD101") == []


def test_spmd101_verifies_builder_by_simulation():
    findings = lint(twin("test_spmd101_verifies_builder_by_simulation:bad"), "SPMD101")
    assert findings and "fails simulation" in findings[0].message
    assert lint(twin("test_spmd101_verifies_builder_by_simulation:good"), "SPMD101") == []


def test_spmd101_skipped_without_dynamic():
    assert lint(twin("test_spmd101_skipped_without_dynamic:src"), "SPMD101", dynamic=False) == []


def test_spmd101_checks_the_perm_keyword_and_builder_unpacking():
    src = """
from heat_tpu_torch.parallel.primitives import _permute

def zigzag_perms(size):
    first = [(i, 0) for i in range(size)]
    return first, first

def resplit(x, size):
    pf, ps = zigzag_perms(size)
    return _permute(x, perm=pf)
"""
    findings = lint(src, "SPMD101")
    assert sorted(f.line for f in findings) == [4, 10]
    assert "duplicate destination" in findings[-1].message


def test_spmd101_verifies_the_ports_own_primitives():
    # the port's builders pass simulation and its _permute sites evaluate
    path = os.path.join(REPO, "heat_tpu_torch", "parallel", "primitives.py")
    assert analyze_file(path, relpath="heat_tpu_torch/parallel/primitives.py", rules=["SPMD101"]) == []
    ctx = FileContext(path, relpath="heat_tpu_torch/parallel/primitives.py")
    assert {"ring_source", "zigzag_perms", "zigzag_inverse_perms", "zigzag_chunk_owner"} <= {
        st.name for st in ctx.tree.body if hasattr(st, "name")}


def test_spmd101_catches_a_broken_port_builder():
    path = os.path.join(REPO, "heat_tpu_torch", "parallel", "primitives.py")
    src = open(path, encoding="utf-8").read()
    broken = src.replace("return c if c < size else 2 * size - 1 - c", "return c if c < size else c - size")
    assert broken != src
    findings = analyze_file(path, source=broken, relpath="heat_tpu_torch/parallel/primitives.py",
                            rules=["SPMD101"])
    assert findings and "fails simulation" in findings[0].message


# --------------------------------------------------------------------- #
# SPMD201: capture purity                                                #
# --------------------------------------------------------------------- #
def test_spmd201_triggers_on_host_effects():
    findings = lint(twin("test_spmd201_triggers_on_host_effects:src"), "SPMD201")
    msgs = " | ".join(f.message for f in findings)
    assert "time.time" in msgs and "print" in msgs and "numpy.random" in msgs
    assert any("torch.Generator" in f.hint for f in findings)


def test_spmd201_triggers_on_global_write_in_shard_map_kernel():
    findings = lint(twin("test_spmd201_triggers_on_global_write_in_shard_map_kernel:src"), "SPMD201")
    assert findings and "global" in findings[0].message


def test_spmd201_clean_outside_traced_context():
    assert lint(twin("test_spmd201_clean_outside_traced_context:src"), "SPMD201") == []


def test_spmd201_sees_through_jitted_factories():
    findings = lint(twin("test_spmd201_sees_through_jitted_factories:src"), "SPMD201")
    assert findings and "print" in findings[0].message


def test_spmd201_jitted_factories_run_eagerly_in_the_port():
    # the reference traces what a jitted factory builds; the port's jitted
    # calls make_fn() once and runs its function eagerly: nothing is traced
    src = """
from heat_tpu_torch.core._compile import jitted

def op(x):
    fn = jitted(("op",), lambda: lambda a: print(a) or a)
    return fn(x)
"""
    assert lint(src, "SPMD201") == []


def test_spmd201_sees_capture_blocks():
    src = """
import random
from torch.cuda import graph

def capture(x, g):
    with graph(g):
        y = x * random.random()
    print(y)
    return y
"""
    assert [f.line for f in lint(src, "SPMD201")] == [7]


# --------------------------------------------------------------------- #
# SPMD202: host syncs of captured values                                 #
# --------------------------------------------------------------------- #
def test_spmd202_triggers_on_float_of_device_value_under_fuse():
    findings = lint(twin("test_spmd202_triggers_on_float_of_device_value_under_fuse:src"), "SPMD202")
    assert findings, "float(device value) under @fuse must fire SPMD202"
    assert "float()" in findings[0].message


def test_spmd202_triggers_on_item_and_asarray():
    msgs = [f.message for f in lint(twin("test_spmd202_triggers_on_item_and_asarray:src"), "SPMD202")]
    assert any(".item()" in m for m in msgs)
    assert any("numpy.asarray" in m for m in msgs)


def test_spmd202_clean_on_static_metadata_and_host_code():
    assert lint(twin("test_spmd202_clean_on_static_metadata_and_host_code:src"), "SPMD202") == []


def test_spmd202_ignores_bare_names_without_device_evidence():
    assert lint(twin("test_spmd202_ignores_bare_names_without_device_evidence:src"), "SPMD202") == []


def test_spmd202_triggers_on_old_norm_coercion_shape():
    findings = lint(twin("test_spmd202_triggers_on_old_norm_coercion_shape:src"), "SPMD202")
    assert findings, "float(sqrt(traced)) under @fuse must fire SPMD202"
    assert "float()" in findings[0].message


def test_spmd202_recognizes_ht_fuse_decorator():
    findings = lint(twin("test_spmd202_recognizes_ht_fuse_decorator:src"), "SPMD202")
    assert findings and ".tolist()" in findings[0].message


def test_spmd202_knows_the_ports_host_copies_and_syncs():
    src = """
import torch
import heat_tpu_torch as htt

@htt.fuse
def f(t):
    a = t.cpu()
    b = t.to("cpu")
    c = t.to(device=torch.device("cpu"))
    torch.cuda.synchronize()
    d = int(t.amax())
    return a, b, c, d

@htt.fuse
def g(t):
    e = t.to("cuda")
    f_ = t.to(torch.float64)
    n = int(t.size(0)) + int(t.numel()) + float(torch.finfo(t.dtype).eps)
    return e, f_, n
"""
    findings = lint(src, "SPMD202")
    assert [f.line for f in findings] == [7, 8, 9, 10, 11]
    assert "host copy .to('cpu')" in findings[1].message
    assert "torch.cuda.synchronize" in findings[3].message


# --------------------------------------------------------------------- #
# SPMD203: quantized collectives on exact dtypes                         #
# --------------------------------------------------------------------- #
def test_spmd203_triggers_on_astype_int_payload():
    findings = lint(twin("test_spmd203_triggers_on_astype_int_payload:src"), "SPMD203")
    assert findings and "'int32'" in findings[0].message


def test_spmd203_triggers_on_integer_constructor_payload():
    findings = lint(twin("test_spmd203_triggers_on_integer_constructor_payload:src"), "SPMD203")
    assert findings and "'bool'" in findings[0].message


def test_spmd203_clean_on_float_payloads():
    assert lint(twin("test_spmd203_clean_on_float_payloads:src"), "SPMD203") == []


def test_spmd203_knows_the_cast_methods_and_reduce_q():
    src = """
import torch
from heat_tpu_torch.comm import compressed as cq

def f(labels, x, comm):
    a = cq.reduce_q(labels.long(), comm=comm)
    b = cq.allreduce_q(x.bool(), comm=comm)
    c = cq.quantize_blocks(x.to("cuda", torch.int16))
    d = cq.allreduce_q(x.float(), comm=comm)
    e = cq.allreduce_q(x.to(torch.float32), comm=comm)
    return a, b, c, d, e
"""
    findings = lint(src, "SPMD203")
    assert [(f.line, f.message.rsplit(" ", 1)[-1]) for f in findings] == [
        (6, "'int64'"), (7, "'bool'"), (8, "'int16'")]


# --------------------------------------------------------------------- #
# SPMD204: quantized collectives in guard-disabled regions               #
# --------------------------------------------------------------------- #
def test_spmd204_triggers_inside_guard_off_block():
    findings = lint(twin("test_spmd204_triggers_inside_guard_off_block:src"), "SPMD204")
    assert findings and "allreduce_q" in findings[0].message
    assert "guard" in findings[0].message


def test_spmd204_triggers_after_set_guard_policy_off():
    findings = lint(twin("test_spmd204_triggers_after_set_guard_policy_off:src"), "SPMD204")
    assert findings and "allgather_q" in findings[0].message


def test_spmd204_suppression_comment_silences():
    assert lint(twin("test_spmd204_suppression_comment_silences:src"), "SPMD204") == []


def test_spmd204_clean_when_guards_active_or_absent():
    assert lint(twin("test_spmd204_clean_when_guards_active_or_absent:src"), "SPMD204") == []


# --------------------------------------------------------------------- #
# SPMD205: host timing inside captured functions                         #
# --------------------------------------------------------------------- #
def test_spmd205_triggers_on_clock_reads_in_jit():
    findings = lint(twin("test_spmd205_triggers_on_clock_reads_in_jit:src"), "SPMD205")
    msgs = " | ".join(f.message for f in findings)
    assert "time.perf_counter_ns" in msgs and "time.process_time" in msgs


def test_spmd205_triggers_on_span_in_shard_map_kernel():
    findings = lint(twin("test_spmd205_triggers_on_span_in_shard_map_kernel:src"), "SPMD205")
    assert findings and "telemetry.span" in findings[0].message


def test_spmd205_triggers_inside_jitted_factory():
    findings = lint(twin("test_spmd205_triggers_inside_jitted_factory:src"), "SPMD205")
    assert findings and "time.monotonic_ns" in findings[0].message


def test_spmd205_clean_on_host_side_timing():
    assert lint(twin("test_spmd205_clean_on_host_side_timing:src"), "SPMD205") == []


def test_spmd205_overlaps_spmd201_on_wall_clock():
    # either rule alone stops the commit; both fire on the shared set
    assert rules_of(lint(twin("test_spmd205_overlaps_spmd201_on_wall_clock:src"))) == ["SPMD201", "SPMD205"]


def test_spmd205_capture_block_covers_its_body_only():
    src = """
import time
import torch

def op(x, g):
    t0 = time.perf_counter()
    with torch.cuda.graph(g), open("log") as fh:
        y = x * 2
        t1 = time.perf_counter()
    return y, time.perf_counter() - t0, t1
"""
    assert [f.line for f in lint(src, "SPMD205")] == [9]


# --------------------------------------------------------------------- #
# SPMD206: monolithic resplit inside a loop body                         #
# --------------------------------------------------------------------- #
def test_spmd206_triggers_on_resplit_in_for_loop():
    findings = lint(twin("test_spmd206_triggers_on_resplit_in_for_loop:src"), "SPMD206")
    assert findings and "resplit" in findings[0].message
    assert "planned" in findings[0].hint


def test_spmd206_triggers_on_alltoall_in_while_loop():
    findings = lint(twin("test_spmd206_triggers_on_alltoall_in_while_loop:src"), "SPMD206")
    assert findings and "alltoall" in findings[0].message


def test_spmd206_triggers_on_dndarray_method_resplit():
    assert lint(twin("test_spmd206_triggers_on_dndarray_method_resplit:src"), "SPMD206")


def test_spmd206_clean_under_planned_policy():
    assert lint(twin("test_spmd206_clean_under_planned_policy:src"), "SPMD206") == []


def test_spmd206_clean_outside_loops_and_in_traced_bodies():
    assert lint(twin("test_spmd206_clean_outside_loops_and_in_traced_bodies:src"), "SPMD206") == []


def test_spmd206_monolithic_policy_does_not_exempt():
    assert lint(twin("test_spmd206_monolithic_policy_does_not_exempt:src"), "SPMD206")


def test_spmd206_suppression_comment_silences():
    assert lint(twin("test_spmd206_suppression_comment_silences:src"), "SPMD206") == []


# --------------------------------------------------------------------- #
# SPMD207: silent broad except around dispatch/collective/io sites       #
# --------------------------------------------------------------------- #
def test_spmd207_triggers_on_silent_except_around_collective():
    findings = lint(twin("test_spmd207_triggers_on_silent_except_around_collective:src"), "SPMD207")
    assert len(findings) == 1
    assert "resplit" in findings[0].message and "Exception" in findings[0].message
    assert "disable=SPMD207" in findings[0].hint


def test_spmd207_triggers_on_swallowed_oserror_open():
    findings = lint(twin("test_spmd207_triggers_on_swallowed_oserror_open:src"), "SPMD207")
    assert len(findings) == 1 and "'open'" in findings[0].message


def test_spmd207_triggers_on_bare_except_and_broad_tuple_member():
    findings = lint(twin("test_spmd207_triggers_on_bare_except_and_broad_tuple_member:src"), "SPMD207")
    assert len(findings) == 2
    assert "(bare except)" in findings[0].message
    assert "OSError" in findings[1].message


def test_spmd207_clean_on_visible_handlers():
    assert lint(twin("test_spmd207_clean_on_visible_handlers:src"), "SPMD207") == []


def test_spmd207_clean_on_narrow_or_unguarded_try():
    assert lint(twin("test_spmd207_clean_on_narrow_or_unguarded_try:src"), "SPMD207") == []


def test_spmd207_suppression_comment_silences():
    assert lint(twin("test_spmd207_suppression_comment_silences:src"), "SPMD207") == []


# --------------------------------------------------------------------- #
# SPMD208: unbucketed dynamic batch shape entering a fused program       #
# --------------------------------------------------------------------- #
def test_spmd208_triggers_on_dynamic_slice_into_fused_in_loop():
    findings = lint(twin("test_spmd208_triggers_on_dynamic_slice_into_fused_in_loop:src"), "SPMD208")
    assert findings, "dynamic slice into a fused program in a loop must fire"
    assert "fresh trace" in findings[0].message
    assert "bucket" in findings[0].hint


def test_spmd208_triggers_via_named_slice_and_jitted_product():
    assert lint(twin("test_spmd208_triggers_via_named_slice_and_jitted_product:src"), "SPMD208")


def test_spmd208_clean_when_bounds_are_bucketed():
    assert lint(twin("test_spmd208_clean_when_bounds_are_bucketed:src"), "SPMD208") == []


def test_spmd208_clean_outside_loops_constant_bounds_and_traced_bodies():
    src = twin("test_spmd208_clean_outside_loops_constant_bounds_and_traced_bodies:src")
    assert lint(src, "SPMD208") == []


def test_spmd208_plain_function_calls_do_not_fire():
    assert lint(twin("test_spmd208_plain_function_calls_do_not_fire:src"), "SPMD208") == []


def test_spmd208_suppression_comment_silences():
    assert lint(twin("test_spmd208_suppression_comment_silences:src"), "SPMD208") == []


def test_spmd208_leaves_the_eager_jitted_dispatch_alone():
    # a jitted product runs eagerly in the port: no program per shape
    src = """
from heat_tpu_torch.core._compile import jitted

def serve_loop(queue, sizes, make):
    prog = jitted(("serve.loop",), make)
    for n in sizes:
        prog(queue[:n])
"""
    assert lint(src, "SPMD208") == []


# --------------------------------------------------------------------- #
# SPMD210: request-scoped observability inside captured functions        #
# --------------------------------------------------------------------- #
def test_spmd210_triggers_on_trace_ctx_in_jit():
    findings = lint(twin("test_spmd210_triggers_on_trace_ctx_in_jit:src"), "SPMD210")
    assert findings and "trace_ctx" in findings[0].message


def test_spmd210_triggers_on_observe_and_flight_note_in_traced():
    findings = lint(twin("test_spmd210_triggers_on_observe_and_flight_note_in_traced:src"), "SPMD210")
    msgs = " | ".join(f.message for f in findings)
    assert "telemetry.observe" in msgs and "flight-recorder note" in msgs


def test_spmd210_triggers_inside_jitted_factory():
    findings = lint(twin("test_spmd210_triggers_inside_jitted_factory:src"), "SPMD210")
    assert findings and "telemetry.observe" in findings[0].message


def test_spmd210_clean_on_host_side_observability():
    assert lint(twin("test_spmd210_clean_on_host_side_observability:src"), "SPMD210") == []


def test_spmd210_suppression_comment_silences():
    assert lint(twin("test_spmd210_suppression_comment_silences:src"), "SPMD210") == []


# --------------------------------------------------------------------- #
# SPMD211-214: retries, blocking reads, IPC and waits                    #
# --------------------------------------------------------------------- #
def test_spmd211_triggers_on_forever_retry_of_compiled_call():
    findings = lint(twin("test_spmd211_triggers_on_forever_retry_of_compiled_call:src"), "SPMD211")
    assert findings and "no deadline" in findings[0].message


def test_spmd211_triggers_on_forever_retry_of_guarded_io():
    findings = lint(twin("test_spmd211_triggers_on_forever_retry_of_guarded_io:src"), "SPMD211")
    assert findings and "guarded site 'open'" in findings[0].message


def test_spmd211_clean_on_retry_engine_and_bounded_loops():
    assert lint(twin("test_spmd211_clean_on_retry_engine_and_bounded_loops:src"), "SPMD211") == []


def test_spmd211_handler_that_escapes_is_clean():
    assert lint(twin("test_spmd211_handler_that_escapes_is_clean:src"), "SPMD211") == []


def test_spmd211_suppression_comment_silences():
    assert lint(twin("test_spmd211_suppression_comment_silences:src"), "SPMD211") == []


def test_spmd211_counts_a_jitted_dispatch_as_a_program_call():
    src = """
from heat_tpu_torch.core._compile import jitted

def run(x, make):
    while True:
        try:
            return jitted(("op.run",), make)(x)
        except Exception:
            pass
"""
    findings = lint(src, "SPMD211")
    assert findings and "a compiled program call" in findings[0].message


def test_spmd212_triggers_on_h5py_read_in_compiled_loop():
    findings = lint(twin("test_spmd212_triggers_on_h5py_read_in_compiled_loop:src"), "SPMD212")
    assert findings and "blocking host read" in findings[0].message
    assert "heat_tpu_torch.io.stream.stream_chunks" in findings[0].hint


def test_spmd212_triggers_on_per_iteration_reopen():
    findings = lint(twin("test_spmd212_triggers_on_per_iteration_reopen:src"), "SPMD212")
    assert findings and "re-opens the file" in findings[0].message


def test_spmd212_triggers_on_netcdf_variable_read():
    findings = lint(twin("test_spmd212_triggers_on_netcdf_variable_read:src"), "SPMD212")
    assert findings and "blocking host read" in findings[0].message


def test_spmd212_clean_on_hoisted_read_and_streamed_loop():
    assert lint(twin("test_spmd212_clean_on_hoisted_read_and_streamed_loop:src"), "SPMD212") == []


def test_spmd212_suppression_comment_silences():
    assert lint(twin("test_spmd212_suppression_comment_silences:src"), "SPMD212") == []


def test_spmd213_triggers_on_socket_recv_in_compiled_loop():
    findings = lint(twin("test_spmd213_triggers_on_socket_recv_in_compiled_loop:src"), "SPMD213")
    assert findings and "blocking socket/pipe I/O" in findings[0].message
    assert "until the peer answers" in findings[0].message


def test_spmd213_triggers_on_os_read_and_subprocess_wait():
    findings = lint(twin("test_spmd213_triggers_on_os_read_and_subprocess_wait:src"), "SPMD213")
    assert len(findings) == 2
    assert "os.read" in findings[0].message
    assert "waits for the child" in findings[1].message


def test_spmd213_clean_on_ipc_without_dispatch_and_worker_shape():
    assert lint(twin("test_spmd213_clean_on_ipc_without_dispatch_and_worker_shape:src"), "SPMD213") == []


def test_spmd213_traced_context_exempt():
    # socket exists but is never read in the loop: clean
    assert lint(twin("test_spmd213_traced_context_exempt:src"), "SPMD213") == []


def test_spmd213_suppression_comment_silences():
    assert lint(twin("test_spmd213_suppression_comment_silences:src"), "SPMD213") == []


def test_spmd214_triggers_on_zero_timeout_waits():
    findings = lint(twin("test_spmd214_triggers_on_zero_timeout_waits:src"), "SPMD214")
    assert len(findings) == 3
    assert "`.wait()` has no timeout" in findings[0].message
    assert "`.get()` has no timeout" in findings[1].message
    assert "timeout-less socket" in findings[2].message


def test_spmd214_clean_on_bounded_waits():
    assert lint(twin("test_spmd214_clean_on_bounded_waits:src"), "SPMD214") == []


def test_spmd214_dict_get_and_bounded_loops_exempt():
    assert lint(twin("test_spmd214_dict_get_and_bounded_loops_exempt:src"), "SPMD214") == []


def test_spmd214_suppression_comment_silences():
    assert lint(twin("test_spmd214_suppression_comment_silences:src"), "SPMD214") == []


# --------------------------------------------------------------------- #
# SPMD401: jitted() cache-key hygiene                                    #
# --------------------------------------------------------------------- #
def test_spmd401_triggers_on_callable_in_key():
    findings = lint(twin("test_spmd401_triggers_on_callable_in_key:src"), "SPMD401")
    assert findings and "callable 'fn'" in findings[0].message


def test_spmd401_triggers_on_lambda_array_and_shapeless_keys():
    msgs = " | ".join(f.message for f in lint(twin("test_spmd401_triggers_on_lambda_array_and_shapeless_keys:src"),
                                              "SPMD401"))
    assert "lambda in jitted() key" in msgs
    assert "array-valued call 'torch.zeros'" in msgs
    assert "not a statically-visible tuple literal" in msgs
    assert "namespace string" in msgs


def test_spmd401_clean_on_static_data_keys():
    assert lint(twin("test_spmd401_clean_on_static_data_keys:src"), "SPMD401") == []


# --------------------------------------------------------------------- #
# SPMD001 and the suppression mechanics                                  #
# --------------------------------------------------------------------- #
SPMD001_SRC = """
from heat_tpu_torch.comm.compressed import allreduce_q
from heat_tpu_torch.resilience import guard

def bare(x, comm):
    with guard("off"):
        return allreduce_q(x, comm=comm)  # spmdlint: disable=SPMD204

def empty(x, comm):
    with guard("off"):
        return allreduce_q(x, comm=comm)  # spmdlint: disable=SPMD204 --

def reasoned(x, comm):
    with guard("off"):
        return allreduce_q(x, comm=comm)  # spmdlint: disable=SPMD204 -- bench harness, guards off by design

def other_rule(x):
    return x  # spmdlint: disable=SPMD206
"""


def test_spmd001_triggers_on_suppressions_without_a_reason():
    findings = lint(SPMD001_SRC)
    assert [(f.rule, f.line) for f in findings] == [("SPMD001", 7), ("SPMD001", 11)]
    assert "SPMD204 has no reason" in findings[0].message


def test_spmd001_clean_on_reasoned_or_ungated_suppressions():
    src = SPMD001_SRC.split("def bare")[0] + "def reasoned" + SPMD001_SRC.split("def reasoned")[1]
    assert lint(src) == []


def test_inline_suppression_and_skip_file():
    assert lint(twin("test_inline_suppression_and_skip_file:hot"), "SPMD201") == []
    assert lint(twin("test_inline_suppression_and_skip_file:skipped")) == []


def test_suppression_is_rule_specific():
    src = twin("test_suppression_is_rule_specific:src")
    assert lint(src, "SPMD201"), "suppressing another rule must not silence SPMD201"


# --------------------------------------------------------------------- #
# baseline and cache                                                     #
# --------------------------------------------------------------------- #
def test_baseline_partition_roundtrip(tmp_path):
    f1 = Finding(rule="SPMD201", path="a.py", line=3, message="m", context="f::x")
    f2 = Finding(rule="SPMD401", path="b.py", line=9, message="n", context="g::y")
    path = str(tmp_path / "base.json")
    write_baseline(path, [f1, f1])
    base = load_baseline(path)
    assert len(base) == 1
    new, old, stale = partition([f1, f2], base)
    assert [f.rule for f in new] == ["SPMD401"]
    assert [f.rule for f in old] == ["SPMD201"]
    assert stale == []
    # f1 fixed -> its entry goes stale
    new, old, stale = partition([f2], base)
    assert len(stale) == 1 and "SPMD201" in stale[0]
    with open(path) as fh:
        assert json.load(fh)["version"] == 1
    assert load_baseline(str(tmp_path / "missing.json")) == {}


def test_baseline_fingerprint_is_line_insensitive():
    a = Finding(rule="SPMD201", path="a.py", line=3, message="m", context="f::print(x)")
    b = Finding(rule="SPMD201", path="a.py", line=30, message="m", context="f::print(x)")
    assert a.fingerprint() == b.fingerprint()
    src = twin("test_spmd201_triggers_on_global_write_in_shard_map_kernel:src")
    moved = lint("\n\n# a comment above\n" + src, "SPMD201")
    here = lint(src, "SPMD201")
    assert [f.line for f in moved] == [f.line + 3 for f in here]
    assert [f.fingerprint() for f in moved] == [f.fingerprint() for f in here]


def test_the_committed_baseline_is_the_ports_own_and_empty():
    path = os.path.join(REPO, DEFAULT_BASELINE)
    assert DEFAULT_BASELINE == os.path.join("heat_tpu_torch", "spmdlint-baseline.json")
    with open(path) as fh:
        assert json.load(fh) == {"findings": [], "version": 1}


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_cache_hits_misses_and_invalidation(tmp_path):
    src_dir = tmp_path / "pkg"
    src_dir.mkdir()
    a = _write(src_dir, "a.py", twin("test_spmd206_triggers_on_resplit_in_for_loop:src"))
    _write(src_dir, "b.py", "x = 1\n")
    cache = FindingsCache(str(tmp_path / "cache"))
    cold = analyze_paths([str(src_dir)], root=str(tmp_path), cache=cache)
    assert (cache.hits, cache.misses) == (0, 2)
    warm = analyze_paths([str(src_dir)], root=str(tmp_path), cache=cache)
    assert (cache.hits, cache.misses) == (2, 2)
    assert warm == cold and [f.rule for f in cold] == ["SPMD206"]
    # an edited file misses; the untouched one hits
    with open(a, "a") as fh:
        fh.write("\n# edited\n")
    cache2 = FindingsCache(str(tmp_path / "cache"))
    analyze_paths([str(src_dir)], root=str(tmp_path), cache=cache2)
    assert (cache2.hits, cache2.misses) == (1, 1)
    # another rule subset or the dynamic flag is another key
    analyze_paths([str(src_dir)], root=str(tmp_path), cache=cache2, rules=["SPMD206"])
    analyze_paths([str(src_dir)], root=str(tmp_path), cache=cache2, dynamic=False)
    assert (cache2.hits, cache2.misses) == (1, 5)
    assert cache2.stats() == "1 hit, 5 miss"


def test_cache_only_holds_file_scope_findings(tmp_path):
    src = "import heat_tpu_torch as ht\n\ndef f(x):\n    y = x.resplit(0)\n    return y.resplit(0)\n"
    p = _write(tmp_path, "m.py", src)
    cache = FindingsCache(str(tmp_path / "cache"))
    ctx = FileContext(p, relpath="m.py")
    first = analyze_contexts([ctx], cache=cache)
    entries = [json.load(open(os.path.join(cache.cache_dir, n))) for n in os.listdir(cache.cache_dir)]
    assert len(entries) == 1 and all(not f["rule"].startswith("SPMD5") for f in entries[0]["findings"])
    again = analyze_contexts([FileContext(p, relpath="m.py")], cache=cache)
    assert cache.hits == 1 and again == first


def test_cache_survives_corrupt_entries_and_unwritable_dirs(tmp_path):
    p = _write(tmp_path, "m.py", "x = 1\n")
    cache = FindingsCache(str(tmp_path / "cache"))
    ctx = FileContext(p, relpath="m.py")
    analyze_contexts([ctx], cache=cache)
    entry = os.path.join(cache.cache_dir, os.listdir(cache.cache_dir)[0])
    with open(entry, "w") as fh:
        fh.write("{not json")
    assert analyze_contexts([ctx], cache=cache) == [] and cache.misses == 2
    blocked = _write(tmp_path, "blocked", "")
    bad = FindingsCache(os.path.join(blocked, "sub"))
    assert analyze_contexts([ctx], cache=bad) == [] and bad.misses == 1


def test_the_default_cache_is_not_the_references():
    from heat_tpu_torch.analysis import cache

    assert cache.DEFAULT_CACHE_DIR == ".spmdlint-torch-cache"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".spmdlint-torch-cache/" in fh.read().split()


# --------------------------------------------------------------------- #
# the CLI                                                                #
# --------------------------------------------------------------------- #
def cli(*args):
    """``python -m heat_tpu_torch.analysis.cli *args`` in this process
    (the interpreter's start-up, a torch import, is what a subprocess
    would add): its exit code, standard output and standard error."""
    import contextlib
    import io

    from heat_tpu_torch.analysis import cli as cli_mod

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli_mod.main(list(args))
        except SystemExit as exc:  # argparse's usage errors
            rc = exc.code
    return subprocess.CompletedProcess(args, rc, out.getvalue(), err.getvalue())


def test_cli_runs_as_a_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-m", "heat_tpu_torch.analysis.cli", "--list-rules"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert [line.split()[0] for line in proc.stdout.splitlines()] == PORTED


@pytest.fixture
def fixtures(tmp_path):
    d = tmp_path / "src"
    d.mkdir()
    _write(d, "dirty.py", twin("test_spmd207_triggers_on_silent_except_around_collective:src"))
    _write(d, "clean.py", twin("test_spmd207_clean_on_visible_handlers:src"))
    return tmp_path, str(d)


def test_cli_exit_codes_and_text_format(fixtures):
    tmp, d = fixtures
    cache = str(tmp / "cache")
    proc = cli(d, "--cache-dir", cache)
    assert proc.returncode == 1, proc.stderr
    assert "dirty.py:5: SPMD207" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1].startswith("spmdlint: 1 finding(s)")
    assert "cache 0 hit, 2 miss" in proc.stdout
    assert "cache 2 hit, 0 miss" in cli(d, "--cache-dir", cache).stdout
    clean = cli(os.path.join(d, "clean.py"), "--no-cache")
    assert clean.returncode == 0 and "0 finding(s)" in clean.stdout and "cache off" in clean.stdout
    missing = cli(os.path.join(d, "nope.py"))
    assert missing.returncode == 2 and "no such path" in missing.stderr
    assert cli("--format", "yaml").returncode == 2


def test_cli_json_and_github_formats(fixtures):
    tmp, d = fixtures
    doc = json.loads(cli(d, "--no-cache", "--format", "json").stdout)
    assert doc["count"] == 1 and doc["findings"][0]["rule"] == "SPMD207"
    assert doc["findings"][0]["fingerprint"].startswith("SPMD207::")
    gh = cli(d, "--no-cache", "--format", "github").stdout.splitlines()
    assert gh[0].startswith("::error file=") and ",line=5,title=SPMD207::" in gh[0]
    assert "," not in gh[0].split("::", 2)[2]
    quiet = cli(d, "--no-cache", "-q")
    assert quiet.returncode == 1 and quiet.stdout.strip().splitlines() == [quiet.stdout.strip()]


def test_cli_baseline_update_and_gate(fixtures):
    tmp, d = fixtures
    base = str(tmp / "base.json")
    upd = cli(d, "--no-cache", "--update-baseline", "--baseline", base)
    assert upd.returncode == 0 and "(1 findings)" in upd.stdout
    gated = cli(d, "--no-cache", "--baseline", base)
    assert gated.returncode == 0 and "0 new, 1 baselined, 0 stale" in gated.stdout
    os.remove(os.path.join(d, "dirty.py"))
    stale = cli(d, "--no-cache", "--baseline", base)
    assert stale.returncode == 0 and "stale baseline entry" in stale.stdout


def test_cli_rule_filter_no_dynamic_and_list_rules(tmp_path):
    p = _write(tmp_path, "m.py", twin("test_spmd101_triggers_on_duplicate_destination:src")
               + twin("test_spmd206_triggers_on_resplit_in_for_loop:src"))
    assert "SPMD101" in cli(p, "--no-cache").stdout
    no_dyn = cli(p, "--no-cache", "--no-dynamic").stdout
    assert "SPMD101" not in no_dyn and "SPMD206" in no_dyn
    only = cli(p, "--no-cache", "--rule", "SPMD101").stdout
    assert "SPMD101" in only and "SPMD206" not in only
    listed = cli("--list-rules").stdout.split()
    assert [w for w in listed if w.startswith("SPMD")] == PORTED


def test_cli_cost_report(tmp_path):
    p = _write(tmp_path, "m.py", "import heat_tpu_torch as ht\n\n\ndef mover(comm=None):\n"
               "    x = ht.ones((64, 8), split=0, comm=comm)\n    return x.resplit(1)\n")
    doc = json.loads(cli(p, "--cost-report", "--format", "json", "--mesh", "4").stdout)
    assert doc["mesh"] == 4 and doc["cost_model"] == "heat_tpu_torch/comm/_costs.py"
    assert doc["totals"]["modeled_wire_bytes"] > 0
    table = cli(p, "--cost-report", "--precision", "int8_block")
    assert table.returncode == 0 and "precision=int8_block" in table.stdout


# --------------------------------------------------------------------- #
# the registry and the gate                                              #
# --------------------------------------------------------------------- #
def test_every_ported_rule_is_registered():
    from heat_tpu_torch.analysis.core import _register_all_rules

    _register_all_rules()  # the program rules register at the first analysis
    assert [r.id for r in all_rules()] == PORTED
    assert not set(NOT_PORTED) & {r.id for r in all_rules()}
    assert [r.id for r in all_rules() if r.dynamic] == ["SPMD101"]


def test_every_ported_rule_has_a_trigger_and_a_clean_twin():
    for rule in PORTED[1:16]:
        keys = [k for k in TWINS if k.startswith(f"test_{rule.lower()}_")]
        fired = [k for k in keys if lint(TWINS[k], rule)]
        assert fired and len(fired) < len(keys), rule


def test_the_ports_tree_has_no_new_findings():
    findings = analyze_paths([os.path.join(REPO, "heat_tpu_torch")], root=REPO)
    baseline = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    new, _, _ = partition(findings, baseline)
    assert new == [], "new spmdlint findings:\n" + "\n".join(f.render() for f in new)


def test_every_suppression_in_the_ports_tree_gives_its_reason():
    import re

    seen = []
    for root, _, files in os.walk(os.path.join(REPO, "heat_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                for lineno, ids, reason in FileContext(path, relpath=name).suppressions():
                    seen.append((name, lineno, ids))
                    assert reason, f"{path}:{lineno}: suppression of {ids} without a reason"
    assert seen and all(re.fullmatch(r"SPMD\d{3}", i) for _, _, ids in seen for i in ids)


# --------------------------------------------------------------------- #
# runtime ground truth: the builders the lint rule simulates             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("size", MESH_SIZES)
def test_zigzag_perms_are_bijections(size):
    from heat_tpu_torch.parallel.primitives import (
        zigzag_chunk_owner,
        zigzag_inverse_perms,
        zigzag_perms,
    )

    for builder in (zigzag_perms, zigzag_inverse_perms):
        for perm in builder(size):
            assert check_partial_bijection(perm, size) is None
            assert {d for _, d in perm} == set(range(size)), "must cover every position"
    assert (
        verify_zigzag_builders(
            zigzag_perms, zigzag_inverse_perms, zigzag_chunk_owner, sizes=[size]
        )
        is None
    )


@pytest.mark.parametrize("size", MESH_SIZES)
def test_ring_map_schedule_is_a_bijection(size):
    import torch

    from heat_tpu_torch.parallel.primitives import _permute, ring_source

    perm = [(i, (i + 1) % size) for i in range(size)]
    assert check_partial_bijection(perm, size) is None
    assert verify_ring_schedule(ring_source, sizes=[size]) is None
    # every round of the ring visits each source exactly once per position
    for pos in range(size):
        sources = {ring_source(pos, r, size) for r in range(size)}
        assert sources == set(range(size))
    # and the port's _permute moves block src to dst along that perm
    blocks = torch.arange(size * 3).reshape(size, 3)
    moved = _permute(blocks, perm)
    for src, dst in perm:
        assert torch.equal(moved[dst], blocks[src])
