"""The benchmark of mic_tpu_torch's study-decode service.

One run serves one cell once.  A cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``configs/<name>.json``: the
slices and studies) and a traffic mix (``traffic/<name>.json``: how the
studies are written and decoded).  The mix names its request path
(``"path"``, ``micw`` where it names none): ``paths/<name>.py``, the
program's writer, its staged plan, its two halves of a request and a
plain decoder of the format.  Each metric is read by its own reader,
``metrics/<name>.py``.  Everything is found by name, so a new cell,
configuration, mix, path or metric is new files and entries only.

Set-up: the pool of slices is drawn from the configuration and written
by the path's ``encode``; each staged study becomes one plan of its own
containers (the path's ``stage``); every study is then served twice.
The window: requests, each one study in a seeded order, each the path's
``launch`` then its ``answer``, dispatched ahead of the card by at most
``in_flight`` requests, timed on the host's clock from the first submit
to the closing synchronise, with no trace and nothing launched but the
program's own work.  Each request's latency runs from its submit (the
host's clock) to a CUDA event recorded after its answer, placed on the
host's clock by an event recorded at the window's start.  A
``--trace 1`` run records the program's own spans and counters through
set-up, then serves an untraced stretch for the host's share, a stretch
traced on the card (``devtrace.py``) for the card's, and a stretch traced
both ways, each request inside the program's ``trace.request``, for the
program's spans beside the card's records (``programtrace.py``).  After
the window, a seeded sample of the answers is compared with the
generated slices and the pool's containers are decoded by the path's
plain reference (``check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

from . import check, devtrace, programtrace, roofline, studies

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mic_tpu")  # top-level module names the run may not hold
WARMUP_ROUNDS = 2  # set-up serves every staged study this many times
CHECK_SAMPLE = 8  # requests of the window drawn for the comparison, besides each study's last
TRACE_REQUESTS = 200  # requests of each stretch of a --trace 1 run
TRACE_TRIES = 2  # traced stretches tried before a run fails on a trace that lost records
DEFAULT_PATH = "micw"  # the request path of a mix that names none


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _load_module(kind: str, name: str, root: Path):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read(ctx)``,
    which returns a number or None where it finds nothing to read."""
    return _load_module("metrics", name, root).read


def load_path(name: str, root: Path = ROOT):
    """The request path ``name``: the module ``paths/<name>.py``, with
    ``encode(pool, config, traffic)`` (the pool's containers, written by
    the program's writer), ``stage(blobs, device, traffic)`` (one study's
    plan), ``launch(plan)`` and ``answer(plan, outs)`` (a request's two
    halves: the answer is [(int16 [w * h] on the device, w, h)] an image)
    and ``reference_decode(blob)`` (a plain decoder, independent of the
    program: (u16 [h * w], w, h)).  Raises FileNotFoundError, naming the
    file, where there is none."""
    return _load_module("paths", name, root)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``traced`` its per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Modules of JAX or the JAX package that the process holds, compared
    by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _untraced(_request):
    return contextlib.nullcontext()


class Served:
    """The staged studies of one run and what serving them needs; the
    mix's request path (``load_path``) writes, stages and serves them."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, root: Path = ROOT):
        self.path = load_path(traffic.get("path", DEFAULT_PATH), root)  # before any set-up
        self.traffic, self.device = traffic, device
        self.width, self.height = config["width"], config["height"]
        self.pool = studies.make_pool(config, root)
        self.blobs = self.path.encode(self.pool, config, traffic)
        self.studies = studies.make_studies(config, seed)
        npx = self.width * self.height
        self.pixel_bytes = [2 * npx * len(s) for s in self.studies]
        self.request_bytes = [roofline.request_bytes([len(self.blobs[j]) for j in s], npx * len(s))
                              for s in self.studies]
        t0 = time.perf_counter()
        self.plans = [self.path.stage([self.blobs[j] for j in s], device, traffic)
                      for s in self.studies]
        self.plan_stage_s = time.perf_counter() - t0
        self.order = studies.request_order(len(self.studies), seed)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def serve(self, *, seconds: float | None = None, requests: int | None = None,
              sample: check.Sample | None = None, spans=None) -> dict:
        """Serve requests until ``seconds`` have passed or ``requests`` were
        made, at most ``in_flight`` ahead of the card, then wait for the
        card; with ``spans`` (the program's tracer) each request's two
        calls run inside ``spans.request(i)``, i counting from 0.  Returns
        the requests, their pixel and request bytes, the wall seconds from
        the first submit to the closing synchronise, the host seconds spent
        inside the program's calls (in all, and inside ``launch`` alone),
        and each request's latency in ms, from its submit to the end of its
        answer on the card."""
        import torch

        depth = self.traffic["in_flight"]
        launch, answer = self.path.launch, self.path.answer
        request = _untraced if spans is None else spans.request
        inflight: deque = deque()
        pixel_bytes = request_bytes = n = 0
        in_call = in_run = 0.0
        submits, ends = [], []
        clock = time.perf_counter
        self.sync()
        if self.cuda:  # the host's clock and the card's, side by side
            start = torch.cuda.Event(enable_timing=True)
            t0 = clock()
            start.record()
        else:
            t0 = clock()
        while (requests is None or n < requests) and (seconds is None or clock() - t0 < seconds):
            k = next(self.order)
            plan = self.plans[k]
            t = clock()
            with request(n):
                outs = launch(plan)
                t_run = clock()
                images = answer(plan, outs)
            t_end = clock()
            in_call += t_end - t
            in_run += t_run - t
            submits.append(t)
            del outs
            if self.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                ends.append(end)
                inflight.append(end)
                if len(inflight) > depth:
                    inflight.popleft().synchronize()
            else:  # on the CPU every call returns finished
                ends.append(t_end)
            if sample is not None:
                sample.offer(k, images)
            del images
            pixel_bytes += self.pixel_bytes[k]
            request_bytes += self.request_bytes[k]
            n += 1
        self.sync()
        wall_s = clock() - t0
        if self.cuda:
            done_ms = [start.elapsed_time(e) for e in ends]
        else:
            done_ms = [1e3 * (e - t0) for e in ends]
        latency_ms = [d - 1e3 * (t - t0) for d, t in zip(done_ms, submits)]
        return {"requests": n, "pixel_bytes": pixel_bytes, "request_bytes": request_bytes,
                "wall_s": wall_s, "dispatch_s": in_call, "run_s": in_run,
                "latency_ms": latency_ms}


def _quiet(fn):
    """``fn()`` with the garbage collector held off, as a service keeps
    it off its request path."""
    gc.collect()
    gc.disable()
    try:
        return fn()
    finally:
        gc.enable()


def _traced(served: Served, stretch):
    """``stretch()`` under ``devtrace.profiled`` with the garbage collector
    held off: (its result, the card's records on the wall clock, the trace
    clock's error).  A stretch whose trace lost a record of a port launch
    is served again in a new session, up to ``TRACE_TRIES`` in all; the
    run fails if the last one lost records too."""
    for attempt in range(TRACE_TRIES):
        try:
            return _quiet(lambda: devtrace.profiled(stretch, served.device))
        except devtrace.LostRecords as exc:
            if attempt + 1 == TRACE_TRIES:
                raise
            print(f"portbench: traced stretch {attempt + 1} lost records, served again: {exc}",
                  file=sys.stderr)


def _window_note(w: dict, allocs: int) -> str:
    """A line on the window for the run's standard error: its requests and
    rate, the host's share inside the program, the requests' mean latency
    in each half (a drifting pace shows there) and the allocator's device
    mallocs during it."""
    ms = w["latency_ms"]
    half = len(ms) // 2
    return (f"portbench: window {w['wall_s']:.3f} s, {w['requests']} requests, "
            f"{w['pixel_bytes'] / w['wall_s'] / 1e9:.3f} GB/s, host in the program "
            f"{w['dispatch_s']:.3f} s (launch {w['run_s']:.3f}), latency ms mean "
            f"{np.mean(ms):.4f} (halves {np.mean(ms[:half]):.4f} / {np.mean(ms[half:]):.4f}), "
            f"device mallocs {allocs}")


def _device_allocs(served: Served) -> int:
    """The caching allocator's calls to the device's malloc so far."""
    import torch

    return torch.cuda.memory_stats(served.device).get("num_device_alloc", 0) if served.cuda else 0


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, root: Path = ROOT) -> tuple[dict, dict]:
    """Serve one cell once on ``device``; returns (the result line, the
    numbers compared).  ``t_start`` is the process's first clock reading:
    set-up runs from it to the end of the warm-up.  ``root`` holds the
    configurations, mixes, paths and readers."""
    import torch

    device = torch.device(device)
    cell = find_cell(bench, workload)
    config, traffic = load_config(cell["config"], root), load_traffic(cell["traffic"], root)
    # the program's spans and counters, in a traced run only: from staging
    # to the end of the warm-up, then in a stretch of their own
    trace = programtrace.tracer() if traced else None
    if trace is not None:
        trace.take()
        trace.enable()
    try:
        t_served = time.perf_counter()
        served = Served(config, traffic, seed, device, root)
        t_warm = time.perf_counter()
        served.serve(requests=WARMUP_ROUNDS * len(served.studies))
    finally:
        if trace is not None:
            setup = trace.take()
            trace.disable()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s: start and load {t_served - t_start:.3f}, pool "
          f"and plans {t_warm - t_served:.3f} (plans {served.plan_stage_s:.3f}), warm-up "
          f"{setup_s - (t_warm - t_start):.3f}; studies of {[len(s) for s in served.studies]} "
          f"slices, {sum(len(b) for b in served.blobs)} bytes of containers in the pool",
          file=sys.stderr)
    allocs = _device_allocs(served)
    sample = check.Sample(studies.sample_rng(seed), CHECK_SAMPLE)
    ctx: dict = {"setup_s": setup_s, "plan_stage_s": served.plan_stage_s}
    dev = {"platform": "gpu" if served.cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if served.cuda else "cpu",
           "count": cell["chips"]}
    line: dict = {}
    if not traced:
        ctx["window"] = _quiet(lambda: served.serve(seconds=seconds, sample=sample))
        attempted = ctx["window"]["requests"]
        print(_window_note(ctx["window"], _device_allocs(served) - allocs), file=sys.stderr)
    else:
        n = TRACE_REQUESTS
        ctx["dispatch"] = _quiet(lambda: served.serve(requests=n, sample=sample))
        port = devtrace.port_kernels()
        stretch, records, _off = _traced(served, lambda: served.serve(requests=n, sample=sample))
        summary = devtrace.summarize(devtrace.in_seconds(records), port)
        ctx["trace"] = {**stretch, **summary, "port": port}
        ctx["card"] = roofline.peaks(dev["kind"])
        attempted = ctx["dispatch"]["requests"] + stretch["requests"]
        dev.update(busy_s=summary["busy_s"], window_s=stretch["wall_s"],
                   power_limit=power_limit())
        line["breakdown"] = devtrace.breakdown(summary, max(stretch["wall_s"] - summary["span_s"],
                                                         0.0))
        if trace is not None:
            program = programtrace.program_stretch(*_traced(
                served, lambda: programtrace.serve_traced(served, trace, n, sample)))
            ctx["program"] = programtrace.program_ctx(setup, program)
            attempted += program["requests"]
            line["breakdown"].update(programtrace.breakdown(ctx["program"]))
            print(programtrace.setup_note(ctx["program"]), file=sys.stderr)
            print(programtrace.stretch_note(ctx["program"], ctx["dispatch"], stretch),
                  file=sys.stderr)
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if served.cuda else 0
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = load_metric(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the judgement, once the window has closed and the peak is read: the
    # program's plans are freed, its answers kept
    kept = sample.kept()
    del served.plans, sample
    gc.collect()
    pool_dev = torch.from_numpy(served.pool.view(np.int16)).to(device)
    wrong, failed, unchecked = check.compare_requests(kept, served.studies, pool_dev,
                                                      served.width, served.height)
    del kept, pool_dev
    numbers = {"pixels_wrong": wrong,
               "blob_pixels_wrong": check.blob_pixels_wrong(
                   served.blobs, served.pool, served.width, served.height,
                   served.path.reference_decode),
               "studies_unchecked": unchecked}
    result = {"correct": check.verdict(numbers), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, **line,
              "compared": {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}}
    return result, numbers


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Serve one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}: nothing measured", file=sys.stderr)
        return 2
    result, numbers = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda:0", t_start)
    held = forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} (JAX or the JAX package): no result",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"compared: {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
