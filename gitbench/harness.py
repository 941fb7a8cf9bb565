"""One run of one cell: set-up, the window, the judge, the metrics.

Set-up is everything from the process's start until the window opens: the
imports, the cell's inputs (made from the seed), the weights (drawn on the
card from the seed), the program's construction by the traffic's driver
(`Driver.build`; its kernels load from `build/gitax_torch/` in the
checkout, built by nvcc on a checkout's first run), and the warm-up of the
shapes this cell's traffic uses.  The window then measures for `seconds`.
After it: the peak device memory is read, the program is closed and freed
(also on any failure), and the plain reference the configuration names
(`spec.reference`) judges a sample of the outputs (not counted in set-up).
"""

from __future__ import annotations

import gc
import os
import shutil
import subprocess
import tempfile
import time
import types

from . import drivers, judge, spec, weights
from . import trace as tr
from .program import Hooks, launch_counts, steps_settled

SPAN_START, SPAN_SECONDS = 0.4, 3.0  # the traced span: where in the window, how long


def card_line():
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable: power limit unknown"


def host_cpu():
    """(this process's CPU seconds, wall seconds)."""
    t = os.times()
    return t.user + t.system, time.perf_counter()


def run(bench, cell, seed, seconds, traced, device, t_start, log, fault=None, traffic=None,
        limits=None, control=False):
    """Run `cell` once; returns the result dict (the last line's keys).
    fault: a callable(program) that breaks the program after it is built
    (the tests' planted faults); traffic, limits: in place of the cell's
    files (the tests' tiny sizes); control: also judge the served tokens
    with the reference one step below the configuration's precision
    (`control_score_gap_bf16` among the checks; control.py)."""
    import torch

    cfg = spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    limits = limits or spec.workload(cell["name"])
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="gitbench-", dir=base)
    program = hooks = None
    try:
        driver = drivers.make(cfg, traffic, seed, work)
        driver.prepare()
        sd = weights.make(cfg, seed, device)
        program = driver.build(cfg, sd, device)
        del sd
        if fault is not None:
            fault(program)
        hooks = Hooks(program, traced=bool(traced))
        driver.warm(program)
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        steps0 = span = None
        if traced and on_card:
            span = tr.Span(SPAN_START * seconds, min(SPAN_SECONDS, 0.4 * seconds),
                           lambda: steps_settled(program.model), launch_counts)
            steps0 = steps_settled(program.model)
        captures0 = hooks.captures
        setup_s = time.perf_counter() - t_start
        cpu0 = host_cpu()
        window = driver.window(program, hooks, seconds, span)
        cpu1 = host_cpu()
        t_end = time.perf_counter()
        if on_card:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        captures = hooks.captures - captures0
        batches = hooks.host_batches()
        served = driver.served(hooks, window)
        ctx = types.SimpleNamespace(cfg=cfg, cell=cell, traffic=traffic, window=window,
                                    setup_s=setup_s, hooks=hooks, batches=batches,
                                    profile=None,
                                    span=span, span_ms=None, steps=None)
        if traced and on_card:
            ctx.span_ms = hooks.span_ms(cpu0[1], t_end)
            ctx.steps = steps_settled(program.model) - steps0
            if span.steps is not None:
                ctx.profile = span.reduce(hooks.spans,
                                          hooks.searches(span.ref, span.t_open, span.t_close))
        hooks.remove()
        program.close()
        program = hooks = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        R = spec.reference(cfg)
        sd = weights.make(cfg, seed, device)
        refs = {"f32": R.Reference(cfg, sd, device),
                "bf16": R.Reference(cfg, sd, device, "bf16")}
        if control:
            refs["lowp"] = R.Reference(cfg, sd, device, precision="lowp")
        del sd
        checks, info = judge.judge(cfg, served, batches, limits["sample"], seed, refs, device,
                                   limits["limits"], R=R, pick=driver.pick)
        del refs
        log("run: {} seed {}: setup {:.2f} s, window {}, graph captures in the window {}, "
            "this process {:.2f} of {} cores; judge {}".format(
                cell["name"], seed, setup_s, {k: v for k, v in window.items()
                                              if k not in ("latencies_s", "late_s")},
                captures, (cpu1[0] - cpu0[0]) / max(cpu1[1] - cpu0[1], 1e-9), os.cpu_count(),
                info))
        kind = "per_layer" if traced else "end_to_end"
        metrics = {}
        for m in spec.metrics(bench, cell["name"], kind):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = len(served), sum(1 for s in served if s.text is None)
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        result = {"correct": judge.passed(checks), "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if ctx.profile is not None:
            dev["busy_s"] = ctx.profile["busy_s"]
            dev["window_s"] = ctx.profile["window_s"]
            result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                                   "idle_gaps": ctx.profile["idle_gaps"]}
            kept = {k: sum(n for name, n in ctx.profile["calls"].items() if k in name)
                    for k in span.launched}
            log("trace: idle by host span {}; steps in the span {}; kernel records kept {} of "
                "launched {}; marker kernels kept {} of 2{}".format(
                    ctx.profile["idle_by_host"], span.steps, kept, span.launched,
                    ctx.profile["markers"], "" if ctx.profile["lost"] is None else
                    " (the {} lost: its end from the host clock)".format(ctx.profile["lost"])))
            # a span whose trace lost a marker kernel (trace.Span.bounds) is marked in the line
            result["trace"] = {"markers_kept": ctx.profile["markers"],
                               "lost": ctx.profile["lost"]}
        result["checks"] = checks
        return result
    finally:
        if hooks is not None:
            hooks.remove()
        if program is not None:
            program.close()
        shutil.rmtree(work, ignore_errors=True)
