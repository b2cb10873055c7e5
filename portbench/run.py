"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

In order: the inputs from the seed (weights drawn on the card, the mix's
requests), the cell built (``kubetpu_torch``'s ``PagedDecodeServer`` over
those weights) and warmed up, a pre-roll of the mix's own traffic, the
measured window, the comparison that decides ``correct``, and one JSON
line on standard output. ``--trace 1`` runs the same cell with
``torch.profiler`` over a slice of the window and reports the per-layer
metrics instead of the end-to-end ones.

Options the benchmark's own runs never pass: ``--control 1`` puts the fp8
control in the program's place in the comparison (its readings are held to
the same limits, so ``correct`` comes out false); ``--seeds a,b,...`` runs
several seeds in one process and prints one line of readings each;
``--rate`` overrides an open loop's rate and ``--clients`` a closed
loop's clients (the sweeps for the knee);
``--device cpu`` skips the look for a card (the tests, at a tiny size).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# every cache the program or its libraries keep, at fixed paths inside
# the checkout; no library may load JAX behind the port's back
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kubetpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``kubetpu_torch`` is the port)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything of cell *workload*, found by name from
    ``BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return SimpleNamespace(name=workload, w=w, config=config,
                           traffic=traffic, limits=limits, e2e=e2e,
                           layer=layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``, or where there is no
    such file, of ``metrics/<base>.py``: the name without its cell suffix
    (the part after the last dot), one reader for every cell."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_served(cell, seed: int, seconds: float, trace: bool, device,
               control: bool = False, rate=None, clients=None,
               t_start: float = T_START, record_routes: bool = False
               ) -> dict:
    """One run of a served cell -> the result's fields (and the readings
    the check compared)."""
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    from portbench import build, check, gen, inputs, serve
    from portbench.trace import Slice, expert_shapes

    m = cell.config["model"]
    mix = dict(cell.traffic)
    if rate is not None:
        mix["rate_per_s"] = rate
    if clients is not None:
        mix["clients"] = clients
    s = mix["server"]
    closed = mix["kind"] == "closed_loop"
    reqs = (gen.closed_loop if closed else gen.open_loop)(
        mix, seed, seconds, m["vocab"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    weights = inputs.make_weights(m, seed, device, getattr(torch, m["dtype"]))
    cfg = build.model_config(m)
    server = PagedDecodeServer(
        cfg, build.transformer(cfg, weights), n_slots=s["n_slots"],
        max_seq=s["max_seq"], max_new_tokens=s["max_new_tokens"],
        page_size=s["page_size"], n_pages=s["n_pages"],
        prefill_budget=s["prefill_budget"], overlap=s["overlap"],
        device=device)
    server.warmup()
    _sync(device)
    routes = None
    if record_routes:
        from kubetpu_torch.jobs import model as model_lib

        from portbench.routes import Routes

        routes = Routes(server, model_lib)
    driver = serve.Driver(server, trace=trace)
    slice_ = (Slice(expert_shapes(m)) if trace and device.type == "cuda"
              else None)

    def plan_trace(start: float) -> None:
        if slice_ is not None:
            driver.trace_plan = (slice_, start + seconds * mix["trace_at"],
                                 min(mix["trace_s"],
                                     seconds * (1 - mix["trace_at"]) / 2))

    if closed:
        def ready():
            start = time.perf_counter()
            plan_trace(start)
            return start, start + seconds

        n = mix["clients"]
        serve.closed_loop(driver, reqs[:n], reqs[n:], n, mix["preroll_s"],
                          ready)
    else:
        start = time.perf_counter() + mix["preroll_s"]
        plan_trace(start)
        serve.open_loop(driver, reqs, start, seconds,
                        drain=not mix.get("saturate"))
    start, close = driver.rec.window
    setup_s = start - t_start
    if slice_ is not None and slice_.t1 == 0.0 and slice_.t0:
        slice_.stop()
    dev = device_info(device)
    summary = server.metrics_summary()
    driver.close()
    rec = driver.rec

    # the end-to-end metrics, over the whole window
    toks = sum(1 for x in rec.served.values() for t in x.times
               if start <= t <= close)
    prompt_toks = sum(t for st in rec.steps if start <= st.t0 < close
                      for _s, t in st.chunks)
    if closed:
        # a client stops reading at the close: in flight is not failed
        attempted = [x for x in rec.served.values()
                     if start <= x.sent <= close]
        failed = []
        extra = {"steps_in_window": sum(1 for st in rec.steps
                                        if start <= st.t0 < close)}
        ttft, gaps = serve.latencies(
            [x for x in attempted if x.done or x.times])
    else:
        attempted = rec.in_window()
        # above the knee the queue grows through the window by design: a
        # request still queued or decoding at the close has not failed
        failed = ([] if mix.get("saturate")
                  else [x for x in attempted if not x.done])
        ttft, gaps = serve.latencies(attempted)
        # the backlog: window requests still without a first token at the
        # close, and the median TTFT of the window's two halves
        half = len(ttft) // 2
        extra = {"steps_in_window": sum(1 for st in rec.steps
                                        if start <= st.t0 < close),
                 "backlog_at_close": sum(
                     1 for x in attempted
                     if not x.times or x.times[0] > close),
                 "ttft_p50_halves_ms": [check.percentile(ttft[:half], 50),
                                        check.percentile(ttft[half:], 50)],
                 "ttft_p50_ms": check.percentile(ttft, 50),
                 "itl_p50_ms": check.percentile(gaps, 50)}
    tails = {"ttft_p95_ms": check.percentile(ttft, 95),
             "itl_p95_ms": check.percentile(gaps, 95)}
    e2e = {"output_tokens_per_s": toks / (close - start),
           "tokens_per_s": (toks + prompt_toks) / (close - start),
           "setup_s": setup_s}
    extra.update(tails, prompt_tokens_per_s=prompt_toks / (close - start))
    late = np.asarray(rec.lateness) * 1e3
    print(f"generator lateness ms: p50 {np.percentile(late, 50):.3f} "
          f"p99 {np.percentile(late, 99):.3f} max {late.max():.3f} over "
          f"{late.size} sends; steps {len(rec.steps)}", file=sys.stderr)

    # the per-layer metrics, from the traced slice
    layer = {}
    if trace and slice_ is not None and slice_.t1:
        slice_.reduce()
        in_slice = [st for st in rec.steps
                    if st.t0 >= slice_.t0 and st.t1 <= slice_.t1]
        # the host's step time, read before the profiler first started
        untraced = [st for st in rec.steps if start <= st.t0 < slice_.t0]
        ctx = SimpleNamespace(m=m, slice=slice_, slice_steps=in_slice,
                              window_steps=untraced,
                              window_s=sum(st.t1 - st.t0 for st in untraced),
                              summary=summary, e2e_extra=tails)
        for met in cell.layer:
            v = reader(met["name"])(ctx)
            if v is not None:
                layer[met["name"]] = v
        dev["busy_s"] = slice_.busy_s
        dev["window_s"] = slice_.window_s

    # what decides `correct`: the program's state freed, the reference
    # run over a sample of the finished requests
    finished = [x for x in rec.served.values()
                if x.done and (x.req.in_window or closed)]
    done = [(x.req.prompt, x.tokens, x.logprobs) for x in finished]
    if routes is not None:
        routes.close()
    del driver, server, weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chk = cell.traffic["check"]
    pick = check.sample(done, seed, chk["min_tokens"], chk["min_requests"])
    weights = inputs.make_weights(m, seed, device, getattr(torch, m["dtype"]))
    read = check.readings(
        m, weights, [done[i] for i in pick], control, device,
        None if routes is None else routes.sets,
        [finished[i].rid for i in pick], chk.get("route_margin", 0.0))
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the cell's limits name the numbers it compares; the control's
    # readings, where asked for, stand in the program's place
    side = "control_" if control else ""
    checks = {k: {"value": read[side + k], "limit": v}
              for k, v in cell.limits.items()}
    if not (closed or mix.get("saturate")):
        checks["unfinished"] = {"value": len(failed), "limit": 0}
    correct = bool(pick) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    out = {"correct": correct, "attempted": len(attempted),
           "failed": len(failed), "e2e": e2e, "layer": layer, "device": dev,
           "checks": checks, "readings": read, "extra": extra}
    if trace and slice_ is not None and slice_.t1:
        out["breakdown"] = {"device_ops": slice_.top_ops(),
                            "idle_gaps": slice_.gaps}
    return out


def result_line(cell, res: dict, trace: bool) -> dict:
    mets = cell.layer if trace else cell.e2e
    vals = res["layer"] if trace else res["e2e"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": {m["name"]: {"value": vals[m["name"]],
                                    "unit": m["unit"]}
                        for m in mets if m["name"] in vals},
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--rate", default="")
    ap.add_argument("--clients", default="")
    ap.add_argument("--routes", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    chips = cell.w["chips"]
    if a.device == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device(a.device)
    seeds = [int(x) for x in a.seeds.split(",") if x] or [a.seed]
    rates = [float(x) for x in a.rate.split(",") if x] or [None]
    clients = [int(x) for x in a.clients.split(",") if x] or [None]
    calibrating = bool(a.seeds or a.rate or a.clients or a.routes)
    t_start = T_START
    for rate, n, seed in itertools.product(rates, clients, seeds):
        res = run_served(cell, seed, a.seconds, bool(a.trace), device,
                         bool(a.control), rate, n, t_start, bool(a.routes))
        t_start = time.perf_counter()
        bad = forbidden_modules()
        if bad:
            print(f"portbench: the run loaded {bad}", file=sys.stderr)
            return 3
        if calibrating:
            print(json.dumps({"seed": seed, "rate": rate, "clients": n,
                              "extra": res["extra"],
                              "correct": res["correct"],
                              "checks": res["checks"],
                              "readings": res["readings"],
                              "e2e": res["e2e"], "layer": res["layer"],
                              "failed": res["failed"],
                              "attempted": res["attempted"],
                              "device": res["device"],
                              "breakdown": res.get("breakdown")}),
                  flush=True)
            continue
        print("readings " + json.dumps(
            {k: v for k, v in res["readings"].items()
             if k not in ("per_request", "flips")}), file=sys.stderr)
        for name, c in res["checks"].items():
            print(f"{name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        print(json.dumps(result_line(cell, res, bool(a.trace))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
