"""Where a cell's traced units spend their time, stage by stage.

    python3 -m portbench.stage_report --workload <cell> --seed <n> \\
        [--warm 8] [--sessions 1]

On the card, from the root of a checkout. It sets the cell up as
``portbench.run`` does, runs ``--warm`` units, then the mix's
``traced_units`` consecutive units inside one ``trace.Session`` (each in
its ``portbench.<unit>`` span, as the window traces them), and the same
number again untraced; ``--sessions`` such runs in a row. Units are
counted, not timed, so two checkouts run the same units of one seed.

For each session it prints one JSON line: the traced and untraced units'
host ms; the session's ``summary()`` as the harness reads it (idle share,
device operations a unit); and from ``stages.read``, for each path of
spans, the spans, host ms, idle ms (where it is the innermost span),
device ms and operations (launched there) a unit, with the idle ms of each
stage's subtree and what no stage holds. It checks the program's span
counts against its own counters where the program has spans: NDT
evaluations and host syncs a scan, GICP host syncs and Gauss-Newton steps
an align. Last, the cost of a span while no profiler records (``span``
and a ``spanned`` call against none, on this host).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
import time

from portbench import spec, stages, trace
from portbench.run import _card, set_cache_dirs

# The stage spans whose subtrees split a unit's idle time, by unit.
STAGES = {
    "scan": ["toyslam.odometry.downsample", "toyslam.ndt.build_map",
             "toyslam.ndt.align", "toyslam.mapping.merge"],
    "align": ["toyslam.gicp.covariances", "toyslam.gicp.correspondences",
              "toyslam.gicp.gn_step", "toyslam.gicp.converge"],
}


def _count(st: stages.Stages, name: str) -> int:
    return sum(c for path, (c, _) in st.host_by_path.items()
               if path and path[-1] == name)


def _checks(kind: str, st: stages.Stages, infos: list, inner: int) -> dict:
    """The program's span counts against its counters over the units;
    empty for a program without spans."""
    if kind == "scan" and _count(st, "toyslam.mapping.step"):
        return {"ndt.derivs=evaluations": [
                    _count(st, "toyslam.ndt.derivs"),
                    sum(i["evaluations"] for i in infos)],
                "ndt.sync=host_syncs": [
                    _count(st, "toyslam.ndt.sync"),
                    sum(i["host_syncs"] for i in infos)]}
    if kind == "align" and _count(st, "toyslam.gicp.align"):
        its = sum(i["iterations"] for i in infos)
        return {"gicp.sync=host_syncs": [_count(st, "toyslam.gicp.sync"),
                                         its],
                "gicp.gn_step=iterations*inner": [
                    _count(st, "toyslam.gicp.gn_step"), its * inner]}
    return {}


def report(kind: str, st: stages.Stages, summary: trace.Summary, infos,
           traced_ms, untraced_ms, inner: int) -> dict:
    n = len(infos)
    ms = 1e3 / n
    rows = []
    paths = set(st.host_by_path) | set(st.idle_by_path) | set(
        st.device_by_path)
    for path in sorted(paths):
        spans_, host_s = st.host_by_path.get(path, [0, 0.0])
        ops, dev_s = st.device_by_path.get(path, [0, 0.0])
        rows.append({"path": "/".join(p.split(".", 1)[1] for p in path)
                     or "outside_calls",
                     "spans": spans_ / n, "host_ms": host_s * ms,
                     "idle_ms": st.idle_by_path.get(path, 0.0) * ms,
                     "device_ms": dev_s * ms, "ops": ops / n})
    idle_total = st.window_s - st.busy_s
    by_stage = {s: stages.subtree(st.idle_by_path, s) * ms
                for s in STAGES[kind]}
    in_stages = sum(by_stage.values()) / ms
    return {
        "units": n, "kind": kind,
        "traced_host_ms": traced_ms, "untraced_host_ms": untraced_ms,
        "traced_host_ms_median": statistics.median(traced_ms),
        "untraced_host_ms_median": statistics.median(untraced_ms),
        "summary": {"idle_pct": 100.0 * (1 - summary.busy_s
                                         / summary.window_s),
                    "ops_per_unit": summary.ops / n,
                    "busy_ms_per_unit": summary.busy_s * ms,
                    "idle_by_span": summary.idle_by_span},
        "stages_equal_summary": [st.busy_s, st.ops, st.by_name] == [
            summary.busy_s, summary.ops, summary.by_name],
        "idle_ms_per_unit": idle_total * ms,
        "idle_ms_by_stage": by_stage,
        "idle_ms_elsewhere": (idle_total - in_stages) * ms,
        "idle_share_elsewhere": (1 - in_stages / idle_total
                                 if idle_total > 0 else None),
        "idle_paths_sum_over_total": (sum(st.idle_by_path.values())
                                      / idle_total if idle_total > 0
                                      else None),
        "device_ops_attributed": sum(c for c, _ in
                                     st.device_by_path.values()) / n,
        "checks": _checks(kind, st, infos, inner),
        "rows": rows,
    }


def span_off_cost_us(n: int = 200_000) -> dict | None:
    """A span's cost while no profiler records, in microseconds a span:
    ``with span(...)`` and a ``spanned`` function's call, each less the
    same loop without it; None for a program without spans."""
    try:
        from toyslam_tpu_torch.utils.profiling import span, spanned
    except ImportError:
        return None

    def bare():
        return None

    wrapped = spanned("x")(bare)

    def per_call(fn):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) / n * 1e6

    def loop_empty():
        for _ in range(n):
            pass

    def loop_span():
        for _ in range(n):
            with span("x"):
                pass

    def loop_bare():
        for _ in range(n):
            bare()

    def loop_wrapped():
        for _ in range(n):
            wrapped()

    best = {k: min(per_call(f) for _ in range(5)) for k, f in (
        ("empty", loop_empty), ("span", loop_span), ("bare", loop_bare),
        ("wrapped", loop_wrapped))}
    return {"span_us": best["span"] - best["empty"],
            "spanned_call_us": best["wrapped"] - best["bare"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.stage_report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=1)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = spec.cell(args.workload)

    import torch

    from toyslam_tpu_torch.ops.launches import launches

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench: stage_report needs a CUDA device", file=sys.stderr)
        return 2
    loop = importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']}")
    n = cell.traffic["traced_units"]
    # Enough units for the runs: the loops size their inputs by seconds.
    rate = cell.traffic.get("max_scans_per_s",
                            cell.traffic.get("max_aligns_per_s"))
    need = args.warm + args.sessions * (2 * n + 4 * 64)
    c = loop.Cell(cell.config, cell.traffic, args.seed, "cuda")
    c.setup(need / rate)
    torch.cuda.synchronize()
    inner = cell.config.get("gicp", {}).get("inner_iterations", 8)
    units = iter(c.units())
    clock = time.perf_counter
    # As in the window: the collector's pauses would land in some unit.
    gc.collect()
    gc.disable()

    def run_unit(u):
        t = clock()
        info = u.call()
        return info, (clock() - t) * 1e3

    for _ in range(args.warm):
        run_unit(next(units))
    for _ in range(args.sessions):
        u = next(units)
        while not u.can_start_trace:
            run_unit(u)
            u = next(units)
        batch = [u] + [next(units) for _ in range(n - 1)]
        infos, traced = [], []
        with trace.Session(launches) as session:
            for u in batch:
                with session.span(u.kind):
                    info, ms = run_unit(u)
                infos.append(info)
                traced.append(ms)
        untraced = []
        while len(untraced) < n:
            u = next(units)
            info, ms = run_unit(u)
            if u.kind == batch[0].kind:
                untraced.append(ms)
        try:
            summary = session.summary()
        except trace.LostEvents as e:
            print(f"portbench: session thrown away: {e}", file=sys.stderr)
            continue
        st = stages.read(session.prof.events())
        out = report(batch[0].kind, st, summary, infos, traced, untraced,
                     inner)
        out |= {"workload": args.workload, "seed": args.seed,
                "card": _card()}
        print(json.dumps(out), flush=True)
    print(json.dumps({"span_off_cost_us": span_off_cost_us(),
                      "card": _card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
