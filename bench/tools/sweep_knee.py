"""Find an open-loop cell's knee: the highest offered rate at which the
backlog does not grow across the window.

    python3 bench/tools/sweep_knee.py --workload vc1m_stencil_serve --seed 7 --seconds 30 --rates 3 4 5 6

Runs the cell's window once a rate (one process, one set-up a rate) and
prints one JSON line a rate: the latencies' p50 and p90, the completed
rate, the drain after the window, and the backlog's trend (the slope of
latency against due time, in seconds of latency per second of window: near
0 below the knee, near 1 − capacity / rate above it)."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from bench.harness import cell as _cell
    from bench.harness import runner
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for rate in args.rates:
        cell = _cell.load_cell(args.workload,
                               traffic_overrides={"rate": rate})
        run = runner.Run(cell, args.seed, args.seconds, False, dev)
        drv = _cell.kind_module(cell)
        drv.setup(run)
        t = time.perf_counter()
        r = drv.window(run)
        lat = np.asarray(r["serve"]["latency_s"])
        due = run.state["due"]
        slope = float(np.polyfit(due, lat, 1)[0])
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p90_ms": float(np.percentile(lat, 90) * 1e3),
            "completed_per_s": len(lat) / (time.perf_counter() - t),
            "drain_s": r["window_s"] - args.seconds,
            "trend": slope, "waves": r["waves"],
            "mean_wave": float(np.mean(r["serve"]["wave_sizes"])),
            "lane_useful": r["serve"]["useful_iters"]
            / max(r["serve"]["lane_slot_iters"], 1)}), flush=True)
        drv.release(run)
        run.state.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
