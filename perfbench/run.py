#!/usr/bin/env python3
"""One run of one benchmark cell of titanet_torch on NVIDIA GPUs.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The run sets up
the cell (weights and inputs from the seed, the cell's shapes warmed up),
drives its timed entry for ``--seconds``, checks what the window produced
against the plain reference, and prints one JSON line as the last line of
its standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``. It exits non-zero without a result
when no CUDA device is there, when the cell asks for more devices than
there are, or when the JAX package (or JAX) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

PERFBENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PERFBENCH)
CACHE = os.path.join(PERFBENCH, ".cache")


@dataclass
class Context:
    seed: int
    seconds: float
    trace: bool
    device: object
    rank: int
    world: int
    port: int
    t_start: float
    argv: list
    perfbench: str = PERFBENCH
    env: dict = field(default_factory=lambda: dict(os.environ))

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 products in full precision (no TF32) for the plain
        reference; the program's settings come back after."""
        import torch

        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # internal: the other ranks of a multi-device cell, and CPU rehearsals
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--root", default=CHECKOUT, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _cache_env() -> None:
    """Every kernel cache at a fixed path inside the checkout, so that only
    the first run of a checkout builds."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("TITANET_DIST_TIMEOUT", "120")
    os.environ["USE_FLAX"] = "0"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fail(message: str) -> int:
    print(f"perfbench: {message}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    _cache_env()
    for path in (args.root, CHECKOUT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    from perfbench.core import bench

    cell = bench.load_cell(args.root, args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device: this benchmark measures the program on NVIDIA GPUs")
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{args.workload} needs {cell.chips} CUDA devices, {torch.cuda.device_count()} visible")
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)

    from titanet_torch.utils import enable_compilation_cache

    enable_compilation_cache(os.path.join(CACHE, "kernels"))
    world = cell.traffic.get("ranks", 1)
    port = args.port or (_free_port() if world > 1 else 0)
    spawn_argv = [a for a in argv]
    if args.device != "cuda":
        spawn_argv += ["--device", args.device] if "--device" not in argv else []
    ctx = Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
                  rank=args.rank, world=world, port=port, t_start=T_START, argv=spawn_argv)
    out = bench.generator(cell).run(cell, ctx)
    if args.rank != 0:
        return 0

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = bench.reader(cell, m["name"])(cell, out["counts"], out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
                   "count": out["devices"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    trace = out["trace"]
    if trace is not None:
        ranks = out["counts"].get("trace_ranks") or [trace]
        device_info["busy_s"] = sum(t.busy_s for t in ranks) / len(ranks)
        device_info["window_s"] = sum(t.window_s for t in ranks) / len(ranks)
        breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}

    bad = bench.loaded_forbidden()
    if bad:
        return fail(f"the run loaded {', '.join(bad)}: nothing of JAX or the JAX package may run here")
    checks = out["checks"]
    for line in checks.lines():
        print(line, file=sys.stderr)
    print(bench.result_line(checks.correct, out["attempted"], out["failed"], metrics, device_info, checks,
                            breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
