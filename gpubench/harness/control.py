"""The readings that a cell's limits are set from: the program's numbers and the
control's on many seeds in one process.

For each seed: the inputs; the program's chain through the cell's own driver for
``--chunks`` chunks after the warm-up, judged as a run judges it (the lower readings);
then the control, the plain reference in the program's place computed in TF32, the
precision below the configuration's float32 with TF32 off: the reference's own stretch
move from the same walkers and generator for ``--control-chunks`` chunks, judged the
same way (the upper readings).  The benchmark's own runs do not run this.

    python3 -m gpubench.harness.control --workload koi2298.stage2 --seeds 11 12 13

One JSON line per seed and side on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gpubench.harness import bench, inputs
from gpubench.reference import posterior, sampler


def control_chain(made, tables, cfg, cell, chunks: int, device) -> dict:
    """The reference's chain in TF32 from the cell's walkers, as ``bench.chain_outputs``
    gives a driver's."""
    dials = cfg["dials"]
    lp_one = lambda x, t: posterior.log_posterior(x, t, dials["median_iters"],
                                                  dials["recip_newton"], tf32=True)
    last = []

    def log_prob(x):
        out = torch.stack([lp_one(x[i], t) for i, t in enumerate(tables)])
        last[:] = [x, out]
        return out

    coords = made["walkers"].to(device)
    lp = log_prob(coords)
    gen = torch.Generator(device=device).manual_seed(made["sampler_seed"])
    layout = "single" if len(tables) == 1 else "fleet"
    state = start = None
    for _ in range(chunks):
        state, start = gen.get_state(), coords
        coords, lp = sampler.run_chunk(coords, lp, gen, cell["chunk"], cfg["stretch_a"],
                                       log_prob, layout)
    return {"coords": coords, "log_prob": lp, "start": start,
            "draws": bench.last_draws(state, device, layout, cell["chunk"], coords.shape[0],
                                      coords.shape[1], cfg["stretch_a"]),
            "last_eval": tuple(last)}


def readings(workload: str, seed: int, chunks: int, control_chunks: int, device, log,
             sizes=None) -> list:
    """The program's and the control's numbers on one seed; ``sizes`` replaces keys of
    the cell's file (``walkers``, ``chunk``, ``nd``) for a test on the CPU."""
    res = bench.resolve(bench.load_json(bench.ROOT / "BENCHMARK.json"), workload)
    cfg, cell = res["cfg"], {**res["cell"], **(sizes or {})}
    bench.set_env(cfg, cell)
    made = inputs.make_inputs(cfg, cell, seed, device)
    out = []
    if chunks:
        t0 = time.perf_counter()
        driver = bench.load_module(bench.BENCH / "drivers" / f"{cell['driver']}.py",
                                   f"gpubench_driver_{cell['driver']}").build(cell, cfg, made,
                                                                             device)
        for _ in range(bench.WARMUP_CHUNKS + chunks):
            driver.chunk()
        outputs = bench.chain_outputs(driver, device, cfg["stretch_a"])
        del driver
        out.append({"workload": workload, "seed": seed, "side": "program", "chunks": chunks,
                    **bench.judge(outputs, made, cfg, device),
                    "seconds": time.perf_counter() - t0})
        log(json.dumps(out[-1]))
    if control_chunks:
        t0 = time.perf_counter()
        tables = [posterior.tables(ref, device) for _, ref in made["targets"]]
        out.append({"workload": workload, "seed": seed, "side": "control",
                    "chunks": control_chunks,
                    **bench.judge(control_chain(made, tables, cfg, cell, control_chunks, device),
                                  made, cfg, device),
                    "seconds": time.perf_counter() - t0})
        log(json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.harness.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--control-chunks", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        readings(args.workload, seed, args.chunks, args.control_chunks, torch.device("cuda", 0),
                 lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
