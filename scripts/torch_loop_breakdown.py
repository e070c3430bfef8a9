"""Where the loader-fed train loop's time goes on the card.

Runs the port's ``runtime.experiment.train`` at full width over
``chip_smoke.MemoryScenes`` (OVSSC and VOOL, ``semantic_abstraction``,
bf16) for two epochs of ``--steps`` steps at each loader thread count in
``--workers``, and prints per epoch: steps/s, the seconds spent waiting on
the loader and in ``device_batch`` (host clock). The second epoch runs with
everything warm. Then one more epoch at the last thread count under
``torch.profiler``: device kernel time over the epoch's wall (the device
busy share), and the same for the device-resident step (one batch on the
card, ``--steps`` steps). Last, with no loader at all, ``--steps`` steps
of one fixed host batch: the host seconds of each step's ``device_batch``
and of the step's enqueue, with ``device_batch`` as it is (pinned staging,
non-blocking copies) and with the host arrays pinned once beforehand (only
the non-blocking copies in the loop), to tell the staging from the wait
for the card. With ``--copies``, only the copies and no step: the host ms
of ``device_batch`` to a synchronize on fresh items (each one just made by
the dataset) and on one item over and over, and of pinning alone
(``torch.from_numpy(v).pin_memory()``) on fresh items.

    python scripts/torch_loop_breakdown.py [--steps 10] [--workers 0 2 4]
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def device_seconds(prof) -> float:
    import torch

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 2, 4])
    ap.add_argument("--tasks", nargs="+", default=["ovssc", "vool"])
    ap.add_argument("--copies", action="store_true",
                    help="only the copy study (no net, no loader threads)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from semantic_abstraction_tpu_torch.cli import common
    from semantic_abstraction_tpu_torch.runtime import experiment as exp

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    card = chip_smoke.card_line()
    if args.copies:
        for task in args.tasks:
            copy_study(task, args.steps, card)
        return
    for task in args.tasks:
        ds = chip_smoke.MemoryScenes(task, length=args.steps + 1)
        for workers in args.workers:
            targs = common.config_parser().parse_args([
                "--file_path", "(in memory)", "--epochs", "2", "--save_freq", "1000",
                "--num_workers", str(workers)])
            setup = exp.build_setup(targs, task, "semantic_abstraction", {"train": ds})
            timings = []
            with tempfile.TemporaryDirectory() as log:
                exp.train(targs, setup, log_dir=log, max_steps_per_epoch=args.steps,
                          timings=timings)
            for t in timings:
                print(json.dumps({
                    "task": task, "workers": workers, "epoch": t["epoch"],
                    "steps": t["steps"], "steps_per_s": t["steps"] / t["wall_s"],
                    "wall_s": t["wall_s"], "loader_wait_s": t["loader_wait_s"],
                    "loader_wait_share": t["loader_wait_s"] / t["wall_s"],
                    "device_batch_s": t["device_batch_s"], "card": card}), flush=True)
        # one profiled epoch at the last thread count, and the resident step
        targs.epochs = 1
        setup = exp.build_setup(targs, task, "semantic_abstraction", {"train": ds})
        with tempfile.TemporaryDirectory() as log:
            exp.train(targs, setup, log_dir=log, max_steps_per_epoch=2)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                exp.train(targs, setup, log_dir=log, max_steps_per_epoch=args.steps)
                torch.cuda.synchronize()
            loop_wall = time.perf_counter() - t0
        step = exp.make_train_step(setup["forward_loss"], setup["cfg"], setup["tx"])
        db = exp.device_batch(next(iter(exp.DataLoader(ds, num_workers=0, shuffle=False))),
                              task, "cuda")
        state = setup["state"]
        state, _ = step(state, db)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as rprof:
            for _ in range(args.steps):
                state, _ = step(state, db)
            torch.cuda.synchronize()
        resident_wall = time.perf_counter() - t0
        busy, rbusy = device_seconds(prof), device_seconds(rprof)
        host = next(iter(exp.DataLoader(ds, num_workers=0, shuffle=False)))
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()
                  if k in exp.DEVICE_KEYS[task] and hasattr(v, "dtype")}
        for variant in ("device_batch", "prepinned"):
            per_step = []
            torch.cuda.synchronize()
            t_all = time.perf_counter()
            for _ in range(args.steps):
                t0 = time.perf_counter()
                if variant == "device_batch":
                    db = exp.device_batch(host, task, "cuda")
                else:
                    db = {k: v.to("cuda", non_blocking=True) for k, v in pinned.items()}
                    db["output_label_pts"] = db["output_label_pts"].to(torch.uint8)
                t1 = time.perf_counter()
                state, _ = step(state, db)
                per_step.append((t1 - t0, time.perf_counter() - t1))
            torch.cuda.synchronize()
            print(json.dumps({
                "task": task, "h2d_variant": variant,
                "steps_per_s": args.steps / (time.perf_counter() - t_all),
                "device_batch_ms": [round(1e3 * a, 2) for a, _ in per_step],
                "step_enqueue_ms": [round(1e3 * b, 2) for _, b in per_step],
                "card": card}), flush=True)
        print(json.dumps({
            "task": task, "workers": targs.num_workers, "profiled": True,
            "loop_wall_s": loop_wall, "loop_device_s": busy,
            "loop_busy_share": busy / loop_wall,
            "resident_wall_s": resident_wall, "resident_device_s": rbusy,
            "resident_busy_share": rbusy / resident_wall, "card": card}), flush=True)
        del setup, state, db
        torch.cuda.empty_cache()


def copy_study(task: str, n: int, card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from semantic_abstraction_tpu_torch.data import collate
    from semantic_abstraction_tpu_torch.runtime import experiment as exp

    ds = chip_smoke.MemoryScenes(task, length=n + 1)
    fresh = [collate([ds[i]]) for i in range(n)]
    same = fresh[0]

    def timed(fn, batches):
        out = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(b)
            torch.cuda.synchronize()
            out.append(round(1e3 * (time.perf_counter() - t0), 2))
        return out

    def pin(b):
        return [torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in b.items() if k in exp.DEVICE_KEYS[task]]

    print(json.dumps({
        "task": task, "copy_study": True,
        "device_batch_fresh_ms": timed(lambda b: exp.device_batch(b, task, "cuda"), fresh),
        "device_batch_same_ms": timed(lambda b: exp.device_batch(b, task, "cuda"),
                                      [same] * n),
        "pin_fresh_ms": timed(pin, fresh),
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
