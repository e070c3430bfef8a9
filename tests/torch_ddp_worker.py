"""One rank of a 2-process ``gloo`` run on the CPU, for
``tests/test_torch_distributed.py``:

    python tests/torch_ddp_worker.py JOB RANK WORLD PORT OUT

``JOB`` is a ``torch.save``'d dict; ``OUT`` gets this rank's results
(``torch.save``). Kinds of job:

- ``steps``: for each case, the port's net from ``state_dict``, then
  ``make_train_step(..., data_parallel=True)`` over this rank's rows of
  each batch (f32); per step the logged loss, accuracy and grad norm and
  the parameters left without a ``.grad``; the parameters at the end.
- ``cli``: a CLI's ``main(argv)`` (``--device cpu``), with the checkpoint
  writes and the final train state of this rank recorded; a
  ``SystemExit`` is caught and its message returned.

The port only: no JAX here. One intra-op thread, as two ranks share the
suite's cores.
"""
import os
import sys
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_steps(job):
    from semantic_abstraction_tpu_torch import parallel
    from semantic_abstraction_tpu_torch.models import convert
    from semantic_abstraction_tpu_torch.runtime import train

    parallel.maybe_initialize_distributed("cpu")
    r, world = parallel.rank(), parallel.world_size()
    out = {}
    for key, case in job["cases"].items():
        model = convert.from_state_dict(case["state_dict"], case["cfg"], device="cpu")
        tx = train.make_optimizer(**job["opt"])
        state = train.init_train_state(model, tx)
        step = train.make_train_step(train.FORWARD_LOSS[key], case["cfg"], tx,
                                     compute_dtype=torch.float32, data_parallel=True)
        stats, no_grad = [], []
        for b in case["batches"]:
            rows = b[next(iter(b))].shape[0] // world
            mine = {k: torch.as_tensor(v[r * rows:(r + 1) * rows]) for k, v in b.items()}
            state, s = step(state, mine)
            stats.append({k: float(v) for k, v in s.items()})
            no_grad.append(sorted(n for n, p in state.model.named_parameters()
                                  if p.grad is None))
        out[key] = {"stats": stats, "no_grad": no_grad,
                    "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    return out


def run_cli(job):
    import importlib

    from semantic_abstraction_tpu_torch.runtime import experiment

    saves, states = [], []
    save, train = experiment.save_checkpoint, experiment.train

    def save_checkpoint(path, *a, **kw):
        saves.append(os.path.basename(path))
        return save(path, *a, **kw)

    def capture_train(*a, **kw):
        state = train(*a, **kw)
        states.append({n: p.detach().clone() for n, p in state.model.named_parameters()})
        return state

    experiment.save_checkpoint, experiment.train = save_checkpoint, capture_train
    cli = importlib.import_module(f"semantic_abstraction_tpu_torch.cli.{job['cli']}")
    try:
        cli.main(job["argv"])
    except SystemExit as e:
        return {"exit": str(e.code)}
    return {"exit": None, "saves": saves, "params": states[-1] if states else None}


def main():
    job_path, rank, world, port, out_path = sys.argv[1:6]
    os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=world,
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    try:
        out = run_steps(job) if job["kind"] == "steps" else run_cli(job)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    finally:
        from semantic_abstraction_tpu_torch.parallel import destroy_distributed

        destroy_distributed()
    torch.save(out, out_path)


if __name__ == "__main__":
    main()
