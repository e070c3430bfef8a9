"""Data parallelism of the port (``parallel/``, the multi-process halves of
``runtime/experiment.py`` and the CLIs) on the CPU: 2 ``gloo`` ranks, each
a subprocess (``tests/torch_ddp_worker.py``) with one intra-op thread and
its own timeout; when one dies or times out, both are killed.

- The five nets at the ``tests/torch_net_cases.py`` widths, f32: two DDP
  steps on 2 ranks against one process on the global batch (rtol 1e-5,
  atol 1e-7: the same arithmetic, sums in another order) and against
  JAX's single-device step on that batch (rtol 1e-4, atol 1e-6, as
  ``tests/test_torch_vool.py`` holds one process to JAX; parameters within
  atol 1e-5, since on these batches one process of the port is itself
  up to 6e-6 from JAX in a conv weight near 0). The global
  batch's halves keep different numbers of points, so OVSSC's masked mean
  is a mean over both ranks' kept points, not a mean of the ranks' means.
  A parameter the net never reads keeps ``.grad is None`` on both ranks.
- ``train_ovssc --num_devices 2``: only rank 0 writes, and its
  ``latest.ckpt`` holds both ranks' (equal) final weights.
- ``eval --num_devices 2`` gives the per-scene detailed stats of
  ``--num_devices 1``.
- ``--num_devices 3`` under a world size of 2 raises.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_abstraction_tpu.runtime import train as jtrain
from semantic_abstraction_tpu_torch import parallel
from semantic_abstraction_tpu_torch.cli import eval as eval_cli
from semantic_abstraction_tpu_torch.models import convert as tconv
from semantic_abstraction_tpu_torch.runtime import train as ttrain
from torch_data_cases import TINY_ARGS, make_corpus
from torch_net_cases import CASES, OPT, batch, to_jax, to_torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_ddp_worker.py")
RANK_TIMEOUT_S = 120
STEPS = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job, tmp_path, world=2):
    """``job`` on ``world`` gloo ranks -> each rank's results."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    job_path = str(tmp_path / "job.pt")
    torch.save(job, job_path)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(HERE))
    env.pop("PYTHONSTARTUP", None)
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, job_path, str(r), str(world), port,
                               outs[r]], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read()[-3000:])
        f.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, f"ranks exited {codes}:\n" + "\n---\n".join(text)
    return [torch.load(o, weights_only=False) for o in outs]


def _uneven_batch(case, seed):
    """A global batch of 2 rows whose halves keep different numbers of
    points: the second row's first description or patch is padding and a
    third of its query points are out of bounds."""
    b = batch(case, np.random.RandomState(seed), b=2)
    b["out_of_bounds_pts"][1, :, : b["out_of_bounds_pts"].shape[2] // 3] = True
    b["padding_mask"][1, 0] = True
    return b


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Two steps of every net: 2 ranks, one process and JAX, from JAX's
    initial weights."""
    job = {"kind": "steps", "opt": OPT, "cases": {}}
    single, jax_runs = {}, {}
    for key, case in CASES.items():
        params = case.jax_params(0)
        batches = [_uneven_batch(case, 20 + i) for i in range(STEPS)]
        model = tconv.from_jax_params(params, case.tcfg, device="cpu")
        job["cases"][key] = {"cfg": case.tcfg, "batches": batches, "state_dict": {
            k: v.clone() for k, v in model.state_dict().items()}}
        tx = ttrain.make_optimizer(**OPT)
        state = ttrain.init_train_state(model, tx)
        step = ttrain.make_train_step(case.torch_loss(), case.tcfg, tx,
                                      compute_dtype=torch.float32)
        stats, no_grad = [], []
        for b in batches:
            state, s = step(state, to_torch(b))
            stats.append({k: float(v) for k, v in s.items()})
            no_grad.append(sorted(n for n, p in model.named_parameters() if p.grad is None))
        single[key] = {"stats": stats, "no_grad": no_grad,
                       "params": {n: p.detach() for n, p in model.named_parameters()}}
        jtx = jtrain.make_optimizer(**OPT)
        jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx)
        jstep = jtrain.make_train_step(case.jax_loss(), case.jcfg, jtx,
                                       compute_dtype=jnp.float32, donate=False)
        jstats = []
        for b in batches:
            jstate, s = jstep(jstate, to_jax(b))
            jstats.append({k: float(v) for k, v in s.items()})
        jmodel = tconv.from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                                       case.tcfg, device="cpu")
        jax_runs[key] = {"stats": jstats, "params": {
            n: p.detach().numpy() for n, p in jmodel.named_parameters()}}
    ranks = run_ranks(job, tmp_path_factory.mktemp("ddp_steps"))
    return ranks, single, jax_runs


def test_uneven_halves_keep_different_point_counts():
    """The fixture's premise: without the global count, the mean of the
    ranks' masked means would not be the global masked mean."""
    b = _uneven_batch(CASES["ovssc/semantic_abstraction"], 20)
    keep = ~(b["padding_mask"][..., None] | b["out_of_bounds_pts"]
             | b["out_of_frustum_pts_mask"])
    assert keep[0].sum() != keep[1].sum()


@pytest.mark.parametrize("key", list(CASES))
def test_two_ranks_match_one_process(steps, key):
    ranks, single, _ = steps
    want = single[key]
    for r, got in enumerate(ranks):
        got = got[key]
        for i, (g, w) in enumerate(zip(got["stats"], want["stats"])):
            for k in ("loss", "accuracy", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"rank {r} step {i + 1} {k}")
        assert got["params"].keys() == want["params"].keys()
        for n, v in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("key", list(CASES))
def test_two_ranks_match_jax_single_device(steps, key):
    ranks, _, jax_runs = steps
    want = jax_runs[key]
    for r, got in enumerate(ranks):
        got = got[key]
        for i, (g, w) in enumerate(zip(got["stats"], want["stats"])):
            for k in ("loss", "accuracy", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           err_msg=f"rank {r} step {i + 1} {k}")
        for n, v in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {n}")


def test_ranks_hold_equal_weights(steps):
    ranks, _, _ = steps
    for key in CASES:
        a, b = ranks[0][key]["params"], ranks[1][key]["params"]
        for n in a:
            assert torch.equal(a[n], b[n]), (key, n)


@pytest.mark.parametrize("key", list(CASES))
def test_unread_parameters_keep_no_gradient(steps, key):
    """SemAbsVOOL never reads ``completion_net.visual_sampler.mlp.0``: under
    DDP its ``.grad`` stays None on every rank, as in one process, so LAMB
    takes it as a zero gradient everywhere."""
    ranks, single, _ = steps
    want = single[key]["no_grad"]
    if key == "vool/semantic_abstraction":
        assert "completion_net.visual_sampler.mlp.0.weight" in want[-1]
    for r in ranks:
        assert r[key]["no_grad"] == want


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

SPLITS = {"train": [0, 1, 2, 3], "unseen_instances": [4, 5, 6]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_corpus")
    make_corpus(d, n_scenes=7, splits=SPLITS)
    return str(d)


def _cli_args(corpus, log, n):
    args = list(TINY_ARGS) + ["--file_path", corpus, "--log", log, "--device", "cpu"]
    args[args.index("--epochs") + 1] = "1"
    args[args.index("--num_devices") + 1] = str(n)
    return args


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_cli")
    log = str(tmp / "log")
    ranks = run_ranks({"kind": "cli", "cli": "train_ovssc",
                       "argv": _cli_args(corpus, log, 2)}, tmp / "ranks")
    return log, ranks


def test_train_cli_two_ranks_only_rank0_writes(trained):
    log, ranks = trained
    assert [r["exit"] for r in ranks] == [None, None]
    assert ranks[0]["saves"] == ["latest.ckpt", "ckpt_0.ckpt"]
    assert ranks[1]["saves"] == []
    assert sorted(f for f in os.listdir(log) if f.endswith(".ckpt")) == [
        "ckpt_0.ckpt", "latest.ckpt"]
    assert not [f for f in os.listdir(log) if f.endswith(".tmp")]
    with open(os.path.join(log, "detailed_stats.pkl"), "rb") as f:
        df = pickle.load(f)
    # the eval split's 3 scenes over 2 ranks: one wrap-pad duplicate, NaN'd
    assert df["scene_id"].nunique() == 3
    net = torch.load(os.path.join(log, "latest.ckpt"), weights_only=True)["net"]
    for r in ranks:
        assert r["params"].keys() <= net.keys()
        for n, p in r["params"].items():
            assert torch.equal(net[n], p), n


def _eval_stats(ckpt):
    with open(os.path.splitext(ckpt)[0] + "_eval_stats.pkl", "rb") as f:
        return pickle.load(f)


def test_eval_cli_two_ranks_match_one(corpus, trained, tmp_path):
    """``eval --num_devices 2``: each rank evaluates its shard, the frames
    are gathered, and the per-scene detailed stats are those of one
    process (the duplicate that equalizes the shards is NaN'd)."""
    log, _ = trained
    ckpt = os.path.join(log, "latest.ckpt")
    argv = ["--file_path", corpus, "--load", ckpt, "--task", "ovssc", "--voxel_shapes",
            "32", "--device", "cpu", "--num_workers", "0"]
    eval_cli.main(argv + ["--num_devices", "1"])
    single = _eval_stats(ckpt)
    os.remove(os.path.splitext(ckpt)[0] + "_eval_stats.pkl")
    ranks = run_ranks({"kind": "cli", "cli": "eval", "argv": argv + ["--num_devices", "2"]},
                      tmp_path / "ranks")
    assert [r["exit"] for r in ranks] == [None, None]
    sharded = _eval_stats(ckpt)
    key = ["scene_id", "label", "cutoff"]
    metrics = [c for c in single.columns if "iou" in c or "precision" in c or "recall" in c]
    a = single.dropna(subset=metrics).sort_values(key).reset_index(drop=True)
    b = sharded.dropna(subset=metrics).sort_values(key).reset_index(drop=True)
    assert len(a) == len(b) > 0 and a["scene_id"].nunique() == 3
    assert (a[key].to_numpy() == b[key].to_numpy()).all()
    for m in metrics:
        np.testing.assert_allclose(b[m].to_numpy(), a[m].to_numpy(), atol=1e-6, err_msg=m)


def test_num_devices_other_than_the_world_size_raises(corpus, tmp_path):
    ranks = run_ranks({"kind": "cli", "cli": "train_ovssc",
                       "argv": _cli_args(corpus, str(tmp_path / "log"), 3)},
                      tmp_path / "ranks")
    for r in ranks:
        assert r["exit"] is not None and "world size of 2" in r["exit"]
        assert "torch.distributed.run --nproc_per_node 3" in r["exit"]
    assert not os.path.exists(tmp_path / "log")


def test_mesh_size_without_a_process_group():
    """One process: --num_devices unset or 1 is a group of 1 and no DDP;
    another value asks for a launch with that many processes."""
    class A:
        num_devices = None

    assert not parallel.is_initialized()
    assert parallel.mesh_size_from_args(A()) == 1
    assert not parallel.data_parallel_from_args(A())
    A.num_devices = 1
    assert parallel.mesh_size_from_args(A()) == 1
    A.num_devices = 2
    with pytest.raises(SystemExit, match="--nproc_per_node 2"):
        parallel.mesh_size_from_args(A())
    assert parallel.all_gather_host_objects({"a": 1}) == [{"a": 1}]
    assert parallel.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not parallel.is_initialized()
