"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a card, on the CPU at tiny sizes, once for each
fault a cell can have. The train cells run one row a step (the published
batch 1 a GPU): no half of a batch can be left out."""
import pytest
import torch

from benchmark.tests import tiny


def unchanged_state(monkeypatch, module):
    """A train step that returns its state unchanged."""
    real = module.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def frozen(state, batch):
            saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            moments = {p: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                       for p, s in state.optimizer.state.items()}
            state, stats = step(state, batch)
            state.model.load_state_dict(saved)
            for p, s in moments.items():
                state.optimizer.state[p].update(s)
            return state, stats

        return frozen

    monkeypatch.setattr(module, "make_train_step", make)


def test_relevancy_answer_altered(tiny_bench, monkeypatch):
    from semantic_abstraction_tpu_torch.cli import generate_relevancy as gr

    real = gr.relevancy

    def altered(sal, img, args):
        maps = real(sal, img, args)
        return torch.cat([maps[1:2], maps[1:]])  # the first label gets the second's map

    monkeypatch.setattr(gr, "relevancy", altered)
    line = tiny.run_cell(tiny_bench, "vitb32-relevancy-ours")
    assert not line["correct"], line["checks"]


def test_resident_state_unchanged(tiny_bench, monkeypatch):
    from semantic_abstraction_tpu_torch import runtime

    unchanged_state(monkeypatch, runtime)
    line = tiny.run_cell(tiny_bench, "ovssc-train-resident")
    assert not line["correct"] and line["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("workload", ["vitb32-relevancy-ours", "ovssc-train-resident"])
def test_sound_runs_are_correct(tiny_bench, workload):
    line = tiny.run_cell(tiny_bench, workload)
    assert line["correct"], line["checks"]


def test_judge_holds_readings_to_the_limits(tiny_bench):
    from benchmark import harness

    run = harness.Run(harness.Manifest(tiny_bench), "ovssc-train-resident", 11, 0.5, False,
                      device="cpu")
    assert run.judge({k: v / 2 for k, v in run.limits.items()})
    assert not run.judge({k: v * 2 for k, v in run.limits.items()})
    assert not run.judge({})  # a control that gives no number has failed


@pytest.mark.parametrize("workload", ["vitb32-relevancy-ours", "ovssc-train-resident"])
def test_controls_are_judged_not_correct(tiny_bench, workload):
    """At tiny sizes each control and fault the driver reads comes out not
    correct (at the train cell's own size the fp8 control does not always:
    PERF.md)."""
    import os

    from benchmark import harness

    torch.set_num_threads(2)
    manifest = harness.Manifest(tiny_bench)
    run = harness.Run(manifest, workload, 11, 0.5, False, device="cpu")
    driver = harness.load_module(os.path.join(manifest.dir, "paths", run.traffic["path"] + ".py"),
                                 "path_" + run.traffic["path"])
    for name, numbers in driver.control(run).items():
        judged = harness.Run(manifest, workload, 11, 0.5, False, device="cpu")
        assert not judged.judge(numbers), (name, judged.checks)
