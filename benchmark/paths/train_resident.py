"""The device-resident OVSSC train step: the program's
``runtime.make_train_step(ovssc_forward_loss, SemAbs3DConfig(...), LAMB)``
in the configuration's compute dtype, cycling a pool of distinct batches
made on the device, no loader.

Set-up builds one train state (the configuration's weights, drawn from
the seed in the reference layout, through ``models.convert``) and drives
it through its first three steps on the pool's first three batches,
keeping the first gradient as the optimizer holds it and the parameters
after the third; the window continues with the same state. After the
window the reference follows those three steps in float32.
"""
from __future__ import annotations

import torch

from benchmark import counts, weights
from benchmark.reference import semabs3d as ref
from benchmark.traffic import batches

FIRST_STEPS = 3


def net_config(c: dict):
    from semantic_abstraction_tpu_torch.models import SemAbs3DConfig

    return SemAbs3DConfig(
        voxel_shape=tuple(c["voxel_shape"]),
        scene_bounds=tuple(tuple(b) for b in c["scene_bounds"]),
        unet_num_channels=c["unet_num_channels"], unet_f_maps=c["unet_f_maps"],
        unet_num_groups=c["unet_num_groups"], unet_num_levels=c["unet_num_levels"],
        network_inputs=tuple(c["network_inputs"]),
        use_pts_feat_extractor=c["use_pts_feat_extractor"],
        pts_feat_extractor_hidden_dim=c["pts_feat_extractor_hidden_dim"],
        reduce_method=c["reduce_method"], output_dim=c["output_dim"],
        decoder_concat_xyz_pts=c["decoder_concat_xyz_pts"])


def compute_dtype(c: dict):
    return torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32


class FirstSteps:
    """What the first steps leave, copied to the host: each step's loss,
    the first gradient as the optimizer holds it (its first moment over
    1 - beta1), the parameters after the last."""

    def __init__(self):
        self.losses, self.first_grad, self.params = [], None, None

    def after_step(self, state, stats, k: int) -> None:
        self.losses.append(stats["loss"])
        if k == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            self.first_grad = {n: (state.optimizer.state[p]["exp_avg"] / (1 - b1)).cpu()
                               for n, p in state.model.named_parameters()}
        if k == FIRST_STEPS - 1:
            self.params = {n: p.detach().cpu().clone()
                           for n, p in state.model.named_parameters()}

    def check(self, r, batches_fed) -> None:
        """The reference follows the same steps from the same weights."""
        ref.tf32_off()
        sd = weights.semabs3d_state_dict(r.config, r.seed, r.device)
        fed = [{k: v.to(r.device) for k, v in b.items()} for b in batches_fed]
        losses, grad, params = ref.train_steps(sd, r.config, r.config["recipe"], fed)
        dev = {k: v.to(r.device) for k, v in self.first_grad.items()}
        keys = sorted(grad)
        moving = ref.moving_leaves(grad)
        start = {k: sd[k] for k in keys}
        change_prog = {k: self.params[k].to(r.device) - start[k] for k in moving}
        change_ref = {k: params[k] - start[k] for k in moving}
        # each step's loss is read, not compared: no control or fault the
        # cell can have separates it from sound runs (PERF.md)
        r.facts["loss_gap"] = ref.worst_relative([float(x) for x in self.losses], losses)
        r.check("grad_gap", ref.median_leaf_gap(dev, grad, keys))
        r.facts["grad_gap_worst_leaf"] = ref.leaf_gap(dev, grad, keys)
        r.check("change_gap", ref.leaf_gap(change_prog, change_ref, moving))
        r.facts.update(moving_leaves=len(moving), leaves=len(keys))


def build(r):
    from semantic_abstraction_tpu_torch.models.convert import from_state_dict
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_optimizer, make_train_step, ovssc_forward_loss)

    c = r.config
    rec = c["recipe"]
    sd = weights.semabs3d_state_dict(c, r.seed, r.device)
    model = from_state_dict(sd, net_config(c), r.device)
    del sd
    tx = make_optimizer(lr=rec["lr"], weight_decay=rec["weight_decay"],
                        grad_max_norm=rec["grad_max_norm"],
                        lr_scheduler_type=rec["lr_scheduler_type"],
                        num_warmup_steps=rec["num_warmup_steps"],
                        num_training_steps=rec["num_training_steps"])
    step = make_train_step(ovssc_forward_loss, net_config(c), tx,
                           compute_dtype=compute_dtype(c))
    return init_train_state(model, tx), step


def step_facts(r, volumes: int) -> dict:
    c = r.config
    return dict(
        flops_per_unit=counts.semabs3d_step_flops(
            c, r.traffic["batch_size"], c["num_patches"], c["num_input_pts"],
            c["num_output_pts"]),
        moments_bound_s_per_unit=counts.moments_step_bound_s(c, volumes, c["compute_dtype"]),
        peak_flops=counts.PEAK_FLOPS["bfloat16"])


def run(r):
    t, c = r.traffic, r.config
    state, step = build(r)
    pool = batches.pool(r.seed, t, c, r.device)
    first = FirstSteps()
    for k in range(FIRST_STEPS):
        state, stats = step(state, pool[k])
        first.after_step(state, stats, k)
    first.losses = [float(x) for x in first.losses]
    holder = {"state": state, "stats": stats}

    def one(i):
        holder["state"], holder["stats"] = step(holder["state"], pool[i % len(pool)])

    n = r.loop(one, first=FIRST_STEPS)
    r.attempted = n
    r.failed = 0 if torch.isfinite(holder["stats"]["loss"]).item() else 1
    r.e2e["train_samples_per_s"] = n * t["batch_size"] / r.window_s
    r.unit_s = r.window_s / n
    r.facts = step_facts(r, t["batch_size"] * c["num_patches"])
    if r.trace_on:
        units = t["traced_steps"]
        start = FIRST_STEPS + n
        r.profile(lambda: [one(start + k) for k in range(units)], units)
    fed = [{k: v.cpu() for k, v in pool[k].items()} for k in range(FIRST_STEPS)]
    del state, step, pool, holder, stats
    r.free_program()
    first.check(r, fed)


def control(r) -> dict:
    """The reference in fp8 in the program's place ("control"), on the
    first steps' batches, against the float32 reference. A state left
    unchanged reads 1 on both numbers by the measure itself; a batch of
    one row has no half to leave out."""
    ref.tf32_off()
    c = r.config
    sd = weights.semabs3d_state_dict(c, r.seed, r.device)
    fed = batches.pool(r.seed, r.traffic, c, r.device)[:FIRST_STEPS]
    losses, grad, params = ref.train_steps(sd, c, c["recipe"], fed)
    o_losses, o_grad, o_params = ref.train_steps(sd, c, c["recipe"], fed, "fp8")
    keys, moving = sorted(grad), ref.moving_leaves(grad)
    return {"control": {
        "loss_gap": ref.worst_relative(o_losses, losses),
        "grad_gap": ref.median_leaf_gap(o_grad, grad, keys),
        "grad_gap_worst_leaf": ref.leaf_gap(o_grad, grad, keys),
        "change_gap": ref.leaf_gap({k: o_params[k] - sd[k] for k in moving},
                                   {k: params[k] - sd[k] for k in moving}, moving)}}
