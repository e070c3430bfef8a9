"""The plain reference against the port's CPU path at a tiny size (here
only: the reference itself imports nothing of the port)."""
import numpy as np
import torch

from benchmark import weights
from benchmark.reference import clip as ref_clip
from benchmark.reference import semabs3d
from benchmark.tests import tiny

NET = dict(tiny.TINY_NET, scene_bounds=[[-1.0, -1.0, -0.1], [1.0, 1.0, 1.9]],
           output_dim=1, decoder_concat_xyz_pts=True, network_inputs=["saliency"],
           use_pts_feat_extractor=True, reduce_method="max")
RECIPE = dict(lr=1e-3, weight_decay=1e-5, grad_max_norm=2.0, num_warmup_steps=1024)


def test_relevancy_matches_the_port_in_f32():
    from semantic_abstraction_tpu_torch.clip import ClipSaliency, saliency_configs
    from semantic_abstraction_tpu_torch.clip.convert import from_openai_state_dict

    torch.set_num_threads(2)
    c = dict(tiny.TINY_CLIP, context_length=77, vocab_size=49408)
    sd = weights.clip_state_dict(c, 77, "cpu")
    model, cfg = from_openai_state_dict(sd, device="cpu")
    sal = ClipSaliency(model, cfg, compute_dtype=torch.float32)
    img = np.random.default_rng(1).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    labels, prompt = ["vase", "wall"], "a photograph of a {} in a home."
    maps, _ = sal.get_clip_saliency(img, labels, [prompt], saliency_configs["ours"](48),
                                    generator=torch.Generator().manual_seed(5))
    ref = ref_clip.relevancy(sd, c, img, labels, prompt, "ours", 5)
    for k in range(2):
        # the port's maps are float16: 2^-11 of their size
        assert float((maps[k].float() - ref[k]).norm() / ref[k].norm()) < 1e-3


def test_train_steps_match_the_port_in_f32():
    from semantic_abstraction_tpu_torch.models.convert import from_state_dict
    from semantic_abstraction_tpu_torch.runtime import (
        init_train_state, make_optimizer, make_train_step, ovssc_forward_loss)

    from benchmark.paths.train_resident import net_config
    from benchmark.traffic import batches

    torch.set_num_threads(2)
    sd = weights.semabs3d_state_dict(NET, 5, "cpu")
    model = from_state_dict(dict(sd), net_config(NET), "cpu")
    tx = make_optimizer(num_training_steps=1000)
    state = init_train_state(model, tx)
    step = make_train_step(ovssc_forward_loss, net_config(NET), tx, compute_dtype=torch.float32)
    pool = batches.pool(5, dict(batch_size=1, pool=2, point_spread=0.2, frustum_drop=0.2),
                        NET, "cpu")
    losses = [float(step(state, b)[1]["loss"]) for b in pool]
    ref_losses, grad, params = semabs3d.train_steps(sd, NET, RECIPE, pool)
    assert semabs3d.worst_relative(losses, ref_losses) < 1e-5
    prog = {k: p.detach() for k, p in state.model.named_parameters()}
    keys = semabs3d.moving_leaves(grad)
    # the changes are ~1e-6 of the f32 parameters: their rounding alone
    # moves a small leaf's change norm by up to ~1e-2
    assert semabs3d.leaf_gap({k: prog[k] - sd[k] for k in keys},
                             {k: params[k] - sd[k] for k in keys}, keys) < 2e-2

