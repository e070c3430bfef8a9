"""The counting functions against hand counts at small shapes."""
import pytest

from benchmark import counts

B32 = dict(embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
           vision_patch_size=32, context_length=77, vocab_size=49408, text_width=512,
           text_heads=8, text_layers=12)


def test_mha_bound_bytes_and_flops():
    # B 2, T 4, W 128, 2 heads of 64: q, k, v, out of 2*4*128 bf16 elements
    assert counts.mha_bound_s(2, 4, 128, 2, "bfloat16") == pytest.approx(
        4 * 2 * 4 * 128 * 2 / 3.35e12)
    # T 2048: QK^T and PV, 2 flops a multiply-add: 2 * 2 * B H T T hd
    flops = 2 * 2 * 1 * 16 * 2048 * 2048 * 64
    assert counts.mha_bound_s(1, 2048, 1024, 16, "bfloat16") == pytest.approx(flops / 989e12)
    assert counts.mha_bound_s(1, 2048, 1024, 16, "float32") == pytest.approx(
        3 * flops / 495e12)


def test_moments_bounds():
    # (2, 3, 1000) bf16: x read (2 bytes each), two (2, 3) f32 outputs
    assert counts.moments_bound_s(2, 3, 1000, "bfloat16") == pytest.approx(
        (6000 * 2 + 2 * 6 * 4) / 3.35e12)
    # backward: x read and gx written, two (2, 3) f32 gradients read
    assert counts.moments_backward_bound_s(2, 3, 1000, "float32") == pytest.approx(
        (2 * 6000 * 4 + 2 * 6 * 4) / 3.35e12)


def test_vit_b32_tile_flops():
    # per block at T 50, W 768: qkv 2*50*768*2304, QK^T and PV 2 * 2*50*50*768,
    # out 2*50*768*768, MLP 2 * 2*50*768*3072
    block = (2 * 50 * 768 * 2304 + 2 * 2 * 50 * 50 * 768 + 2 * 50 * 768 * 768
             + 2 * 2 * 50 * 768 * 3072)
    assert counts.block_flops(50, 768) == block
    embed = 2 * 49 * 3072 * 768
    tail = (2 * 50 * 768 * 2304 + 2 * 2 * 50 * 768 + 2 * 768 * 768 + 2 * 2 * 768 * 3072
            + 2 * 768 * 512)
    grad = 2 * 768 * 512 + 2 * 2 * 768 * 3072 + 2 * 768 * 768 + 2 * 50 * 768
    assert counts.relevancy_tile_flops(B32, 9) == embed + 11 * block + tail + 9 * grad


def test_tiles_of_ours_at_480x640():
    # tile sizes 480, 320, 240, 120: 2 + 15 + 35 + 13 * 16 tiles, over the
    # image and 5 jittered copies, twice with the flip
    assert counts.tiles_per_image(480, 640, "ours") == (2 + 15 + 35 + 208) * 6 * 2 == 3120


def test_unet3d_flops_on_a_small_grid():
    c = dict(voxel_shape=[8, 8, 8], unet_num_channels=2, unet_f_maps=4, unet_num_levels=2)
    v0, v1 = 512, 64
    enc = 2 * 27 * v0 * (2 * 4 + 2 * 4 * 4) + 2 * 27 * v1 * (4 * 8 + 2 * 8 * 8)
    dec = 2 * 27 * v1 * 8 * 4 + 2 * 27 * v0 * 3 * 4 * 4
    final = 2 * v0 * 4 * 2
    assert counts.unet3d_flops(c, 3) == 3 * (enc + dec + final)
    shapes = counts.unet_groupnorm_shapes(c, 3)
    assert shapes == [(3, 2, v0), (3, 4, v0), (3, 4, v0), (3, 4, v1), (3, 8, v1),
                      (3, 8, v1), (3, 4, v0), (3, 4, v0), (3, 4, v0)]


def test_full_unet_has_33_groupnorms():
    c = dict(voxel_shape=[128] * 3, unet_num_channels=16, unet_f_maps=16, unet_num_levels=6)
    assert len(counts.unet_groupnorm_shapes(c, 4)) == 33
