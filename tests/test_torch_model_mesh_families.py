"""The attention-free, hybrid, vision-language and encoder-decoder
families split over a model mesh: tests/test_torch_model_mesh_world.py's
cases for rwkv6, zamba2, internvl2 and whisper, on their own gloo worlds
of (1, 2) and (2, 2) CPU processes, held to the reference's padded model
on one device at that module's tolerances (1e-5), their constant leaves
moved off their constants:

* rwkv6 with 3 heads, padded to 4 (the time mix by heads: ``u`` read
  by rows, the norm over the split ``inner``; the channel mix's ff);
* zamba2 with 3 Mamba2 heads (padded to 4) and 3 attention heads: the
  contiguous ``in_proj`` block of rank 0 holds z and part of x, rank
  1's the rest of x, B, C and dt, so the projection is gathered and the
  conv's weights too; the shared block runs split after each layer;
* internvl2 with one kv head (replicated), its projector replicated;
* whisper with 3 heads (padded to 4, kv split): the encoder, the split
  cross attention, the split vocabulary.
"""
import pytest

import test_torch_model_mesh_world as world_cases

FAMILIES = ("rwkv6", "zamba2", "internvl2", "whisper")


@pytest.fixture(scope="module")
def families():
    return world_cases.run_worlds(FAMILIES)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", FAMILIES)
def test_sharded_forward_loss_and_gradients(families, tag, shape):
    world_cases.check_case(*families, tag, shape)


def test_each_rank_holds_its_shards(families):
    """Every split leaf is halved on every rank; internvl2's single kv
    head stays whole (kv replicated), whisper's split."""
    worlds = families[1]
    world_cases.check_shards(worlds)
    for ranks in worlds.values():
        assert not ranks[0]["internvl2"]["shard_kv"]
        assert ranks[0]["whisper"]["shard_kv"]


def test_the_mamba2_block_crosses_the_stream_boundaries():
    """At the case's widths rank 0's contiguous block of ``in_proj``'s
    columns ends inside x, and rank 1's holds B, C and dt: no rank's
    block is its heads' streams."""
    from repro_torch.models import common, ssm
    _, tcfg, _ = world_cases._cfgs("zamba2")
    with common.mesh_axes_scope(common.MeshAxes(model_par=2)):
        h, p, n, d_inner = ssm._dims(tcfg)
    width = 2 * d_inner + 2 * n + h
    assert h == 4 and width % 2 == 0
    assert d_inner < width // 2 < 2 * d_inner
