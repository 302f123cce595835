"""The moe family split over a model mesh: tests/test_torch_model_mesh_world.py's
cases for mixtral and arctic, on their own gloo worlds of (1, 2) and
(2, 2) CPU processes, held to the reference's padded model on one device
at that module's tolerances (1e-5):

* mixtral at seq 64 (the window of 32 binds; 4 experts split 2 a rank,
  the router's expert columns gathered);
* arctic (its dense residual MLP split over ff; 4 experts split);
* arctic with 3 experts, which do not divide: every expert's
  ``ff_inner`` is split instead.
"""
import pytest

import test_torch_model_mesh_world as world_cases

MOE = ("mixtral", "arctic", "arctic-ff")


@pytest.fixture(scope="module")
def moe():
    return world_cases.run_worlds(MOE)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", MOE)
def test_sharded_forward_loss_and_gradients(moe, tag, shape):
    world_cases.check_case(*moe, tag, shape)


def test_each_rank_holds_its_shards(moe):
    """The experts split when they divide over the model axis, else
    their ff_inner."""
    worlds = moe[1]
    world_cases.check_shards(worlds)
    for ranks in worlds.values():
        assert ranks[0]["mixtral"]["shard_expert"]
        assert ranks[0]["arctic"]["shard_expert"]
        assert not ranks[0]["arctic-ff"]["shard_expert"]
