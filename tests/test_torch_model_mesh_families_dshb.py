"""D-SHB on a model mesh for rwkv6, zamba2, internvl2 and whisper:
tests/test_torch_model_mesh_trainer.py's step (n = 8, f = 2, ALIE, NNM +
CWTM on "cuda_sharded", 2 steps) on gloo worlds of (1, 2) and (2, 2) CPU
processes, each rank holding its shards of the padded model (the
families' cases of tests/test_torch_model_mesh_world.py, their constant
leaves moved off their constants), held to the reference's
single-device step at that module's tolerances: the loss 1e-5 relative,
direction_norm and kappa_hat 1e-4, the parameters 1e-5 of the largest
magnitude, and the attacked stack's Gram summed over the blocks within
1e-5 of its largest entry (a replicated per-head leaf such as rwkv6's
``u`` or Mamba2's ``a_log`` counted twice, or holding only its rank's
rows' gradient, would show there).
"""
import pytest

import test_torch_model_mesh_trainer as trainer_cases

CASES = {f"{tag} nnm+cwtm": (tag, dict(rule="cwtm", pre="nnm",
                                       backend="cuda_sharded"), False)
         for tag in trainer_cases.FAMILY_ARCHS}


@pytest.fixture(scope="module")
def run():
    return trainer_cases.run_cases(CASES)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", list(CASES))
def test_dshb_step_matches_reference(run, tag, shape):
    refs, worlds = run
    trainer_cases.check_step(worlds, refs, CASES, tag, shape)
