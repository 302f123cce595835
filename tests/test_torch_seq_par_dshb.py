"""One D-SHB step under sequence parallelism (``MeshAxes.seq_par``) on
gloo worlds of (1, 2) and (2, 2) CPU processes: the five families of
tests/test_torch_seq_par.py (dense, moe, vlm, rwkv6, zamba2 at reduced
widths), NNM + CWTM, n = 8, f = 2, ALIE, each rank holding its shards
and its sequence blocks, against the reference's padded single-device
step (the helpers of tests/test_torch_model_mesh_trainer.py): loss 1e-5
relative, parameters within 1e-5 of the tree's largest magnitude, the
attacked stack's Gram within 1e-5 of its largest entry.
"""
import pytest

import test_torch_model_mesh_trainer as trainer_cases

TAGS = ("smollm", "mixtral", "internvl2", "rwkv6", "zamba2")

DSHB = {f"{tag}+seq_par": (tag, dict(rule="cwtm", pre="nnm",
                                     backend="cuda_sharded"), False,
                           {"seq_par": True})
        for tag in TAGS}


@pytest.fixture(scope="module")
def dshb():
    return trainer_cases.run_cases(DSHB, steps=1)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", list(DSHB))
def test_seq_par_dshb_step_matches_reference(dshb, tag, shape):
    refs, worlds = dshb
    trainer_cases.check_step(worlds, refs, DSHB, tag, shape)
